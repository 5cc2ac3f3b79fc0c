"""k10_roofline: K10's least time, max(bytes / HBM peak, products / TF32
peak) a launch (``yardstick.k10_least_s``) at the cell's SSD shape (a
launch scans one local step's batch: B sequences of S tokens, H heads of
width P, state N, chunks of Q), over its device time in the trace."""
from portbench import kernel_names as kn
from portbench import yardstick


def read(rec: dict):
    launches = [e - s for name, kind, s, e in rec["ops"] if kind == "kernel" and kn.K10 in name]
    sizes, mix = rec["sizes"], rec["mix"]
    if not launches or "ssm_state" not in sizes:
        return None
    P = sizes["ssm_headdim"]
    shape = dict(B=mix["batch"], S=mix["seq"], H=sizes["ssm_expand"] * sizes["d_model"] // P, P=P,
                 N=sizes["ssm_state"], Q=sizes["ssm_chunk"])
    least = len(launches) * yardstick.k10_least_s(shape)
    return 100.0 * least / (sum(launches) / 1e9)
