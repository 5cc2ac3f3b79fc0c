"""k1_roofline: K1's least time for its bytes (``yardstick.k1_bytes``, no
bucket ids) at the card's HBM peak, over its device time in the trace."""
from portbench import kernel_names as kn
from portbench import yardstick


def read(rec: dict):
    launches = [e - s for name, kind, s, e in rec["ops"] if kind == "kernel" and kn.K1 in name]
    if not launches:
        return None
    C, N, nb = rec["clients"], rec["n_total"], rec["n_buckets"]
    least = len(launches) * yardstick.k1_bytes(C, N, nb) / yardstick.PEAK_BYTES
    return 100.0 * least / (sum(launches) / 1e9)
