"""other_ms_per_round: device ms a round in every kernel that is neither
a convolution, a matrix product nor one of the port's own K1-K12:
autograd's elementwise passes, the optimizer, Eq. 6's scoring."""
from portbench import kernel_names as kn


def read(rec: dict):
    ms = kn.kernel_ms(rec, lambda n: not kn.is_port(n) and not kn.matches(n, kn.CONV + kn.GEMM))
    return ms / len(rec["rounds"]) if ms > 0 else None
