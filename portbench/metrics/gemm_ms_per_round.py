"""gemm_ms_per_round: device ms a round in cuBLAS's matrix products, by
``kernel_names.GEMM``."""
from portbench import kernel_names as kn


def read(rec: dict):
    ms = kn.kernel_ms(rec, lambda n: not kn.is_port(n) and kn.matches(n, kn.GEMM))
    return ms / len(rec["rounds"]) if ms > 0 else None
