"""conv_ms_per_round: device ms a round in cuDNN's convolution kernels
(forward, data and weight gradients), by ``kernel_names.CONV``."""
from portbench import kernel_names as kn


def read(rec: dict):
    ms = kn.kernel_ms(rec, lambda n: not kn.is_port(n) and kn.matches(n, kn.CONV))
    return ms / len(rec["rounds"]) if ms > 0 else None
