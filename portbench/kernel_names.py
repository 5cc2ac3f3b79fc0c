"""Kernel families by name, for the per-layer readers.

The port's own kernels (K1-K12) carry the names of their ``__global__``
functions in ``src/repro_torch/kernels/csrc``. cuDNN's convolutions and
cuBLAS's products run under library names that change with the algorithm
and the library's version; the patterns below are substrings of the names
seen in this card's traces, matched case-blind.
"""
from __future__ import annotations

PORT = ("bucket_reduce_kernel", "pairwise_iou_kernel", "nms_bitmask_kernel", "nms_scan_kernel",
        "quant_reduce_kernel", "quant_reduce_tile_kernel", "rowquant_kernel", "rowquant_tile_kernel",
        "rowdequant_kernel", "treedequant_kernel", "grouped_reduce_kernel", "masked_sum_kernel",
        "flash_attention_kernel", "ssd_chunk_scan_kernel", "fedavg_kernel")
K1 = "bucket_reduce_kernel"
K10 = "ssd_chunk_scan_kernel"
CONV = ("conv", "cudnn", "xmma", "implicit", "fprop", "dgrad", "wgrad", "winograd", "fft",
        "nchw", "nhwc", "cutlass", "gemm", "gemv", "splitk")
GEMM = ("gemm", "gemv", "splitk", "xmma", "cutlass", "cublas")


def matches(name: str, patterns) -> bool:
    low = name.lower()
    return any(p.lower() in low for p in patterns)


def is_port(name: str) -> bool:
    return any(k in name for k in PORT)


def kernel_ms(rec: dict, keep) -> float:
    """Device ms of the record's kernels whose name ``keep`` accepts."""
    return sum(e - s for name, kind, s, e in rec["ops"] if kind == "kernel" and keep(name)) / 1e6
