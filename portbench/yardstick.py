"""The yardstick: the card's peaks and the work of the port's own kernels,
frozen here so that no change to the program moves them.

Peaks of one NVIDIA H100 SXM5 80GB at its 700 W limit (NVIDIA's data
sheet, dense): TF32 tensor-core products 494.7e12 FLOP/s, HBM3 3.35e12 B/s.
The configurations compute in f32; no f32-faithful path runs faster than
TF32's own rate, so a share of these peaks cannot pass 100%.
"""
from __future__ import annotations

PEAK_FLOPS = 494.7e12  # TF32 dense tensor-core products
PEAK_BYTES = 3.35e12  # HBM3


def k1_bytes(C: int, N: int, nb: int) -> float:
    """K1 (``packed_bucket_reduce``): the (C, N) f32 rows, the (C, nb)
    weight table and the (C,) mask read once, num and den (2 N f32)
    written once. The (N,) bucket ids are the implementation's, not the
    work's, and are not counted."""
    return 4.0 * (C * N + C * nb + C + 2 * N)


def k10_work(B: int, S: int, H: int, P: int, N: int, Q: int, esize: int = 4) -> tuple[float, float]:
    """K10 (``ssd_chunk_scan``, one launch): (products, bytes). C B^T over
    each chunk's causal triangle, y (2 P a pair) and the chunk states (2 Q N
    P) per head; xdt, B and C read once, dA read once, y, the states, the
    chunk decay and exp(cum) written once."""
    nc, tri = S // Q, Q * (Q + 1) // 2
    products = B * nc * tri * 2 * N + B * nc * H * (tri * 2 * P + 2 * Q * N * P)
    nbytes = (esize * (B * S * H * P + 2 * B * S * N) + 4 * B * S * H
              + 4 * (B * S * H * P + B * nc * H * P * N + B * nc * H + B * S * H))
    return float(products), float(nbytes)


def k10_least_s(shape: dict) -> float:
    """The least time of one K10 launch: max(bytes / HBM, products / TF32)."""
    products, nbytes = k10_work(**shape)
    return max(nbytes / PEAK_BYTES, products / PEAK_FLOPS)
