"""The work of one launch of a hand-written kernel, reported to the op
counter (``launch.op_analysis``).

A kernel launched through ``ctypes`` is invisible to a ``TorchDispatchMode``:
the counter sees only the buffers its wrapper allocates. So each wrapper on
a plan's step (K9 ``flash_attention``, K10 ``ssd_chunk_scan``, K1
``packed_bucket_reduce``) calls :func:`report` with the kernel's own
operations and bytes where it launches on the card, and where it runs on the
``meta`` device (an empty output of the kernel's shape and dtype, no
launch), so a counted round on the card and its trace on ``meta`` count the
same. The formulas are ``chip_smoke.py``'s bounds (``PERF.md`` §6): each
input read once and each output written once; the products (``flops``)
and the other operations (``other``), with the rate ``kind`` the products
run at (``"tf32x3"``: f32 through the 3xTF32 split; ``"bf16"``; ``"fp32"``:
the FP32 units).
"""
from __future__ import annotations

import contextlib

_SINKS: list = []


@contextlib.contextmanager
def collect(sink):
    """Call ``sink(name, flops, other, nbytes, kind)`` for every report in
    the block."""
    _SINKS.append(sink)
    try:
        yield
    finally:
        _SINKS.remove(sink)


def report(name: str, flops: float, other: float, nbytes: float, kind: str) -> None:
    for sink in list(_SINKS):
        sink(name, flops, other, nbytes, kind)


def visible_pairs(S: int, causal: bool, window: int) -> int:
    """(query, key) pairs an S x S attention computes: all of them, the
    causal triangle, or its band of ``window`` keys per query."""
    band = min(window, S) if window else S
    if not causal:  # keys j with i - j < window: every later key and the band before
        return S * S - (S - band) * (S - band + 1) // 2
    return band * (band + 1) // 2 + (S - band) * band


def flash_attention(B: int, H: int, Hkv: int, S: int, hd: int, causal: bool, window: int,
                    esize: int) -> tuple[float, float, float]:
    """K9: (products, other ops, bytes). Per visible pair 2 hd for q.k and 2
    hd for p.v, and 3 for the softmax; q, k, v read and out written once."""
    pairs = visible_pairs(S, causal, window) * B * H
    return pairs * 4 * hd, pairs * 3, esize * (2 * B * H * S * hd + 2 * B * Hkv * S * hd)


def ssd_chunk_scan(B: int, S: int, H: int, P: int, N: int, Q: int,
                   esize: int) -> tuple[float, float, float]:
    """K10: (products, other ops, bytes). C B^T over each chunk's causal
    triangle, y (2 P a pair) and the states (2 Q N P) per head; the
    triangle's exp and masks, the decay and the cumsums."""
    nc, tri = S // Q, Q * (Q + 1) // 2
    products = B * nc * tri * 2 * N + B * nc * H * (tri * 2 * P + 2 * Q * N * P)
    other = B * nc * H * (tri * 3 + Q * N + 3 * Q)
    nbytes = (esize * (B * S * H * P + 2 * B * S * N) + 4 * B * S * H
              + 4 * (B * S * H * P + B * nc * H * P * N + B * nc * H + B * S * H))
    return products, other, nbytes


def packed_bucket_reduce(C: int, N: int, nb: int) -> tuple[float, float, float]:
    """K1: (products, other ops, bytes). x, the ids, the (C, B) table and the
    mask read once, num and den written; per element and client a weight
    product, a multiply-add pair and an add, on the FP32 units."""
    return 0.0, 4.0 * C * N, 4.0 * (C * N + N + C * nb + C + 2 * N)
