"""Fused 4-bit transport kernel K7 (port of ``repro/kernels/quant4.py``).

:func:`quant4_reduce` is the quant4 aggregator's one launch per round under
``FedConfig.agg_impl="kernel"``: per-block symmetric quantization to
[-7, 7], nearest or counter-hash stochastic rounding, dequantization and
the weighted client sum, with no payload materialized. For a tensor on the
card it launches ``csrc/quant_reduce.cu`` (the K4 kernel with Q = 7); for a
tensor on the CPU it runs the plain version ``kernels.ref.quant4_reduce``. A
CUDA tensor never takes the plain version: the kernel launches or the call
raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.pack import check_quant_operands

MODES = ("nearest", "stochastic")


def quant4_reduce(delta: torch.Tensor, weights: torch.Tensor, key: int = 0, *,
                  mode: str = "nearest", block: int = 1024) -> torch.Tensor:
    """delta (C, N) f32, weights (C,) f32 (participation folded in), ``key``
    the round's uint32 PRNG key as a Python int (``packing.round_key``) ->
    (N,) f32 ``sum_c w_c dequant(quant4(delta_c))``. Counts its CUDA
    launches in ``quant4_reduce.launches``."""
    if mode not in MODES:
        raise ValueError(f"quant4 mode={mode!r}; expected one of {MODES}")
    if not 0 <= key <= 0xFFFFFFFF:
        raise ValueError(f"key {key} is not a uint32")
    if delta.device.type == "cpu":
        return ref.quant4_reduce(delta, weights, key, mode, block)
    check_quant_operands("quant4_reduce", delta, weights, block)
    C, N = delta.shape
    out = torch.empty(N, dtype=torch.float32, device=delta.device)
    _build.launch("quant_reduce_launch", delta.device, delta.data_ptr(), weights.data_ptr(),
                  out.data_ptr(), C, N, block, 7.0, int(mode == "stochastic"), key)
    quant4_reduce.launches += 1
    return out


quant4_reduce.launches = 0
