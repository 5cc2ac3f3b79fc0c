"""Legacy block quantizers K12a/K12b (port of ``repro/kernels/quant.py``).

:func:`quantize` and :func:`dequantize` are the per-leaf int8 transport of
``kernels.ops.quantize_tree`` / ``dequantize_tree``: one flat leaf, one
scale per ``block`` elements, the ragged tail zero-padded for the scale.
They are the row quantizers of ``csrc/row_quant.cu`` at C = 1. For a tensor
on the card they launch that kernel; for a tensor on the CPU they run the
plain versions ``kernels.ref.quantize`` / ``dequantize``. A CUDA tensor
never takes the plain version: the kernel launches or the call raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import pack, ref


def _flat(what: str, x: torch.Tensor) -> None:
    if x.dim() != 1:
        raise ValueError(f"{what} takes a 1-D tensor, got {tuple(x.shape)}")


def quantize(x: torch.Tensor, *, block: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """x (N,) f32 -> (q int8 (N,), scales f32 (ceil(N/block),)). Counts its
    CUDA launches in ``quantize.launches``."""
    _flat("quantize", x)
    if x.device.type == "cpu":
        return ref.quantize(x, block)
    q, scales = pack.launch_quantize_rows("quantize", x[None], block)
    quantize.launches += 1
    return q[0], scales[0]


quantize.launches = 0


def dequantize(q: torch.Tensor, scales: torch.Tensor, *, dtype: torch.dtype = torch.float32,
               block: int = 1024) -> torch.Tensor:
    """q (N,) int8, scales (ceil(N/block),) f32 -> (N,) ``q * scale`` in
    ``dtype`` (float32 or bfloat16). Counts its CUDA launches in
    ``dequantize.launches``."""
    _flat("dequantize", q)
    pack.check_dequant_dtype("dequantize", dtype)
    if q.device.type == "cpu":
        return ref.dequantize(q, scales, block, dtype)
    out = pack.launch_dequantize_rows("dequantize", q[None], scales[None], dtype, block)
    dequantize.launches += 1
    return out[0]


dequantize.launches = 0
