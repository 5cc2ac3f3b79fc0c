"""Secure-aggregation integer reduce K8 (port of ``repro/kernels/mask.py``).

:func:`masked_u32_sum` is the secure aggregator's one launch per round
under ``FedConfig.agg_impl="kernel"``: the participation-gated sum mod 2^32
of the masked client rows, in which the pairwise masks cancel exactly. The
rows travel as an int32 tensor holding the uint32 bits (torch's uint32 has
too few operations on the CPU). For a tensor on the card it launches
``csrc/masked_sum.cu``; for a tensor on the CPU it runs the plain version
``kernels.ref.masked_u32_sum``. A CUDA tensor never takes the plain
version: the kernel launches or the call raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def masked_u32_sum(rows: torch.Tensor, participation: torch.Tensor) -> torch.Tensor:
    """rows (C, N) int32 (uint32 bits), participation (C,) f32 -> (N,) int32
    bits of the sum mod 2^32 of the rows with ``participation > 0``. Counts
    its CUDA launches in ``masked_u32_sum.launches``."""
    if rows.device.type == "cpu":
        return ref.masked_u32_sum(rows, participation)
    if rows.device.type != "cuda":
        raise ValueError(f"masked_u32_sum runs on cuda or cpu tensors, not {rows.device}")
    if rows.dim() != 2 or participation.shape != (rows.shape[0],):
        raise ValueError(f"expected rows (C, N) and participation (C,), got "
                         f"{tuple(rows.shape)} and {tuple(participation.shape)}")
    if rows.dtype != torch.int32 or participation.dtype != torch.float32:
        raise TypeError("masked_u32_sum takes int32 rows and float32 participation")
    if participation.device != rows.device:
        raise ValueError("rows and participation must be on one device")
    if not (rows.is_contiguous() and participation.is_contiguous()):
        raise ValueError("masked_u32_sum takes contiguous tensors")
    C, N = rows.shape
    out = torch.empty(N, dtype=torch.int32, device=rows.device)
    _build.launch("masked_u32_sum_launch", rows.device, rows.data_ptr(),
                  participation.data_ptr(), out.data_ptr(), C, N)
    masked_u32_sum.launches += 1
    return out


masked_u32_sum.launches = 0
