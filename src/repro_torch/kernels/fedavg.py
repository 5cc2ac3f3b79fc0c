"""Per-leaf masked FedAvg K11 (port of ``repro/kernels/fedavg.py``).

:func:`fedavg_masked_mean` is the legacy per-leaf Eq. 5 + Eq. 6 reduction
that ``kernels.ops.fedavg_tree`` launches once per leaf of a client-stacked
tree (the compression demo's last step,
``repro_torch.examples.compression_demo``). For a tensor on the card it
launches the hand-written CUDA kernel ``csrc/fedavg.cu``; for a tensor on
the CPU it runs the plain version ``kernels.ref.fedavg_masked_mean``. A CUDA
tensor never takes the plain version: the kernel launches or the call
raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def weighted_mask(weights: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(C,) weights and (C,) 0/1 upload mask -> (wm (C,) f32 = weights *
    mask, den 0-d f32 = max(sum(wm), 1e-12)), on weights' device. ``den`` is
    a 0-d tensor so that the plain version's division is a true IEEE
    division on every device, as the kernel's is (``packing.exact_div``)."""
    wm = (weights.float() * mask.float().to(weights.device)).contiguous()
    return wm, torch.clamp_min(torch.sum(wm), 1e-12)


def fedavg_masked_mean(stacked: torch.Tensor, weights: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """stacked (C, N) float32 or bfloat16, weights (C,), mask (C,) 0/1 ->
    (N,) in stacked's dtype: ``sum_c w_c m_c x[c, n] / max(sum_c w_c m_c,
    1e-12)``, accumulated in float32. Counts its CUDA launches in
    ``fedavg_masked_mean.launches``."""
    if stacked.dim() != 2:
        raise ValueError(f"expected stacked (C, N), got {tuple(stacked.shape)}")
    C, N = stacked.shape
    if weights.shape != (C,) or mask.shape != (C,):
        raise ValueError(f"weights and mask must be ({C},), got {tuple(weights.shape)} and "
                         f"{tuple(mask.shape)}")
    if stacked.dtype not in DTYPES:
        raise TypeError(f"fedavg_masked_mean takes float32 or bfloat16 leaves, got {stacked.dtype}")
    wm, den = weighted_mask(weights, mask)
    if stacked.device.type == "cpu":
        return ref.fedavg_masked_mean(stacked, wm, den)
    if stacked.device.type != "cuda":
        raise ValueError(f"fedavg_masked_mean runs on cuda or cpu tensors, not {stacked.device}")
    if wm.device != stacked.device:
        raise ValueError("stacked and weights must be on one device")
    x = stacked if stacked.is_contiguous() else stacked.contiguous()
    out = torch.empty(N, dtype=stacked.dtype, device=stacked.device)
    _build.launch("fedavg_masked_mean_launch", stacked.device, x.data_ptr(), wm.data_ptr(),
                  den.data_ptr(), out.data_ptr(), DTYPES[stacked.dtype], C, N)
    fedavg_masked_mean.launches += 1
    return out


fedavg_masked_mean.launches = 0
