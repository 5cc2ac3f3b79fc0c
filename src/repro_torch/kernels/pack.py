"""Packed-buffer kernels (port of ``repro/kernels/pack.py``): the bucket
reduce K1.

:func:`packed_bucket_reduce` is the reduction every dense, eq6 and
static_topn round runs under ``FedConfig.agg_impl="kernel"``
(``core.packing.masked_bucket_mean``). For a tensor on the card it launches
the hand-written CUDA kernel ``csrc/bucket_reduce.cu``; for a tensor on the
CPU it runs the plain version ``kernels.ref.packed_bucket_reduce``. A CUDA
tensor never takes the plain version: the kernel launches or the call
raises. The quant8, row-quantisation and grouped kernels belong to a later
slice.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref


def packed_bucket_reduce(packed: torch.Tensor, wmask: torch.Tensor, bucket_ids: torch.Tensor,
                         mask: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """packed (C, N) f32, wmask (C, B) f32, bucket_ids (N,) int32 with every
    id in [0, B), mask (C,) f32 0/1 or None (everyone) -> (num (N,), den
    (N,)) f32. Counts its CUDA launches in ``packed_bucket_reduce.launches``."""
    if packed.device.type == "cpu":
        return ref.packed_bucket_reduce(packed, wmask, bucket_ids, mask)
    if packed.device.type != "cuda":
        raise ValueError(f"packed_bucket_reduce runs on cuda or cpu tensors, not {packed.device}")
    if packed.dim() != 2 or wmask.dim() != 2 or wmask.shape[0] != packed.shape[0]:
        raise ValueError(f"expected packed (C, N) and wmask (C, B), got "
                         f"{tuple(packed.shape)} and {tuple(wmask.shape)}")
    C, N = packed.shape
    if bucket_ids.shape != (N,):
        raise ValueError(f"bucket_ids must be ({N},), got {tuple(bucket_ids.shape)}")
    if mask is None:
        mask = torch.ones(C, dtype=torch.float32, device=packed.device)
    if mask.shape != (C,):
        raise ValueError(f"mask must be ({C},), got {tuple(mask.shape)}")
    if packed.dtype != torch.float32 or wmask.dtype != torch.float32 or mask.dtype != torch.float32:
        raise TypeError("packed_bucket_reduce takes float32 packed, wmask and mask")
    if bucket_ids.dtype != torch.int32:
        raise TypeError("packed_bucket_reduce takes int32 bucket ids")
    if any(t.device != packed.device for t in (wmask, bucket_ids, mask)):
        raise ValueError("packed, wmask, bucket_ids and mask must be on one device")
    if not all(t.is_contiguous() for t in (packed, wmask, bucket_ids, mask)):
        raise ValueError("packed_bucket_reduce takes contiguous tensors")
    # the kernel indexes wmask with the ids: one reduction and a host sync
    lo, hi = (int(v) for v in torch.aminmax(bucket_ids)) if N else (0, 0)
    if N and (lo < 0 or hi >= wmask.shape[1]):
        raise ValueError(f"bucket ids span [{lo}, {hi}], outside [0, {wmask.shape[1]})")
    num = torch.empty(N, dtype=torch.float32, device=packed.device)
    den = torch.empty(N, dtype=torch.float32, device=packed.device)
    lib = _build.library()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.packed_bucket_reduce_launch(
            packed.data_ptr(), wmask.data_ptr(), bucket_ids.data_ptr(), mask.data_ptr(),
            num.data_ptr(), den.data_ptr(), C, N, wmask.shape[1], stream)
    _build.check(lib, code, "packed_bucket_reduce launch")
    packed_bucket_reduce.launches += 1
    return num, den


packed_bucket_reduce.launches = 0
