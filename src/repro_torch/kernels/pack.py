"""Packed-buffer kernels (port of ``repro/kernels/pack.py``): the bucket
reduce K1, the fused quant8 transport K4, the row quantizers K5a/K5b and
the grouped reduce K6.

:func:`packed_bucket_reduce` is the reduction every dense, eq6 and
static_topn round runs under ``FedConfig.agg_impl="kernel"``
(``core.packing.masked_bucket_mean``). For a tensor on the card it launches
the hand-written CUDA kernel ``csrc/bucket_reduce.cu``; for a tensor on the
CPU it runs the plain version ``kernels.ref.packed_bucket_reduce``. A CUDA
tensor never takes the plain version: the kernel launches or the call
raises. On the ``meta`` device (the launch plans' dry-run) it returns empty
outputs and launches nothing; on the card and on ``meta`` it reports its
work to the op counter (``kernels.costs``). :func:`quant8_reduce` (``csrc/quant_reduce.cu``) is quant8's one
launch per round without a client mesh, :func:`quantize_rows`
(``csrc/row_quant.cu``) its one launch per round with one (the gathered
int8 transport; :func:`dequantize_rows` is its inverse, which no round
runs), and :func:`grouped_reduce` (``csrc/grouped_reduce.cu``) hier's inner
reduce, all under the same rule.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, costs, ref


def packed_bucket_reduce(packed: torch.Tensor, wmask: torch.Tensor, bucket_ids: torch.Tensor,
                         mask: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """packed (C, N) f32, wmask (C, B) f32, bucket_ids (N,) int32 with every
    id in [0, B), mask (C,) f32 0/1 or None (everyone) -> (num (N,), den
    (N,)) f32. Counts its CUDA launches in ``packed_bucket_reduce.launches``."""
    if packed.device.type == "cpu":
        return ref.packed_bucket_reduce(packed, wmask, bucket_ids, mask)
    if packed.device.type not in ("cuda", "meta"):
        raise ValueError(f"packed_bucket_reduce runs on cuda, cpu or meta tensors, "
                         f"not {packed.device}")
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
    costs.report("packed_bucket_reduce", *costs.packed_bucket_reduce(C, N, wmask.shape[1]), "fp32")
    if packed.device.type == "meta":  # the dry-run: the outputs' shapes, no launch
        return (torch.empty(N, dtype=torch.float32, device=packed.device),
                torch.empty(N, dtype=torch.float32, device=packed.device))
    # the kernel indexes wmask with the ids: one reduction and a host sync
    lo, hi = (int(v) for v in torch.aminmax(bucket_ids)) if N else (0, 0)
    if N and (lo < 0 or hi >= wmask.shape[1]):
        raise ValueError(f"bucket ids span [{lo}, {hi}], outside [0, {wmask.shape[1]})")
    num = torch.empty(N, dtype=torch.float32, device=packed.device)
    den = torch.empty(N, dtype=torch.float32, device=packed.device)
    _build.launch("packed_bucket_reduce_launch", packed.device, packed.data_ptr(), wmask.data_ptr(),
                  bucket_ids.data_ptr(), mask.data_ptr(), num.data_ptr(), den.data_ptr(), C, N,
                  wmask.shape[1])
    packed_bucket_reduce.launches += 1
    return num, den


packed_bucket_reduce.launches = 0


# the generic CUDA kernel gives each thread at most 4 float4 chunks of a scale block
MAX_QUANT_BLOCK = 4096
# the whole-tile kernels of csrc/quant_reduce.cu (K4/K7) and csrc/row_quant.cu
# (K5a/K12a) (block 1024, N % 4 == 0, 16-byte aligned rows; csrc/quant_tile.cuh):
# one warp per scale block at a time, 4 CTAs of 4 warps per SM, so one pass
# of their persistent grid covers SMs x 16 scale blocks. The row quantizer
# takes its whole-tile kernel from SMs x 4 (row, scale block) units up.
QUANT_TILE_BLOCK, QUANT_TILE_WARPS_PER_CTA, QUANT_TILE_WARPS_PER_SM = 1024, 4, 16


def check_quant_operands(what: str, delta: torch.Tensor, weights: torch.Tensor, block: int) -> None:
    """Validate the operands of a fused quantized reduce (K4, K7) on the card."""
    if delta.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {delta.device}")
    if delta.dim() != 2 or delta.shape[0] < 1 or weights.shape != (delta.shape[0],):
        raise ValueError(f"expected delta (C, N) with C >= 1 and weights (C,), got "
                         f"{tuple(delta.shape)} and {tuple(weights.shape)}")
    if delta.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError(f"{what} takes float32 delta and weights")
    if weights.device != delta.device:
        raise ValueError("delta and weights must be on one device")
    if not (delta.is_contiguous() and weights.is_contiguous()):
        raise ValueError(f"{what} takes contiguous tensors")
    if block < 4 or block % 4 or block > MAX_QUANT_BLOCK:
        raise ValueError(f"{what}: block={block} must be a multiple of 4 in [4, {MAX_QUANT_BLOCK}]")


def quant8_reduce(delta: torch.Tensor, weights: torch.Tensor, *, block: int = 1024) -> torch.Tensor:
    """delta (C, N) f32, weights (C,) f32 (participation folded in) -> (N,)
    f32 ``sum_c w_c dequant(quant8(delta_c))``, one scale per ``block``
    elements. Counts its CUDA launches in ``quant8_reduce.launches``."""
    if delta.device.type == "cpu":
        return ref.quant8_reduce(delta, weights, block)
    check_quant_operands("quant8_reduce", delta, weights, block)
    C, N = delta.shape
    out = torch.empty(N, dtype=torch.float32, device=delta.device)
    _build.launch("quant_reduce_launch", delta.device, delta.data_ptr(), weights.data_ptr(),
                  out.data_ptr(), C, N, block, 127.0, 0, 0)
    quant8_reduce.launches += 1
    return out


quant8_reduce.launches = 0


def _check_rows(what: str, x: torch.Tensor, dtype: torch.dtype, block: int) -> None:
    """Validate a (C, N) row-quantizer operand on the card."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu tensors, not {x.device}")
    if x.dim() != 2 or not 1 <= x.shape[0] <= 65535:
        raise ValueError(f"{what}: expected (C, N) with 1 <= C <= 65535, got {tuple(x.shape)}")
    if x.dtype != dtype:
        raise TypeError(f"{what} takes {dtype}, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what} takes contiguous tensors")
    if block < 4 or block % 4 or block > MAX_QUANT_BLOCK:
        raise ValueError(f"{what}: block={block} must be a multiple of 4 in [4, {MAX_QUANT_BLOCK}]")


def launch_quantize_rows(what: str, x: torch.Tensor, block: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One launch of ``csrc/row_quant.cu``'s quantizer on a (C, N) f32 card
    tensor -> (q int8 (C, N), scales f32 (C, ceil(N/block))); the callers
    (K5a here, K12a in ``kernels.quant``) count it."""
    _check_rows(what, x, torch.float32, block)
    C, N = x.shape
    nb = -(-N // block)
    q = torch.empty((C, N), dtype=torch.int8, device=x.device)
    scales = torch.empty((C, nb), dtype=torch.float32, device=x.device)
    _build.launch("quantize_rows_launch", x.device, x.data_ptr(), q.data_ptr(), scales.data_ptr(),
                  C, N, block, nb)
    return q, scales


# the output dtypes of the dequantizer, by the code its C entry takes
DEQUANT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def launch_dequantize_rows(what: str, q: torch.Tensor, scales: torch.Tensor, dtype: torch.dtype,
                           block: int) -> torch.Tensor:
    """One launch of ``csrc/row_quant.cu``'s dequantizer on card tensors
    -> (C, N) ``q * scale`` in ``dtype``; the callers (K5b here, K12b in
    ``kernels.quant``) count it."""
    _check_rows(what, q, torch.int8, block)
    C, N = q.shape
    nb = -(-N // block)
    if scales.shape != (C, nb) or scales.dtype != torch.float32:
        raise ValueError(f"{what}: scales must be ({C}, {nb}) float32, got "
                         f"{tuple(scales.shape)} {scales.dtype}")
    if scales.device != q.device or not scales.is_contiguous():
        raise ValueError(f"{what}: scales must be contiguous and on q's device")
    out = torch.empty((C, N), dtype=dtype, device=q.device)
    _build.launch("dequantize_rows_launch", q.device, q.data_ptr(), scales.data_ptr(),
                  out.data_ptr(), DEQUANT_DTYPES[dtype], C, N, block, nb)
    return out


def check_dequant_dtype(what: str, dtype: torch.dtype) -> None:
    if dtype not in DEQUANT_DTYPES:
        raise TypeError(f"{what} writes float32 or bfloat16, not {dtype}")


def quantize_rows(x: torch.Tensor, *, block: int = 1024) -> tuple[torch.Tensor, torch.Tensor]:
    """x (C, N) f32 -> (q int8 (C, N), scales f32 (C, ceil(N/block))): one
    symmetric scale ``max(amax, 1e-12)/127`` per ``block`` elements of each
    row, ``q = clip(round(x/scale), -127, 127)``. Counts its CUDA launches
    in ``quantize_rows.launches``."""
    if x.device.type == "cpu":
        return ref.quantize_rows(x, block)
    q, scales = launch_quantize_rows("quantize_rows", x, block)
    quantize_rows.launches += 1
    return q, scales


quantize_rows.launches = 0


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor, *, dtype: torch.dtype = torch.float32,
                    block: int = 1024) -> torch.Tensor:
    """q (C, N) int8, scales (C, ceil(N/block)) f32 -> (C, N) ``q * scale``
    in ``dtype`` (float32 or bfloat16). Counts its CUDA launches in
    ``dequantize_rows.launches``."""
    check_dequant_dtype("dequantize_rows", dtype)
    if q.device.type == "cpu":
        return ref.dequantize_rows(q, scales, block, dtype)
    out = launch_dequantize_rows("dequantize_rows", q, scales, dtype, block)
    dequantize_rows.launches += 1
    return out


dequantize_rows.launches = 0


def grouped_reduce(packed: torch.Tensor, wn: torch.Tensor) -> torch.Tensor:
    """packed (C, N) f32, wn (C/G, G) f32 pre-normalized member weights ->
    (C/G, N) f32 ``out[g] = sum_i wn[g, i] packed[gG + i]``. Counts its CUDA
    launches in ``grouped_reduce.launches``."""
    if packed.device.type == "cpu":
        return ref.grouped_reduce(packed, wn)
    if packed.device.type != "cuda":
        raise ValueError(f"grouped_reduce runs on cuda or cpu tensors, not {packed.device}")
    if packed.dim() != 2 or wn.dim() != 2 or wn.shape[0] * wn.shape[1] != packed.shape[0]:
        raise ValueError(f"expected packed (C, N) and wn (C/G, G), got "
                         f"{tuple(packed.shape)} and {tuple(wn.shape)}")
    if packed.dtype != torch.float32 or wn.dtype != torch.float32:
        raise TypeError("grouped_reduce takes float32 packed and wn")
    if wn.device != packed.device:
        raise ValueError("packed and wn must be on one device")
    if not (packed.is_contiguous() and wn.is_contiguous()):
        raise ValueError("grouped_reduce takes contiguous tensors")
    ngroups, G = wn.shape
    if ngroups > 65535:
        raise ValueError(f"grouped_reduce takes at most 65535 groups, got {ngroups}")
    N = packed.shape[1]
    out = torch.empty((ngroups, N), dtype=torch.float32, device=packed.device)
    _build.launch("grouped_reduce_launch", packed.device, packed.data_ptr(), wn.data_ptr(),
                  out.data_ptr(), ngroups, G, N)
    grouped_reduce.launches += 1
    return out


grouped_reduce.launches = 0
