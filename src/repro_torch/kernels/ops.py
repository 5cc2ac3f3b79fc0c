"""Kernel dispatch (port of ``repro/kernels/ops.py``): NMS, pairwise IoU, the
fused transports (quant8 K4, grouped K6, quant4 K7, masked sum K8), flash
attention (K9) and the Mamba2 SSD chunk scan (K10) with the full SSD around
it.

``impl="kernel"`` (the default) runs the kernel wrapper, which launches the
CUDA kernel for a tensor on the card and its plain version for one on the
CPU. ``impl="ref"`` forces the plain PyTorch version on any device; only
``chip_smoke.py`` and the tests pass it, to hold the kernel against it. The
aggregators select K1, K4, K6, K7 and K8 through ``FedConfig.agg_impl``
instead (``core.packing``, ``core.aggregators``), and the LM blocks select
K9 and K10 through ``ArchConfig.attention_impl`` / ``ssm_impl``. The
reference wraps K9 and K10 in a ``custom_vjp`` for training; the port's LM
path serves only, so these are forward passes (gradients come with LM
training).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import detect, mask, pack, quant4, ref
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ssd_scan as _ssd

IMPLS = ("kernel", "ref")


def nms(boxes: torch.Tensor, scores: torch.Tensor, *, iou_thresh: float = 0.5,
        score_thresh: float = 0.0, max_keep: int = 0, impl: str = "kernel") -> torch.Tensor:
    if impl == "kernel":
        return detect.nms(boxes, scores, iou_thresh=iou_thresh,
                          score_thresh=score_thresh, max_keep=max_keep)
    if impl == "ref":
        return ref.nms(boxes, scores, iou_thresh, score_thresh, max_keep)
    raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")


def pairwise_iou(boxes_a: torch.Tensor, boxes_b: torch.Tensor, *, giou: bool = False,
                 impl: str = "kernel") -> torch.Tensor:
    if impl == "kernel":
        return detect.pairwise_iou(boxes_a, boxes_b, giou=giou)
    if impl == "ref":
        return ref.pairwise_iou(boxes_a, boxes_b, giou)
    raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")


def quant8_reduce(delta: torch.Tensor, weights: torch.Tensor, *, block: int = 1024,
                  impl: str = "kernel") -> torch.Tensor:
    if impl == "kernel":
        return pack.quant8_reduce(delta, weights, block=block)
    if impl == "ref":
        return ref.quant8_reduce(delta, weights, block)
    raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")


def quant4_reduce(delta: torch.Tensor, weights: torch.Tensor, key: int = 0, *,
                  mode: str = "nearest", block: int = 1024, impl: str = "kernel") -> torch.Tensor:
    if impl == "kernel":
        return quant4.quant4_reduce(delta, weights, key, mode=mode, block=block)
    if impl == "ref":
        return ref.quant4_reduce(delta, weights, key, mode, block)
    raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")


def grouped_reduce(packed: torch.Tensor, wn: torch.Tensor, *, impl: str = "kernel") -> torch.Tensor:
    if impl == "kernel":
        return pack.grouped_reduce(packed, wn)
    if impl == "ref":
        return ref.grouped_reduce(packed, wn)
    raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")


def masked_u32_sum(rows: torch.Tensor, participation: torch.Tensor, *,
                   impl: str = "kernel") -> torch.Tensor:
    if impl == "kernel":
        return mask.masked_u32_sum(rows, participation)
    if impl == "ref":
        return ref.masked_u32_sum(rows, participation)
    raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    window: int = 0, impl: str = "kernel") -> torch.Tensor:
    """q (B, H, S, hd), k/v (B, Hkv, S, hd) -> (B, H, S, hd) in q's dtype."""
    if impl == "kernel":
        return _flash.flash_attention(q, k, v, causal=causal, window=window)
    if impl == "ref":
        return ref.flash_attention(q, k, v, causal, window)
    raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")


def ssd_chunk_scan(xdt: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, *,
                   chunk: int = 128, impl: str = "kernel"):
    """-> float32 (y_diag, states, chunk_decay, exp_cum); see
    ``kernels.ssd_scan.ssd_chunk_scan``."""
    if impl == "kernel":
        return _ssd.ssd_chunk_scan(xdt, dA, Bm, Cm, chunk=chunk)
    if impl == "ref":
        return ref.ssd_chunk_scan(xdt, dA, Bm, Cm, chunk)
    raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")


def ssd_full(xdt: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, *,
             chunk: int = 128, impl: str = "kernel"):
    """Full SSD: the intra-chunk pass (K10) plus the inter-chunk recurrence,
    a loop over the S / chunk chunks, then the ``y_off`` term
    (``repro/kernels/ops.py::ssd_full``). Same contract as
    ``models.mamba2.ssd_chunked``: (y (B, S, H, P) in xdt's dtype,
    final_state (B, H, P, N) float32)."""
    B, S, H, P = xdt.shape
    N = Bm.shape[-1]
    y_diag, states, chunk_decay, exp_cum = ssd_chunk_scan(xdt, dA, Bm, Cm, chunk=chunk, impl=impl)
    nc = S // chunk
    carry = torch.zeros((B, H, P, N), dtype=torch.float32, device=xdt.device)
    prev = []
    for c in range(nc):  # emit the state entering each chunk
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)  # (B, nc, H, P, N)
    y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", Cm.float().reshape(B, nc, chunk, N), prev,
                         exp_cum.reshape(B, nc, chunk, H))
    y = y_diag + y_off.reshape(B, S, H, P)
    return y.to(xdt.dtype), carry
