"""Kernel dispatch (port of ``repro/kernels/ops.py``): NMS, pairwise IoU, the
fused transports (quant8 K4, grouped K6, quant4 K7, masked sum K8), the row
quantizers (K5a/K5b) and the block quantizers of a tree (K12a a launch per
leaf, K12b one launch per tree), flash attention (K9) and the Mamba2 SSD
chunk scan (K10) with the full SSD around it, their trainable forms, and the
per-leaf FedAvg of a client-stacked tree (K11).

``impl="kernel"`` (the default) runs the kernel wrapper, which launches the
CUDA kernel for a tensor on the card and its plain version for one on the
CPU. ``impl="ref"`` forces the plain PyTorch version on any device; only
``chip_smoke.py`` and the tests pass it, to hold the kernel against it. The
aggregators select K1, K4, K5a, K6, K7 and K8 through ``FedConfig.agg_impl``
instead (``core.packing``, ``core.aggregators``), and the LM blocks select
K9 and K10 through ``ArchConfig.attention_impl`` / ``ssm_impl``.

Training goes through :func:`flash_attention_trainable` and
:func:`ssd_full_trainable`, ``torch.autograd.Function``s in the reference's
``custom_vjp`` pattern: the forward runs the kernel wrapper and saves the
inputs; the backward recomputes the plain function under
``torch.enable_grad()`` and returns its ``torch.autograd.grad``. The raw
wrappers write into fresh buffers with no ``grad_fn``, so they raise when
an input requires grad under grad mode: a gradient must never vanish
silently behind a kernel.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels import _build, detect, mask, pack, quant4, ref
from repro_torch.kernels import quant as _quant
from repro_torch.kernels import fedavg as _fedavg
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import ssd_scan as _ssd

PyTree = Any
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


def quantize_rows(x: torch.Tensor, *, block: int = 1024,
                  impl: str = "kernel") -> tuple[torch.Tensor, torch.Tensor]:
    """(C, N) f32 -> (q int8 (C, N), scales (C, ceil(N/block)))."""
    if impl == "kernel":
        return pack.quantize_rows(x, block=block)
    if impl == "ref":
        return ref.quantize_rows(x, block)
    raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")


def dequantize_rows(q: torch.Tensor, scales: torch.Tensor, *, dtype: torch.dtype = torch.float32,
                    block: int = 1024, impl: str = "kernel") -> torch.Tensor:
    if impl == "kernel":
        return pack.dequantize_rows(q, scales, dtype=dtype, block=block)
    if impl == "ref":
        return ref.dequantize_rows(q, scales, block, dtype)
    raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")


def quantize(x: torch.Tensor, *, block: int = 1024,
             impl: str = "kernel") -> tuple[torch.Tensor, torch.Tensor]:
    """(N,) f32 -> (q int8 (N,), scales (ceil(N/block),))."""
    if impl == "kernel":
        return _quant.quantize(x, block=block)
    if impl == "ref":
        return ref.quantize(x, block)
    raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")


def dequantize(q: torch.Tensor, scales: torch.Tensor, *, dtype: torch.dtype = torch.float32,
               block: int = 1024, impl: str = "kernel") -> torch.Tensor:
    if impl == "kernel":
        return _quant.dequantize(q, scales, dtype=dtype, block=block)
    if impl == "ref":
        return ref.dequantize(q, scales, block, dtype)
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
    final_state (B, H, P, N) float32). A forward pass: under grad it raises
    (:func:`ssd_full_trainable` is the training form)."""
    _build.forward_only("ssd_full", xdt, dA, Bm, Cm)
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


class _FlashAttention(torch.autograd.Function):
    """K9 forward, the plain version's gradient (``flash_attention_trainable``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        return _flash.flash_attention(q, k, v, causal=causal, window=window)

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            out = ref.flash_attention(*ins, ctx.causal, ctx.window)
            grads = torch.autograd.grad(out, ins, g)
        return (*grads, None, None)


def flash_attention_trainable(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                              causal: bool = True, window: int = 0) -> torch.Tensor:
    """Flash attention with a gradient (``repro/kernels/ops.py::
    flash_attention_trainable``): the kernel wrapper runs the forward (K9 on
    the card, the plain version on the CPU), the backward is autograd of
    ``kernels.ref.flash_attention`` recomputed from the saved q, k, v. Same
    layout as :func:`flash_attention`."""
    return _FlashAttention.apply(q, k, v, causal, window)


class _SSDFull(torch.autograd.Function):
    """:func:`ssd_full` forward (K10), ``ssd_chunked``'s gradient."""

    @staticmethod
    def forward(ctx, xdt, dA, Bm, Cm, chunk: int):
        ctx.save_for_backward(xdt, dA, Bm, Cm)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return ssd_full(xdt, dA, Bm, Cm, chunk=chunk)

    @staticmethod
    def backward(ctx, gy, gstate):
        from repro_torch.models.mamba2 import ssd_chunked

        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
            y, state = ssd_chunked(*ins, ctx.chunk)
            outs = [(o, g.to(o.dtype)) for o, g in ((y, gy), (state, gstate)) if g is not None]
            grads = torch.autograd.grad([o for o, _ in outs], ins, [g for _, g in outs],
                                        allow_unused=True) if outs else (None,) * 4
        return (*grads, None)


def ssd_full_trainable(xdt: torch.Tensor, dA: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                       *, chunk: int = 128):
    """:func:`ssd_full` with a gradient (``repro/kernels/ops.py::
    ssd_full_trainable``): the forward is the full SSD around the K10 wrapper,
    the backward autograd of ``models.mamba2.ssd_chunked`` over the whole
    SSD, recomputed from the saved inputs (the reference's ``bwd``)."""
    return _SSDFull.apply(xdt, dA, Bm, Cm, chunk)


def fedavg_masked_mean(stacked: torch.Tensor, weights: torch.Tensor, mask: torch.Tensor, *,
                       impl: str = "kernel") -> torch.Tensor:
    """(C, N), (C,), (C,) -> (N,) in stacked's dtype; see
    ``kernels.fedavg.fedavg_masked_mean``."""
    if impl == "kernel":
        return _fedavg.fedavg_masked_mean(stacked, weights, mask)
    if impl == "ref":
        wm, den = _fedavg.weighted_mask(weights, mask)
        return ref.fedavg_masked_mean(stacked, wm, den)
    raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")


def fedavg_tree(stacked: PyTree, weights: torch.Tensor, mask_per_leaf: PyTree, *,
                impl: str = "kernel") -> PyTree:
    """Eq. 5 + Eq. 6 over a client-stacked tree (``repro/kernels/ops.py::
    fedavg_tree``): each (C, *shape) leaf is flattened to (C, N) and reduced
    by one K11 launch with its own (C,) upload mask -> a tree of (*shape)
    leaves in the leaves' dtypes."""
    from repro_torch.models.params import flatten_with_paths, unflatten

    masks = dict(flatten_with_paths(mask_per_leaf))
    out = {}
    for path, x in flatten_with_paths(stacked):
        flat = x.reshape(x.shape[0], -1)
        out[path] = fedavg_masked_mean(flat, weights, masks[path], impl=impl).reshape(x.shape[1:])
    return unflatten(stacked, out)


def quantize_tree(tree: PyTree, *, impl: str = "kernel") -> PyTree:
    """Per-leaf int8 block quantization (``repro/kernels/ops.py::
    quantize_tree``): each leaf flattened, widened to float32 and quantized
    by one K12a launch -> a tree of ``{"q", "scales"}`` leaves."""
    from repro_torch.models.params import flatten_with_paths, unflatten

    out = {}
    for path, x in flatten_with_paths(tree):
        q, scales = quantize(x.reshape(-1).float(), impl=impl)
        out[path] = {"q": q, "scales": scales}
    return unflatten(tree, out)


def dequantize_tree(qtree: PyTree, like: PyTree, *, impl: str = "kernel") -> PyTree:
    """Inverse of :func:`quantize_tree`: every ``{"q", "scales"}`` leaf
    decoded in its ``like`` leaf's dtype and shape, by one K12b launch for
    the whole tree (up to ``kernels.quant.TREE_CAPACITY`` leaves a launch)."""
    from repro_torch.models.params import flatten_with_paths, unflatten

    flat = dict(flatten_with_paths(qtree))
    likes = list(flatten_with_paths(like))
    qs = [flat[f"{path}/q"] for path, _ in likes]
    scales = [flat[f"{path}/scales"] for path, _ in likes]
    if impl == "kernel":
        outs = _quant.dequantize_tree(qs, scales, [x.dtype for _, x in likes])
    elif impl == "ref":
        outs = [ref.dequantize(q, s, _quant.TREE_BLOCK, x.dtype) for q, s, (_, x) in zip(qs, scales, likes)]
    else:
        raise ValueError(f"impl={impl!r}; expected one of {IMPLS}")
    return unflatten(like, {path: o.reshape(x.shape) for (path, x), o in zip(likes, outs)})
