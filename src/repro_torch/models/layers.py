"""Shared building blocks of the LM family (port of ``repro/models/layers.py``):
RMSNorm, RoPE and the SwiGLU MLP, with the reference's numerics.

``rms_norm`` takes its statistics in float32 and multiplies ``x`` by
``(1 + w) * rsqrt(var + eps)`` cast back to ``x.dtype``; RoPE rotates in
float32 and casts back; SiLU runs in float32. :func:`einsum` promotes its
operands to one dtype first, as ``jnp.einsum`` does (``torch.einsum``
refuses mixed dtypes): the decode path multiplies a bfloat16 hidden state or
cache by float32 weights. :func:`softmax_cross_entropy` is the LM training
loss.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F


def einsum(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` after promoting every operand to their common dtype
    (bfloat16 with float32 -> float32, as JAX promotes)."""
    dtype = functools.reduce(torch.promote_types, (o.dtype for o in operands))
    return torch.einsum(eq, *(o.to(dtype) for o in operands))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with float32 statistics; the product is in ``x.dtype``."""
    xf = x.float()
    var = (xf * xf).sum(-1) / x.shape[-1]
    inv = torch.rsqrt(var + eps)[..., None]
    return x * ((1.0 + weight.float()) * inv).to(x.dtype)


def rope_freqs(positions: torch.Tensor, head_dim: int, theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) int -> cos, sin of shape (..., head_dim // 2), float32."""
    half = head_dim // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=positions.device) / half))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (S, D/2) or (B, S, D/2)."""
    dtype = x.dtype
    x1, x2 = x.float().chunk(2, dim=-1)
    if cos.dim() == 2:  # (S, half) -> broadcast over batch and heads
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:  # (B, S, half)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    g = einsum("...d,df->...f", x, w_gate)
    u = einsum("...d,df->...f", x, w_up)
    h = F.silu(g.float()).to(x.dtype) * u
    return einsum("...f,fd->...d", h, w_down)


def gold_logit(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The label's logit in float32, (..., V), (...,) -> (...,). The
    reference takes it with a masked reduction (``sum(logits * (iota ==
    label))``); every other term of that sum is a signed zero, so it is the
    gathered value bit for bit on finite logits. The port gathers: no
    (..., V) one-hot is materialized."""
    return torch.gather(logits.float(), -1, labels.long()[..., None])[..., 0]


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean CE over valid positions; logits (..., V), labels (...,) int,
    mask (...,) or None. float32 statistics; the masked mean divides by
    ``max(sum(mask), 1)``."""
    nll = torch.logsumexp(logits.float(), dim=-1) - gold_logit(logits, labels)
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
