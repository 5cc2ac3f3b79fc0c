"""Mamba2 SSD (state-space duality) block (port of ``repro/models/mamba2.py``).

The minimal SSD formulation of arXiv:2405.21060: an intra-chunk quadratic
term plus an inter-chunk recurrent state, the recurrence a loop over chunks
(the reference's ``lax.scan``). Under ``ssm_impl="kernel"`` a prefill whose
length is a multiple of ``ssm_chunk`` runs the intra-chunk pass as the SSD
chunk-scan kernel (K10, through ``kernels.ops.ssd_full``, or under grad
``ssd_full_trainable``, whose backward is :func:`ssd_chunked`'s); other lengths take
:func:`ssd_chunked`, as in the reference. Projections stay separate (wz, wx,
wB, wC, wdt), as in the reference's param tree. :func:`mamba2_decode` is the
O(1)-in-sequence one-token step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import einsum, rms_norm
from repro_torch.models.params import ParamInfo


def dims(cfg):
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_headdim, cfg.ssm_state


def mamba2_template(cfg, prefix_axes=("layer",), n_stack=()):
    d = cfg.d_model
    di, h, n = dims(cfg)
    k = cfg.ssm_conv
    pa, ns = prefix_axes, n_stack
    return {
        "wz": ParamInfo(ns + (d, di), pa + ("embed", "ssm_inner")),
        "wx": ParamInfo(ns + (d, di), pa + ("embed", "ssm_inner")),
        "wB": ParamInfo(ns + (d, n), pa + ("embed", "ssm_state")),
        "wC": ParamInfo(ns + (d, n), pa + ("embed", "ssm_state")),
        "wdt": ParamInfo(ns + (d, h), pa + ("embed", "heads")),
        "conv_x": ParamInfo(ns + (k, di), pa + ("conv", "ssm_inner"), init="small_normal"),
        "conv_B": ParamInfo(ns + (k, n), pa + ("conv", "ssm_state"), init="small_normal"),
        "conv_C": ParamInfo(ns + (k, n), pa + ("conv", "ssm_state"), init="small_normal"),
        "A_log": ParamInfo(ns + (h,), pa + ("heads",), init="zeros"),
        "D": ParamInfo(ns + (h,), pa + ("heads",), init="ones"),
        "dt_bias": ParamInfo(ns + (h,), pa + ("heads",), init="zeros"),
        "gate_norm": ParamInfo(ns + (di,), pa + ("ssm_inner",), init="zeros"),
        "wo": ParamInfo(ns + (di, d), pa + ("ssm_inner", "embed")),
    }


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x (B, S, C), w (k, C) -> (B, S, C)."""
    k, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, i:i + S, :] * w[i] for i in range(k))


def _silu32(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.silu(x.float()).to(dtype)


def ssd_chunked(xdt, dA, Bm, Cm, chunk: int):
    """Chunked SSD. xdt (b, s, h, p) [x * dt folded], dA (b, s, h), Bm/Cm
    (b, s, n) -> y (b, s, h, p) and the final state (b, h, p, n), both in
    xdt's dtype; float32 decay math."""
    b, s, h, p = xdt.shape
    n = Bm.shape[-1]
    s_orig = s
    if s % chunk:  # right-pad to a chunk multiple (dA = 0 -> decay 1, xdt = 0)
        pad = chunk - s % chunk
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        dA, Bm, Cm = (F.pad(t, (0, 0, 0, pad)) for t in (dA, Bm, Cm))
        s += pad
    nc = s // chunk
    dt = xdt.dtype
    xdt_c = xdt.reshape(b, nc, chunk, h, p)
    B_c = Bm.reshape(b, nc, chunk, n)
    C_c = Cm.reshape(b, nc, chunk, n)
    cum = torch.cumsum(dA.reshape(b, nc, chunk, h).float(), dim=2)  # (b, nc, Q, h)
    # intra-chunk decay L[q, t] = exp(cum[q] - cum[t]), q >= t. The mask goes
    # in before the exp (-inf -> 0): above the diagonal cum[q] - cum[t] > 0
    # reaches exp's overflow at full width (dA about -0.8 over a chunk of
    # 128), and where(tri, exp(.), 0) would then backpropagate 0 * inf = NaN.
    # The forward is the reference's bit for bit.
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=xdt.device).tril()[None, None, :, :, None]
    L = torch.exp(torch.where(tri, cum[:, :, :, None, :] - cum[:, :, None, :, :],
                              float("-inf"))).to(dt)
    scores = einsum("bcqn,bctn->bcqt", C_c, B_c)
    y_diag = einsum("bcqth,bcthp->bcqhp", scores[..., None] * L, xdt_c)
    # per-chunk state contribution and total chunk decay
    decay_states = torch.exp(cum[:, :, -1:, :] - cum).to(dt)  # (b, nc, Q, h)
    states = einsum("bcthn,bcthp->bchpn", B_c[:, :, :, None, :] * decay_states[..., None], xdt_c)
    chunk_decay = torch.exp(cum[:, :, -1, :]).to(dt)  # (b, nc, h)
    carry = torch.zeros((b, h, p, n), dtype=dt, device=xdt.device)
    prev = []
    for c in range(nc):  # emit the state entering each chunk
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (b, nc, h, p, n)
    y_off = einsum("bcqn,bchpn,bcqh->bcqhp", C_c, prev_states, torch.exp(cum).to(dt))
    y = (y_diag + y_off).reshape(b, s, h, p)[:, :s_orig]
    return y, carry


def mamba2_block(p: dict, x: torch.Tensor, cfg, return_state: bool = False):
    """Full-sequence Mamba2 block. x (B, S, D) -> (B, S, D).

    With return_state=True also returns the decode-ready layer state
    {"ssm" (B, h, p, n) float32, "conv" (B, k-1, C) pre-activation tail}.
    """
    di, h, n = dims(cfg)
    pdim = cfg.ssm_headdim
    z = einsum("bsd,de->bse", x, p["wz"])
    x_pre = einsum("bsd,de->bse", x, p["wx"])
    B_pre = einsum("bsd,dn->bsn", x, p["wB"])
    C_pre = einsum("bsd,dn->bsn", x, p["wC"])
    xin = _silu32(causal_conv(x_pre, p["conv_x"]), x.dtype)
    Bm = _silu32(causal_conv(B_pre, p["conv_B"]), x.dtype)
    Cm = _silu32(causal_conv(C_pre, p["conv_C"]), x.dtype)
    dt = einsum("bsd,dh->bsh", x, p["wdt"])
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())  # (h,)
    dA = dt * A  # (B, S, h)
    xh = xin.reshape(*xin.shape[:2], h, pdim)
    xdt = xh * dt[..., None].to(x.dtype)
    if cfg.ssm_impl == "kernel" and x.shape[1] % cfg.ssm_chunk == 0:
        # training takes the autograd Function (K10 forward, ssd_chunked's backward)
        ssd = kops.ssd_full_trainable if torch.is_grad_enabled() else kops.ssd_full
        y, final_state = ssd(xdt, dA, Bm, Cm, chunk=cfg.ssm_chunk)
    else:
        y, final_state = ssd_chunked(xdt, dA, Bm, Cm, cfg.ssm_chunk)
    y = y + xh * p["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(*x.shape[:2], di)
    y = rms_norm(y * _silu32(z, x.dtype), p["gate_norm"], cfg.norm_eps)
    out = einsum("bse,ed->bsd", y, p["wo"])
    if return_state:
        k = cfg.ssm_conv
        pre = torch.cat([x_pre, B_pre, C_pre], dim=-1)  # (B, S, C)
        S = x.shape[1]
        # a copy, not a view: a view would keep the whole (B, S, C) ``pre``
        # alive for as long as the cache lives (every layer of a prefill)
        conv_cache = (pre[:, -(k - 1):, :].clone() if S >= k - 1
                      else F.pad(pre, (0, 0, k - 1 - S, 0)))
        return out, {"ssm": final_state.float(), "conv": conv_cache}
    return out


# ---------------------------------------------------------------------------
# Decode path: O(1)-in-sequence recurrent state
# ---------------------------------------------------------------------------

def init_state(cfg, n_layers: int, batch: int, dtype=torch.bfloat16, device=None) -> dict:
    di, h, n = dims(cfg)
    return {
        "ssm": torch.zeros((n_layers, batch, h, cfg.ssm_headdim, n), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((n_layers, batch, cfg.ssm_conv - 1, di + 2 * n), dtype=dtype,
                            device=device),
    }


def _conv_step(cache: torch.Tensor, new: torch.Tensor, w: torch.Tensor):
    """cache (B, k-1, C), new (B, C), w (k, C) -> out (B, C), cache'."""
    full = torch.cat([cache, new[:, None, :]], dim=1)  # (B, k, C)
    return (full * w[None]).sum(dim=1), full[:, 1:]


def mamba2_decode(p: dict, x: torch.Tensor, layer_state: dict, cfg):
    """One-token step. x (B, 1, D); layer_state {ssm (B, h, p, n), conv
    (B, k-1, C)} -> (out (B, 1, D), new layer_state)."""
    di, h, n = dims(cfg)
    pdim = cfg.ssm_headdim
    xt = x[:, 0]  # (B, D)
    z = einsum("bd,de->be", xt, p["wz"])
    pre = torch.cat([einsum("bd,de->be", xt, p["wx"]), einsum("bd,dn->bn", xt, p["wB"]),
                     einsum("bd,dn->bn", xt, p["wC"])], dim=-1)
    w_all = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=-1)
    conv_out, conv_cache = _conv_step(layer_state["conv"], pre.to(layer_state["conv"].dtype), w_all)
    xin, Bm, Cm = torch.split(conv_out, [di, n, n], dim=-1)
    xin = _silu32(xin, x.dtype)
    Bm, Cm = F.silu(Bm.float()), F.silu(Cm.float())
    dt = einsum("bd,dh->bh", xt, p["wdt"])
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    decay = torch.exp(dt * A)  # (B, h)
    xh = xin.reshape(-1, h, pdim).float()
    contrib = torch.einsum("bh,bhp,bn->bhpn", dt, xh, Bm)
    ssm = layer_state["ssm"] * decay[:, :, None, None] + contrib
    y = torch.einsum("bhpn,bn->bhp", ssm, Cm)
    y = y + xh * p["D"].float()[None, :, None]
    y = y.reshape(-1, di).to(x.dtype)
    y = rms_norm(y * _silu32(z, x.dtype), p["gate_norm"], cfg.norm_eps)
    out = einsum("be,ed->bd", y, p["wo"])[:, None, :]
    return out, {"ssm": ssm, "conv": conv_cache}
