"""GQA attention: full, structurally windowed, and decode paths (port of
``repro/models/attention.py``).

RoPE, qk-norm, grouped KV heads, causal or bidirectional masking and
per-layer sliding windows, in the reference's (B, S, H, hd) layout. Under
``attention_impl="kernel"`` a causal prefill whose length is a multiple of
128 runs flash attention (K9: ``kernels.ops.flash_attention``, or under
grad ``flash_attention_trainable``, its plain version's backward); every other
shape takes the plain paths below, as in the reference. Mixed dtypes (a
bfloat16 cache against float32 weights) promote as ``jnp.einsum`` does
(``layers.einsum``). :func:`decode_attention` writes the new position into
the layer's cache in place and returns it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models.layers import apply_rope, einsum, rms_norm, rope_freqs
from repro_torch.models.params import ParamInfo

NEG_INF = -1e30
Q_CHUNK_THRESHOLD = 8192  # above this, chunk queries to avoid S^2 scores
Q_CHUNK = 1024


def eff_heads(cfg) -> int:
    """q heads incl. per-group sharding padding (llava: 8 groups of 7 -> 8)."""
    if cfg.q_group_pad:
        return cfg.n_kv_heads * cfg.q_group_pad
    return cfg.n_heads


def head_mask(cfg, device=None) -> torch.Tensor | None:
    """(H_eff,) 0/1 mask killing padded dead heads; None when unpadded."""
    if not cfg.q_group_pad:
        return None
    real = cfg.n_heads // cfg.n_kv_heads
    idx = torch.arange(eff_heads(cfg), device=device)
    return (idx % cfg.q_group_pad < real).float()


def attention_template(cfg, prefix_axes: tuple[str, ...] = ("layer",),
                       n_stack: tuple[int, ...] = ()) -> dict:
    """ParamInfo tree for one (optionally layer-stacked) attention block."""
    d, h, kv, hd = cfg.d_model, eff_heads(cfg), cfg.n_kv_heads, cfg.resolved_head_dim
    pa, ns = prefix_axes, n_stack
    t = {
        "wq": ParamInfo(ns + (d, h, hd), pa + ("embed", "heads", "head_dim")),
        "wk": ParamInfo(ns + (d, kv, hd), pa + ("embed", "kv_heads", "head_dim")),
        "wv": ParamInfo(ns + (d, kv, hd), pa + ("embed", "kv_heads", "head_dim")),
        "wo": ParamInfo(ns + (h, hd, d), pa + ("heads", "head_dim", "embed"), scale=1.0),
    }
    if cfg.qk_norm:
        t["q_norm"] = ParamInfo(ns + (hd,), pa + ("head_dim",), init="zeros")
        t["k_norm"] = ParamInfo(ns + (hd,), pa + ("head_dim",), init="zeros")
    return t


def _project_qkv(p: dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    """x (B, S, D) -> q (B, S, H, hd), k/v (B, S, Hkv, hd), qk-norm + RoPE."""
    q = einsum("bsd,dhk->bshk", x, p["wq"])
    k = einsum("bsd,dhk->bshk", x, p["wk"])
    v = einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    cos, sin = rope_freqs(positions, cfg.resolved_head_dim, cfg.rope_theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def _sdpa(q, k, v, mask):
    """q (B, Sq, H, hd), k/v (B, Sk, Hkv, hd), mask broadcastable to
    (B, 1, 1, Sq, Sk)."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, hd)
    scores = einsum("bskgh,btkh->bkgst", qg, k).float()
    scores = scores / torch.full((), float(hd), device=q.device).sqrt()
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = einsum("bkgst,btkh->bskgh", probs, v)
    return out.reshape(B, Sq, H, hd)


def full_attention(q, k, v, *, causal: bool) -> torch.Tensor:
    Sq, Sk = q.shape[1], k.shape[1]
    if Sq >= Q_CHUNK_THRESHOLD and Sq % Q_CHUNK == 0:
        return _q_chunked_attention(q, k, v, causal=causal)
    if causal:
        mask = (torch.arange(Sq, device=q.device)[:, None]
                >= torch.arange(Sk, device=q.device)[None, :])[None, None, None]
    else:
        mask = torch.ones((1, 1, 1, Sq, Sk), dtype=torch.bool, device=q.device)
    return _sdpa(q, k, v, mask)


def _q_chunked_attention(q, k, v, *, causal: bool, q_chunk: int = Q_CHUNK) -> torch.Tensor:
    """Softmax per query chunk against the full K/V, so the peak score
    buffer is (B, H, Q_CHUNK, S) instead of (B, H, S, S)."""
    S = q.shape[1]
    qc = min(q_chunk, S)
    kp = torch.arange(S, device=q.device)
    outs = []
    for i in range(S // qc):
        qpos = i * qc + torch.arange(qc, device=q.device)
        if causal:
            mask = (qpos[:, None] >= kp[None, :])[None, None, None]
        else:
            mask = torch.ones((1, 1, 1, qc, S), dtype=torch.bool, device=q.device)
        outs.append(_sdpa(q[:, i * qc:(i + 1) * qc], k, v, mask))
    return torch.cat(outs, dim=1)


def windowed_attention(q, k, v, *, window: int) -> torch.Tensor:
    """Structural causal sliding-window attention (two-chunk local):
    S % window == 0; each query chunk attends its own and the previous key
    chunk, exact window-W causal attention at O(S W) cost."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    W = window
    if S % W:
        raise ValueError(f"seq {S} not a multiple of window {W}")
    nc, G = S // W, H // Hkv
    qc = q.reshape(B, nc, W, Hkv, G, hd)
    kc = k.reshape(B, nc, W, Hkv, hd)
    vc = v.reshape(B, nc, W, Hkv, hd)
    kprev = torch.cat([torch.zeros_like(kc[:, :1]), kc[:, :-1]], dim=1)
    vprev = torch.cat([torch.zeros_like(vc[:, :1]), vc[:, :-1]], dim=1)
    kcat = torch.cat([kprev, kc], dim=2)  # (B, nc, 2W, Hkv, hd)
    vcat = torch.cat([vprev, vc], dim=2)
    scores = einsum("bnskgh,bntkh->bnkgst", qc, kcat).float()
    scores = scores / torch.full((), float(hd), device=q.device).sqrt()
    s_idx = torch.arange(W, device=q.device)[:, None]  # query offset in chunk
    t_idx = torch.arange(2 * W, device=q.device)[None, :]  # key offset in [prev, cur]
    rel = s_idx + W - t_idx  # qpos - kpos
    valid = (rel >= 0) & (rel < W)
    # the first chunk has no previous keys: only the [W, 2W) half is real
    first = torch.arange(nc, device=q.device)[:, None, None] > 0
    mask = valid[None] & (first | (t_idx >= W)[None])
    scores = scores.masked_fill(~mask[None, :, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = einsum("bnkgst,bntkh->bnskgh", probs, vcat)
    return out.reshape(B, S, H, hd)


def attention_block(p: dict, x: torch.Tensor, cfg, *, window: int = 0, positions=None,
                    return_kv: bool = False):
    """Full train/prefill attention block (no cache); window=0 -> full.

    With return_kv=True also returns cache-ready (k, v): full-length for
    global layers; for windowed layers the trailing ``window`` positions in
    ring order, slot i holding the position p with p % window == i, as
    :func:`decode_attention` reads them. (The reference stores them in
    position order, which is ring order only when S % window == 0; past
    that its decode evicts a key inside the window and keeps a stale one.
    The port rolls them into place: the same cache wherever the reference's
    is right.)
    """
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    if cfg.attention_impl == "kernel" and cfg.causal and S % 128 == 0:
        # training takes the autograd Function (K9 forward, plain backward)
        fa = kops.flash_attention_trainable if torch.is_grad_enabled() else kops.flash_attention
        out = fa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                 causal=True, window=window).transpose(1, 2)
    elif window and cfg.causal and S % window == 0 and S > window:
        out = windowed_attention(q, k, v, window=window)
    elif window and cfg.causal:
        # fallback: masked full attention with window (small shapes)
        qp = torch.arange(S, device=x.device)[:, None]
        kp = torch.arange(S, device=x.device)[None, :]
        out = _sdpa(q, k, v, ((qp >= kp) & (qp - kp < window))[None, None, None])
    else:
        out = full_attention(q, k, v, causal=cfg.causal)
    hm = head_mask(cfg, x.device)
    if hm is not None:
        out = out * hm[None, None, :, None].to(out.dtype)
    out = einsum("bshk,hkd->bsd", out, p["wo"])
    if return_kv:
        if window and S >= window:
            # position S - window + j goes to slot (S + j) % window
            kc, vc = (torch.roll(a[:, -window:], S % window, dims=1) for a in (k, v))
        elif window:
            pad = (0, 0, 0, 0, 0, window - S)
            kc, vc = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
        else:
            kc, vc = k, v
        return out, (kc, vc)
    return out


# ---------------------------------------------------------------------------
# KV-cache decode path
# ---------------------------------------------------------------------------

def init_cache(cfg, n_layers: int, batch: int, max_len: int, window: int = 0,
               dtype=torch.bfloat16, device=None) -> dict:
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    S = min(window, max_len) if window else max_len
    shape = (n_layers, batch, S, kv, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(p: dict, x: torch.Tensor, layer_cache: dict, cfg, pos: int, *,
                     window: int = 0):
    """One-token attention against a cache slice.

    x (B, 1, D); layer_cache {"k", "v"}: (B, S_cache, Hkv, hd); pos: the
    current position. Returns (out (B, 1, D), layer_cache), the cache
    updated in place. Windowed layers use a ring buffer of size ``window``.
    """
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    ck, cv = layer_cache["k"], layer_cache["v"]
    S_cache = ck.shape[1]
    slot = pos % S_cache if window else pos
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    idx = torch.arange(S_cache, device=x.device)
    # ring buffer: slot i holds the largest position p <= pos with p % S_cache == i
    kpos = pos - ((pos - idx) % S_cache) if window else idx
    valid = (kpos <= pos) & (kpos >= 0)
    if window:
        valid &= pos - kpos < window
    out = _sdpa(q, ck, cv, valid[None, None, None, None, :])
    hm = head_mask(cfg, x.device)
    if hm is not None:
        out = out * hm[None, None, :, None].to(out.dtype)
    return einsum("bshk,hkd->bsd", out, p["wo"]), layer_cache
