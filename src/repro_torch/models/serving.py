"""LM serving: prefill (build the caches) and decode_step (one token) (port
of ``repro/models/serving.py``).

Cache layout per family, layer-stacked as in the reference:

- dense / moe / vlm / audio: {"k", "v"}: (L, B, S, kv, hd) in the config's
  dtype (a ring of W slots if windowed);
- gemma3's pattern: {"g_local": {k, v} (ng, p-1, B, W, ...), "g_global":
  {k, v} (ng, B, S, ...), "tail": {k, v} (nt, B, W, ...)};
- ssm: {"ssm": (L, B, h, p, n) float32, "conv": (L, B, k-1, C)};
- hybrid: {"ssm", "conv": (ng, period, ...), "shared": {k, v} (ng, B, S,
  ...)}, one KV cache per application of the shared block.

A ring of W slots holds in slot i the position p with p % W == i
(``attention.attention_block``'s ring order). :func:`prefill` writes every
layer's cache into one preallocated tree and :func:`decode_step` writes the
new position into ``cache`` in place and returns the same dicts; the
reference's scans over layers and groups are Python loops. As in the
reference, :func:`cache_spec` and the stacked dense prefill keep the KV
caches in the config's dtype, the other families' prefill in the compute
dtype.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models.layers import rms_norm
from repro_torch.models.shard_ctx import constrain
from repro_torch.models.transformer import (_dtype, embed_inputs, ffn_block, gemma_pattern, index,
                                            is_stacked_dense, layer_window, logits_fn)

PyTree = Any


def _kv(shape, dtype, device) -> dict:
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _caches(cfg: ArchConfig, batch: int, max_len: int, ring: int, device,
            dt: torch.dtype) -> PyTree:
    """Zero caches in ``dt`` (SSM states float32): global ones of ``max_len``
    slots, windowed rings of ``ring``."""
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    if is_stacked_dense(cfg):
        return _kv((cfg.n_layers, batch, ring if cfg.window else max_len, kv, hd), dt, device)
    if cfg.local_global_period:
        ng, nt = gemma_pattern(cfg)
        out = {"g_local": _kv((ng, cfg.local_global_period - 1, batch, ring, kv, hd), dt, device),
               "g_global": _kv((ng, batch, max_len, kv, hd), dt, device)}
        if nt:
            out["tail"] = _kv((nt, batch, ring, kv, hd), dt, device)
        return out
    if cfg.family == "ssm":
        return m2.init_state(cfg, cfg.n_layers, batch, dtype=dt, device=device)
    if cfg.family == "hybrid":
        ng, per = cfg.n_layers // cfg.shared_attn_period, cfg.shared_attn_period
        st = m2.init_state(cfg, ng * per, batch, dtype=dt, device=device)
        return {"ssm": st["ssm"].unflatten(0, (ng, per)), "conv": st["conv"].unflatten(0, (ng, per)),
                "shared": _kv((ng, batch, max_len, kv, hd), dt, device)}
    raise ValueError(cfg.family)


def cache_spec(cfg: ArchConfig, batch: int, max_len: int, device=None,
               abstract: bool = False) -> PyTree:
    """The zero-initialized cache for ``batch`` sequences of ``max_len``;
    with ``abstract`` its shapes and dtypes on the ``meta`` device, no
    memory (the reference's ``ShapeDtypeStruct`` form, for the dry-run)."""
    if abstract:
        device = "meta"
    return _caches(cfg, batch, max_len, min(cfg.window, max_len), device, _dtype(cfg))


def _dense_decode_block(cfg, p, h, layer_cache, pos: int, window: int):
    a, _ = attn.decode_attention(p["attn"], rms_norm(h, p["norm1"], cfg.norm_eps), layer_cache,
                                 cfg, pos, window=window)
    return ffn_block(cfg, p, h + a)[0]


def _ssm_decode_block(cfg, p, h, ssm, conv):
    """One Mamba2 step; the layer's state rows ``ssm`` and ``conv`` are
    updated in place."""
    y, new = m2.mamba2_decode(p["ssm"], rms_norm(h, p["norm1"], cfg.norm_eps),
                              {"ssm": ssm, "conv": conv}, cfg)
    ssm.copy_(new["ssm"])
    conv.copy_(new["conv"])
    return h + y


def _at(kv: dict, *idx) -> dict:
    return {"k": kv["k"][idx], "v": kv["v"][idx]}


def decode_step(cfg: ArchConfig, params: PyTree, cache: PyTree, tokens: torch.Tensor, pos: int):
    """One-token decode. tokens (B, 1) int, pos the cache length so far.
    Returns (logits (B, 1, V), cache), the cache updated in place."""
    x = params["embed"][tokens].to(_dtype(cfg))
    if is_stacked_dense(cfg):
        for i in range(cfg.n_layers):
            x = _dense_decode_block(cfg, index(params["layers"], i), x, _at(cache, i), pos,
                                    cfg.window)
    elif cfg.local_global_period:
        ng, nt = gemma_pattern(cfg)
        for g in range(ng):
            gp = index(params["groups"], g)
            for i in range(cfg.local_global_period):
                w = layer_window(cfg, i)
                lc = _at(cache["g_local"], g, i) if w else _at(cache["g_global"], g)
                x = _dense_decode_block(cfg, index(gp, i), x, lc, pos, w)
        for i in range(nt):
            x = _dense_decode_block(cfg, index(params["tail"], i), x, _at(cache["tail"], i), pos,
                                    cfg.window)
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x = _ssm_decode_block(cfg, index(params["layers"], i), x, cache["ssm"][i],
                                  cache["conv"][i])
    elif cfg.family == "hybrid":
        for g in range(cfg.n_layers // cfg.shared_attn_period):
            gp = index(params["mamba_groups"], g)
            for i in range(cfg.shared_attn_period):
                x = _ssm_decode_block(cfg, index(gp, i), x, cache["ssm"][g, i], cache["conv"][g, i])
            x = _dense_decode_block(cfg, params["shared"], x, _at(cache["shared"], g), pos, 0)
    else:
        raise ValueError(cfg.family)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_fn(cfg, params, x), cache


def _dense_block_kv(cfg, p, h, window: int, kv: dict):
    """A prefill layer: its output, its (k, v) written into ``kv``'s first
    slots (a ring's ``window`` slots, in ring order)."""
    a, (kc, vc) = attn.attention_block(p["attn"], rms_norm(h, p["norm1"], cfg.norm_eps), cfg,
                                       window=window, return_kv=True)
    kv["k"][:, :kc.shape[1]] = kc.to(kv["k"].dtype)
    kv["v"][:, :vc.shape[1]] = vc.to(kv["v"].dtype)
    return ffn_block(cfg, p, h + a)[0]


def _ssm_block_state(cfg, p, h, ssm, conv):
    y, st = m2.mamba2_block(p["ssm"], rms_norm(h, p["norm1"], cfg.norm_eps), cfg,
                            return_state=True)
    ssm.copy_(st["ssm"])
    conv.copy_(st["conv"])
    return h + y


def prefill_hidden(cfg: ArchConfig, params: PyTree, batch: dict, max_len: int = 0):
    """The prefill's trunk: (hidden after the final norm (B, S, D) at every
    position, cache). ``max_len > S`` sizes the global KV caches for later
    decode steps; windowed rings hold ``cfg.window`` slots and SSM states are
    fixed-size. The serving families' full forward: with ``max_len`` 0 its
    logits at every position are what teacher forcing holds decode to."""
    x = constrain(embed_inputs(cfg, params, batch))
    B, S_in = x.shape[:2]
    # the stacked dense caches take the config's dtype, the others the
    # compute dtype, as the reference's prefill returns them
    dt = _dtype(cfg) if is_stacked_dense(cfg) else x.dtype
    cache = _caches(cfg, B, max(max_len, S_in), cfg.window, x.device, dt)
    if is_stacked_dense(cfg):
        for i in range(cfg.n_layers):
            x = constrain(_dense_block_kv(cfg, index(params["layers"], i), x, cfg.window,
                                          _at(cache, i)))
    elif cfg.local_global_period:
        ng, nt = gemma_pattern(cfg)
        for g in range(ng):
            gp = index(params["groups"], g)
            for i in range(cfg.local_global_period):
                w = layer_window(cfg, i)
                lc = _at(cache["g_local"], g, i) if w else _at(cache["g_global"], g)
                x = _dense_block_kv(cfg, index(gp, i), x, w, lc)
        for i in range(nt):
            x = _dense_block_kv(cfg, index(params["tail"], i), x, cfg.window, _at(cache["tail"], i))
    elif cfg.family == "ssm":
        for i in range(cfg.n_layers):
            x = constrain(_ssm_block_state(cfg, index(params["layers"], i), x, cache["ssm"][i],
                                           cache["conv"][i]))
    elif cfg.family == "hybrid":
        for g in range(cfg.n_layers // cfg.shared_attn_period):
            gp = index(params["mamba_groups"], g)
            for i in range(cfg.shared_attn_period):
                x = _ssm_block_state(cfg, index(gp, i), x, cache["ssm"][g, i], cache["conv"][g, i])
            x = _dense_block_kv(cfg, params["shared"], x, 0, _at(cache["shared"], g))
    else:
        raise ValueError(cfg.family)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), cache


def prefill(cfg: ArchConfig, params: PyTree, batch: dict, max_len: int = 0):
    """Returns (last-token logits (B, 1, V), cache); see :func:`prefill_hidden`."""
    hidden, cache = prefill_hidden(cfg, params, batch, max_len)
    return logits_fn(cfg, params, hidden[:, -1:]), cache
