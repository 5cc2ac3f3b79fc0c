"""LM serving: prefill (build the caches) and decode_step (one token) (port
of the dense and ssm branches of ``repro/models/serving.py``).

Cache layout per family, layer-stacked as in the reference:

- dense: {"k", "v"}: (L, B, S, kv, hd) in the config's dtype (a ring of W
  slots if windowed);
- ssm: {"ssm": (L, B, h, p, n) float32, "conv": (L, B, k-1, C)}.

:func:`decode_step` writes the new position into ``cache`` in place and
returns the same dicts. The other families raise ``NotImplementedError``
(slice 7c).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models.layers import rms_norm, swiglu
from repro_torch.models.transformer import _dtype, check_family, embed_inputs, layer, logits_fn

PyTree = Any


def cache_spec(cfg: ArchConfig, batch: int, max_len: int, device=None) -> PyTree:
    """The zero-initialized cache for ``batch`` sequences of ``max_len``."""
    check_family(cfg)
    dt = _dtype(cfg)
    if cfg.family == "dense":
        S = min(cfg.window, max_len) if cfg.window else max_len
        return attn.init_cache(cfg, cfg.n_layers, batch, S, dtype=dt, device=device)
    return m2.init_state(cfg, cfg.n_layers, batch, dtype=dt, device=device)


def _dense_decode_block(cfg, p, h, layer_cache, pos: int, window: int):
    a, _ = attn.decode_attention(p["attn"], rms_norm(h, p["norm1"], cfg.norm_eps), layer_cache,
                                 cfg, pos, window=window)
    h = h + a
    g = rms_norm(h, p["norm2"], cfg.norm_eps)
    return h + swiglu(g, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"])


def decode_step(cfg: ArchConfig, params: PyTree, cache: PyTree, tokens: torch.Tensor, pos: int):
    """One-token decode. tokens (B, 1) int, pos the cache length so far.
    Returns (logits (B, 1, V), cache), the cache updated in place."""
    check_family(cfg)
    x = params["embed"][tokens].to(_dtype(cfg))
    for i in range(cfg.n_layers):
        p = layer(params, i)
        if cfg.family == "dense":
            x = _dense_decode_block(cfg, p, x, {"k": cache["k"][i], "v": cache["v"][i]}, pos,
                                    cfg.window)
        else:
            y, new = m2.mamba2_decode(p["ssm"], rms_norm(x, p["norm1"], cfg.norm_eps),
                                      {"ssm": cache["ssm"][i], "conv": cache["conv"][i]}, cfg)
            x = x + y
            cache["ssm"][i] = new["ssm"]
            cache["conv"][i] = new["conv"]
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return logits_fn(cfg, params, x), cache


def prefill(cfg: ArchConfig, params: PyTree, batch: dict, max_len: int = 0):
    """Returns (last-token logits (B, 1, V), cache).

    ``max_len > S`` pads the global KV cache so that later decode_step calls
    have slots to write into (windowed and SSM caches are fixed-size).
    """
    x = embed_inputs(cfg, params, batch)
    B, S_in = x.shape[:2]
    if cfg.family == "dense":
        dt = _dtype(cfg)
        W = cfg.window
        cache = cache_spec(cfg, B, W if W else max(max_len, S_in), device=x.device)
        for i in range(cfg.n_layers):
            p = layer(params, i)
            a, (kc, vc) = attn.attention_block(p["attn"], rms_norm(x, p["norm1"], cfg.norm_eps),
                                               cfg, window=W, return_kv=True)
            x = x + a
            g = rms_norm(x, p["norm2"], cfg.norm_eps)
            x = x + swiglu(g, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"])
            cache["k"][i, :, :kc.shape[1]] = kc.to(dt)
            cache["v"][i, :, :vc.shape[1]] = vc.to(dt)
    else:
        ssm, conv = [], []
        for i in range(cfg.n_layers):
            p = layer(params, i)
            y, st = m2.mamba2_block(p["ssm"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg,
                                    return_state=True)
            x = x + y
            ssm.append(st["ssm"])
            conv.append(st["conv"])
        cache = {"ssm": torch.stack(ssm), "conv": torch.stack(conv)}
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return logits_fn(cfg, params, x), cache
