"""LM orchestration for serving: templates, embedding, the trunk and the
logits (port of the serving subset of ``repro/models/transformer.py``).

Families ported: ``dense`` without a local:global pattern (pre-norm GQA +
SwiGLU, qwen3) and ``ssm`` (attention-free Mamba2 SSD blocks, mamba2). The
layer stacks stay stacked ((n_layers, ...) leaves, the reference's layout),
and the reference's ``lax.scan`` over layers is a Python loop over
:func:`layer`. MoE, gemma3's local/global groups, the zamba2 hybrid, vlm and
audio raise ``NotImplementedError`` (slice 7c); ``chunked_ce`` and
``loss_fn`` come with LM training (slice 7b). The reference's
``models/shard_ctx.py::constrain`` is a sharding hint, the identity on one
card, and is not ported.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models.layers import einsum, rms_norm, swiglu
from repro_torch.models.params import ParamInfo, map_tree

PyTree = Any

VOCAB_PAD = 16  # pad vocab to the model-axis width; padded logits masked
LATER = "slice 7c"


def check_family(cfg: ArchConfig) -> None:
    """Raise for the LM configurations the port does not serve yet."""
    if cfg.family not in ("dense", "ssm") or cfg.local_global_period or cfg.modality != "text":
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (modality {cfg.modality!r}, local_global_period "
            f"{cfg.local_global_period}) is ported in {LATER}; the port serves dense and ssm text "
            f"models")


def _mlp_template(cfg, pa, ns):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamInfo(ns + (d, f), pa + ("embed", "ffn")),
        "w_up": ParamInfo(ns + (d, f), pa + ("embed", "ffn")),
        "w_down": ParamInfo(ns + (f, d), pa + ("ffn", "embed")),
    }


def _dense_layer_template(cfg, pa=("layer",), ns=()):
    d = cfg.d_model
    return {
        "norm1": ParamInfo(ns + (d,), pa + ("embed",), init="zeros"),
        "attn": attn.attention_template(cfg, pa, ns),
        "norm2": ParamInfo(ns + (d,), pa + ("embed",), init="zeros"),
        "mlp": _mlp_template(cfg, pa, ns),
    }


def _ssm_layer_template(cfg, pa=("layer",), ns=()):
    return {
        "norm1": ParamInfo(ns + (cfg.d_model,), pa + ("embed",), init="zeros"),
        "ssm": m2.mamba2_template(cfg, pa, ns),
    }


def padded_vocab(cfg: ArchConfig) -> int:
    return -(-cfg.vocab_size // VOCAB_PAD) * VOCAB_PAD


def template(cfg: ArchConfig) -> PyTree:
    check_family(cfg)
    d, v = cfg.d_model, padded_vocab(cfg)
    t: dict = {
        "embed": ParamInfo((v, d), ("vocab", "embed"), init="small_normal"),
        "final_norm": ParamInfo((d,), ("embed",), init="zeros"),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = ParamInfo((d, v), ("embed", "vocab"))
    if cfg.family == "dense":
        t["layers"] = _dense_layer_template(cfg, ("layer",), (cfg.n_layers,))
    else:
        t["layers"] = _ssm_layer_template(cfg, ("layer",), (cfg.n_layers,))
    return t


def layer(params: PyTree, i: int) -> PyTree:
    """Layer ``i``'s parameters: views into the stacked leaves."""
    return map_tree(lambda w: w[i], params["layers"])


def _dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def dense_block(cfg, p, x, window: int):
    x = x + attn.attention_block(p["attn"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg,
                                 window=window)
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    return x + swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"])


def ssm_block(cfg, p, x):
    return x + m2.mamba2_block(p["ssm"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg)


def embed_inputs(cfg, params, batch) -> torch.Tensor:
    check_family(cfg)
    return params["embed"][batch["tokens"]]


def trunk(cfg: ArchConfig, params: PyTree, x: torch.Tensor):
    """Hidden states (B, S, D) -> (B, S, D) after all layers and the final
    norm. Returns (hidden, aux_loss); aux is 0 without MoE."""
    check_family(cfg)
    for i in range(cfg.n_layers):
        p = layer(params, i)
        x = dense_block(cfg, p, x, cfg.window) if cfg.family == "dense" else ssm_block(cfg, p, x)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), torch.zeros((), device=x.device)


def logits_fn(cfg, params, hidden: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = einsum("bsd,vd->bsv", hidden, params["embed"])
    else:
        logits = einsum("bsd,dv->bsv", hidden, params["lm_head"])
    if logits.shape[-1] != cfg.vocab_size:  # mask the padding columns
        pad = torch.zeros(logits.shape[-1], dtype=logits.dtype, device=logits.device)
        pad[cfg.vocab_size:] = -1e30
        logits = logits + pad
    return logits
