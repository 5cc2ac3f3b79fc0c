"""LM orchestration: templates, embedding, the trunk, the logits and the
training loss (port of ``repro/models/transformer.py``).

Families: ``dense`` / ``vlm`` / ``audio`` (pre-norm GQA + SwiGLU; vlm
prepends projected image embeddings, audio embeds its frames), gemma3's
local:global pattern (period groups of ``local_global_period`` layers, the
last of each global, the rest windowed, plus a tail), ``moe`` (GShard top-k
FFN, ``models/moe.py``), ``ssm`` (Mamba2 SSD blocks) and ``hybrid``
(zamba2: Mamba2 groups with one shared attention + MLP block after each
group). The layer stacks stay stacked ((n_layers, ...) or (n_groups,
period, ...) leaves, the reference's layout), and the reference's
``lax.scan`` over layers is a Python loop. Every family has its template
and its serving path (``models/serving.py``); the training trunk and loss
run the dense and ssm text families, and raise ``NotImplementedError`` for
the others (:func:`check_trainable`, slice 7d). The reference's
``models/shard_ctx.py::constrain`` is a sharding hint, the identity on one
card, and is not ported.

Under grad, as the reference's ``jax.checkpoint`` does on every scanned
block and on the CE body, each layer and each CE chunk runs under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: the
backward recomputes its activations, so a layer keeps only its (B, S, D)
input. The recompute runs the layer's forward again, K9 and K10 included:
a local step launches each kernel twice per layer.
"""
from __future__ import annotations

from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import einsum, gold_logit, rms_norm, softmax_cross_entropy, swiglu
from repro_torch.models.params import ParamInfo, flatten_with_paths, map_tree, unflatten

PyTree = Any

VOCAB_PAD = 16  # pad vocab to the model-axis width; padded logits masked
LATER = "slice 7d"


def is_stacked_dense(cfg) -> bool:
    """One (n_layers, ...) stack of attention layers (no period groups)."""
    return cfg.family in ("dense", "vlm", "audio", "moe") and not cfg.local_global_period


def check_trainable(cfg: ArchConfig) -> None:
    """Raise for the LM configurations the port does not train yet."""
    if cfg.family not in ("dense", "ssm") or cfg.local_global_period or cfg.modality != "text":
        raise NotImplementedError(
            f"{cfg.name}: training family {cfg.family!r} (modality {cfg.modality!r}, "
            f"local_global_period {cfg.local_global_period}) is ported in {LATER}; the port "
            f"trains dense and ssm text models and serves every LM family")


def _mlp_template(cfg, pa, ns):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamInfo(ns + (d, f), pa + ("embed", "ffn")),
        "w_up": ParamInfo(ns + (d, f), pa + ("embed", "ffn")),
        "w_down": ParamInfo(ns + (f, d), pa + ("ffn", "embed")),
    }


def _dense_layer_template(cfg, pa=("layer",), ns=()):
    d = cfg.d_model
    t = {
        "norm1": ParamInfo(ns + (d,), pa + ("embed",), init="zeros"),
        "attn": attn.attention_template(cfg, pa, ns),
        "norm2": ParamInfo(ns + (d,), pa + ("embed",), init="zeros"),
    }
    if cfg.family == "moe":
        t["moe"] = moe_mod.moe_template(cfg, pa, ns)
    else:
        t["mlp"] = _mlp_template(cfg, pa, ns)
    return t


def _ssm_layer_template(cfg, pa=("layer",), ns=()):
    return {
        "norm1": ParamInfo(ns + (cfg.d_model,), pa + ("embed",), init="zeros"),
        "ssm": m2.mamba2_template(cfg, pa, ns),
    }


def gemma_pattern(cfg) -> tuple[int, int]:
    """(n_groups, n_tail) for the local:global period pattern."""
    period = cfg.local_global_period
    return cfg.n_layers // period, cfg.n_layers % period


def layer_window(cfg, group_pos: int) -> int:
    """Window for position-in-period: gemma3 = [W]*(p-1) + [0 (global)]."""
    return cfg.window if group_pos != cfg.local_global_period - 1 else 0


def padded_vocab(cfg: ArchConfig) -> int:
    return -(-cfg.vocab_size // VOCAB_PAD) * VOCAB_PAD


def template(cfg: ArchConfig) -> PyTree:
    d, v = cfg.d_model, padded_vocab(cfg)
    t: dict = {
        "embed": ParamInfo((v, d), ("vocab", "embed"), init="small_normal"),
        "final_norm": ParamInfo((d,), ("embed",), init="zeros"),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = ParamInfo((d, v), ("embed", "vocab"))
    if cfg.modality == "vlm":
        t["img_proj"] = ParamInfo((d, d), ("embed", None))
    if is_stacked_dense(cfg):
        t["layers"] = _dense_layer_template(cfg, ("layer",), (cfg.n_layers,))
    elif cfg.local_global_period:  # gemma3
        ng, nt = gemma_pattern(cfg)
        t["groups"] = _dense_layer_template(cfg, ("group", "layer"),
                                            (ng, cfg.local_global_period))
        if nt:
            t["tail"] = _dense_layer_template(cfg, ("layer",), (nt,))
    elif cfg.family == "ssm":
        t["layers"] = _ssm_layer_template(cfg, ("layer",), (cfg.n_layers,))
    elif cfg.family == "hybrid":
        ng = cfg.n_layers // cfg.shared_attn_period
        t["mamba_groups"] = _ssm_layer_template(cfg, ("group", "layer"),
                                                (ng, cfg.shared_attn_period))
        t["shared"] = {
            "norm1": ParamInfo((d,), ("embed",), init="zeros"),
            "attn": attn.attention_template(cfg, (), ()),
            "norm2": ParamInfo((d,), ("embed",), init="zeros"),
            "mlp": _mlp_template(cfg, (), ()),
        }
    else:
        raise ValueError(f"unsupported family {cfg.family}")
    return t


def index(tree: PyTree, i: int) -> PyTree:
    """Entry ``i`` of a stacked tree: views into its leaves."""
    return map_tree(lambda w: w[i], tree)


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
    """Token embeddings; audio: the frames in the config's dtype; vlm: the
    projected image embeddings (B, n_image_tokens, D) before the text's."""
    if cfg.modality == "audio":
        return batch["frames"].to(_dtype(cfg))
    if cfg.modality == "vlm":
        img = einsum("bnd,de->bne", batch["images"].to(_dtype(cfg)), params["img_proj"])
        return torch.cat([img, params["embed"][batch["tokens"]]], dim=1)
    return params["embed"][batch["tokens"]]


def unstack_layers(params: PyTree) -> list[PyTree]:
    """Every layer's parameters, views into the stacked leaves through
    ``unbind``: its backward stacks the layers' gradients once, where
    indexing each layer (:func:`index`) would zero-fill a full-size stacked
    gradient per layer and leaf."""
    leaves = list(flatten_with_paths(params["layers"]))
    split = [w.unbind(0) for _, w in leaves]
    return [unflatten(params["layers"], {path: split[j][i] for j, (path, _) in enumerate(leaves)})
            for i in range(len(split[0]))]


def remat(fn, *args):
    """``fn(*args)``, under grad as a non-reentrant checkpoint: the backward
    recomputes ``fn``'s activations (the reference's ``jax.checkpoint``)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def trunk(cfg: ArchConfig, params: PyTree, x: torch.Tensor):
    """Hidden states (B, S, D) -> (B, S, D) after all layers and the final
    norm. Returns (hidden, aux_loss); aux is 0 without MoE. The dense and
    ssm text families only (:func:`check_trainable`)."""
    check_trainable(cfg)
    for p in unstack_layers(params):
        if cfg.family == "dense":
            x = remat(lambda h, q: dense_block(cfg, q, h, cfg.window), x, p)
        else:
            x = remat(lambda h, q: ssm_block(cfg, q, h), x, p)
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


CE_CHUNK = 512  # sequence-chunked loss: never materialize (B, S, V) logits


def _ce_chunk(cfg, params, hc, lc, mc):
    """One CE chunk's (sum of masked nll, sum of mask), float32."""
    logits = logits_fn(cfg, params, hc)
    nll = torch.logsumexp(logits.float(), dim=-1) - gold_logit(logits, lc)
    mc = mc.float()
    return torch.sum(nll * mc), torch.sum(mc)


def chunked_ce(cfg, params, hidden: torch.Tensor, labels: torch.Tensor,
               mask: torch.Tensor | None) -> torch.Tensor:
    """CE over sequence chunks of ``CE_CHUNK`` (each recomputed in the
    backward): the peak logits buffer is (B, CE_CHUNK, V) instead of (B, S,
    V). A sequence that is not a multiple of the chunk, or not longer than
    one, takes the whole-sequence loss."""
    B, S, _ = hidden.shape
    if S % CE_CHUNK or S <= CE_CHUNK:
        return softmax_cross_entropy(logits_fn(cfg, params, hidden), labels, mask)
    if mask is None:
        mask = torch.ones((B, S), dtype=torch.float32, device=hidden.device)
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(S // CE_CHUNK):
        sl = slice(i * CE_CHUNK, (i + 1) * CE_CHUNK)
        t, c = remat(lambda h, p, l, m: _ce_chunk(cfg, p, h, l, m),
                     hidden[:, sl], params, labels[:, sl], mask[:, sl])
        tot, cnt = tot + t, cnt + c
    return tot / torch.clamp_min(cnt, 1.0)


def _next_token_ce(cfg, params, hidden: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token CE over the full (chunk-divisible) sequence: labels are the
    tokens shifted left, the last position masked out."""
    S = hidden.shape[1]
    labels = torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)
    mask = (torch.arange(S, device=hidden.device) < S - 1)[None].expand(labels.shape)
    return chunked_ce(cfg, params, hidden, labels, mask)


def loss_fn(cfg: ArchConfig, params: PyTree, batch: dict) -> tuple[torch.Tensor, dict]:
    """The text training objective: next-token CE (+ the router's aux loss,
    0 without MoE). batch {"tokens" (B, S) int} -> (loss, {"ce", "aux"}).
    The dense and ssm text families only (:func:`check_trainable`)."""
    check_trainable(cfg)
    x = embed_inputs(cfg, params, batch)
    hidden, aux = trunk(cfg, params, x)
    ce = _next_token_ce(cfg, params, hidden, batch["tokens"])
    return ce + cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}
