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
``lax.scan`` over layers is a Python loop. A gemma3 cut to fewer layers
than its period has no ``groups`` stack, only its tail of windowed layers
(the reference's template would hold zero-size group leaves, which neither
package's init or packing takes). Every family has its template,
its training trunk and loss (:func:`trunk`, :func:`loss_fn`: next-token
CE, hubert's masked-frame CE, llava's CE over the text after its image
tokens, plus ``router_aux_weight`` times MoE's load-balance loss summed
over the layers) and its serving path (``models/serving.py``). The
reference's ``models/shard_ctx.py::constrain`` is a sharding hint, the
identity on one card, and is not ported.

Under grad, as the reference's ``jax.checkpoint`` does on every scanned
unit and on the CE body, each unit and each CE chunk runs under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: a layer
of a stack, a whole period group of gemma3, a whole Mamba2 group of zamba2
with the shared block after it. The backward recomputes the unit's
activations, so a unit keeps only its (B, S, D) input. The recompute runs
the unit's forward again, K9 and K10 included: a local step launches each
kernel twice per layer (or per application of zamba2's shared block).
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
from repro_torch.models.shard_ctx import constrain

PyTree = Any

VOCAB_PAD = 16  # pad vocab to the model-axis width; padded logits masked


def is_stacked_dense(cfg) -> bool:
    """One (n_layers, ...) stack of attention layers (no period groups)."""
    return cfg.family in ("dense", "vlm", "audio", "moe") and not cfg.local_global_period


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
        if ng:  # fewer layers than a period: the tail alone (see the docstring)
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


def ffn_block(cfg, p, x):
    """A block's second half, ``x + FFN(norm2(x))`` -> (x, aux): GShard's
    top-k experts with their load-balance loss under MoE, else SwiGLU and
    an aux of 0.0 (a Python float: serving discards it)."""
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if cfg.family == "moe":
        y, aux = moe_mod.moe_block(p["moe"], h, cfg)
        return x + y, aux
    return x + swiglu(h, p["mlp"]["w_gate"], p["mlp"]["w_up"], p["mlp"]["w_down"]), 0.0


def dense_block(cfg, p, x, window: int):
    """Pre-norm attention, then :func:`ffn_block` -> (x, aux)."""
    x = x + attn.attention_block(p["attn"], rms_norm(x, p["norm1"], cfg.norm_eps), cfg,
                                 window=window)
    return ffn_block(cfg, p, x)


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


def unstack(tree: PyTree, levels: int = 1) -> list:
    """The entries of a stacked subtree, views into its leaves through
    ``unbind``: a list of trees, or for ``levels=2`` (gemma3's and zamba2's
    (n_groups, period, ...) leaves) a list of lists. Its backward stacks the
    entries' gradients once, where indexing each entry (:func:`index`) would
    zero-fill a full-size stacked gradient per entry and leaf."""
    leaves = list(flatten_with_paths(tree))
    split = [w.unbind(0) for _, w in leaves]
    out = [unflatten(tree, {path: split[j][i] for j, (path, _) in enumerate(leaves)})
           for i in range(len(split[0]))]
    return out if levels == 1 else [unstack(t, levels - 1) for t in out]


def remat(fn, *args):
    """``fn(*args)``, under grad as a non-reentrant checkpoint: the backward
    recomputes ``fn``'s activations (the reference's ``jax.checkpoint``)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def trunk(cfg: ArchConfig, params: PyTree, x: torch.Tensor, fetch=None):
    """Hidden states (B, S, D) -> (B, S, D) after all layers and the final
    norm. Returns (hidden, aux): MoE's load-balance loss summed over the
    layers in their order (0 for the other families). Each unit is
    checkpointed under grad (:func:`remat`); the stacks are unbound outside
    the checkpoints (:func:`unstack`).

    ``fetch`` (a ``core.layer_gather.Gather``): ``params`` holds only the
    leaves outside the stacks, and each layer comes from ``fetch`` as a
    thunk that gathers it, called inside the layer's checkpoint, so the
    checkpoint keeps no gathered layer and the recompute gathers again.
    Within a gemma3 or zamba2 group each layer is then a checkpoint of its
    own too, so that the group's recompute holds one gathered layer at a
    time; such a layer runs its forward (and K9 or K10) up to three times
    a step."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = constrain(x)
    if fetch is None:  # views of the materialized stacks
        has, take, inner = params.__contains__, (lambda q: q), (lambda fn, *args: fn(*args))

        def stack(key, levels=1):
            return unstack(params[key], levels)
    else:  # one gathered layer at a time
        stack, has, take, inner = fetch.entries, fetch.__contains__, (lambda q: q()), remat

    def layer(h, a, q, window):
        h, b = dense_block(cfg, take(q), h, window)
        return h, a + b

    def gemma_group(h, a, layers):
        for i, q in enumerate(layers):
            h, a = inner(layer, h, a, q, layer_window(cfg, i))
        return h, a

    def hybrid_group(h, layers, shared):
        for q in layers:
            h = inner(lambda h_, q_: ssm_block(cfg, take(q_), h_), h, q)
        return dense_block(cfg, shared, h, 0)[0]

    if is_stacked_dense(cfg):
        for p in stack("layers"):
            x, aux = remat(layer, x, aux, p, cfg.window)
            x = constrain(x)
    elif cfg.local_global_period:  # gemma3: period groups, then the tail
        for g in stack("groups", 2) if has("groups") else ():
            x, aux = remat(gemma_group, x, aux, g)
            x = constrain(x)
        for p in stack("tail") if has("tail") else ():
            x, aux = remat(layer, x, aux, p, cfg.window)
            x = constrain(x)
    elif cfg.family == "ssm":
        for p in stack("layers"):
            x = constrain(remat(lambda h, q: ssm_block(cfg, take(q), h), x, p))
    elif cfg.family == "hybrid":  # each Mamba2 group, then the one shared block
        for g in stack("mamba_groups", 2):
            x = constrain(remat(hybrid_group, x, g, params["shared"]))
    else:
        raise ValueError(f"unsupported family {cfg.family}")
    return rms_norm(x, params["final_norm"], cfg.norm_eps), aux


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


def loss_fn(cfg: ArchConfig, params: PyTree, batch: dict, fetch=None) -> tuple[torch.Tensor, dict]:
    """The training objective per modality -> (loss, {"ce", "aux"}), loss =
    ce + ``router_aux_weight`` * aux. Text: next-token CE over ``tokens``
    (B, S); audio (hubert's masked cluster prediction): CE over ``labels``
    (B, S) at the frames where ``mask`` (B, S) is set, from ``frames`` (B,
    S, D); vlm: next-token CE over the text positions, after the
    ``images`` (B, n_img, D). ``fetch``: the layers come from a gather
    (:func:`trunk`)."""
    x = embed_inputs(cfg, params, batch)
    hidden, aux = trunk(cfg, params, x, fetch)
    if cfg.modality == "audio":
        ce = chunked_ce(cfg, params, hidden, batch["labels"], batch["mask"])
    elif cfg.modality == "vlm":
        n_img = batch["images"].shape[1]
        ce = _next_token_ce(cfg, params, hidden[:, n_img:], batch["tokens"])
    else:
        ce = _next_token_ce(cfg, params, hidden, batch["tokens"])
    return ce + cfg.router_aux_weight * aux, {"ce": ce, "aux": aux}
