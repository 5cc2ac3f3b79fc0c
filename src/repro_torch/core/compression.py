"""Upload compression: Eq. 6 layer-contribution scores and per-tensor int8
quantization (port of ``repro/core/compression.py``).

Eq. 6 of the paper: v(j) = | sum(M_j^{i,k}) - sum(M_j^{i,k-1}) |, the signed
sums of all parameters in layer j across consecutive rounds. Each client
ranks its own layers by v(j) and uploads only the top-n.

"Layer" granularity: every scan-stacked slice of the model is a layer;
all unstacked tensors share one extra bucket at index ``n_layers``. Every
fedyolov3 leaf has axes ``(None, None, None, None)``, so all of its
parameters fall in that one "misc" bucket: with ``topn >= 1`` the ``>= kth``
tie rule then uploads every bucket, and Eq. 6 on fedyolov3 is a masked
weighted mean. The port keeps that reference behaviour. An LM's layer
stacks (axes ``("layer", ...)``) give one bucket per layer, its embedding
and final norm the misc bucket.

:func:`layer_sums` and :func:`apply_layer_mask` map a param tree to the
``(n_layers+1,)`` bucket vector and back, leaf by leaf: the per-leaf
reference that ``core.fedavg`` runs and the packed engine's slot-wise
``packing.bucket_sums`` and ``expand_bucket_vec`` replace. Their leaves may
carry leading dims (a client-stacked tree): the sums then have them too,
and a mask with them scales each client by its own row (the reference
vmaps over the clients). :func:`quantize` and :func:`dequantize` are the
per-tensor symmetric int8 transport of ``core.fedavg.aggregate_quant8``.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.params import ParamInfo, flatten_with_paths, unflatten

PyTree = Any


def n_score_buckets(cfg) -> int:
    return cfg.n_layers + 1


def leaf_layer_ids(path: str, info: ParamInfo, cfg) -> tuple[str, int]:
    """Leaf at ``path`` (the reference's key path joined with ``/``) ->
    (kind, offset), kind in {stack1, stack2, misc}: the one source of the
    param-leaf -> score-bucket map that ``core.packing`` lays out."""
    top = path.split("/")[0]
    if info.axes[:2] == ("group", "layer"):
        return "stack2", 0
    if info.axes[:1] == ("layer",):
        if top == "tail":  # gemma3 tail starts after the grouped layers
            period = cfg.local_global_period
            return "stack1", (cfg.n_layers // period) * period
        return "stack1", 0
    return "misc", cfg.n_layers


def _leaves(cfg, template: PyTree, params: PyTree):
    """(kind, offset, leaf shape, leaf) per leaf, in flattening order."""
    for (path, info), (_, x) in zip(flatten_with_paths(template), flatten_with_paths(params)):
        yield (*leaf_layer_ids(path, info, cfg), tuple(info.shape), x)


def bucket_factor(kind: str, off: int, shape: tuple, vec: torch.Tensor) -> torch.Tensor:
    """A bucket vector ``vec`` (lead..., n_buckets) -> its entries for a leaf
    of ``shape`` (lead..., then one entry per layer slice, broadcastable
    against the leaf with its leading dims)."""
    lead = tuple(vec.shape[:-1])
    if kind == "stack2":
        g, p = shape[:2]
        return vec[..., off: off + g * p].reshape(lead + (g, p) + (1,) * (len(shape) - 2))
    if kind == "stack1":
        l = shape[0]
        return vec[..., off: off + l].reshape(lead + (l,) + (1,) * (len(shape) - 1))
    return vec[..., off].reshape(lead + (1,) * len(shape))


def layer_sums(cfg, template: PyTree, params: PyTree) -> torch.Tensor:
    """Signed per-layer parameter sums -> (lead..., n_layers+1) f32 (the
    Eq. 6 inner sums): a ``stack2`` leaf sums over its dims 2+, a
    ``stack1`` leaf over dims 1+, a misc leaf whole into bucket
    ``n_layers``."""
    out = None
    for kind, off, shape, x in _leaves(cfg, template, params):
        lead = tuple(x.shape[: x.dim() - len(shape)])
        if out is None:
            out = torch.zeros(lead + (n_score_buckets(cfg),), dtype=torch.float32, device=x.device)
        xf = x.float()
        if kind == "stack2":
            n = shape[0] * shape[1]
            out[..., off: off + n] += xf.reshape(lead + (n, -1)).sum(-1)
        elif kind == "stack1":
            out[..., off: off + shape[0]] += xf.reshape(lead + (shape[0], -1)).sum(-1)
        else:
            out[..., off] += xf.reshape(lead + (-1,)).sum(-1)
    return out


def apply_layer_mask(cfg, template: PyTree, params: PyTree, mask: torch.Tensor) -> PyTree:
    """Multiply each layer slice of ``params`` by its entry of ``mask``
    (n_layers+1,), cast to the leaf's dtype; a client-stacked tree takes a
    (C, n_layers+1) mask, one row a client."""
    out = {path: x * bucket_factor(kind, off, shape, mask).to(x.dtype)
           for (path, _), (kind, off, shape, x)
           in zip(flatten_with_paths(params), _leaves(cfg, template, params))}
    return unflatten(params, out)


def contribution_scores(prev_sums: torch.Tensor, new_sums: torch.Tensor) -> torch.Tensor:
    """Eq. 6: v(j) = |sum_k - sum_{k-1}|."""
    return torch.abs(new_sums - prev_sums)


def topn_mask(scores: torch.Tensor, n: int) -> torch.Tensor:
    """Mask of the n largest scores along the last dim: ``scores >= kth``,
    so ties at the n-th value upload more than n buckets (the reference's
    rule)."""
    n = min(n, scores.shape[-1])
    kth = torch.topk(scores, n, dim=-1).values[..., -1:]
    return scores >= kth


def compression_ratio(cfg, n: int) -> float:
    """Fraction of layer buckets uploaded under top-n selection."""
    return n / n_score_buckets(cfg)


# ---------------------------------------------------------------------------
# int8 symmetric quantization (the upload transport of core.fedavg's quant8)
# ---------------------------------------------------------------------------

def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 -> (q int8, scale f32 0-d): ``scale =
    max(amax, 1e-12) / 127``, ``q = clip(round(x / scale), -127, 127)``,
    rounding half to even as ``jnp.round`` does. Both divisions are IEEE
    divisions by a tensor, never a multiply by a reciprocal, so ``q`` is
    the reference's bit for bit."""
    xf = x.float()
    amax = torch.max(torch.abs(xf))
    scale = torch.clamp_min(amax, 1e-12) / torch.tensor(127.0, device=x.device)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)
