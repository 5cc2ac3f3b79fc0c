"""Legacy tree-path aggregation, paper Eq. 5, over a client-stacked param
tree (port of ``repro/core/fedavg.py``).

The rounds aggregate the packed ``(C, N_total)`` buffer through
``core.aggregators`` (K1, K4, K5a, K6, K7, K8). This module is the per-leaf
reference beside them: the packed engine must match it on the four seed
modes (``tests/test_torch_tree.py``), and it is the plainest statement of
each mode's semantics. Neither package calls it from a round, so it runs
plain PyTorch: its weighted means are ``torch.einsum`` products, which the
reference too computes outside any Pallas kernel.

Every function takes ``stacked``: a tree of tensors, each with a leading
client dim C, and the participation ``weights`` (C,), the scheduler's
output, normalized. Modes:

- :func:`aggregate_dense`: Eq. 5 FedAvg, the weighted mean, full upload;
- :func:`aggregate_eq6`: the paper's top-n layer upload per client by the
  Eq. 6 contribution scores; layers uploaded by nobody keep each client's
  local values;
- :func:`aggregate_quant8`: the int8-quantized delta upload, one scale per
  client-axis shard, the int8 blocks all-gathered over the client axis;
- :func:`aggregate_static_topn`: a round-robin subset of layer buckets,
  only the selected rows of each stack averaged.

The reference's ``aggregate_quant8`` also takes ``specs``, the
``PartitionSpec`` tree its ``shard_map`` reads. The port has no such tree:
a rank's leaves are already its block of clients (``core.packing.
packed_pspec``), so the argument is dropped.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core import collectives
from repro_torch.core import compression as comp
from repro_torch.core.aggregators.basic import static_layer_schedule  # noqa: F401 (re-exported, as the reference does)
from repro_torch.models.params import flatten_with_paths, map_tree, unflatten

PyTree = Any

AGGREGATION_MODES = ("dense", "eq6", "quant8", "static_topn")


def _wmean_leaf(x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The f32 weighted mean of ``x`` over its client dim, broadcast back to
    (C, ...) in ``x``'s dtype (a new tensor)."""
    g = torch.einsum("c,c...->...", weights.float(), x.float())
    return g.to(x.dtype)[None].expand(x.shape).clone()


def _wmean(stacked: PyTree, weights: torch.Tensor) -> PyTree:
    """:func:`_wmean_leaf` of every leaf."""
    return map_tree(lambda x: _wmean_leaf(x, weights), stacked)


def aggregate_dense(stacked: PyTree, weights: torch.Tensor) -> PyTree:
    return _wmean(stacked, weights)


def aggregate_eq6(cfg, template: PyTree, stacked: PyTree, weights: torch.Tensor,
                  prev_sums: torch.Tensor, topn: int) -> tuple[PyTree, torch.Tensor]:
    """-> (new_stacked, new_sums (C, n_layers+1)).

    Each client uploads only its top-n layers by Eq. 6 score; a layer's
    global value is the weighted mean over the clients that uploaded it;
    layers uploaded by nobody keep each client's local values."""
    new_sums = comp.layer_sums(cfg, template, stacked)  # (C, NL+1)
    v = comp.contribution_scores(prev_sums, new_sums)
    wmask = comp.topn_mask(v, topn).float() * weights.float()[:, None]  # (C, NL+1)
    den = torch.sum(wmask, dim=0)  # (NL+1,)
    inv = torch.where(den > 0, 1.0 / torch.clamp_min(den, 1e-12), 0.0)
    masked = comp.apply_layer_mask(cfg, template, stacked, wmask)
    num = map_tree(lambda x: torch.sum(x.float(), dim=0), masked)
    global_f32 = comp.apply_layer_mask(cfg, template, num, inv)
    uploaded = (den > 0).float()
    out = {}
    for (path, info), (_, x), (_, g) in zip(flatten_with_paths(template),
                                            flatten_with_paths(stacked),
                                            flatten_with_paths(global_f32)):
        kind, off = comp.leaf_layer_ids(path, info, cfg)
        # 1 where the leaf's layer slice was uploaded by anyone
        sel = comp.bucket_factor(kind, off, tuple(info.shape), uploaded).bool()
        out[path] = torch.where(sel[None], g.to(x.dtype)[None].expand(x.shape), x)
    return unflatten(stacked, out), new_sums


def aggregate_quant8(stacked: PyTree, base: PyTree, weights: torch.Tensor, mesh=None,
                     client_axis: str = "pod") -> PyTree:
    """global = base + wmean_c(dequant(quant(new_c - base))), int8 transport.

    ``stacked`` and ``base``: this rank's clients (all C without a mesh, C/S
    rows on each of the S ranks of ``client_axis``); ``weights``: all C.
    Each leaf's delta block is quantized with one scale (per shard); the
    int8 blocks and the S scales are all-gathered over the client axis
    (``core.collectives``), every client row is dequantized by its shard's
    scale, and the rank gets its rows of ``base`` plus the weighted mean."""
    C = weights.shape[0]
    n_shards = collectives.size(mesh, client_axis)
    if C % n_shards:
        raise ValueError(
            f"quant8 requires n_clients ({C}) divisible by the "
            f"'{client_axis}' mesh axis ({n_shards} shards): "
            f"repeating the scales C // n_shards times would silently produce a "
            f"wrong-length row-scale vector"
        )
    w = weights.float()

    def per_leaf(n_leaf: torch.Tensor, b_leaf: torch.Tensor) -> torch.Tensor:
        delta = n_leaf.float() - b_leaf.float()
        q, scale = comp.quantize(delta)
        qg = collectives.all_gather(q, mesh, client_axis)  # (C, ...)
        sg = collectives.all_gather(scale.reshape(1), mesh, client_axis)  # (n_shards,)
        row_scale = torch.repeat_interleave(sg, C // n_shards)  # (C,)
        d = qg.float() * row_scale.reshape((C,) + (1,) * (qg.dim() - 1))
        gd = torch.einsum("c,c...->...", w, d)
        return (b_leaf.float() + gd[None]).to(n_leaf.dtype)

    out = {path: per_leaf(n, b) for (path, n), (_, b)
           in zip(flatten_with_paths(stacked), flatten_with_paths(base))}
    return unflatten(stacked, out)


def aggregate_static_topn(cfg, template: PyTree, stacked: PyTree, weights: torch.Tensor,
                          sync_layers: tuple[int, ...]) -> PyTree:
    """Aggregate only a static subset of layer buckets: the selected rows of
    each layer stack are sliced out and averaged, the rest stay local."""
    nl = cfg.n_layers
    mask_vec = np.zeros(comp.n_score_buckets(cfg), bool)
    mask_vec[list(sync_layers)] = True

    def agg(path: str, info, x: torch.Tensor) -> torch.Tensor:
        kind, off = comp.leaf_layer_ids(path, info, cfg)
        if kind == "misc":
            return _wmean_leaf(x, weights) if mask_vec[nl] else x
        stack_dims = 2 if kind == "stack2" else 1  # (C, g, p, ...) or (C, l, ...)
        n = int(np.prod(x.shape[1: 1 + stack_dims]))
        flat = x.reshape((x.shape[0], n) + tuple(x.shape[1 + stack_dims:]))
        sel = torch.from_numpy(np.nonzero(mask_vec[np.arange(n) + off])[0]).to(x.device)
        if sel.numel() == 0:
            return x
        out = flat.clone()
        out[:, sel] = _wmean_leaf(flat[:, sel], weights)
        return out.reshape(x.shape)

    out = {path: agg(path, info, x) for (path, info), (_, x)
           in zip(flatten_with_paths(template), flatten_with_paths(stacked))}
    return unflatten(stacked, out)
