"""Eq. 6 layer-contribution scores (port of ``repro/core/compression.py``:
``n_score_buckets``, ``leaf_layer_ids``, ``contribution_scores``,
``topn_mask``, ``compression_ratio``).

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
"""
from __future__ import annotations

import torch

from repro_torch.models.params import ParamInfo


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
