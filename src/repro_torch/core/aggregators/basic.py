"""Baseline aggregators (port of ``repro/core/aggregators/basic.py``):
Eq. 5 dense FedAvg, static layer schedules and the FedSGD topology."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.aggregators.base import Aggregator, register


def static_layer_schedule(n_buckets: int, topn: int, round_idx: int) -> tuple[int, ...]:
    """Round-robin layer subset for round ``round_idx``."""
    off = (round_idx * topn) % n_buckets
    return tuple((off + i) % n_buckets for i in range(topn))


@register
class Dense(Aggregator):
    """Paper Eq. 5: weighted mean of every parameter, full upload."""

    name = "dense"
    local_cols = True

    def aggregate(self, packed, weights, agg_state, mask=None):
        g = self._wmean_full(packed, weights, mask)
        return self._broadcast(g, packed), agg_state


@register
class StaticTopN(Aggregator):
    """A fixed round-robin layer subset: only the scheduled buckets
    aggregate; the rest keep each client's local values."""

    name = "static_topn"
    local_cols = True

    def __init__(self, ctx):
        super().__init__(ctx)
        sched = static_layer_schedule(ctx.spec.n_buckets, ctx.fed.topn, ctx.fed.round_idx_static)
        mask = np.zeros(ctx.spec.n_buckets, np.float32)
        mask[list(sched)] = 1.0
        self._bucket_mask = torch.from_numpy(mask)

    def aggregate(self, packed, weights, agg_state, mask=None):
        bucket_mask = self._bucket_mask.to(packed.device)
        wmask = weights.float()[:, None] * bucket_mask[None, :]
        g, den_b = self._mean(packed, wmask, mask)
        return self._dispatch_uploaded(g, den_b, packed), agg_state


@register
class FedSGD(Aggregator):
    """FedSGD-equivalent topology: clients are data-parallel shards of ONE
    shared model copy, so there is no client-stacked buffer to aggregate
    (param-averaging == gradient-averaging for E = 1). ``core.rounds``
    branches on ``stacked``, never on the mode name."""

    name = "fedsgd"
    stacked = False

    def aggregate(self, packed, weights, agg_state, mask=None):
        raise RuntimeError("fedsgd runs one shared model copy; nothing to aggregate")
