"""Robust aggregation: coordinate-wise trimmed mean (Yin et al. 2018; port
of ``repro/core/aggregators/robust.py``).

Sorts each packed coordinate over the clients and averages after dropping
the k = floor(trim_ratio * C) largest and smallest values, tolerant to up to
k outlier clients per coordinate. Scheduler weights are ignored on purpose:
weighting would reopen the attack surface the trim closes.

Under partial participation the trim happens within the selected subset:
with C_sel participants, k = floor(trim_ratio * C_sel) extremes per side are
dropped among participant values only, so a stale row of a client that sat
out can neither be trimmed in place of an attacker nor leak into the mean.
The masked path ranks participants per coordinate on the device (no host
sync on C_sel).
"""
from __future__ import annotations

import torch

from repro_torch.core.aggregators.base import Aggregator, register


@register
class TrimmedMean(Aggregator):
    name = "trimmed_mean"
    local_cols = True  # a sort per coordinate

    def __init__(self, ctx):
        super().__init__(ctx)
        C = ctx.fed.n_clients
        self._k = int(ctx.fed.trim_ratio * C)
        if self._k == 0:
            raise ValueError(
                f"trimmed_mean: floor(trim_ratio * n_clients) = floor({ctx.fed.trim_ratio} * {C}) "
                f"= 0 — this would be a plain mean with zero Byzantine tolerance; raise "
                f"trim_ratio (>= {1.0 / C:.3f}) or use aggregation='dense'"
            )
        if 2 * self._k >= C:
            raise ValueError(
                f"trimmed_mean: trim_ratio {ctx.fed.trim_ratio} trims 2*{self._k} >= "
                f"n_clients ({C}); nothing left to average"
            )

    def aggregate(self, packed, weights, agg_state, mask=None):
        C = packed.shape[0]
        x = packed.float()
        if mask is None:
            g = torch.mean(torch.sort(x, dim=0).values[self._k: C - self._k], dim=0)
            return self._broadcast(g, packed), agg_state
        m = mask.float()
        c_sel = torch.sum(m)
        k = torch.floor(self.ctx.fed.trim_ratio * c_sel)
        order = torch.argsort(x, dim=0, stable=True)  # (C, N)
        x_sorted = torch.take_along_dim(x, order, dim=0)
        m_sorted = m[order]
        rank = torch.cumsum(m_sorted, dim=0) - m_sorted  # participant rank, 0-based
        keep = m_sorted * (rank >= k) * (rank < c_sel - k)
        g = torch.sum(x_sorted * keep, dim=0) / torch.clamp_min(torch.sum(keep, dim=0), 1.0)
        return self._broadcast(g, packed), agg_state
