"""Hierarchical two-level aggregation over the packed buffer (port of the
unsharded path of ``repro/core/aggregators/hier.py``).

FedVision's deployment is many cameras behind a few edge servers: clients
split into C/G contiguous edge groups of ``FedConfig.group_size`` G; each
group reduces locally with a per-group renormalized weighted mean
(``packing.grouped_weighted_mean``: one K6 launch under
``agg_impl="kernel"``), then the registered ``FedConfig.hier_base`` reducer
merges the (C/G, N) group rows as it would merge client rows. Group weights
are the sums of their members' (mask-folded) weights, so the two-level
dense mean IS the flat dense mean analytically:

    sum_g (sum_i w_gi) [sum_i w_gi x_gi / sum_i w_gi] / sum_g sum_i w_gi
  = sum_c w_c x_c / sum_c w_c                                     (Eq. 5)

A group none of whose members took part reduces to a zero row with a zero
group weight and is masked out of the outer reduce. Each group's dispatch
row goes to all its members (the edge server redistributes).

At ``G == 1`` and ``G == C`` hier delegates verbatim to the ``hier_base``
aggregator over the full cohort: both are the flat path itself, bit for
bit.

Sharded client axis: with a mesh whose client axis has S > 1 ranks, each
rank reduces its own groups (one K6 launch over its C/S rows): groups must
be shard-local ((C/S) % G == 0, validated at build), so every group mean
completes without communication, and the only collective is the gather of
the small (C/G, N) group-row operand (and its (C/G,) weights) into the
outer reduce, which every rank runs on all C/G rows.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import packing
from repro_torch.core.aggregators.base import (
    AggContext, Aggregator, _client_shards, gather_clients, get, register,
)


@register
class Hier(Aggregator):
    name = "hier"

    def __init__(self, ctx: AggContext):
        super().__init__(ctx)
        fed = ctx.fed
        C = fed.n_clients
        G = fed.group_size or C
        if not 1 <= G <= C or C % G:
            raise ValueError(f"hier: group_size={G} must divide n_clients={C} (and lie in [1, {C}])")
        base = fed.hier_base
        if base == "hier":
            raise ValueError("hier: hier_base='hier' would recurse; name a flat reducer")
        base_cls = get(base)  # build time: unknown names fail here
        if not base_cls.stacked:
            raise ValueError(
                f"hier: hier_base={base!r} runs one shared model copy "
                "(fedsgd topology); compose a client-stacked reducer"
            )
        self.group_size = G
        self.ngroups = C // G
        self._shards = _client_shards(fed, ctx.mesh)
        self._delegate = G in (1, C)
        if self._delegate:
            # the delegate sees the whole cohort (and the mesh): it IS the
            # flat path, and takes its rows as the base takes them
            self._impl = base_cls(dataclasses.replace(
                ctx, fed=dataclasses.replace(fed, aggregation=base, group_size=0)))
            self.local_rows = self._impl.local_rows
            return
        if self._shards > 1 and (C // self._shards) % G:
            raise ValueError(
                f"hier: groups must be shard-local — n_clients={C} over "
                f"{self._shards} '{fed.client_axis}' shards leaves "
                f"{C // self._shards} rows per shard, not divisible by "
                f"group_size={G}"
            )
        self.local_rows = True
        # the outer reduce sees the C/G group rows as its clients, on every
        # rank: the gathered (C/G, N) operand is the one cross-rank merge
        outer_fed = dataclasses.replace(fed, n_clients=self.ngroups, aggregation=base, group_size=0)
        self._impl = base_cls(dataclasses.replace(ctx, fed=outer_fed, mesh=None))

    def init_state(self, packed0):
        if self._delegate:
            return self._impl.init_state(packed0)
        # one representative row per group (every client starts from one
        # dispatch), copied out of the round buffer
        return self._impl.init_state(packed0[:: self.group_size].clone())

    def state_pspecs(self, axis_sizes=None):
        if self._delegate:
            return self._impl.state_pspecs(axis_sizes)
        # outer state is group-granular ((C/G, ...) at most): replicated
        return super().state_pspecs(axis_sizes)

    def aggregate(self, packed, weights, agg_state, mask=None):
        if self._delegate:
            return self._impl.aggregate(packed, weights, agg_state, mask)
        fed = self.ctx.fed
        own = packing.packed_pspec(fed.n_clients, fed.client_axis, self.ctx.mesh)
        w = self._masked_weights(weights, mask)[own]
        rows, den = packing.grouped_weighted_mean(packed, w, self.group_size, impl=fed.agg_impl)
        if self._shards > 1:  # this rank's groups -> all C/G of them
            rows = gather_clients(rows, fed, self.ctx.mesh)
            den = gather_clients(den, fed, self.ctx.mesh)
        gmask = (den > 0).float()  # empty groups drop out
        out_g, agg_state = self._impl.aggregate(rows, den, agg_state, gmask)
        n_own, N = packed.shape[0] // self.group_size, packed.shape[1]
        g0 = own.start // self.group_size
        packed.view(n_own, self.group_size, N).copy_(
            out_g[g0: g0 + n_own].to(packed.dtype)[:, None, :].expand(n_own, self.group_size, N))
        return packed, agg_state
