"""quant8: int8-quantized delta upload over the packed buffer (port of
``repro/core/aggregators/quant.py``).

global = base + sum_c w_c dequant(quant8(new_c - base)), one f32 scale per
``FedConfig.quant_block`` elements of each client row.

- With a client mesh (``AggContext.mesh``; the launcher's is 1 x 1) the
  int8 payload is real: each rank quantizes its own (C/S, N) delta rows
  (ONE K5a launch, ``kernels.pack.quantize_rows``, under
  ``agg_impl="kernel"``), one int8 all-gather of ``q`` and one f32
  all-gather of the scales over the client axis bring every row to every
  rank, and ``packing.dequant_reduce_ref`` decodes and reduces all C rows
  without a (C, N) f32 buffer. Each rank writes the dispatch into its rows.
- Without a mesh there is no wire to put int8 bytes on, so encode, decode
  and the weighted reduction fuse into one pass: ONE K4 launch
  (``kernels.pack.quant8_reduce``) under ``agg_impl="kernel"``,
  ``packing.quant8_mean_ref`` under ``"ref"``.

``clip(round(x/s))`` in f32 is the int8 round trip bit for bit, and the
decode chain is the fused one, so both transports give the same global bit
for bit.
"""
from __future__ import annotations

from repro_torch.core import packing
from repro_torch.core.aggregators.base import Aggregator, _client_shards, gather_clients, register
from repro_torch.models.params import Spec


@register
class Quant8(Aggregator):
    name = "quant8"
    local_rows = True

    def __init__(self, ctx):
        super().__init__(ctx)
        C, G = ctx.fed.n_clients, ctx.fed.group_size
        shards = _client_shards(ctx.fed, ctx.mesh)
        if G:
            # hierarchical geometry: groups must tile the cohort AND each
            # shard must hold whole groups, or the gathered int8 rows of a
            # group straddle ranks and the row-scale vectors misalign
            if C % G or (shards > 1 and G % shards):
                raise ValueError(
                    f"quant8 hierarchical geometry invalid: n_clients={C}, "
                    f"group_size={G}, '{ctx.fed.client_axis}' shards={shards} "
                    f"— need n_clients % group_size == 0 and "
                    f"group_size % shards == 0"
                )
        elif C % max(shards, 1):
            raise ValueError(
                f"quant8 requires n_clients ({C}) divisible by the "
                f"'{ctx.fed.client_axis}' mesh axis ({shards} shards); "
                f"otherwise the gathered row-scale vector has the wrong length"
            )

    def init_state(self, packed0):
        # the dispatched (N,) row each client diffs against next round: a
        # copy, never a view of the round buffer the next local step rewrites
        return {"base": packed0[0].clone()}

    def state_pspecs(self, axis_sizes=None):
        ps = packing.packed_spec(self.ctx.spec.n_total, self.ctx.fed.client_axis, axis_sizes)
        return {"base": Spec(*ps[1:])}  # the dispatched row: no client dim

    def _quant(self, delta, block):
        if self.ctx.fed.agg_impl == "kernel":
            from repro_torch.kernels import pack as kpack

            return kpack.quantize_rows(delta, block=block)
        return packing.quantize_rows_ref(delta, block)

    def _quant_reduce(self, delta, w, block):
        if self.ctx.fed.agg_impl == "kernel":
            from repro_torch.kernels import pack as kpack

            return kpack.quant8_reduce(delta, w.contiguous(), block=block)
        return packing.quant8_mean_ref(delta, w, block)

    def aggregate(self, packed, weights, agg_state, mask=None):
        base = agg_state["base"].float()
        block = self.ctx.fed.quant_block
        w_eff = self._masked_weights(weights, mask)
        delta = packed.float() - base[None, :]
        mesh = self.ctx.mesh
        if mesh is None:
            gd = self._quant_reduce(delta, w_eff, block)
        else:
            q, scales = self._quant(delta, block)  # this rank's (C/S, N) rows
            del delta
            q = gather_clients(q, self.ctx.fed, mesh)  # int8 (C, N)
            scales = gather_clients(scales, self.ctx.fed, mesh)
            gd = packing.dequant_reduce_ref(q, scales, w_eff, block)
        out = self._broadcast(base + gd, packed)
        return out, {"base": out[0].clone()}
