"""quant8: int8-quantized delta upload over the packed buffer (port of the
meshless path of ``repro/core/aggregators/quant.py``).

global = base + sum_c w_c dequant(quant8(new_c - base)), one f32 scale per
``FedConfig.quant_block`` elements of each client row. Without a client
mesh there is no wire to put int8 bytes on, so encode, decode and the
weighted reduction fuse into one pass: ONE K4 launch
(``kernels.pack.quant8_reduce``) under ``agg_impl="kernel"``,
``packing.quant8_mean_ref`` under ``"ref"``; ``clip(round(x/s))`` in f32 is
the int8 round trip bit for bit. The gathered int8 transport of a sharded
client axis belongs to the slice that shards it.
"""
from __future__ import annotations

from repro_torch.core import packing
from repro_torch.core.aggregators.base import Aggregator, register


@register
class Quant8(Aggregator):
    name = "quant8"

    def __init__(self, ctx):
        super().__init__(ctx)
        C, G = ctx.fed.n_clients, ctx.fed.group_size
        # hierarchical geometry (one shard here): groups must tile the cohort
        if G and C % G:
            raise ValueError(
                f"quant8 hierarchical geometry invalid: n_clients={C}, group_size={G}, "
                f"'{ctx.fed.client_axis}' shards=1 — need n_clients % group_size == 0"
            )

    def init_state(self, packed0):
        # the dispatched (N,) row each client diffs against next round: a
        # copy, never a view of the round buffer the next local step rewrites
        return {"base": packed0[0].clone()}

    def aggregate(self, packed, weights, agg_state, mask=None):
        base = agg_state["base"].float()
        block = self.ctx.fed.quant_block
        w_eff = self._masked_weights(weights, mask)
        delta = packed.float() - base[None, :]
        if self.ctx.fed.agg_impl == "kernel":
            from repro_torch.kernels import pack as kpack

            gd = kpack.quant8_reduce(delta, w_eff.contiguous(), block=block)
        else:
            gd = packing.quant8_mean_ref(delta, w_eff, block)
        out = self._broadcast(base + gd, packed)
        return out, {"base": out[0].clone()}
