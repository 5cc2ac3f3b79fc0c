"""quant4: 4-bit delta upload over the packed buffer (port of
``repro/core/aggregators/lowbit.py``).

quant8's sub-byte sibling: global = base + sum_c w_c dequant(quant4(new_c -
base)), one f32 scale per ``quant_block`` elements, values in [-7, 7].
``quant4_mode`` picks the rounding:

- ``stochastic``: ``clip(floor(x/s + u), -7, 7)``, u from the fmix32
  counter hash under a per-round key. The key mixes the session seed with
  the round counter kept in ``state["agg"]["round"]`` (a Python int), so it
  is computed on the host and reaches the kernel as a launch argument; the
  same (seed, round, client, element) always rounds the same way.
- ``nearest``: ``clip(round(x/s), -7, 7)`` (half to even).
- ``skip``: dense's exact reduction (the dense-equivalence pin).

One K7 launch per round under ``agg_impl="kernel"``
(``kernels.quant4.quant4_reduce``), ``packing.quant4_mean_ref`` under
``"ref"``.
"""
from __future__ import annotations

from repro_torch.core import packing
from repro_torch.core.aggregators.base import Aggregator, _client_shards, register


@register
class Quant4(Aggregator):
    name = "quant4"

    def __init__(self, ctx):
        super().__init__(ctx)
        if ctx.fed.quant4_mode not in ("stochastic", "nearest", "skip"):
            raise ValueError(
                f"quant4_mode={ctx.fed.quant4_mode!r} not in ('stochastic', 'nearest', 'skip')"
            )
        shards = _client_shards(ctx.fed, ctx.mesh)
        if shards > 1:
            raise ValueError(
                f"quant4 has no sharded int4 collective; '{ctx.fed.client_axis}' "
                f"mesh axis must be 1 (got {shards}) — use quant8 for the "
                f"gathered transport"
            )

    def init_state(self, packed0):
        return {"base": packed0[0].clone(), "round": 0}

    def aggregate(self, packed, weights, agg_state, mask=None):
        fed = self.ctx.fed
        r = agg_state["round"]
        if fed.quant4_mode == "skip":  # dense, bit for bit
            out = self._broadcast(self._wmean_full(packed, weights, mask), packed)
            return out, {"base": out[0].clone(), "round": r + 1}
        base = agg_state["base"].float()
        w_eff = self._masked_weights(weights, mask)
        key = packing.round_key(fed.quant4_seed, r)
        delta = packed.float() - base[None, :]
        if fed.agg_impl == "kernel":
            from repro_torch.kernels import quant4 as kq

            gd = kq.quant4_reduce(delta, w_eff.contiguous(), key, mode=fed.quant4_mode,
                                  block=fed.quant_block)
        else:
            gd = packing.quant4_mean_ref(delta, w_eff, fed.quant_block, key=key,
                                         mode=fed.quant4_mode)
        out = self._broadcast(base + gd, packed)
        return out, {"base": out[0].clone(), "round": r + 1}
