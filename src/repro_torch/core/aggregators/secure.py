"""secure: pairwise additive masking in the packed integer domain (port of
``repro/core/aggregators/secure.py``).

Every active pair (a, b) of clients derives a shared fmix32 mask stream; a
adds +m and b adds -m, mod 2^32, so the server's modular sum of the active
rows equals the unmasked sum bit for bit. That needs integers: each
client's weighted delta w_c (new_c - base) is quantized to a scale shared
per block (amax over participants only), values in [-Q, Q] with Q = 127
("int8") or 7 ("int4"). |sum_c q_c| <= C Q << 2^31, so the 32-bit total
read as int32 is the true signed sum.

A deselected client is left out of the scale, adds no row to the sum and
activates no pair, so no orphan mask survives. ``secure_mask=False`` skips
the masks and keeps the identical quantized sum (the masked == unmasked
pin). Pairwise masking is O(C^2 N); C <= 32 is checked at build time.

The sum is one K8 launch under ``agg_impl="kernel"``
(``kernels.mask.masked_u32_sum``); the rows travel as int32 tensors holding
the uint32 bits, and the mask arithmetic runs in int64 masked to 32 bits.
"""
from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.core.aggregators.base import Aggregator, _client_shards, register

MAX_SECURE_CLIENTS = 32


@register
class Secure(Aggregator):
    name = "secure"

    def __init__(self, ctx):
        super().__init__(ctx)
        if ctx.fed.secure_domain not in ("int8", "int4"):
            raise ValueError(f"secure_domain={ctx.fed.secure_domain!r} not in ('int8', 'int4')")
        if ctx.fed.n_clients > MAX_SECURE_CLIENTS:
            raise ValueError(
                f"secure pairwise masking is O(C^2); n_clients={ctx.fed.n_clients} "
                f"exceeds the build-time bound {MAX_SECURE_CLIENTS}"
            )
        shards = _client_shards(ctx.fed, ctx.mesh)
        if shards > 1:
            raise ValueError(
                f"secure masking needs every client row on one host; "
                f"'{ctx.fed.client_axis}' mesh axis must be 1 (got {shards})"
            )

    def init_state(self, packed0):
        return {"base": packed0[0].clone(), "round": 0}

    def aggregate(self, packed, weights, agg_state, mask=None):
        fed = self.ctx.fed
        C, N = packed.shape
        base = agg_state["base"].float()
        r = agg_state["round"]
        Q = 127.0 if fed.secure_domain == "int8" else 7.0
        block = fed.quant_block
        pm = (torch.ones(C, dtype=torch.float32, device=packed.device) if mask is None
              else mask.float())
        w_eff = self._masked_weights(weights, mask)

        # weighted deltas: their plain sum is the weighted mean
        v = w_eff[:, None] * (packed.float() - base[None, :])
        pad = (-N) % block
        vb = torch.nn.functional.pad(v, (0, pad)).reshape(C, -1, block)
        # the scale is shared per block over participants only: a junk row
        # of a deselected client must not blow up everyone's step
        amax = torch.amax(torch.where(pm[:, None, None] > 0, torch.abs(vb), 0.0), dim=(0, 2))
        scale = packing.exact_div(torch.clamp_min(amax, 1e-12), Q)
        q = torch.clamp(torch.round(vb / scale[None, :, None]), -Q, Q).to(torch.int32)
        rows = q.reshape(C, -1)

        rk = packing.round_key(fed.secure_session, r)
        if fed.agg_impl == "kernel":
            from repro_torch.kernels import mask as kmask

            if fed.secure_mask:
                rows = packing.secure_masked_rows(rows, pm, rk)
            s = kmask.masked_u32_sum(rows, pm.contiguous())
        else:
            s = packing.secure_sum_ref(rows, pm, rk, use_masks=fed.secure_mask)
        # the int32 bits are the signed sum: the masks cancelled exactly
        gd = (s.float().reshape(-1, block) * scale[:, None]).reshape(-1)[:N]
        out = self._broadcast(base + gd, packed)
        return out, {"base": out[0].clone(), "round": r + 1}
