"""topk_ef: per-client top-k sparsified delta upload with error feedback
(port of ``repro/core/aggregators/sparse.py``).

Each round every client uploads only the k = round(topk_frac * N) largest
magnitudes of its *compensated* delta (this round's delta plus the residual
earlier rounds did not upload); what stays home accumulates in a
per-client error-feedback row, ``state["agg"]["ef"]``. The telescoping
invariant uploaded + residual == compensated delta holds bit for bit
because the split is a disjoint ``torch.where``, never arithmetic (adding
0.0 would already flip -0.0). The threshold is each row's k-th largest
|value| with ``>=`` selection, so ties at it select more than k.

A deselected client's ef row passes through bit for bit (select, not
blend), and its upload row never reaches the mean (weight 0 there).

The aggregate runs through dense's ``_wmean_full`` (K1 under
``agg_impl="kernel"``) on the upload rows ``where(sel, compensated,
base)``; at k == N the mode is dense bit for bit. ``topk_quant="quant4"``
quantizes the selected values to 4 bits (``packing.quant4_dequant_rows_ref``)
and the residual absorbs that error too.
"""
from __future__ import annotations

import torch

from repro_torch.core import packing
from repro_torch.core.aggregators.base import Aggregator, register


def topk_count(frac: float, n_total: int) -> int:
    """Per-client upload budget: k in [1, n_total]."""
    return max(1, min(n_total, int(round(frac * n_total))))


@register
class TopKEF(Aggregator):
    name = "topk_ef"

    def __init__(self, ctx):
        super().__init__(ctx)
        fed = ctx.fed
        if not 0.0 < fed.topk_frac <= 1.0:
            raise ValueError(f"topk_frac={fed.topk_frac} must be in (0, 1]")
        if fed.topk_quant not in ("none", "quant4"):
            raise ValueError(f"topk_quant={fed.topk_quant!r} not in ('none', 'quant4')")
        if fed.topk_quant == "quant4" and fed.quant4_mode not in ("nearest", "stochastic"):
            raise ValueError(
                f"quant4_mode={fed.quant4_mode!r}: the topk_ef x quant4 composition "
                f"supports 'nearest' | 'stochastic' ('skip' belongs to the pure quant4 mode)"
            )
        self._k = topk_count(fed.topk_frac, ctx.spec.n_total)

    def init_state(self, packed0):
        return {
            "base": packed0[0].clone(),
            "ef": torch.zeros(packed0.shape, dtype=torch.float32, device=packed0.device),
            "round": 0,
        }

    def split(self, packed, agg_state):
        """-> (acc, sel, upload rows, residual): the compensated delta, the
        selected positions, what each client uploads, and what it keeps for
        the next round."""
        fed = self.ctx.fed
        base = agg_state["base"].float()
        t = packed.float() + agg_state["ef"]  # compensated params
        acc = t - base[None, :]
        if self._k >= self.ctx.spec.n_total:
            sel = torch.ones(acc.shape, dtype=torch.bool, device=acc.device)
        else:
            mag = torch.abs(acc)
            # the k-th largest per row: the least of the top k (no sort needed)
            thresh = torch.topk(mag, self._k, dim=1, sorted=False).values.amin(dim=1)
            sel = mag >= thresh[:, None]
        if fed.topk_quant == "none":
            up = torch.where(sel, t, base[None, :])  # unselected positions say "no change"
            residual = torch.where(sel, 0.0, acc)  # disjoint split
        else:
            key = packing.round_key(fed.quant4_seed, agg_state["round"])
            vq = packing.quant4_dequant_rows_ref(torch.where(sel, acc, 0.0), fed.quant_block,
                                                 key=key, mode=fed.quant4_mode)
            up = base[None, :] + vq
            residual = acc - vq
        return acc, sel, up, residual

    def aggregate(self, packed, weights, agg_state, mask=None):
        _, _, up, residual = self.split(packed, agg_state)
        ef = agg_state["ef"]
        out = self._broadcast(self._wmean_full(up, weights, mask), packed)
        # masked rows keep their residual bit for bit (select, not blend)
        ef_new = residual if mask is None else torch.where(mask.float()[:, None] > 0, residual, ef)
        return out, {"base": out[0].clone(), "ef": ef_new, "round": agg_state["round"] + 1}
