"""The comparison that decides ``correct``, for a cell that trains.

Set-up drives the program's server through the cell's first rounds (the
window's own call, on pool batches that all differ); the plain reference
follows the same rounds from the same initial row and batches. The
numbers below are read in every run; those that ``limits/<cell>.json``
gives a limit are compared with it:

- ``loss_gap``: the largest relative gap between the program's and the
  reference's loss of a round; ``first_loss_gap``: that of the first
  round alone;
- ``first_update_gap``: per client and leaf, the gap between the norms of
  the first update (the gradient as the optimizer takes it), over the
  reference's norm of that leaf or of the client's median leaf, whichever
  is larger; the largest;
- ``change_gap``: per leaf, the gap between the norms of the parameters'
  change over the rounds, over the reference's norm of that leaf or of the
  median leaf, whichever is larger; the largest; ``first_change_gap``: the
  same after the first round. A leaf whose reference gradient is under a
  thousandth of the median leaf's moves by round-off alone and is left out.
"""
from __future__ import annotations

import math

import torch


def gaps(prog: dict, ref: dict) -> dict[str, float]:
    lp, lr = prog["loss"].double(), ref["loss"].double()
    per_round = torch.abs(lp - lr) / torch.clamp_min(torch.abs(lr), 1e-30)
    fp, fr = prog["first_update"].double(), ref["first_update"].double()
    med = fr.median(dim=1, keepdim=True).values
    first_gap = float(torch.max(torch.abs(fp - fr) / torch.clamp_min(torch.maximum(fr, med), 1e-30)))
    g = fr.max(dim=0).values
    moved = g >= 1e-3 * g.median()

    def change_gap(key: str) -> float:
        cp, cr = prog[key].double()[moved], ref[key].double()[moved]
        return float(torch.max(torch.abs(cp - cr) / torch.clamp_min(torch.maximum(cr, cr.median()),
                                                                     1e-30)))

    return {"loss_gap": float(per_round.max()), "first_loss_gap": float(per_round[0]),
            "first_update_gap": first_gap, "first_change_gap": change_gap("first_change"),
            "change_gap": change_gap("change")}


def passes(found: dict[str, float], limits: dict[str, float]) -> bool:
    """Every number with a limit is finite and within it (a NaN fails)."""
    return bool(limits) and all(math.isfinite(found[k]) and found[k] <= v
                                for k, v in limits.items())
