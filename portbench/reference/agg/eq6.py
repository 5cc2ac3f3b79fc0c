"""Plain reference of Eq. 6 (FedVision), the mix's ``eq6`` aggregate (a
frozen copy, plain PyTorch f32).

Client i scores each layer bucket j by v(j) = |sum of its parameters in j
now - that sum before the round|, and uploads its top-n buckets (ties at the
n-th score upload too). A bucket's global value is the weighted mean over
the clients that uploaded it (weights 1/C under full participation); every
client takes it. A bucket nobody uploaded keeps each client's own values.
"""
from __future__ import annotations

import torch

from portbench.reference import layout


def bucket_sums(row: torch.Tensor, leaves, sizes: dict) -> torch.Tensor:
    out = torch.zeros(layout.n_buckets(sizes), dtype=torch.float32, device=row.device)
    for off, b0, nb, per in layout.bucket_runs(leaves, sizes):
        out[b0:b0 + nb] += row[off:off + nb * per].reshape(nb, per).sum(-1)
    return out


def init(r0: torch.Tensor, leaves, sizes: dict, C: int) -> list[torch.Tensor]:
    """The state before the first round: each client's bucket sums of the
    initial row."""
    return [bucket_sums(r0, leaves, sizes)] * C


def aggregate(rows: list[torch.Tensor], prev: list[torch.Tensor], leaves, sizes: dict,
              mix: dict) -> list[torch.Tensor]:
    """Aggregate the trained ``rows`` in place; -> each client's bucket sums
    before the aggregate (the next round's ``prev``)."""
    C, topn = len(rows), mix["topn"]
    sums = [bucket_sums(r, leaves, sizes) for r in rows]
    up = []
    for s, p in zip(sums, prev):
        v = torch.abs(s - p)
        kth = torch.topk(v, min(topn, v.numel())).values[-1]
        up.append((v >= kth).float())
    w = torch.stack(up) * (1.0 / C)  # (C, B)
    den = w.sum(0)
    for off, b0, nb, per in layout.bucket_runs(leaves, sizes):
        seg = slice(off, off + nb * per)
        x = [r[seg].reshape(nb, per) for r in rows]
        mean = sum(w[c, b0:b0 + nb, None] * x[c] for c in range(C)) / torch.clamp_min(
            den[b0:b0 + nb, None], 1e-12)
        took = den[b0:b0 + nb] > 0
        for c in range(C):
            x[c][took] = mean[took]
    return sums
