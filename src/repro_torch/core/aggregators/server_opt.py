"""Server-side optimizer aggregation, FedAvgM and FedAdam (Reddi et al.
2021; port of ``repro/core/aggregators/server_opt.py``).

The weighted client mean is a target and ``delta = global - avg`` a
pseudo-gradient; a server optimizer from ``repro_torch.optim`` takes one
step per round on the (N,) global row. The port's optimizers update one
row in place, so the state is the row and its moment rows, copied before
each step (the caller's state is never written). With server_lr=1 and zero
momentum this is dense FedAvg.

FedAdam wants a small server_lr (0.01-0.1): the adaptive step is about
server_lr per coordinate whatever the delta's size.
"""
from __future__ import annotations

from repro_torch.core.aggregators.base import Aggregator, register
from repro_torch.optim import adamw, sgd


class _ServerOpt(Aggregator):
    def _optimizer(self):
        raise NotImplementedError

    def init_state(self, packed0):
        g = packed0[0].float().clone()  # clients start from one dispatch
        # the optimizer's state of a one-row buffer, row 0: (N,) moments and
        # a 0-d step count, as the reference's state of a flat vector
        return {"global": g, "opt": {k: v[0] for k, v in self._optimizer().init(g[None]).items()}}

    def aggregate(self, packed, weights, agg_state, mask=None):
        avg = self._wmean_full(packed, weights, mask)
        g = agg_state["global"].clone()
        opt_state = {k: v.clone() for k, v in agg_state["opt"].items()}
        self._optimizer().update(g, g - avg, opt_state)  # delta = global - avg
        return self._broadcast(g, packed), {"global": g, "opt": opt_state}


@register
class FedAvgM(_ServerOpt):
    """Dense FedAvg + server momentum on the aggregated delta."""

    name = "fedavgm"

    def _optimizer(self):
        fed = self.ctx.fed
        return sgd(lr=fed.server_lr, momentum=fed.server_momentum, clip_norm=0.0)


@register
class FedAdam(_ServerOpt):
    """Adam on the server delta (weight decay off, clipping off)."""

    name = "fedadam"

    def _optimizer(self):
        fed = self.ctx.fed
        return adamw(lr=fed.server_lr, b1=fed.server_momentum, b2=fed.server_beta2,
                     eps=fed.server_eps, weight_decay=0.0, clip_norm=0.0)
