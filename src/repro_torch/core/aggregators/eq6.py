"""Paper Eq. 6 top-n aggregation over the packed buffer (port of
``repro/core/aggregators/eq6.py``).

Each client ranks its score buckets by v(j) = |sum_k - sum_{k-1}| (signed
per-layer parameter sums across consecutive rounds) and uploads only its
top-n. A bucket's global value is the weighted mean over the clients that
uploaded it; buckets uploaded by nobody keep each client's local values.
On fedyolov3 every parameter sits in one bucket, so every client uploads
everything and this is the masked weighted mean (``core.compression``).
"""
from __future__ import annotations

from repro_torch.core import compression as comp
from repro_torch.core import packing
from repro_torch.core.aggregators.base import Aggregator, register
from repro_torch.models.params import Spec


@register
class Eq6(Aggregator):
    name = "eq6"

    def init_state(self, packed0):
        return {"prev_sums": packing.bucket_sums(self.ctx.spec, packed0)}

    def state_pspecs(self, axis_sizes=None):
        return {"prev_sums": Spec(self.ctx.fed.client_axis, None)}

    def aggregate(self, packed, weights, agg_state, mask=None):
        new_sums = packing.bucket_sums(self.ctx.spec, packed)  # (C, B)
        v = comp.contribution_scores(agg_state["prev_sums"], new_sums)
        upload = comp.topn_mask(v, self.ctx.fed.topn)  # per client, along B
        wmask = upload.float() * weights.float()[:, None]
        g, den_b = self._mean(packed, wmask, mask)
        return self._dispatch_uploaded(g, den_b, packed), {"prev_sums": new_sums}
