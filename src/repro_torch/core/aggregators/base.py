"""Aggregator strategy interface + registry (port of
``repro/core/aggregators/base.py``).

An :class:`Aggregator` is the server-side policy for one federated round:
``init_state`` builds any cross-round state (Eq. 6 score sums) from the
packed initial params and ``aggregate`` maps the packed ``(C, N_total)``
round state, just trained, to the post-round state. The round state is the
flat engine's one preallocated buffer, so ``aggregate`` writes the dispatch
into it in place and returns it; nothing else may hold a private copy.

``aggregate(packed, weights, agg_state, mask=None)``:

- ``weights``: (C,) scheduler weights (sum 1 over participants);
- ``mask``: (C,) 0/1 participation, or None under full participation.
  Rows with ``mask == 0`` did not train this round and contribute to
  neither numerator nor denominator of any mean. A mask of all ones is
  numerically identical to ``None`` (a product with 1.0 is exact).

``FedConfig.agg_impl`` picks the reduction: ``"ref"`` plain torch,
``"kernel"`` the CUDA kernels (K1, and K4, K6, K7 or K8 where a mode has
one; their plain versions on the CPU).

Cross-round state (a dispatched ``base`` row, error-feedback rows, server
optimizer moments) never aliases the round buffer: the next round's local
steps rewrite that buffer in place, so every row taken from it is a copy.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import packing

PyTree = Any


@dataclasses.dataclass(frozen=True)
class AggContext:
    """Everything an aggregator may need, fixed at build time."""

    cfg: Any  # ArchConfig
    fed: Any  # rounds.FedConfig
    template: PyTree  # ParamInfo tree
    spec: packing.PackSpec


class Aggregator:
    """Strategy interface: init_state / aggregate over the packed buffer."""

    name: str = ""
    stacked: bool = True  # False -> fedsgd topology (a later slice)

    def __init__(self, ctx: AggContext):
        self.ctx = ctx

    def init_state(self, packed0: torch.Tensor) -> PyTree:
        """Aggregator state from the packed initial params. Default: none."""
        return {}

    def aggregate(self, packed: torch.Tensor, weights: torch.Tensor, agg_state: PyTree,
                  mask: torch.Tensor | None = None) -> tuple[torch.Tensor, PyTree]:
        """(C, N) packed updates + (C,) weights [+ (C,) 0/1 participation
        mask] -> (packed', agg_state'), packed' written into ``packed``."""
        raise NotImplementedError

    # -- shared helpers ------------------------------------------------------
    def _mean(self, packed: torch.Tensor, wmask: torch.Tensor,
              mask: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """One masked bucket-weighted reduction (plain torch or K1) ->
        (global (N,), den (B,) per-bucket denominator)."""
        return packing.masked_bucket_mean(
            packed, wmask, self.ctx.spec, mask, impl=self.ctx.fed.agg_impl
        )

    def _wmean_full(self, packed: torch.Tensor, weights: torch.Tensor,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
        """Participation-weighted Eq. 5 mean, every bucket uploaded: the flat
        contraction under ``ref``, K1 over a full weight mask under
        ``kernel``."""
        if self.ctx.fed.agg_impl == "kernel":
            g, _ = self._mean(packed, self._full_wmask(weights), mask)
            return g
        return packing.weighted_mean(packed, weights, mask)

    def _full_wmask(self, weights: torch.Tensor) -> torch.Tensor:
        """(C,) weights -> (C, B) mask with every bucket uploaded."""
        return weights.float()[:, None].expand(weights.shape[0], self.ctx.spec.n_buckets)

    def _masked_weights(self, weights: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        """Fold the participation mask into the weight vector (f32)."""
        w = weights.float()
        return w if mask is None else w * mask.float()

    def _broadcast(self, global_: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
        """(N,) global -> every row of ``packed`` (in place): every client
        gets the new model."""
        return packed.copy_(global_.to(packed.dtype)[None].expand_as(packed))

    def _dispatch_uploaded(self, global_: torch.Tensor, den_b: torch.Tensor,
                           packed: torch.Tensor) -> torch.Tensor:
        """Write ``global_`` into every row where some client uploaded the
        bucket (den > 0); elsewhere each client keeps its local values."""
        up = packing.expand_bucket_vec(self.ctx.spec, den_b > 0)
        return torch.where(up[None, :], global_.to(packed.dtype)[None, :], packed, out=packed)


_REGISTRY: dict[str, type[Aggregator]] = {}


def register(cls: type[Aggregator]) -> type[Aggregator]:
    assert cls.name, f"{cls.__name__} needs a non-empty .name"
    assert cls.name not in _REGISTRY, f"duplicate aggregator {cls.name!r}"
    _REGISTRY[cls.name] = cls
    return cls


def get(name: str) -> type[Aggregator]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown aggregation {name!r}; the port has: {sorted(_REGISTRY)} "
            "(the fedsgd topology belongs to a later slice)"
        ) from None


def names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
