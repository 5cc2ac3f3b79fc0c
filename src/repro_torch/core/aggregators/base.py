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
``"kernel"`` the CUDA kernels (K1, and K4, K5a, K6, K7 or K8 where a mode
has one; their plain versions on the CPU).

Client mesh (``AggContext.mesh``, a ``torch.distributed`` ``DeviceMesh``
whose dim ``FedConfig.client_axis`` splits the C rows over S ranks): an
aggregator with a transport of its own (``local_rows = True``: quant8's
gathered int8 payload, hier's shard-local groups) gets the rank's own
(C/S, N) rows with the full (C,) weights and mask, and writes its dispatch
into them. Every other aggregator gets the whole (C, N) buffer, all-gathered
by the round, and runs unchanged on every rank.

Model axis (the mesh's ``"model"`` dim with M > 1 ranks dividing N_total,
``AggContext.cols`` the rank's block of the flat dim): a column-local
aggregator (``local_cols = True``: dense, static_topn, eq6, hier over a
column-local base, trimmed_mean, fedavgm, fedadam) gets the rank's
(rows, N_total / M) block and aggregates it, K1 on the block's bucket ids
(eq6 sums its per-bucket layer sums over the model axis first, so every
rank makes the same upload choice). Every other aggregator (quant8 and
quant4, whose scale blocks may cross a block edge, secure, whose masks
span the row, topk_ef, whose top-k is the row's) gets whole rows, gathered
over the model axis by the round, and the round keeps its block of what
comes out. Cross-round state follows the buffer (:func:`map_state`): the
leaves along the flat dim (``FLAT_KEYS``) hold the rank's column block,
and the client-stacked ones (``ROW_KEYS``) its rows as well.

Every collective goes through ``core.collectives``.

Cross-round state (a dispatched ``base`` row, error-feedback rows, server
optimizer moments) never aliases the round buffer: the next round's local
steps rewrite that buffer in place, so every row taken from it is a copy.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core import collectives, packing
from repro_torch.models.params import Spec, map_tree

PyTree = Any

# state leaves laid along the flat dim (their last dim is the row's), by key
FLAT_KEYS = frozenset({"base", "global", "ef", "mu", "m", "v"})
# the flat leaves with one row per client
ROW_KEYS = frozenset({"ef"})


def map_state(state: PyTree, cols=None, rows=None) -> PyTree:
    """A copy of an aggregator state with ``cols(t)`` applied to every
    tensor leaf under a key of ``FLAT_KEYS`` and ``rows(t)`` (first) to
    those under ``ROW_KEYS``; nested dicts recurse, other leaves pass."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out[k] = map_state(v, cols, rows)
            continue
        if isinstance(v, torch.Tensor):
            if rows is not None and k in ROW_KEYS:
                v = rows(v)
            if cols is not None and k in FLAT_KEYS:
                v = cols(v)
        out[k] = v
    return out


@dataclasses.dataclass(frozen=True)
class AggContext:
    """Everything an aggregator may need, fixed at build time."""

    cfg: Any  # ArchConfig
    fed: Any  # rounds.FedConfig
    template: PyTree  # ParamInfo tree
    spec: packing.PackSpec
    mesh: Any = None  # torch.distributed DeviceMesh (the client axis) or None
    cols: slice | None = None  # the flat dim's block of this rank (None: whole)
    cols_mesh: Any = None  # the mesh whose "model" dim holds the other blocks


class Aggregator:
    """Strategy interface: init_state / aggregate over the packed buffer."""

    name: str = ""
    stacked: bool = True  # False -> fedsgd topology: one shared model copy
    local_rows: bool = False  # True -> aggregate takes the rank's own rows under a mesh
    local_cols: bool = False  # True -> aggregate takes the rank's column block
    row_state: bool = True  # False -> the ROW_KEYS state is group-level, whole on every rank

    def __init__(self, ctx: AggContext):
        self.ctx = ctx

    def init_state(self, packed0: torch.Tensor) -> PyTree:
        """Aggregator state from the packed initial params. Default: none."""
        return {}

    def state_pspecs(self, axis_sizes: dict | None = None) -> PyTree:
        """Specs (``models.params.Spec``) matching init_state's structure, for
        a launch plan. Default: all replicated server-side state."""
        C = self.ctx.fed.n_clients
        meta = torch.empty((C, self.ctx.spec.n_total), device="meta")
        return map_tree(lambda _: Spec(), self.init_state(meta))

    def aggregate(self, packed: torch.Tensor, weights: torch.Tensor, agg_state: PyTree,
                  mask: torch.Tensor | None = None) -> tuple[torch.Tensor, PyTree]:
        """(C, N) packed updates + (C,) weights [+ (C,) 0/1 participation
        mask] -> (packed', agg_state'), packed' written into ``packed``."""
        raise NotImplementedError

    def state_block(self, state: PyTree, rows: slice | None, cols: slice | None) -> PyTree:
        """The rank's copy of a whole state: ``cols`` of its flat leaves and
        ``rows`` of its client-stacked ones (None: that dim stays whole)."""
        rows = rows if self.row_state else None
        return map_state(state, cols=None if cols is None else lambda t: t[..., cols].clone(),
                         rows=None if rows is None else lambda t: t[rows].clone())

    # -- shared helpers ------------------------------------------------------
    @property
    def _cols(self) -> slice | None:
        """The block of the flat dim ``aggregate`` receives (None: whole)."""
        return self.ctx.cols if self.local_cols else None

    def _mean(self, packed: torch.Tensor, wmask: torch.Tensor,
              mask: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """One masked bucket-weighted reduction (plain torch or K1) ->
        (global (N,), den (B,) per-bucket denominator)."""
        return packing.masked_bucket_mean(
            packed, wmask, self.ctx.spec, mask, impl=self.ctx.fed.agg_impl, cols=self._cols
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
        up = packing.expand_bucket_vec(self.ctx.spec, den_b > 0, self._cols)
        return torch.where(up[None, :], global_.to(packed.dtype)[None, :], packed, out=packed)


def _client_shards(fed, mesh) -> int:
    """Size of the mesh axis acting as the federation (1 without a mesh)."""
    return packing.mesh_axis_size(mesh, fed.client_axis)


def gather_clients(x: torch.Tensor, fed, mesh) -> torch.Tensor:
    """All-gather each rank's leading-dim block of ``x`` over the client
    axis, in rank order: (k, ...) -> (S k, ...), one collective (a copy on a
    1-rank group). Without a mesh, ``x`` itself."""
    return collectives.all_gather(x, mesh, fed.client_axis)


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
        raise ValueError(f"unknown aggregation {name!r}; the port has: {sorted(_REGISTRY)}") from None


def names() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
