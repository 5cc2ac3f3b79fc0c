"""Packed-buffer transport for the aggregation engine (port of
``repro/core/packing.py``, the parts the flat round runs).

The packed ``(C, N_total)`` buffer is the round state of the flat engine:
row c holds client c's parameters, leaf after leaf in the reference's
flattening order (``heads``, ``stages``, ``stem`` for fedyolov3) and each
leaf in its HWIO element order, so a row of the port's buffer equals a row
of the reference's ``state["params"]`` element for element. Clients train
on per-leaf views of their row (:func:`unpack_views`) and the optimizer
writes back in place; :func:`pack` and :func:`unpack` survive only at the
edges (initial state, weight carry-over).

Layer buckets come from ``compression.leaf_layer_ids``: each slot spans a
contiguous range of Eq. 6 score buckets, kept slot-wise (offset + bucket
count per leaf); the explicit ``(N,)`` id vector (:func:`bucket_ids`) is
materialized only for the K1 kernel.

:func:`masked_bucket_mean` is the one masked/weighted reduction of the
dense, eq6 and static_topn rounds: ``impl="kernel"`` runs K1
(``kernels.pack.packed_bucket_reduce``), ``impl="ref"`` the reference's
folded-weight multiply-add chain over :func:`merged_runs` in plain torch.
The reference's ``bucket_tile_bound`` sizes a TPU kernel's bucket window;
the CUDA kernel gathers each element's weight directly and needs no bound.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import numpy as np
import torch

from repro_torch.core import compression as comp
from repro_torch.models.params import flatten_with_paths, unflatten

PyTree = Any

# clients beyond this reduce through one contraction instead of a
# multiply-add chain unrolled per client (the reference's cutover)
CHAIN_MAX_CLIENTS = 64


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    name: str  # the leaf's key path (``stages/0/down``)
    shape: tuple[int, ...]  # per-client leaf shape (no leading C)
    offset: int  # element offset into the packed buffer
    size: int  # number of elements
    bucket_off: int  # first Eq. 6 score bucket this slot touches
    n_buckets: int  # contiguous buckets spanned (layers, or 1 for misc)

    @property
    def per_bucket(self) -> int:
        return self.size // self.n_buckets


@dataclasses.dataclass(frozen=True)
class PackSpec:
    n_total: int
    n_buckets: int  # total score buckets (cfg.n_layers + 1)
    slots: tuple[LeafSlot, ...]


def build_pack_spec(cfg, template: PyTree) -> PackSpec:
    """Flatten the param template into slot metadata."""
    slots: list[LeafSlot] = []
    off = 0
    for path, info in flatten_with_paths(template):
        size = max(math.prod(info.shape), 1)
        kind, boff = comp.leaf_layer_ids(path, info, cfg)
        if kind == "stack2":
            nb = info.shape[0] * info.shape[1]
        elif kind == "stack1":
            nb = info.shape[0]
        else:
            nb = 1
        slots.append(LeafSlot(path, tuple(info.shape), off, size, boff, nb))
        off += size
    return PackSpec(off, comp.n_score_buckets(cfg), tuple(slots))


@functools.lru_cache(maxsize=16)
def bucket_ids(spec: PackSpec) -> np.ndarray:
    """Explicit (N_total,) int32 bucket id per element (the K1 operand)."""
    return np.concatenate(
        [
            np.repeat(np.arange(s.n_buckets, dtype=np.int32) + s.bucket_off, s.per_bucket)
            for s in spec.slots
        ]
    )


@functools.lru_cache(maxsize=16)
def bucket_ids_on(spec: PackSpec, device: torch.device) -> torch.Tensor:
    """:func:`bucket_ids` as an int32 tensor on ``device``, copied there once
    per process rather than once per round."""
    return torch.from_numpy(bucket_ids(spec)).to(device)


# ---------------------------------------------------------------------------
# pack / unpack
# ---------------------------------------------------------------------------

def pack(spec: PackSpec, stacked: PyTree, dtype: torch.dtype | None = None) -> torch.Tensor:
    """Client-stacked tree of (C, *shape) tensors -> one (C, N_total) buffer.
    With dtype None the buffer takes the promoted dtype of all leaves."""
    leaves = [leaf for _, leaf in flatten_with_paths(stacked)]
    C = leaves[0].shape[0]
    if dtype is None:
        dtype = functools.reduce(torch.promote_types, (x.dtype for x in leaves))
    return torch.cat([x.reshape(C, -1).to(dtype) for x in leaves], dim=1)


def unpack(spec: PackSpec, packed: torch.Tensor, like: PyTree) -> PyTree:
    """(C, N_total) buffer -> a tree shaped like ``like`` of (C, *shape)
    copies, each cast to its ``like`` leaf's dtype where the leaf has one."""
    out = {}
    C = packed.shape[0]
    for s, (path, leaf) in zip(spec.slots, flatten_with_paths(like)):
        x = packed[:, s.offset: s.offset + s.size].reshape((C,) + s.shape)
        out[path] = x.to(getattr(leaf, "dtype", x.dtype), copy=True)
    return unflatten(like, out)


def unpack_views(spec: PackSpec, packed: torch.Tensor, like: PyTree) -> PyTree:
    """Per-leaf views of the packed buffer: ``packed[..., off:off+size]``
    reshaped to ``lead + shape``, where ``lead`` is whatever leading dims the
    buffer has (``(C,)`` for the round state, none for one client's row).
    No copy: writes through a view land in the buffer, and autograd hands a
    leaf's gradient back into the buffer's layout. ``like`` gives only the
    tree structure (a ParamInfo template or any matching tree)."""
    lead = packed.shape[:-1]
    views = {
        s.name: packed[..., s.offset: s.offset + s.size].view(lead + s.shape)
        for s in spec.slots
    }
    return unflatten(like, {path: views[path] for path, _ in flatten_with_paths(like)})


def write_slots(spec: PackSpec, packed: torch.Tensor, stacked: PyTree) -> torch.Tensor:
    """Write client-stacked leaves into the packed buffer in place
    (``unpack_views``' inverse) and return the buffer."""
    C = packed.shape[0]
    for s, (_, leaf) in zip(spec.slots, flatten_with_paths(stacked)):
        packed[:, s.offset: s.offset + s.size].copy_(leaf.reshape(C, s.size))
    return packed


# ---------------------------------------------------------------------------
# reduction tiling: maximal merged runs of uniform-width buckets
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def merged_runs(spec: PackSpec) -> tuple[tuple[int, int, int, int], ...]:
    """Maximal contiguous (column, bucket) runs with one per-bucket width.

    Each run ``(col0, bucket0, n_buckets, per)`` satisfies
    ``bucket(col0 + i) == bucket0 + i // per``: adjacent slots merge when
    both their columns and their bucket ranges continue the run (same-shape
    misc tensors do not merge: they share one bucket)."""
    runs: list[tuple[int, int, int, int]] = []
    for s in spec.slots:
        if runs:
            col0, b0, nb, per = runs[-1]
            if (
                per == s.per_bucket
                and s.offset == col0 + nb * per
                and s.bucket_off == b0 + nb
            ):
                runs[-1] = (col0, b0, nb + s.n_buckets, per)
                continue
        runs.append((s.offset, s.bucket_off, s.n_buckets, s.per_bucket))
    return tuple(runs)


def expand_bucket_vec(spec: PackSpec, vec: torch.Tensor) -> torch.Tensor:
    """(..., n_buckets) bucket vector -> (..., N_total) per-element vector,
    one broadcast per merged run."""
    parts = []
    for (_, b0, nb, per) in merged_runs(spec):
        v = vec[..., b0: b0 + nb]
        parts.append(v[..., None].expand(v.shape + (per,)).reshape(v.shape[:-1] + (nb * per,)))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def bucket_sums(spec: PackSpec, packed: torch.Tensor) -> torch.Tensor:
    """Per-bucket signed element sums: (C, N_total) -> (C, n_buckets) f32
    (the Eq. 6 inner sums)."""
    C = packed.shape[0]
    out = torch.zeros((C, spec.n_buckets), dtype=torch.float32, device=packed.device)
    for s in spec.slots:
        x = packed[:, s.offset: s.offset + s.size].float()
        sums = x.reshape(C, s.n_buckets, s.per_bucket).sum(dim=-1)
        out[:, s.bucket_off: s.bucket_off + s.n_buckets] += sums
    return out


# ---------------------------------------------------------------------------
# the masked/weighted reductions every stacked mode lowers to
# ---------------------------------------------------------------------------

def weighted_mean(packed: torch.Tensor, weights: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Unmasked Eq. 5 over the flat buffer: (C, N), (C,) -> (N,) f32, the
    optional (C,) 0/1 participation mask dropping rows from numerator and
    denominator. The 1/sum(w) normalization is folded into the weights:
    one multiply-add chain over the clients (one contraction beyond
    CHAIN_MAX_CLIENTS)."""
    C = packed.shape[0]
    w = weights.float()
    if mask is not None:
        w = w * mask.float()
    wn = w / torch.clamp_min(torch.sum(w), 1e-12)
    if C > CHAIN_MAX_CLIENTS:
        return wn @ packed.float()
    acc = packed[0].float() * wn[0]
    for c in range(1, C):
        acc = acc + packed[c].float() * wn[c]
    return acc


def masked_bucket_mean(
    packed: torch.Tensor,
    wmask: torch.Tensor,
    spec: PackSpec,
    mask: torch.Tensor | None = None,
    *,
    impl: str = "ref",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Weighted mean over clients under a per-(client, bucket) mask.

    packed (C, N); wmask (C, B): participation weight times the 0/1 upload
    mask per score bucket; mask: optional (C,) 0/1 participation vector.
    Returns (global (N,) f32, den (B,) f32) with
    ``global[n] = sum_c mask[c] wmask[c, b(n)] x[c, n] / den[b(n)]`` and
    ``den[b] = sum_c mask[c] wmask[c, b]`` (0 where nobody uploaded).

    ``impl="kernel"``: K1 gives per-element (num, den) and the division
    takes a 1e-12 floor. ``impl="ref"``: 1/den folds into the per-bucket
    weights and one multiply-add chain runs per merged run.
    """
    C = packed.shape[0]
    wm = wmask.float()
    if mask is not None:
        wm = wm * mask.float()[:, None]
    den_b = torch.sum(wm, dim=0)  # (B,)
    if impl == "kernel":
        from repro_torch.kernels import pack as kpack

        ids = bucket_ids_on(spec, packed.device)
        num, den = kpack.packed_bucket_reduce(
            packed, wmask.float().contiguous(), ids,
            None if mask is None else mask.float().contiguous(),
        )
        return num / torch.clamp_min(den, 1e-12), den_b
    if impl != "ref":
        raise ValueError(f"agg_impl={impl!r}; expected ref | kernel")
    wn = wm / torch.clamp_min(den_b, 1e-12)[None, :]
    parts = []
    for (col0, b0, nb, per) in merged_runs(spec):
        xs = packed[:, col0: col0 + nb * per].float().reshape(C, nb, per)
        wt = wn[:, b0: b0 + nb]  # (C, nb)
        if C > CHAIN_MAX_CLIENTS:
            parts.append(torch.einsum("cb,cbp->bp", wt, xs).reshape(nb * per))
            continue
        acc = xs[0] * wt[0][:, None]
        for c in range(1, C):
            acc = acc + xs[c] * wt[c][:, None]
        parts.append(acc.reshape(nb * per))
    g = parts[0] if len(parts) == 1 else torch.cat(parts)
    return g, den_b
