"""Parameter templates (port of ``repro/models/params.py``).

A model module builds a tree (dicts and tuples) of :class:`ParamInfo`
leaves; :func:`init_params` turns it into tensors in the reference's layout,
:func:`abstract` into tensors on the ``meta`` device (shapes without
memory, for the launch plans' dry-run), and :func:`spec_for` /
:func:`pspecs` into sharding specs by the reference's logical-axis rules.
A :class:`Spec` is the torch meaning of a ``PartitionSpec``: a tuple with
one entry per dim, a mesh-axis name (or a tuple of names) or ``None``;
:func:`shardings` turns it into ``torch.distributed.tensor`` placements on
a ``DeviceMesh``.
The leaf order is the reference's flattening order — dict keys sorted,
sequences by index — so the yolo leaves go ``heads``, ``stages``, ``stem``,
and :func:`flatten_with_paths` gives them the reference's key paths
(``stages/0/down``), which are also the checkpoint's npz keys.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator

import torch

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ParamInfo:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis name per dim
    init: str = "normal"  # normal | zeros | ones | small_normal
    scale: float = 1.0  # multiplier on the fan-in init std

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def is_info(x) -> bool:
    return isinstance(x, ParamInfo)


class Spec(tuple):
    """A sharding spec: one entry per dim, a mesh-axis name, a tuple of
    names or None (the torch meaning of a ``PartitionSpec``). A tree walk
    (:func:`flatten_with_paths`, :func:`map_tree`) takes it as a leaf."""

    def __new__(cls, *entries):
        # a one-axis tuple is that axis, as a PartitionSpec normalizes it
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"

    def __getnewargs__(self):
        return tuple(self)


# Default logical-axis -> mesh-axis rules (tensor parallel over "model").
# The leading federated-client axis is added by core.rounds, not here.
DEFAULT_RULES: dict[str | None, str | None] = {
    None: None,
    "layer": None,  # scan-stacked layer dim
    "group": None,  # layer-pattern group dim (gemma3/zamba2)
    "vocab": "model",
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ffn": "model",
    "expert": None,  # baseline: experts replicated, ffn sharded
    "ssm_inner": "model",
    "ssm_state": None,
    "conv": None,
}

# Production-mesh axis sizes (launch.mesh). Examples on host meshes pass
# their own sizes.
PROD_AXIS_SIZES: dict[str, int] = {"pod": 2, "data": 16, "model": 16}

# dims never sharded by fallback placement: scan/stack dims, and head_dim
# (RoPE splits it in half, so sharding it forces pathological reshards).
_NO_FALLBACK = {"layer", "group", "conv", "expert", "head_dim"}


def spec_for(info: ParamInfo, rules: dict | None = None,
             axis_sizes: dict | None = None) -> tuple[str | None, ...]:
    """Shape-aware sharding: honor rules where the dim is divisible by the
    mesh axis, otherwise leave the dim replicated (the reference's rule:
    non-divisible cases are handled structurally instead, by vocab padding
    and per-group q-head padding). -> one mesh-axis name or None per dim,
    each axis used at most once."""
    rules = DEFAULT_RULES if rules is None else rules
    sizes = PROD_AXIS_SIZES if axis_sizes is None else axis_sizes
    assigned: list[str | None] = [None] * len(info.shape)
    used: set[str] = set()
    for i, (dim, ax) in enumerate(zip(info.shape, info.axes)):
        mesh_ax = rules.get(ax)
        if not mesh_ax or mesh_ax in used:
            continue
        if dim > 0 and dim % sizes.get(mesh_ax, 1) == 0:
            assigned[i] = mesh_ax
            used.add(mesh_ax)
    return Spec(*assigned)


def pspecs(template: PyTree, rules: dict | None = None, axis_sizes: dict | None = None) -> PyTree:
    """:func:`spec_for` of every leaf, in the template's structure."""
    return map_tree(lambda i: spec_for(i, rules, axis_sizes), template)


def abstract(template: PyTree, dtype: torch.dtype) -> PyTree:
    """Every leaf as an uninitialized tensor of its shape on ``meta``."""
    return map_tree(lambda i: torch.empty(i.shape, dtype=dtype, device="meta"), template)


def map_with_path(fn, template: PyTree) -> PyTree:
    """``fn(path, leaf)`` over a tree, ``path`` being the leaf's
    :func:`flatten_with_paths` key (``stages/0/down``)."""
    flat = {path: fn(path, leaf) for path, leaf in flatten_with_paths(template)}
    return unflatten(template, flat)


def placements(spec: tuple, mesh) -> list:
    """A spec -> one ``Shard(dim)`` or ``Replicate()`` per dim of ``mesh``
    (a ``DeviceMesh`` with named dims): a mesh dim that names a tensor dim
    shards it, every other replicates."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.mesh_dim_names]
    for dim, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple) else (entry,)):
            if name is not None and name in mesh.mesh_dim_names:
                out[mesh.mesh_dim_names.index(name)] = Shard(dim)
    return out


def shardings(template: PyTree, mesh, rules: dict | None = None,
              axis_sizes: dict | None = None) -> PyTree:
    """Every leaf's placements on ``mesh`` (``axis_sizes`` defaults to the
    mesh's own dims, where the reference defaults to the production sizes)."""
    if axis_sizes is None:
        axis_sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return map_tree(lambda i: placements(spec_for(i, rules, axis_sizes), mesh), template)


def flatten_with_paths(tree: PyTree, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """Yield ``(path, leaf)`` in the reference's order: dict keys sorted,
    tuple/list items by index, paths joined with ``/``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten_with_paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (tuple, list)) and not isinstance(tree, Spec):
        for i, v in enumerate(tree):
            yield from flatten_with_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _fan_in(info: ParamInfo) -> int:
    # fan-in heuristic: product of all dims except the last
    if len(info.shape) <= 1:
        return max(info.shape[-1] if info.shape else 1, 1)
    stacked = info.axes[0] in ("layer", "group", "expert") and len(info.shape) > 2
    return max(math.prod(info.shape[:-1]) // (info.shape[0] if stacked else 1), 1)


def init_params(template: PyTree, generator: torch.Generator,
                dtype: torch.dtype = torch.float32) -> PyTree:
    """Initialize tensors from a template on ``generator``'s device, leaves
    drawn in flattening order from ``generator``. Same distributions as the
    reference's ``init_params``, not the same numbers: parity with the
    reference comes from carrying its weights over (``models.convert``)."""
    dev = generator.device

    def make(info: ParamInfo) -> torch.Tensor:
        if info.init == "zeros":
            return torch.zeros(info.shape, dtype=dtype, device=dev)
        if info.init == "ones":
            return torch.ones(info.shape, dtype=dtype, device=dev)
        std = info.scale / math.sqrt(_fan_in(info))
        if info.init == "small_normal":
            std = 0.02 * info.scale
        w = torch.randn(info.shape, generator=generator, dtype=torch.float32, device=dev)
        return (w * std).to(dtype)

    # draw in flattening order (sorted keys), then rebuild the tree
    drawn = {path: make(info) for path, info in flatten_with_paths(template)}
    return unflatten(template, drawn)


def unflatten(template: PyTree, flat: dict[str, Any], prefix: str = "") -> PyTree:
    """Rebuild ``template``'s structure with the leaves of ``flat`` (keyed by
    :func:`flatten_with_paths` paths)."""
    if isinstance(template, dict):
        return {k: unflatten(v, flat, f"{prefix}{k}/") for k, v in template.items()}
    if isinstance(template, (tuple, list)) and not isinstance(template, Spec):
        return type(template)(unflatten(v, flat, f"{prefix}{i}/") for i, v in enumerate(template))
    return flat[prefix[:-1]]


def map_tree(fn, tree: PyTree) -> PyTree:
    """Apply ``fn`` to every leaf of a tree of dicts, tuples and lists,
    keeping its structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, Spec):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def count_params(template: PyTree) -> int:
    return sum(math.prod(info.shape) for _, info in flatten_with_paths(template))
