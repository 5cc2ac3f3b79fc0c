"""Parameter templates (port of ``repro/models/params.py``).

A model module builds a tree (dicts and tuples) of :class:`ParamInfo`
leaves; :func:`init_params` turns it into tensors in the reference's layout.
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


def flatten_with_paths(tree: PyTree, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """Yield ``(path, leaf)`` in the reference's order: dict keys sorted,
    tuple/list items by index, paths joined with ``/``."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from flatten_with_paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (tuple, list)):
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
    if isinstance(template, (tuple, list)):
        return type(template)(unflatten(v, flat, f"{prefix}{i}/") for i, v in enumerate(template))
    return flat[prefix[:-1]]


def map_tree(fn, tree: PyTree) -> PyTree:
    """Apply ``fn`` to every leaf of a tree of dicts, tuples and lists,
    keeping its structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


def count_params(template: PyTree) -> int:
    return sum(math.prod(info.shape) for _, info in flatten_with_paths(template))
