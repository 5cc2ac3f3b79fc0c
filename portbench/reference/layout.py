"""The parameter row as the benchmark sees it: every leaf of a model in the
order the flat row holds it, its shape, how it is drawn, and its Eq. 6
score bucket.

The row is one client's model laid end to end, each leaf in its own element
order (convolutions HWIO), leaves in sorted-key order. This file is the
benchmark's own account of that layout, written from the models' published
structure; the test ``test_portbench_reference.py`` holds it against the
program's pack spec at small and at full size.

Drawing: ``normal`` leaves take N(0, 1/fan_in), ``small`` leaves N(0,
0.02^2), ``zeros`` and ``ones`` are constant. A leaf stacked over layers
takes one score bucket per layer; every other leaf shares the bucket after
the last layer.
"""
from __future__ import annotations

import dataclasses
import importlib
import math


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: tuple[int, ...]
    init: str  # normal | small | zeros | ones
    std: float  # of normal and small leaves
    stacked: bool  # one score bucket per entry of dim 0
    offset: int = 0

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def place(leaves: list[Leaf]) -> list[Leaf]:
    out, off = [], 0
    for leaf in leaves:
        out.append(dataclasses.replace(leaf, offset=off))
        off += leaf.size
    return out


def normal(name, shape, fan_in, stacked=False):
    return Leaf(name, tuple(shape), "normal", 1.0 / math.sqrt(fan_in), stacked)


def family(name: str):
    """The reference module of a model family,
    ``portbench/reference/<name>.py``, found by name: its ``leaves(sizes)``
    (the row's layout) and ``loss(params, batch, sizes)``."""
    return importlib.import_module(f"portbench.reference.{name}")


def leaves_of(name: str, sizes: dict) -> list[Leaf]:
    return family(name).leaves(sizes)


def n_buckets(sizes: dict) -> int:
    return sizes["n_layers"] + 1


def bucket_runs(leaves: list[Leaf], sizes: dict):
    """(offset, first bucket, buckets, elements a bucket) per leaf."""
    L = sizes["n_layers"]
    for leaf in leaves:
        if leaf.stacked:
            yield leaf.offset, 0, leaf.shape[0], leaf.size // leaf.shape[0]
        else:
            yield leaf.offset, L, 1, leaf.size
