"""Weight carrier between the reference's param tree and the port's module.

No counterpart in the reference. The reference keeps conv weights HWIO in a
tree of dicts and tuples (``{"heads": (...), "stages": ({"down", "res1",
"res2"}, ...), "stem"}``); :class:`~repro_torch.models.yolov3.FedYOLOv3`
keeps them OIHW under state keys that are the same paths joined with ``.``.
Both directions only permute axes, so a round trip is bit-exact. The tests
use this to give both packages identical weights, and the checkpoint store
uses it to read and write the reference's npz layout.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.models.params import flatten_with_paths

PyTree = Any


def from_reference(tree: PyTree) -> dict[str, torch.Tensor]:
    """Reference HWIO tree (numpy arrays or host tensors) -> OIHW state dict."""
    return {
        path.replace("/", "."): torch.tensor(np.asarray(leaf)).permute(3, 2, 0, 1).contiguous()
        for path, leaf in flatten_with_paths(tree)
    }


def to_reference(module: nn.Module) -> PyTree:
    """Module -> the reference's HWIO tree of numpy arrays (inverse of
    :func:`from_reference`): dicts with sorted keys, digit-keyed levels as
    tuples."""
    root: dict = {}
    for key, w in module.state_dict().items():
        *parents, leaf = key.split(".")
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = w.detach().cpu().permute(2, 3, 1, 0).contiguous().numpy()
    return _tuplify(root)


def _tuplify(node):
    if not isinstance(node, dict):
        return node
    if all(k.isdigit() for k in node):
        return tuple(_tuplify(node[str(i)]) for i in range(len(node)))
    return {k: _tuplify(node[k]) for k in sorted(node)}
