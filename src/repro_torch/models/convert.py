"""Weight carrier between the reference's param tree and the port's module.

No counterpart in the reference. The reference keeps conv weights HWIO in a
tree of dicts and tuples (``{"heads": (...), "stages": ({"down", "res1",
"res2"}, ...), "stem"}``); :class:`~repro_torch.models.yolov3.FedYOLOv3`
keeps them OIHW under state keys that are the same paths joined with ``.``.
Both directions only permute axes, so a round trip is bit-exact. The tests
use this to give both packages identical weights, and the checkpoint store
uses it to read and write the reference's npz layout.

:func:`state_from_reference` and :func:`state_to_reference` carry a flat
round state across, for fedyolov3 and the LM archs alike (the pack spec
comes from the config's family): the reference's ``state["params"]`` is
already the packed ``(C, N_total)`` buffer in the port's layout, and its
optimizer moments (client-stacked trees such as ``state["opt"]["mu"]`` or
adamw's ``"m"`` and ``"v"``) pack into the port's ``(C, N_total)`` moment
buffers; its ``rows`` and ``cols`` arguments keep one rank's block of a
mesh (``core.packing.packed_block``): the rows of a sharded client axis and
the column block of a model axis that splits the flat dim. :func:`fedsgd_state_from_reference` carries the fedsgd
topology's one shared tree and its moments into the one packed row.
:func:`tree_state_from_reference` and :func:`tree_state_to_reference` carry
a ``state_layout="tree"`` state's params and optimizer state, whose trees
are in the same layout in both packages (HWIO for fedyolov3), so only the
container changes.
:func:`agg_state_from_reference`
and :func:`agg_state_to_reference` carry ``state["agg"]``: its rows
(``base``, ``global``, ``ef``, ``prev_sums``, the server optimizer's
``opt`` moments and step count, hier's state of its base) are flat arrays
in both packages; only the round counter changes form, a traced int32
scalar there and a Python int here (it keys the PRNG on the host). Its
``rows`` and ``cols`` keep a rank's block of the leaves that follow the
flat dim (``core.aggregators.map_state``).

:func:`lm_params_from_reference` and :func:`lm_params_to_reference` carry an
LM's param tree (``transformer.template``'s layout, layer stacks stacked) in
both directions, for every family: ``layers``, gemma3's ``groups`` and
``tail``, the hybrid's ``mamba_groups`` and ``shared``, the ``moe`` experts,
llava's ``img_proj`` and an untied ``lm_head``. The layout is the same in both
packages, so only the container changes and a round trip is bit-exact.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.models.params import flatten_with_paths, map_tree

PyTree = Any


def from_reference(tree: PyTree) -> dict[str, torch.Tensor]:
    """Reference HWIO tree (NumPy arrays or tensors on any device) -> OIHW
    state dict (tensors stay on their device)."""
    return {
        path.replace("/", "."): _tensor(leaf).permute(3, 2, 0, 1).contiguous()
        for path, leaf in flatten_with_paths(tree)
    }


def _tensor(leaf) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else torch.tensor(np.asarray(leaf))


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


def _spec(cfg):
    from repro_torch.core import packing, rounds

    tpl = rounds.make_template(cfg)
    return packing.build_pack_spec(cfg, tpl), tpl


def state_from_reference(cfg, params, opt: dict, device: str | torch.device = "cpu",
                         rows: slice = slice(None), cols: slice = slice(None)):
    """The reference's flat state -> (packed params (C, N_total), opt dict).

    params: ``state["params"]`` as a (C, N_total) array; opt:
    ``state["opt"]`` with each moment a client-stacked tree of (C, *shape)
    arrays (``{"mu": tree}`` for sgd, ``{"m", "v": tree, "t": (C,)}`` for
    adamw, ``{}`` for stateless sgd). Moments pack into (C, N_total)
    buffers; the step count stays a (C,) tensor. ``rows`` keeps a block of
    clients, e.g. a rank's ``packing.packed_pspec`` under a client mesh, and
    ``cols`` a block of the flat dim (``packing.packed_cols``) of the params
    and of each moment buffer."""
    from repro_torch.core import packing

    spec, _ = _spec(cfg)
    params = np.asarray(params, np.float32)
    if params.shape[1] != spec.n_total:
        raise ValueError(f"params have {params.shape[1]} columns, the spec {spec.n_total}")
    packed = torch.tensor(params[rows, cols], device=device)
    as_t = lambda x: torch.tensor(np.asarray(x)[rows], device=device)
    out = {k: packing.pack(spec, map_tree(as_t, v))[:, cols].clone()
           if isinstance(v, (dict, tuple, list)) else as_t(v) for k, v in opt.items()}
    return packed, out


def fedsgd_state_from_reference(cfg, params: PyTree, opt: dict,
                                device: str | torch.device = "cpu"):
    """The reference's fedsgd state -> (the shared row (N_total,), opt dict).

    params: the one shared param tree; opt: its optimizer state, each
    moment a tree of the params' shapes (adamw's ``t`` a scalar). Both pack
    into one row, the step count becomes a 0-d tensor."""
    from repro_torch.core import packing

    spec, _ = _spec(cfg)
    as_row = lambda x: torch.tensor(np.asarray(x)[None], device=device)
    row = packing.pack(spec, map_tree(as_row, params), torch.float32)[0]
    out = {k: packing.pack(spec, map_tree(as_row, v))[0] if isinstance(v, (dict, tuple, list))
           else torch.tensor(np.asarray(v), device=device) for k, v in opt.items()}
    return row, out


def state_to_reference(cfg, packed: torch.Tensor, opt: dict):
    """Inverse of :func:`state_from_reference`: -> ((C, N_total) NumPy
    params, opt dict with each (C, N_total) moment unpacked into the
    reference's client-stacked tree of NumPy arrays)."""
    from repro_torch.core import packing

    spec, tpl = _spec(cfg)
    to_np = lambda x: x.detach().cpu().numpy()
    out = {}
    for k, v in opt.items():
        if v.dim() == 2 and v.shape[1] == spec.n_total:
            out[k] = map_tree(to_np, packing.unpack(spec, v, tpl))
        else:
            out[k] = to_np(v)
    return to_np(packed), out


def tree_state_from_reference(params: PyTree, opt: dict, device: str | torch.device = "cpu",
                              rows: slice | None = slice(None)):
    """The reference's tree state -> (params tree, opt dict) of tensors.

    params: ``state["params"]``, a client-stacked tree of (C, *shape)
    arrays; opt: ``state["opt"]``, each moment a tree like it (adamw's
    ``t`` a (C,) array). ``rows`` keeps a block of clients (a rank's
    ``packing.packed_pspec``); fedsgd's unstacked trees take ``rows=None``.
    Same dtypes and bits."""
    cut = (lambda a: a) if rows is None else (lambda a: a[rows])
    as_t = lambda x: torch.tensor(cut(np.asarray(x)), device=device)
    return map_tree(as_t, params), {k: map_tree(as_t, v) for k, v in opt.items()}


def tree_state_to_reference(params: PyTree, opt: dict):
    """Inverse of :func:`tree_state_from_reference`: trees of NumPy arrays."""
    to_np = lambda t: t.detach().cpu().numpy()
    return map_tree(to_np, params), {k: map_tree(to_np, v) for k, v in opt.items()}


def agg_state_from_reference(agg: dict, device: str | torch.device = "cpu",
                             rows: slice | None = None, cols: slice | None = None) -> dict:
    """The reference's ``state["agg"]`` -> the port's: arrays become tensors
    of the same dtype and bits, ``round`` a Python int, dicts recurse.
    ``cols`` keeps that block of every leaf along the flat dim and ``rows``
    those rows of every client-stacked one (``aggregators.map_state``; a
    hier state over groups keeps its rows whole: pass no ``rows``)."""
    if rows is not None or cols is not None:
        from repro_torch.core.aggregators import map_state

        return map_state(agg_state_from_reference(agg, device),
                         cols=None if cols is None else lambda t: t[..., cols].clone(),
                         rows=None if rows is None else lambda t: t[rows].clone())
    out = {}
    for k, v in agg.items():
        if isinstance(v, dict):
            out[k] = agg_state_from_reference(v, device)
        elif k == "round":
            out[k] = int(np.asarray(v))
        else:
            out[k] = torch.tensor(np.asarray(v), device=device)
    return out


def agg_state_to_reference(agg: dict) -> dict:
    """Inverse of :func:`agg_state_from_reference`: tensors -> NumPy arrays,
    ``round`` -> an int32 scalar array."""
    out = {}
    for k, v in agg.items():
        if isinstance(v, dict):
            out[k] = agg_state_to_reference(v)
        elif k == "round":
            out[k] = np.asarray(v, np.int32)
        else:
            out[k] = v.detach().cpu().numpy()
    return out


def lm_params_from_reference(tree: PyTree, device: str | torch.device = "cpu") -> PyTree:
    """The reference's LM param tree (NumPy or JAX arrays) -> the port's tree
    of tensors on ``device``, same keys, shapes, dtypes and bits."""
    return map_tree(lambda a: torch.tensor(np.asarray(a), device=device), tree)


def lm_params_to_reference(params: PyTree) -> PyTree:
    """Inverse of :func:`lm_params_from_reference`: a tree of NumPy arrays."""
    return map_tree(lambda t: t.detach().cpu().numpy(), params)
