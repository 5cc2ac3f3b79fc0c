"""The collectives of the sharded round, each over one named dim of a
``torch.distributed`` ``DeviceMesh``: :func:`all_gather_into_tensor`,
:func:`all_reduce` (a sum), :func:`reduce` (a sum to one rank) and
:func:`broadcast`. No counterpart in the reference, where GSPMD places
these from sharding annotations.

The group's backend for the tensor's device type picks the path
(``dist.get_backend_config``), never a caught error:

- NCCL: the collective runs on the CUDA tensors directly;
- gloo with CPU tensors: directly;
- gloo with CUDA tensors: the operands go through a pinned host buffer this
  module keeps and reuses, one copy to the host and one back, with the
  collective between them on the host (a broadcast's source and a
  reduce's every rank copy to the host; a broadcast's receivers and a
  reduce's destination copy back). Gloo takes CUDA tensors only for
  broadcast and all-reduce, and NCCL refuses two ranks on one device, so
  two processes sharing one card run over gloo this way.

A one-rank group (and ``mesh=None``) runs no collective: a gather is a
copy, an all-reduce, a reduce and a broadcast the identity.

:data:`stats` counts the calls that reached a group of more than one rank,
their bytes and their wall seconds (staging copies included); callers
reset it with :func:`reset_stats`.
"""
from __future__ import annotations

import time

import torch

stats = {"calls": 0, "bytes": 0, "seconds": 0.0}
_pinned: dict[torch.dtype, torch.Tensor] = {}


def reset_stats() -> None:
    stats.update(calls=0, bytes=0, seconds=0.0)


def size(mesh, dim: str) -> int:
    """Ranks along ``dim`` (1 without a mesh or without such a dim)."""
    names = () if mesh is None else (mesh.mesh_dim_names or ())
    return mesh.size(names.index(dim)) if dim in names else 1


def backend(group, device: torch.device) -> str:
    """The backend ``group`` runs for tensors on ``device``: ``"nccl"`` or
    ``"gloo"``. Raises if the group has none for that device type."""
    import torch.distributed as dist

    config = dist.get_backend_config(group)
    kinds = dict(part.split(":") for part in config.split(",")) if ":" in config else {}
    name = kinds.get(torch.device(device).type) if kinds else config
    if name not in ("nccl", "gloo"):
        raise RuntimeError(f"the group's backends {config!r} serve no {torch.device(device).type} "
                           f"tensors")
    return name


def _staging(dtype: torch.dtype, numel: int) -> torch.Tensor:
    """A pinned host buffer of at least ``numel`` elements of ``dtype``,
    grown as needed and reused across calls."""
    buf = _pinned.get(dtype)
    if buf is None or buf.numel() < numel:
        _pinned.pop(dtype, None)  # free the old one before the larger one
        buf = torch.empty(numel, dtype=dtype, pin_memory=True)
        _pinned[dtype] = buf
    return buf[:numel]


def _run(call, mesh, dim: str, operands: tuple[torch.Tensor, ...], reads: tuple[int, ...],
         writes: tuple[int, ...]) -> None:
    """``call(*operands, group)`` over ``dim``'s group, by its backend for
    the operands' device. Under gloo with CUDA operands, the operands at
    ``reads`` go to the pinned host buffer first and those at ``writes``
    come back after."""
    group = mesh.get_group(dim)
    t0 = time.perf_counter()
    dev = operands[0].device
    if dev.type == "cuda" and backend(group, dev) == "gloo":
        buf = _staging(operands[0].dtype, sum(t.numel() for t in operands))
        host, off = [], 0
        for t in operands:
            host.append(buf[off: off + t.numel()].view(t.shape))
            off += t.numel()
        for i in reads:
            host[i].copy_(operands[i])  # one copy to the host
        call(*host, group)
        for i in writes:
            operands[i].copy_(host[i])  # one copy back
    else:
        call(*operands, group)
    stats["calls"] += 1
    stats["bytes"] += sum(t.numel() * t.element_size() for t in operands)
    stats["seconds"] += time.perf_counter() - t0


def all_gather_into_tensor(out: torch.Tensor, x: torch.Tensor, mesh, dim: str) -> torch.Tensor:
    """Each rank's ``x`` along ``dim``, in rank order, into ``out`` (S times
    ``x``'s elements, block ``j`` from the rank at coordinate ``j``)."""
    import torch.distributed as dist

    if size(mesh, dim) == 1:
        out.view(-1).copy_(x.reshape(-1))
        return out
    # the name torch 2.11 has; later versions keep it beside all_gather_single
    _run(lambda o, i, group: dist.all_gather_into_tensor(o, i, group=group), mesh, dim,
         (out.view(-1), x.contiguous().view(-1)), reads=(1,), writes=(0,))
    return out


def all_reduce(x: torch.Tensor, mesh, dim: str) -> torch.Tensor:
    """``x`` summed over ``dim`` in place, the same bits on every rank."""
    import torch.distributed as dist

    if size(mesh, dim) == 1:
        return x
    _run(lambda t, group: dist.all_reduce(t, group=group), mesh, dim, (x,), reads=(0,),
         writes=(0,))
    return x


def broadcast(x: torch.Tensor, mesh, dim: str, src: int = 0) -> torch.Tensor:
    """``x`` of the rank at coordinate ``src`` along ``dim``, in place, on
    every rank of that dim."""
    import torch.distributed as dist

    if size(mesh, dim) == 1:
        return x
    root = dist.get_global_rank(mesh.get_group(dim), src)
    mine = mesh.get_local_rank(dim) == src
    _run(lambda t, group: dist.broadcast(t, src=root, group=group), mesh, dim, (x,),
         reads=(0,) if mine else (), writes=() if mine else (0,))
    return x


def reduce(x: torch.Tensor, mesh, dim: str, dst: int = 0) -> torch.Tensor:
    """``x`` summed over ``dim``, in place on the rank at coordinate ``dst``
    (the other ranks' ``x`` is undefined after)."""
    import torch.distributed as dist

    if size(mesh, dim) == 1:
        return x
    root = dist.get_global_rank(mesh.get_group(dim), dst)
    mine = mesh.get_local_rank(dim) == dst
    _run(lambda t, group: dist.reduce(t, dst=root, group=group), mesh, dim, (x,), reads=(0,),
         writes=(0,) if mine else ())
    return x


def all_gather(x: torch.Tensor, mesh, dim: str, axis: int = 0) -> torch.Tensor:
    """A new tensor of every rank's ``x`` along ``dim``, the blocks side by
    side on ``axis`` in rank order (``x`` itself without a mesh)."""
    if mesh is None:
        return x
    S, axis = size(mesh, dim), axis % max(x.dim(), 1)
    out = torch.empty((S,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    all_gather_into_tensor(out, x, mesh, dim)
    # (S, ..., n, ...) -> (..., S n, ...)
    return out.movedim(0, axis).reshape(x.shape[:axis] + (S * x.shape[axis],) + x.shape[axis + 1:])
