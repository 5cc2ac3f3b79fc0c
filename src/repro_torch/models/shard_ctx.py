"""Activation-sharding context (port of ``repro/models/shard_ctx.py``).

The reference sets an activation ``PartitionSpec`` here because GSPMD's
cost model sometimes resolves the weights-over-data (FSDP) against
batch-over-data conflict by replicating the batch; the model constrains
its activations at block boundaries. PyTorch has no GSPMD to fight: a
tensor's placement is what the program gives it. The context keeps the
reference's API and reset semantics so a plan's step function
(``launch.specs.step_fn``) states the same layout, and :func:`constrain`
enforces it where it means something: on a plain tensor it is the
identity; on a ``DTensor`` it redistributes to the batch placements (dim 0
on the batch axes, dim 1 on the sequence axis under ``seqpar``), every
other mesh dim replicated.
"""
from __future__ import annotations

import contextlib
from contextvars import ContextVar

import torch

_ACT_BATCH: ContextVar[tuple | None] = ContextVar("act_batch_axes", default=None)
_ACT_SEQ: ContextVar[str | None] = ContextVar("act_seq_axis", default=None)


@contextlib.contextmanager
def activation_sharding(batch_axes: tuple | None, seq_axis: str | None = None):
    """batch_axes: mesh axes for the leading batch dim of (B, S, D) acts.
    seq_axis: optional sequence-parallel axis (Megatron-SP): the residual
    stream between blocks is sharded over S."""
    tok = _ACT_BATCH.set(batch_axes)
    tok2 = _ACT_SEQ.set(seq_axis)
    try:
        yield
    finally:
        _ACT_BATCH.reset(tok)
        _ACT_SEQ.reset(tok2)


def constrain(x: torch.Tensor) -> torch.Tensor:
    """Constrain an activation whose dim 0 is the batch dim: the identity on
    a plain tensor or outside :func:`activation_sharding`; a ``DTensor``
    is redistributed to the context's placements."""
    axes = _ACT_BATCH.get()
    if axes is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return x
    names = x.device_mesh.mesh_dim_names or ()
    seq = _ACT_SEQ.get()
    want = [Replicate() for _ in names]
    for i, name in enumerate(names):
        if name in axes:
            want[i] = Shard(0)
        elif seq is not None and name == seq and x.ndim > 1:
            want[i] = Shard(1)
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)
