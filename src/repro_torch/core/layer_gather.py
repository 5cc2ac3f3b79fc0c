"""The layer-by-layer gather of a model-sharded local step (no counterpart
in the reference, where GSPMD gathers each leaf inside the scanned
``jax.checkpoint`` units from the packed buffer's ``P(client, "model")``
annotation).

Where the mesh's ``"model"`` axis splits the flat dim
(``packing.packed_cols``), a rank holds a contiguous block of each packed
row. A local step then gathers the row one *unit* at a time, as the
forward and the checkpointed recompute reach it, and reduces each unit's
gradient into the rank's block gradient as the backward finishes it
(:class:`Gather`, :class:`GatherUnit`). A rank holds its block, its block
gradient, the rest unit and one layer with their gradients; never a whole
row or a whole gradient.

Units (:func:`build_plan`):

- the *rest unit*: every leaf outside a layer stack (embed, final norm, a
  head, llava's ``img_proj``, zamba2's ``shared`` block; the whole of
  fedyolov3, which has no stack). It is gathered once per forward pass and
  held to its end, since the tied head reads the embedding last;
- one unit per layer entry of each stack (:data:`STACKS`): ``layers/i``,
  ``tail/i``, and ``groups/g/i`` / ``mamba_groups/g/i`` for each layer of
  gemma3's period groups and zamba2's Mamba2 groups.

A layer entry of a stacked leaf is a contiguous range of the leaf's slot,
so a unit is a list of flat ranges in packed order. The blocks are
contiguous and in rank order, so the pieces of a unit that one rank owns
are one contiguous *segment* of the unit's buffer.

Collectives (through ``core.collectives``): a unit's forward broadcasts
each segment from its owner; its backward reduces (a sum) each segment of
the unit's gradient to its owner, which copies it into its block gradient
(or adds it, for the second and later microbatches of a step). A broadcast
per owner moves each byte of the unit once. A padded all-gather would move
M times the largest owner's part: the blocks cut the units unevenly (the
rest unit of a tied LM lies wholly in block 0, a layer crosses at most a
boundary or two). A unit takes one collective per owner in each direction.

:data:`stats` counts units gathered and their bytes, and the live and
high-water bytes of this module's buffers: the gathered units and the unit
gradients a backward holds. :func:`reset_stats` zeroes them.
"""
from __future__ import annotations

import dataclasses
import math
import weakref

import numpy as np
import torch

from repro_torch.core import collectives
from repro_torch.models.params import flatten_with_paths, unflatten

# the layer stacks of the LM templates: key -> leading stacked dims
STACKS = {"layers": 1, "tail": 1, "groups": 2, "mamba_groups": 2}

stats = {"units": 0, "bytes": 0, "live": 0, "high": 0}


def reset_stats() -> None:
    """Zero the counts; the high-water restarts from what is live now."""
    stats.update(units=0, bytes=0, high=stats["live"])


def _hold(nbytes: int) -> None:
    stats["live"] += nbytes
    stats["high"] = max(stats["high"], stats["live"])


def _drop(nbytes: int) -> None:
    stats["live"] -= nbytes


@dataclasses.dataclass(frozen=True)
class Segment:
    owner: int  # the model coordinate whose block holds these elements
    lo: int  # the segment within the unit's buffer
    hi: int
    pieces: tuple[tuple[int, int], ...]  # (flat offset, length) runs, in buffer order


@dataclasses.dataclass(frozen=True)
class Unit:
    key: tuple  # () for the rest unit, (stack, i) or (stack, g, i) for a layer
    size: int  # elements
    leaves: tuple[tuple[str, tuple[int, ...]], ...]  # (path within the unit, shape)
    segments: tuple[Segment, ...]


@dataclasses.dataclass(frozen=True)
class Plan:
    n_total: int
    block: int  # elements of each rank's block
    rest: Unit
    layers: dict  # (stack, *idx) -> Unit
    counts: dict  # stack -> its leading stacked dims
    likes: dict  # "" (the rest) or a stack -> the template subtree the views fill

    def units(self) -> list[Unit]:
        return [self.rest, *self.layers.values()]


def _unit(key: tuple, ranges: list[tuple[str, tuple[int, ...], int, int]], k: int) -> Unit:
    """A unit from its leaves' (path, shape, flat offset, size), in packed
    order; its runs cut at the block edges into one segment per owner."""
    runs: list[list[int]] = []
    for _, _, off, n in ranges:
        if runs and runs[-1][0] + runs[-1][1] == off:
            runs[-1][1] += n
        else:
            runs.append([off, n])
    segs: dict[int, list] = {}
    pos = 0
    for off, n in runs:
        while n:
            owner = off // k
            take = min(n, (owner + 1) * k - off)
            seg = segs.setdefault(owner, [pos, pos, []])
            seg[1] += take
            seg[2].append((off, take))
            pos, off, n = pos + take, off + take, n - take
    return Unit(key, pos, tuple((p, s) for p, s, _, _ in ranges),
                tuple(Segment(o, lo, hi, tuple(p)) for o, (lo, hi, p) in sorted(segs.items())))


def build_plan(spec, template, M: int) -> Plan:
    """The static plan of a packed row split into ``M`` equal blocks:
    the rest unit and one unit per layer entry of each stack."""
    k = spec.n_total // M
    counts = {key: next(flatten_with_paths(template[key]))[1].shape[:lv]
              for key, lv in STACKS.items() if key in template}
    rest: list = []
    entries: dict[tuple, list] = {}
    for s in spec.slots:
        top, _, sub = s.name.partition("/")
        if top not in counts:
            rest.append((s.name, s.shape, s.offset, s.size))
            continue
        lead = counts[top]
        shape = s.shape[len(lead):]
        per = max(math.prod(shape), 1)
        for i, idx in enumerate(np.ndindex(*lead)):
            entries.setdefault((top,) + tuple(int(j) for j in idx), []).append(
                (sub, shape, s.offset + i * per, per))
    likes = {"": {key: v for key, v in template.items() if key not in counts},
             **{key: template[key] for key in counts}}
    return Plan(spec.n_total, k, _unit((), rest, k),
                {key: _unit(key, ranges, k) for key, ranges in entries.items()}, counts, likes)


class Gather:
    """One local trainer's gather over a model axis of M ranks, this rank
    at model coordinate ``j`` holding ``plan``'s block ``j``. Each forward
    pass runs between :meth:`begin` and :meth:`finish`: :meth:`rest` gives
    the rest unit's views, :meth:`entries` the layers as thunks that the
    trunk calls inside each layer's checkpoint."""

    def __init__(self, plan: Plan, mesh):
        # torch imports this at its first checkpoint, inside a step, and the
        # import's frames would hold that step's gathered units in a
        # reference cycle until the collector ran
        import torch._dynamo  # noqa: F401

        self.plan, self.mesh = plan, mesh
        self.j = mesh.get_local_rank("model")
        self.c0 = self.j * plan.block
        self.block = self.grad = self.anchor = None
        self.accumulate, self.reduced = False, []

    def begin(self, block: torch.Tensor, grad: torch.Tensor, accumulate: bool) -> torch.Tensor:
        """Start a pass over ``block``: each unit's reduced gradient lands
        in ``grad`` (the rank's block gradient), copied, or added with
        ``accumulate``. Returns the pass's anchor, the tensor to take the
        gradient of the loss by (``torch.autograd.grad(loss, anchor)``)."""
        self.block, self.grad, self.accumulate, self.reduced = block.detach(), grad, accumulate, []
        self.anchor = torch.zeros((), device=block.device, requires_grad=True)
        return self.anchor

    def finish(self) -> None:
        """Every unit's gradient was reduced once this pass."""
        want = [u.key for u in self.plan.units()]
        if sorted(self.reduced) != sorted(want):
            raise RuntimeError(f"the pass reduced units {sorted(self.reduced)}, not {sorted(want)}")
        self.block = self.anchor = None

    def __contains__(self, key: str) -> bool:
        return key in self.plan.counts

    def rest(self):
        return self._views(self.plan.rest, self.plan.likes[""])

    def entries(self, key: str, levels: int = 1) -> list:
        """The layers of stack ``key`` as thunks (a list of lists for a
        two-level stack), each gathering its layer when called."""
        lead = self.plan.counts[key]
        assert len(lead) == levels, (key, lead, levels)
        like = self.plan.likes[key]

        def thunk(idx):
            return lambda: self._views(self.plan.layers[(key,) + idx], like)

        if levels == 1:
            return [thunk((i,)) for i in range(lead[0])]
        return [[thunk((g, i)) for i in range(lead[1])] for g in range(lead[0])]

    def _views(self, unit: Unit, like):
        buf = GatherUnit.apply(self.anchor, self, unit)
        parts = torch.split(buf, [max(math.prod(s), 1) for _, s in unit.leaves])
        return unflatten(like, {p: x.view(s) for (p, s), x in zip(unit.leaves, parts)})

    def assemble(self, unit: Unit) -> torch.Tensor:
        """The unit's buffer: each segment copied out of its owner's block
        and broadcast from there."""
        buf = torch.empty(unit.size, dtype=self.block.dtype, device=self.block.device)
        nbytes = buf.numel() * buf.element_size()
        _hold(nbytes)
        weakref.finalize(buf, _drop, nbytes)
        with torch.no_grad():
            for seg in unit.segments:
                if seg.owner == self.j:
                    pos = seg.lo
                    for off, n in seg.pieces:
                        buf[pos: pos + n].copy_(self.block[off - self.c0: off - self.c0 + n])
                        pos += n
                collectives.broadcast(buf[seg.lo: seg.hi], self.mesh, "model", src=seg.owner)
        stats["units"] += 1
        stats["bytes"] += nbytes
        return buf

    def scatter(self, unit: Unit, g: torch.Tensor) -> None:
        """The unit's gradient summed over the model ranks, each segment to
        its owner, into the owner's block gradient."""
        g = g.contiguous()
        nbytes = g.numel() * g.element_size()
        _hold(nbytes)
        with torch.no_grad():
            for seg in unit.segments:
                collectives.reduce(g[seg.lo: seg.hi], self.mesh, "model", dst=seg.owner)
                if seg.owner != self.j:
                    continue
                pos = seg.lo
                for off, n in seg.pieces:
                    dst = self.grad[off - self.c0: off - self.c0 + n]
                    (dst.add_ if self.accumulate else dst.copy_)(g[pos: pos + n])
                    pos += n
        _drop(nbytes)
        self.reduced.append(unit.key)


class GatherUnit(torch.autograd.Function):
    """Forward: the unit's buffer gathered from the ranks' blocks
    (:meth:`Gather.assemble`). Backward: the buffer's gradient reduced into
    the block gradient (:meth:`Gather.scatter`), returning no block-sized
    tensor. Its input is the pass's anchor, which ties every unit into the
    graph the loss's gradient is taken through."""

    @staticmethod
    def forward(ctx, anchor, gather: Gather, unit: Unit):
        ctx.gather, ctx.unit = gather, unit
        return gather.assemble(unit)

    @staticmethod
    def backward(ctx, g):
        ctx.gather.scatter(ctx.unit, g)
        return None, None, None
