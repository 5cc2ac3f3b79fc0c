"""Op-level costs of a plan's step: the port's counterpart of the reference's
``repro/launch/hlo_analysis.py``.

The reference parses the compiled HLO text of its jitted step. The port has
no HLO: it counts by running the step. :class:`OpCounter`, a
``TorchDispatchMode``, sees every aten op the step runs below autograd, so
a checkpointed layer's recompute and every layer of a Python loop count as
they run (the reference's while-loop trip counts come for free):

- FLOPs: per aten op by ``torch.utils.flop_counter``'s formulas (products:
  mm, bmm, addmm, baddbmm, convolutions, attention), plus mv, addmv and dot
  (2 per multiply-add), split by the operands' dtype into the rate kinds of
  ``launch.roofline`` (``"fp32"`` for f32 products: cuBLAS with TF32 off;
  ``"bf16"``). Elementwise ops are not counted, as in the reference.
- HBM traffic, the eager kernel-boundary model: each op moves its operands
  and writes its result (an in-place op reads its target only where it uses
  it; a fill or a copy writes it). This is the eager counterpart of the
  reference's fusion-boundary model. Views and bookkeeping ops are free.
- Peak bytes: the live storages, the step's inputs included, followed by
  weak-reference finalizers (the reference reads ``memory_analysis()``).
- The hand-written kernels: a kernel launched through ``ctypes`` is not an
  aten op, so K9, K10 and K1 report their own products, other operations and
  bytes (``kernels.costs``) where they launch on the card and where they run
  on the ``meta`` device (an empty output of the kernel's shape, no launch).
  A counted round on the card and its trace on ``meta`` count the same.

:func:`trace_plan` runs one step of ``specs.step_fn(plan)`` on ``meta`` (no
memory, no card) at the shapes the plan gives one client, or one serving
replica, at full model width, on the kernel path (K9, K10) the card runs:
the plain attention would materialize the S x S scores (2 TB at
``prefill_32k``) that the kernel path never holds. The collectives are not
traced (one process, no mesh): :func:`collectives` counts them from the
plan's rules, by kind: the tensor-parallel all-reduces of every block, the
FSDP all-gathers and reduce-scatters of the ``"data"``-sharded weights, the
within-client gradient all-reduce, and the aggregation over the client
axis. A group whose ranks span more than a node's 8 cards crosses nodes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from collections import defaultdict
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import costs as kcosts
from repro_torch.launch.mesh import NODE_CARDS
from repro_torch.models.params import PROD_AXIS_SIZES

aten = torch.ops.aten
PyTree = Any

# bookkeeping: no bytes move
_FREE = {
    aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty, aten.new_empty_strided,
    aten.detach, aten.alias, aten.lift_fresh, aten.set_, aten.resize_, aten.sym_size,
    aten.sym_stride, aten.sym_numel, aten.sym_storage_offset, aten.is_same_size,
    aten._local_scalar_dense,
}
# in-place ops that write their target without reading it
_WRITE_ONLY = {aten.copy_, aten.fill_, aten.zero_, aten.normal_, aten.uniform_, aten.random_,
               aten.bernoulli_, aten.exponential_}
_MATVEC = {aten.mv, aten.addmv, aten.dot, aten.vdot}


def _kind(dtype: torch.dtype) -> str:
    return "bf16" if dtype in (torch.bfloat16, torch.float16) else "fp32"


def _tensors(tree, out: list | None = None) -> list[torch.Tensor]:
    """The tensors of nested tuples, lists and dicts, in order (a plain walk:
    the op counter calls it twice an op, and ``tree_flatten`` costs a third
    of a trace)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclasses.dataclass
class Costs:
    flops: dict = dataclasses.field(default_factory=lambda: defaultdict(float))  # by rate kind
    other_ops: float = 0.0  # the kernels' non-product operations (FP32 units)
    traffic: float = 0.0  # HBM bytes
    input_bytes: int = 0  # the step's inputs (live at the start)
    peak_bytes: int = 0  # live storages at their most, inputs included
    ops: int = 0  # aten ops counted
    kernels: dict = dataclasses.field(default_factory=dict)  # name -> launches, flops, bytes

    @property
    def total_flops(self) -> float:
        return float(sum(self.flops.values()))

    def as_dict(self) -> dict:
        return {"flops": self.total_flops, "flops_by_kind": dict(self.flops),
                "other_ops": self.other_ops, "traffic_bytes": self.traffic,
                "input_bytes": self.input_bytes, "peak_bytes": self.peak_bytes,
                "ops": self.ops, "kernels": self.kernels}


class OpCounter(TorchDispatchMode):
    """Counts FLOPs, traffic and live bytes of what runs inside it (module
    docstring), on any device. ``inputs``: tensors already live when the
    count starts (the step's arguments)."""

    def __init__(self, inputs=()):
        super().__init__()
        self.costs = Costs()
        self._live: dict[int, int] = {}
        self._now = 0
        for t in _tensors(inputs):
            self._track(t)
        self.costs.input_bytes = self.costs.peak_bytes = self._now

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        self._live[key] = st.nbytes()
        self._now += st.nbytes()
        self.costs.peak_bytes = max(self.costs.peak_bytes, self._now)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self._now -= self._live.pop(key, 0)

    def kernel(self, name: str, flops: float, other: float, nbytes: float, kind: str) -> None:
        self.costs.flops[kind] += flops
        self.costs.other_ops += other
        self.costs.traffic += nbytes
        k = self.costs.kernels.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        k["launches"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        self.costs.ops += 1
        ins = _tensors((args, kwargs))
        if packet in flop_registry:
            self.costs.flops[_kind(ins[0].dtype)] += flop_registry[packet](*args, **kwargs,
                                                                           out_val=out)
        elif packet in _MATVEC:
            mat = max(ins, key=lambda t: t.numel())
            self.costs.flops[_kind(mat.dtype)] += 2.0 * mat.numel()
        outs = _tensors(out)
        if packet not in _FREE and not func.is_view:
            moved = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
            if packet in _WRITE_ONLY and ins:
                moved -= _nbytes(ins[0])  # the target is written, not read
            self.costs.traffic += moved
        for t in outs:
            self._track(t)
        return out


def count(fn: Callable, *args, live=()) -> tuple[Any, Costs]:
    """Run ``fn(*args)`` under an :class:`OpCounter` (the kernels' reports
    included) -> (its result, the costs). ``live``: tensors the step finds
    already made beside its arguments (a cache it reads), counted live from
    the start."""
    counter = OpCounter((args, live))
    with kcosts.collect(counter.kernel), counter:
        result = fn(*args)
    return result, counter.costs


# ---------------------------------------------------------------------------
# A plan's replica
# ---------------------------------------------------------------------------

def _size(sizes: dict, axes) -> int:
    n = 1
    for a in axes if isinstance(axes, tuple) else (axes,):
        if a is not None:
            n *= sizes.get(a, 1)
    return n


def replica(plan, axis_sizes: dict | None = None, impl: str = "kernel"):
    """(the plan cut to one client or one serving replica, its batch): the
    clients a device's slice of the client axis holds and their rows of the
    batch, at full model width. ``impl="kernel"`` runs attention and the SSD
    on K9 and K10, as on the card; ``"ref"`` keeps the plan's plain paths."""
    sizes = PROD_AXIS_SIZES if axis_sizes is None else axis_sizes
    arch = plan.arch
    if impl == "kernel":
        arch = dataclasses.replace(arch, attention_impl="kernel", ssm_impl="kernel")
    B = plan.shape.global_batch
    fed = plan.fed
    if plan.kind == "train":
        C = fed.n_clients // _size(sizes, fed.client_axis)
        b = B // fed.n_clients // (_size(sizes, fed.data_axis) if fed.data_axis else 1)
        fed, batch = dataclasses.replace(fed, n_clients=C), C * b
    elif plan.kind == "fedsgd":
        dp = ("pod", "data") if plan.multi_pod else ("data",)
        fed, batch = dataclasses.replace(fed, n_clients=1), B // _size(sizes, dp)
    else:
        batch = -(-B // _size(sizes, plan.dp_axes)) if B > 1 else B
    return dataclasses.replace(plan, arch=arch, fed=fed), batch


def trace_plan(plan, axis_sizes: dict | None = None, impl: str = "kernel",
               dtype: torch.dtype = torch.bfloat16) -> Costs:
    """One step of the plan's replica (:func:`replica`) on the ``meta``
    device, params in ``dtype``, counted."""
    from repro_torch.launch import specs

    rplan, batch = replica(plan, axis_sizes, impl)
    args, _ = specs.input_specs(rplan, batch, dtype)
    with torch.no_grad() if rplan.kind in ("prefill", "decode") else contextlib.nullcontext():
        return count(specs.step_fn(rplan), *args)[1]


# ---------------------------------------------------------------------------
# Collectives, from the plan's rules
# ---------------------------------------------------------------------------

def _span(sizes: dict, axes: tuple) -> int:
    """Ranks between the first and last of a group over ``axes`` in the
    row-major mesh of ``sizes`` (its dims in order)."""
    names = list(sizes)
    span = 0
    for a in axes:
        stride = math.prod(sizes[n] for n in names[names.index(a) + 1:])
        span += (sizes[a] - 1) * stride
    return span + 1


def collectives(plan, param_bytes: float, row_bytes: float, tokens: int,
                axis_sizes: dict | None = None, esize: int = 2) -> list[dict]:
    """The plan's collectives per device per step: ``{"kind", "axes",
    "bytes", "count", "cross_node"}`` rows, ``bytes`` each operation's result
    on a device (all of them: ``bytes * count``). ``param_bytes``: the model
    in the step's dtype; ``row_bytes``: one client's packed row; ``tokens``:
    the replica's tokens a step (all microbatches)."""
    sizes = PROD_AXIS_SIZES if axis_sizes is None else axis_sizes
    arch, out = plan.arch, []

    def add(kind, axes, nbytes, n):
        axes = tuple(a for a in axes if sizes.get(a, 1) > 1)
        if axes and n and nbytes:
            out.append({"kind": kind, "axes": axes, "bytes": float(nbytes), "count": int(n),
                        "cross_node": _span(sizes, axes) > NODE_CARDS})

    m = sizes.get("model", 1)
    train = plan.kind in ("train", "fedsgd")
    # tensor parallel: a row-parallel output all-reduce per mixer and per
    # FFN of every block (one for a Mamba2 block); training runs the
    # forward, its recompute and the backward's input gradients
    blocks = arch.n_layers * (1 if arch.family == "ssm" else 2)
    if arch.family == "hybrid":
        blocks = arch.n_layers + 2 * (arch.n_layers // arch.shared_attn_period)
    act = tokens * arch.d_model * esize
    micro = plan.fed.microbatches if train else 1
    add("all-reduce", ("model",), act / micro, blocks * micro * (3 if train else 1))
    fsdp = plan.rules.get("embed") == "data"
    w_dev = param_bytes / m  # a device's model shard, gathered over data
    if fsdp and train:
        add("all-gather", ("data",), w_dev, 2 * micro)  # forward and recompute/backward
        add("reduce-scatter", ("data",), w_dev, micro)  # the gradients
    elif fsdp:
        add("all-gather", ("data",), w_dev, 1)
    elif train and plan.fed.data_axis:
        add("all-reduce", (plan.fed.data_axis,), w_dev, plan.fed.local_steps)
    if plan.kind == "train":  # the aggregation over the client axis
        add("all-reduce", (plan.fed.client_axis,), row_bytes / m, 1)
    return out


def collective_totals(rows: list[dict]) -> tuple[dict, dict, dict]:
    """(bytes by kind, operations by kind, cross-node bytes by kind)."""
    nbytes, ops, cross = defaultdict(float), defaultdict(int), defaultdict(float)
    for r in rows:
        nbytes[r["kind"]] += r["bytes"] * r["count"]
        ops[r["kind"]] += r["count"]
        if r["cross_node"]:
            cross[r["kind"]] += r["bytes"] * r["count"]
    return dict(nbytes), dict(ops), dict(cross)
