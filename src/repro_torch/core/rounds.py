"""Federated rounds (port of ``repro/core/rounds.py``): ``FedConfig``, the
round state and the flat synchronous round.

Flat-state engine: the round state ``state["params"]`` is the packed
``(C, N_total)`` buffer of ``core.packing``, one preallocated tensor for the
whole run, and each optimizer moment is one more ``(C, N_total)`` buffer in
the same layout (``optim``). One round:

1. each client that takes part trains E local steps on views of its own row
   (``packing.unpack_views``): the functional model (``yolov3.yolo_loss``,
   or ``transformer.loss_fn`` for every LM family) runs over
   the views, autograd returns the gradient in the packed layout, and the
   optimizer updates the row and its moment rows in place. With
   ``FedConfig.microbatches = m > 1`` each step splits its batch into m
   parts and averages their gradients (and losses). The reference
   vmaps the clients and scans the steps inside one donated jit; here the
   clients are a loop and the steps a Python loop, and the in-place update
   of the one buffer takes the place of donation. The trainer is exposed
   (:func:`local_training`, :func:`train_clients`): the async engines'
   flushes and the row update train through it;
2. the buffer goes straight to the registered aggregator, which writes the
   dispatch into it in place (``core.aggregators``).

Participation comes from the Task Scheduler as NumPy (``participation_input``):
``full`` trains every client; ``masked`` trains only the clients with
``mask[c] == 1``; ``compact`` trains exactly the K = ``max_participants``
clients of the scheduler's ``idx`` (the reference gathers those K rows into
a compact axis for its vmap; the port's client loop trains them in place).
Clients that do not train keep their params and optimizer rows untouched
and report loss 0. The mask, when given, rides into the aggregation and the
mean loss (a bare weight vector means mask ``None``).

The fedsgd topology (``aggregators.FedSGD``, ``stacked = False``) keeps one
shared model copy: ``state["params"]`` is one (N_total,) packed row with
(N_total,) moments, trained on the cohort's batch as one batch
(``(E, C b, ...)``, the reference's layout); nothing is aggregated.

A client mesh (``mesh``, a ``torch.distributed`` ``DeviceMesh`` with a dim
named ``FedConfig.client_axis`` of S ranks) shards the client axis: rank r
holds and trains rows ``[r C/S, (r+1) C/S)`` of the packed buffer and of
every moment buffer (``packing.packed_pspec``), reads its clients' rows of
the whole-cohort batch, and all-gathers ``client_loss``, so every rank
reports the same metrics. quant8 and hier move their own rows
(``Aggregator.local_rows``); every other aggregator gets the whole buffer by
one all-gather, runs unchanged, and the rank keeps its rows of the dispatch
(what XLA's SPMD does for them in the reference).

The mesh's ``"model"`` dim, where its M ranks divide N_total, splits the
flat dim too (``packing.packed_cols``): a rank holds the (C/S, N_total/M)
block of the params, of every moment and of every aggregator buffer along
the flat dim, FSDP-style. Each local step gathers the client's whole row,
runs on the model rank's 1/M of the step's batch and reduce-scatters the
gradient to the rank's block, which the optimizer steps
(:func:`local_training`). A column-local aggregator aggregates the block;
the others get whole rows, gathered over the model axis, and the rank
keeps its block (:func:`aggregate_sharded`). Where M does not divide
N_total, the flat dim stays whole on every model rank and only the batch
splits. fedsgd treats the client axis as data-parallel ranks too: each
takes its clients' part of the merged batch and the gradient is summed
over both axes, so the one shared copy steps identically on every rank.
Every collective goes through ``core.collectives``. The tree layout
(slice 9) raises ``NotImplementedError``.

For the launch plans (``launch.specs``), :func:`state_template` gives the
round state on the ``meta`` device (shapes, no memory) and
:func:`state_pspecs` its specs (``models.params.Spec``, the reference's
``PartitionSpec`` entries): the packed params as the reference's
``packed_pspec``, and each packed moment buffer as a
``packing.SegmentSpec``, every template leaf's segment sharded by the
reference's spec for that leaf's moment, so a plan's per-device bytes are
the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import aggregators, collectives, packing
from repro_torch.models import params as mp
from repro_torch.models import transformer, yolov3
from repro_torch.optim import Optimizer

PyTree = Any


@dataclasses.dataclass(frozen=True)
class FedConfig:
    n_clients: int
    local_steps: int = 1
    aggregation: str = "eq6"  # any name in repro.core.aggregators.names()
    topn: int = 8  # Eq. 6 / static_topn upload budget (layer buckets)
    client_axis: str = "pod"  # mesh axis acting as the federation
    data_axis: str | None = "data"  # within-client data-parallel axis
    round_idx_static: int = 0  # static_topn: trace-time round phase
    microbatches: int = 1  # grad-accumulation splits of each local step
    agg_impl: str = "ref"  # ref (plain torch) | kernel (the K1, K4, K5a, K6, K7, K8 CUDA kernels)
    quant_block: int = 1024  # quant8: elements per int8 scale block
    server_lr: float = 1.0  # fedavgm/fedadam server step (fedadam wants ~0.01-0.1)
    server_momentum: float = 0.9  # fedavgm momentum / fedadam b1
    server_beta2: float = 0.99  # fedadam second-moment decay
    server_eps: float = 1e-3  # fedadam adaptivity floor (Reddi et al. tau)
    trim_ratio: float = 0.25  # trimmed_mean: fraction trimmed per side (>=1 client)
    participation: str = "full"  # full | masked | compact (DESIGN.md §8)
    max_participants: int = 0  # compact: static per-round budget K (0 -> C)
    state_layout: str = "flat"  # flat (packed (C,N) round state) | tree (legacy reference)
    mode: str = "sync"  # sync | async (buffered FedBuff-style engine, DESIGN.md §12)
    buffer_size: int = 0  # async: K_buf staged updates per flush (0 -> n_clients)
    staleness_alpha: float = 0.5  # async: polynomial staleness discount (1+s)^-alpha
    max_staleness: int = 0  # async: drop updates staler than this (0 -> keep all)
    group_size: int = 0  # hier: edge-group width G (DESIGN.md §13; 0 -> C, one group)
    hier_base: str = "dense"  # hier: the registered reducer composed over group rows
    stream: bool = False  # async: streaming O(buffer_size*N) flush (DESIGN.md §13)
    # --- communication frontier (DESIGN.md §15) ---
    topk_frac: float = 0.1  # topk_ef: uploaded fraction k/N of each client delta
    topk_quant: str = "none"  # topk_ef: quantize the selected values (none | quant4)
    quant4_mode: str = "stochastic"  # quant4: stochastic | nearest | skip (dense passthrough)
    quant4_seed: int = 0  # quant4/topk_ef: session seed of the per-round counter PRNG
    secure_domain: str = "int8"  # secure: shared-scale integer ring width (int8 | int4)
    secure_mask: bool = True  # secure: pairwise masks on (False -> plain integer sum)
    secure_session: int = 0  # secure: session key feeding the per-round mask PRNG
    # --- multi-process transport (DESIGN.md §14) ---
    transport: str = "inproc"  # inproc (SimClock event heap) | socket (real wire)
    wire_codec: str = "dense"  # dense | quant8 | quant4 | topk (see transport/codec.py)
    queue_cap: int = 0  # socket: bounded landing-queue depth (0 -> 2 * n_clients)
    heartbeat_s: float = 0.2  # socket: worker heartbeat period (wall seconds)
    heartbeat_timeout_s: float = 2.0  # socket: silence beyond this marks a client dead
    # --- serving plane (DESIGN.md §17) ---
    serve_batch: int = 8  # inference batch slots of the jitted decode+NMS program
    serve_max_wait_s: float = 0.004  # batcher linger: how long a formed batch waits to fill
    serve_max_detections: int = 16  # NMS output slots per served image
    serve_soft_stale_rounds: int = 2  # freshness: rounds-behind beyond this -> soft_stale
    serve_hard_stale_rounds: int = 8  # freshness: rounds-behind beyond this -> hard_stale
    serve_soft_stale_s: float = 60.0  # freshness: seconds-behind beyond this -> soft_stale
    serve_hard_stale_s: float = 600.0  # freshness: seconds-behind beyond this -> hard_stale


def loss_for(cfg) -> Callable:
    """``(params, batch) -> (loss, metrics)`` for the config's family."""
    if cfg.family == "yolo":
        return lambda params, batch: yolov3.yolo_loss(params, batch, cfg)
    return lambda params, batch: transformer.loss_fn(cfg, params, batch)


def make_template(cfg) -> PyTree:
    """The trained model's template: fedyolov3's or any LM family's."""
    if cfg.family == "yolo":
        return yolov3.template(cfg)
    return transformer.template(cfg)


def make_aggregator(cfg, fed: FedConfig, mesh=None) -> aggregators.Aggregator:
    """Resolve ``FedConfig.aggregation`` through the registry (unknown names
    and configurations the port does not run yet fail here)."""
    _check_ported(fed)
    if mesh is not None and fed.client_axis not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"client_axis={fed.client_axis!r} is not a dim of the mesh "
                         f"{mesh.mesh_dim_names}")
    tpl = make_template(cfg)
    spec = packing.build_pack_spec(cfg, tpl)
    cols = packing.packed_cols(spec.n_total, mesh)
    ctx = aggregators.AggContext(cfg=cfg, fed=fed, template=tpl, spec=spec, mesh=mesh,
                                 cols=cols if packing.is_block(cols, spec.n_total) else None,
                                 cols_mesh=mesh)
    return aggregators.get(fed.aggregation)(ctx)


def _check_ported(fed: FedConfig) -> None:
    if fed.state_layout == "tree":
        raise NotImplementedError("state_layout='tree' (the legacy reference path) is slice 9")
    if fed.state_layout != "flat":
        raise ValueError(f"unknown state_layout {fed.state_layout!r}; expected flat|tree")
    if fed.microbatches < 1:
        raise ValueError(f"microbatches={fed.microbatches} must be >= 1")
    if fed.agg_impl not in ("ref", "kernel"):
        raise ValueError(f"unknown agg_impl {fed.agg_impl!r}; expected ref|kernel")


# ---------------------------------------------------------------------------
# Sharding specs (launch plans)
# ---------------------------------------------------------------------------

def stacked_pspecs(template: PyTree, client_axis: str, rules: dict | None = None,
                   axis_sizes: dict | None = None) -> PyTree:
    """Param specs with the leading client dim on ``client_axis``."""
    return mp.map_tree(lambda s: mp.Spec(client_axis, *s), mp.pspecs(template, rules, axis_sizes))


def batch_pspecs(batch_template: PyTree, fed: FedConfig) -> PyTree:
    spec = mp.Spec(fed.client_axis, None, fed.data_axis)  # (C, E, b, ...)
    return mp.map_tree(lambda _: spec, batch_template)


def state_template(cfg, fed: FedConfig, optimizer: Optimizer, dtype: torch.dtype) -> PyTree:
    """The round state of :func:`make_state` on the ``meta`` device, params
    in ``dtype``: what a plan's step function takes, with no memory."""
    agg = make_aggregator(cfg, fed)
    n = agg.ctx.spec.n_total
    packed = torch.empty((fed.n_clients, n), dtype=dtype, device="meta")
    if not agg.stacked:
        return {"params": packed[0], "opt": {k: v[0] for k, v in optimizer.init(packed[:1]).items()},
                "agg": {}, "round": 0}
    return {"params": packed, "opt": optimizer.init(packed), "agg": agg.init_state(packed),
            "round": 0}


def state_pspecs(cfg, fed: FedConfig, optimizer: Optimizer, rules: dict | None = None,
                 opt_rules: dict | None = None, axis_sizes: dict | None = None) -> PyTree:
    """Specs of :func:`state_template`'s leaves. ``opt_rules``: separate
    rules for the optimizer moments, ZeRO-1 style (moments over data while
    params stay TP-only)."""
    agg = make_aggregator(cfg, fed)
    tpl = agg.ctx.template
    mrules = opt_rules if opt_rules else rules
    if not agg.stacked:
        pspec = packing.SegmentSpec.of(tpl, mp.Spec(), rules, axis_sizes)
        mspec = packing.SegmentSpec.of(tpl, mp.Spec(), mrules, axis_sizes)
    else:
        pspec = packing.packed_spec(agg.ctx.spec.n_total, fed.client_axis, axis_sizes)
        mspec = packing.SegmentSpec.of(tpl, mp.Spec(fed.client_axis), mrules, axis_sizes)
    moments = optimizer.init(torch.empty((1, 0), device="meta"))
    return {
        "params": pspec,
        "opt": {k: (mspec if k in ("mu", "m", "v") else mp.Spec()) for k in moments},
        "agg": agg.state_pspecs(axis_sizes) if agg.stacked else {},
        "round": mp.Spec(),
    }


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

def seed_generator(cfg, seed: int, device: str | torch.device = "cuda") -> torch.Generator:
    """The generator an entry point draws its initial model from: fedyolov3's
    on the host, an LM's on ``device`` (a full-width model is 1.7 B values).
    Every engine with one seed starts from one global this way."""
    return torch.Generator(device="cpu" if cfg.family == "yolo" else device).manual_seed(seed)


def initial_row(agg: aggregators.Aggregator, generator: torch.Generator | None = None,
                device: str | torch.device = "cuda",
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The server's first dispatch as one packed (1, N_total) row on
    ``device``, drawn by ``init_params`` from ``generator`` (seed 0 when
    None): row 0 of :func:`make_state`, and the async engines' first global."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    tree = mp.init_params(agg.ctx.template, generator, dtype)
    return packing.pack(agg.ctx.spec, mp.map_tree(lambda x: x[None], tree), dtype).to(device)


def make_state(cfg, fed: FedConfig, optimizer: Optimizer, generator: torch.Generator | None = None,
               device: str | torch.device = "cuda", dtype: torch.dtype = torch.float32,
               mesh=None) -> PyTree:
    """The flat round state on ``device``: every client row starts from one
    model (the server's dispatch, :func:`initial_row`); under a client mesh,
    this rank's rows (``packing.packed_pspec``) and their moments. The
    fedsgd topology holds the one shared (N_total,) row, its (N_total,)
    moments and no aggregator state. Under a mesh whose model axis splits
    the flat dim, each of those is the rank's column block
    (``packing.packed_block``), as is each aggregator buffer along the flat
    dim, copied out so that no rank holds another's part. Parity with the
    reference comes from carrying its state over (``models.convert``)."""
    from repro_torch import device as D

    dev = D.resolve(device)
    agg = make_aggregator(cfg, fed, mesh)
    row = initial_row(agg, generator, dev, dtype)
    rows, cols = packing.packed_block(fed.n_clients, agg.ctx.spec.n_total, fed.client_axis, mesh)
    if not agg.stacked:
        shared = row[:, cols].clone()
        return {"params": shared[0], "opt": {k: v[0] for k, v in optimizer.init(shared).items()},
                "agg": {}, "round": 0}
    full = row.expand(fed.n_clients, -1)  # a view: every client holds the dispatch
    packed = full[rows, cols].clone(memory_format=torch.contiguous_format)
    agg_state = agg.init_state(full)
    if mesh is not None:
        agg_state = agg.state_block(agg_state, rows, cols)
    return {"params": packed, "opt": optimizer.init(packed), "agg": agg_state, "round": 0}


def state_bytes(state: PyTree) -> dict[str, int]:
    """Bytes of a round state's tensors by kind: ``"clients"`` the
    client-stacked buffers along the flat dim (params, moments, error
    feedback), ``"server"`` the flat rows with no client dim (a dispatched
    base, a server global and its moments, fedsgd's shared copy), and
    ``"other"`` the rest (step counts, per-bucket sums), which every rank
    holds whole."""
    flat = aggregators.FLAT_KEYS | {"params"}
    out = {"clients": 0, "server": 0, "other": 0}

    def walk(node, key):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif isinstance(node, torch.Tensor):
            kind = "other" if key not in flat else "clients" if node.dim() >= 2 else "server"
            out[kind] += node.numel() * node.element_size()

    walk(state, None)
    return out


def is_stateless(optimizer: Optimizer) -> bool:
    """True when ``optimizer`` keeps no per-client state between rounds
    (``sgd(momentum=0.0)``): the rule of the row update, the streaming
    flush and the arrival engine, which keep no optimizer rows."""
    return not optimizer.init(torch.empty((1, 0)))


def unpacked_params(cfg, fed: FedConfig, state: PyTree) -> PyTree:
    """Edge helper: the param tree of a flat state (one copy; HWIO for
    fedyolov3, the template's layout for an LM), client-stacked for a
    stacked topology and the one shared tree for fedsgd."""
    tpl = make_template(cfg)
    spec = packing.build_pack_spec(cfg, tpl)
    params = state["params"]
    if params.dim() == 1:  # fedsgd: one shared row
        return mp.map_tree(lambda x: x[0], packing.unpack(spec, params[None], tpl))
    return packing.unpack(spec, params, tpl)


def global_model(cfg, row: torch.Tensor, device: str | torch.device = "cuda"):
    """One packed (N_total,) global row -> the dispatchable model: a
    ``FedYOLOv3`` on ``device`` holding its own copy of the weights, or an
    LM's param tree of copies. Nothing returned aliases ``row``."""
    tpl = make_template(cfg)
    spec = packing.build_pack_spec(cfg, tpl)
    if cfg.family != "yolo":
        return mp.map_tree(lambda x: x[0], packing.unpack(spec, row[None], tpl))
    with torch.device(device):
        return yolov3.FedYOLOv3(cfg, weights=packing.unpack_views(spec, row, tpl)).eval()


# ---------------------------------------------------------------------------
# Participation input and batches
# ---------------------------------------------------------------------------

def static_budget(fed: FedConfig) -> int:
    """Compact mode's static per-round participant count K."""
    return fed.max_participants or fed.n_clients


def participation_input(fed: FedConfig, mask, weights, idx=None) -> dict:
    """Host arrays from the scheduler -> the round's participation operands,
    ``{"mask": (C,) f32, "weights": (C,) f32[, "idx": (K,) int32]}`` host
    tensors (the round reads the mask, or under compact the idx, on the host
    to pick the clients that train, then moves mask and weights to its
    device). ``idx`` is required, and only used, under compact: exactly K
    distinct client indices."""
    part = {
        "mask": torch.as_tensor(np.asarray(mask, np.float32)),
        "weights": torch.as_tensor(np.asarray(weights, np.float32)),
    }
    if fed.participation == "compact":
        if idx is None:
            raise ValueError("compact participation needs the (K,) idx vector")
        idx = np.asarray(idx, np.int32)
        if idx.shape != (static_budget(fed),):
            raise ValueError(
                f"compact idx has shape {idx.shape}; the static budget is "
                f"({static_budget(fed)},) — the scheduler must emit exactly K indices"
            )
        if len(np.unique(idx)) != idx.shape[0]:
            # training rows by idx must be one-to-one: a duplicate would
            # silently train a client twice
            raise ValueError(
                f"compact idx {idx.tolist()} has duplicate "
                "client indices; the scheduler must select K distinct clients"
            )
        part["idx"] = torch.from_numpy(idx)
    return part


def _parse_participation(part, device: torch.device):
    """A bare (C,) weight vector means full participation (mask and idx
    None); a dict is ``participation_input``'s output."""
    if isinstance(part, dict):
        return part["weights"].float().to(device), part["mask"].float(), part.get("idx")
    return torch.as_tensor(part).float().to(device), None, None


def _check_compact_idx(fed: FedConfig, idx) -> None:
    if fed.participation == "compact" and idx is None:
        raise ValueError(
            "compact participation: pass participation_input(fed, mask, "
            "weights, idx), not a bare weight vector"
        )


def to_device(batch: PyTree, device: str | torch.device) -> PyTree:
    """A batch tree of NumPy arrays or tensors -> tensors on ``device``."""
    return mp.map_tree(lambda x: torch.as_tensor(x, device=device), batch)


# ---------------------------------------------------------------------------
# The round
# ---------------------------------------------------------------------------

def local_training(cfg, fed: FedConfig, optimizer: Optimizer, mesh=None, *,
                   shared: bool = False) -> Callable:
    """The local trainer every engine shares: ``local_train(row, opt_row,
    batch) -> mean step loss`` runs ``fed.local_steps`` steps on one packed
    (N_total,) row and its optimizer rows (a dict of the matching rows of
    each state buffer, ``{}`` for a stateless optimizer), in place; ``batch``
    leaves are (E, b, ...). The sync round, the buffered flush, the
    streaming fold and the row update all train through it.

    ``mesh``: the step's batch splits over the P data-parallel ranks, the M
    of the ``"model"`` dim (and with ``shared``, fedsgd's one shared copy,
    the S of the client axis as well: rank (s, j) takes part ``s M + j``).
    Where the model axis splits the flat dim (``packing.packed_cols``) the
    row and its optimizer rows are the rank's column block, and each step
    is FSDP over the flat dim: the client's whole row is all-gathered into
    one reused (N_total,) buffer, ``grads_of`` runs on the rank's part of
    the batch, the packed gradient is reduce-scattered (a sum) to the
    block, divided by the number of parts (a mean), and the optimizer steps
    the block (the clip's norm summed over the model axis). Where the flat
    dim stays whole, the gradient is all-reduced instead and every model
    rank steps the whole row alike. The loss is all-reduced to the mean of
    the parts. Cost: one full row and one full gradient live per rank
    during a step, beside the block state; the collectives run one after
    another, not under the compute. The batch (with ``microbatches`` m > 1:
    the m microbatches) must split into P parts, else ``ValueError``. A
    one-rank mesh takes the same code, its collectives the identity, and
    equals the meshless trainer bit for bit."""
    tpl = make_template(cfg)
    spec = packing.build_pack_spec(cfg, tpl)
    loss_fn = loss_for(cfg)
    N = spec.n_total
    cols = packing.packed_cols(N, mesh)
    blocked = packing.is_block(cols, N)
    M = packing.mesh_axis_size(mesh, "model")
    S = packing.mesh_axis_size(mesh, fed.client_axis) if shared else 1
    P = S * M
    part = ((mesh.get_local_rank(fed.client_axis) if S > 1 else 0) * M
            + (mesh.get_local_rank("model") if M > 1 else 0))
    whole_rows: dict = {}  # the reused (N_total,) row buffer, per device and dtype

    def whole(row: torch.Tensor) -> torch.Tensor:
        if not blocked:
            return row
        buf = whole_rows.get((row.device, row.dtype))
        if buf is None:
            buf = whole_rows[(row.device, row.dtype)] = torch.empty(N, dtype=row.dtype,
                                                                   device=row.device)
        return collectives.all_gather_into_tensor(buf, row, mesh, "model")

    def over_parts(x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the P ranks, in place; a gradient lands as
        the rank's block where the flat dim is split."""
        if blocked and x.dim():
            x = collectives.reduce_scatter_tensor(
                torch.empty(cols.stop - cols.start, dtype=x.dtype, device=x.device), x, mesh,
                "model")
        else:
            collectives.all_reduce(x, mesh, "model")
        if S > 1:
            collectives.all_reduce(x, mesh, fed.client_axis)
        return x

    def grads_of(row: torch.Tensor, step_batch: PyTree):
        """(loss, packed gradient) of one local step at ``row`` (the rank's
        block of it where the flat dim is split): the loss runs over views
        of a detached alias of the whole row, so the gradient comes back as
        one (N_total,) tensor in the packed layout. The step's batch splits
        into T parts, the m microbatches or else the P ranks' parts; the
        rank runs its T / P of them in order, their gradients summed, the
        sum taken over the P ranks (to the rank's block) and divided by T
        once, and the mean loss (the reference's scan). With T = 1, one
        pass over the whole batch."""
        m = fed.microbatches
        T = m if m > 1 else P
        b = next(iter(mp.flatten_with_paths(step_batch)))[1].shape[0]
        if T % P or b % T:
            if P == 1:
                raise ValueError(f"a local batch of {b} does not split into {m} microbatches")
            raise ValueError(f"a local batch of {b}" + (f" in {m} microbatches" if m > 1 else "")
                             + f" does not split over the {P} data-parallel ranks of the mesh "
                             f"({M} on 'model', {S} on {fed.client_axis!r})")
        flat = whole(row).detach().requires_grad_(True)
        views = packing.unpack_views(spec, flat, tpl)
        if T > 1:
            cut = mp.map_tree(lambda x: x.reshape((T, b // T) + x.shape[1:]), step_batch)
        tot = g_sum = None
        for i in range(part * (T // P), (part + 1) * (T // P)):
            loss, _ = loss_fn(views, step_batch if T == 1 else mp.map_tree(lambda x: x[i], cut))
            (g,) = torch.autograd.grad(loss, flat)
            if g_sum is None:  # the first part's gradient is the sum's buffer
                tot, g_sum = loss.detach(), g
            else:
                tot = tot + loss.detach()
                g_sum.add_(g)
            del g
        del views, flat
        tot, g_sum = over_parts(tot), over_parts(g_sum)
        if T == 1:
            return tot, g_sum
        return packing.exact_div(tot, float(T)), packing.exact_div(g_sum, float(T))

    sum_blocks = (lambda x: collectives.all_reduce(x, mesh, "model")) if blocked else None

    def local_train(row: torch.Tensor, opt_row: dict, batch: PyTree) -> torch.Tensor:
        losses = []
        for e in range(fed.local_steps):
            loss, g = grads_of(row, mp.map_tree(lambda x: x[e], batch))
            with torch.no_grad():
                if sum_blocks is None:
                    optimizer.update(row, g, opt_row)
                else:
                    optimizer.update(row, g, opt_row, sum_blocks)
            losses.append(loss)
        return torch.stack(losses).mean()

    return local_train


def train_clients(local_train: Callable, packed: torch.Tensor, opt: dict, batch: PyTree,
                  on: np.ndarray, own: slice = slice(None)) -> torch.Tensor:
    """Train, in place, every client ``c`` of this rank's rows ``own`` (row
    ``c - own.start`` of ``packed`` and of each ``opt`` buffer) with
    ``on[c]``, on its batch ``batch[c]`` -> the (rows,) loss, 0 for a client
    that sat out (its rows untouched)."""
    start = own.start or 0
    loss = torch.zeros(packed.shape[0], dtype=torch.float32, device=packed.device)
    for r in range(packed.shape[0]):
        c = start + r
        if on[c]:
            loss[r] = local_train(packed[r], {k: v[r] for k, v in opt.items()},
                                  mp.map_tree(lambda x: x[c], batch))
    return loss


def build_fed_round(cfg, fed: FedConfig, optimizer: Optimizer, mesh=None) -> Callable:
    """Returns ``fed_round(state, batch, part) -> (state, metrics)``.

    batch: ``{"images" (C, E, b, H, W, 3), "targets": per scale {"obj",
    "box", "cls"} (C, E, b, ...)}`` for detection, ``{"tokens" (C, E, b,
    S)}`` for an LM, on the state's device (``to_device``); the whole
    cohort's batch on every rank of a client mesh. fedsgd takes the
    cohort's batch as one, ``(E, C b, ...)`` (:func:`merge_clients`).
    part: a bare (C,) normalized weight vector (full participation) or the
    ``participation_input`` dict. metrics: ``{"loss": participant mean,
    "client_loss": (C,)}``, tensors on the device (no host sync).

    mesh: a ``torch.distributed`` ``DeviceMesh`` with a dim named
    ``fed.client_axis`` (module docstring), or None.
    """
    if fed.mode != "sync":
        # this builder always emits the synchronous round; the buffered
        # control plane builds its full-buffer flush through here with
        # mode="sync"
        raise ValueError(
            f"build_fed_round builds the synchronous round (mode='sync'), got "
            f"mode={fed.mode!r}; drive async mode through "
            "core/async_engine.BufferedAsyncEngine or FLServer"
        )
    agg = make_aggregator(cfg, fed, mesh)
    if fed.participation not in ("full", "masked", "compact"):
        raise ValueError(
            f"unknown participation {fed.participation!r}; expected full|masked|compact"
        )
    if fed.participation != "full" and not agg.stacked:
        raise ValueError(
            f"participation={fed.participation!r} needs a client-stacked "
            "topology; fedsgd runs one shared model copy (use participation='full')"
        )
    if fed.participation == "compact" and not 1 <= static_budget(fed) <= fed.n_clients:
        raise ValueError(
            f"compact participation: max_participants={fed.max_participants} "
            f"must be in [1, n_clients={fed.n_clients}]"
        )
    C = fed.n_clients
    S = packing.mesh_axis_size(mesh, fed.client_axis)
    if S > 1 and C % S:
        raise ValueError(
            f"sharded client axis: n_clients={C} must be "
            f"divisible by the '{fed.client_axis}' mesh axis ({S} shards)"
        )
    own = packing.packed_pspec(C, fed.client_axis, mesh)
    local_train = local_training(cfg, fed, optimizer, mesh, shared=not agg.stacked)

    def fedsgd_round(state: PyTree, batch: PyTree):
        # clients = data-parallel shards of one batch, so param-averaging is
        # gradient-averaging for E = 1: one shared copy trains on it (over a
        # sharded client axis, each rank on its clients' part of it)
        loss = local_train(state["params"], state["opt"], batch)
        out = {**state, "round": state["round"] + 1}
        return out, {"loss": loss, "client_loss": loss.expand(C).clone()}

    def fed_round(state: PyTree, batch: PyTree, part):
        if not agg.stacked:
            return fedsgd_round(state, batch)
        packed = state["params"]
        weights, mask, idx = _parse_participation(part, packed.device)
        _check_compact_idx(fed, idx)
        if fed.participation == "compact":
            on = np.zeros(C, bool)
            on[idx.numpy()] = True
        elif fed.participation == "masked" and mask is not None:
            on = mask.numpy() > 0
        else:  # full participation trains every client; the mask still
            on = np.ones(C, bool)  # shapes the aggregate and the mean loss
        loss = train_clients(local_train, packed, state["opt"], batch, on, own)
        mask_d = None if mask is None else mask.to(packed.device)
        if S > 1:
            loss = aggregators.gather_clients(loss, fed, mesh)
        packed, agg_state = aggregate_sharded(agg, packed, weights, state["agg"], mask_d)
        out = {**state, "params": packed, "agg": agg_state, "round": state["round"] + 1}
        return out, round_metrics(loss, mask_d)

    return fed_round


def aggregate_sharded(agg: aggregators.Aggregator, packed: torch.Tensor, weights: torch.Tensor,
                      agg_state: PyTree, mask: torch.Tensor | None = None):
    """The registered aggregate over this rank's block of the round buffer,
    written into it in place -> (packed, new aggregator state, the rank's
    block of it). Without a mesh, ``agg.aggregate`` itself. Over a model
    axis that splits the flat dim, an aggregator that is not column-local
    gets whole rows (the buffer and its flat state leaves all-gathered over
    ``"model"``); over a sharded client axis, one that does not move its own
    rows gets all C rows (the buffer and its client-stacked state leaves
    all-gathered over the client axis). The rank keeps its block of what
    comes out."""
    ctx = agg.ctx
    fed, mesh = ctx.fed, ctx.mesh
    wide = ctx.cols is not None and not agg.local_cols
    tall = packing.mesh_axis_size(mesh, fed.client_axis) > 1 and not agg.local_rows
    if not (wide or tall):
        return agg.aggregate(packed, weights, agg_state, mask)
    x, st = packed, agg_state
    if wide:
        x = collectives.all_gather(x, mesh, "model", axis=-1)
        st = aggregators.map_state(st, cols=lambda t: collectives.all_gather(t, mesh, "model", -1))
    if tall:
        x = aggregators.gather_clients(x, fed, mesh)
        if agg.row_state:
            st = aggregators.map_state(st, rows=lambda t: aggregators.gather_clients(t, fed, mesh))
    out, st = agg.aggregate(x, weights, st, mask)
    rows = packing.packed_pspec(fed.n_clients, fed.client_axis, mesh) if tall else slice(None)
    cols = ctx.cols if wide else slice(None)
    packed.copy_(out[rows, cols])
    return packed, agg.state_block(st, rows if tall else None, cols if wide else None)


def merge_clients(batch: PyTree) -> PyTree:
    """A client-stacked batch ``(C, E, b, ...)`` -> fedsgd's one batch
    ``(E, C b, ...)`` (client-major within each step)."""
    return mp.map_tree(lambda x: x.transpose(0, 1).reshape(
        (x.shape[1], x.shape[0] * x.shape[2]) + tuple(x.shape[3:])), batch)


def round_metrics(loss: torch.Tensor, mask: torch.Tensor | None) -> dict:
    if mask is None:
        mean_loss = torch.mean(loss)
    else:
        mean_loss = torch.sum(loss * mask) / torch.clamp_min(torch.sum(mask), 1.0)
    return {"loss": mean_loss, "client_loss": loss}


def uniform_weights(n_clients: int) -> torch.Tensor:
    """Paper Eq. 5: unweighted average."""
    return torch.full((n_clients,), 1.0 / n_clients, dtype=torch.float32)
