"""Buffered asynchronous aggregation on a simulated wall clock (port of
``repro/core/async_engine.py``; DESIGN.md §12-§14).

FedVision's clients are camera-edge devices whose upload times, not FLOPs,
set round latency: the sync round waits for the slowest selected client.
Here clients run free, updates land when their simulated completion time
comes, and the server flushes a staleness-weighted aggregate every
``FedConfig.buffer_size`` landed updates.

- :class:`BufferedAsyncEngine` keeps the flat ``(C, N_total)`` round state.
  Row ``c`` holds the global version client ``c`` was dispatched with;
  local training is deferred to the flush (an update is a function of the
  dispatch row, the optimizer row and the batch, so the event queue only
  decides when it lands). A flush trains the staged rows through the sync
  round's own trainer (``rounds.local_training``, ``rounds.train_clients``),
  then runs the registered aggregator with the staleness discount folded
  into the weights, ``w_c (1 + s_c)^-alpha`` (every reducer normalizes by
  its own denominator). The port's aggregators write the global into every
  row in place, so the flush saves the rows still in flight before the
  aggregate and puts them back after it: they keep their dispatch version,
  as the reference's ``where(mask, packed_out, packed_new)`` keeps them.
  With ``buffer_size == C`` every client completes before a flush, no
  update is stale, and the flush IS ``rounds.build_fed_round``'s sync round.
- :class:`StreamingAsyncEngine` keeps no ``(C, N)`` buffer: a ring of
  ``max_staleness + 1`` global rows (the versions a kept update can still
  reference), a running (N,) accumulator and its weight sum. A flush trains
  at most ``_cohort`` rows at a time, gathered from the ring, and folds
  their weighted sum into the accumulator (one f32 matrix-vector product):
  O(buffer · N) memory, never O(C · N).
- :class:`ArrivalAsyncEngine` is driven by an external arrival stream (the
  schedule replay of ``core/transport/replay.py``): updates arrive already
  trained by :func:`build_row_update`, and the flush is the aggregate alone.

The control plane is a deterministic discrete-event simulation in NumPy: a
heap of ``(completion_time, client)`` events (ties pop in client-id order),
a ``SimClock``, and the Explorer's load model stepped by the simulated gap
between events. Completion time is compute under the client's load plus
payload over the paper's 512 KB/s camera uplink. Updates staler than
``max_staleness`` are dropped, counted, and the client redispatched from
the current global.

Tensors live on the engine's ``device`` and are changed in place. Every
row that leaves an engine through ``global_packed_row()`` is a copy: the
next flush or landing rewrites the engine's rows.

The buffered and streaming engines take a client mesh (``mesh=``, as the
sync round does; the arrival engine stays meshless, as in the reference).
The host control plane (event heap, clock, load model, staleness, drops)
runs identically on every rank from the same seed. A buffered rank holds
its rows (and, under a model axis that splits the flat dim, its column
block of each), trains the staged rows it owns, keeps in flight only its
own idle rows, and aggregates as the sync round does
(``rounds.aggregate_sharded``); the fresh global's block goes from the
rank that owns it to the others by one broadcast a flush. A streaming
rank trains the staged rows it owns and folds them into its own
accumulator; the accumulators, weight sums and losses are summed over the
client axis at the flush. Every rank's records equal the meshless
engine's. ``global_packed_row()`` then gathers the whole row: every rank
calls it together.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Any

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.core import aggregators, collectives, explorer, packing
from repro_torch.core import rounds as R
from repro_torch.core.simclock import SimClock
from repro_torch.models import params as mp

PyTree = Any

# -- the bandwidth term (a copy of benchmarks/bandwidth_model.py's) ----------

PER_CHANNEL_B_S = 512e3  # paper: 512 KB/s per camera channel


def upload_seconds(payload_bytes: float, uplink_b_s: float = PER_CHANNEL_B_S) -> float:
    """Seconds to push one model update over a client uplink."""
    return float(payload_bytes) / max(float(uplink_b_s), 1.0)


def client_uplink_scales(n_clients: int, rng, spread: float = 0.5):
    """Per-client uplink multipliers in [1-spread, 1+spread] (uniform), drawn
    once per engine: a camera on a bad link stays on a bad link."""
    if not 0.0 <= spread < 1.0:
        raise ValueError(f"uplink spread must be in [0, 1), got {spread}")
    if spread == 0.0:
        return np.ones(n_clients)
    return rng.uniform(1.0 - spread, 1.0 + spread, n_clients)


# -- timing ------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TimingModel:
    """Per-client completion-time model: compute + upload, in sim seconds.

    ``compute`` scales the idle-client cost by the Explorer load (a client
    at load L runs at (1 - L) effective speed, floored at min_headroom).
    ``upload`` is payload bytes over the paper's camera uplink, with an
    optional stable per-client spread. Zero spread and a zero-variance load
    model give every client the same completion time: the sync-equivalence
    regime.
    """

    base_compute_s: float = 10.0  # one local step on an idle client
    min_headroom: float = 0.05  # floor on (1 - load): max slowdown 20x
    uplink_b_s: float | None = None  # None -> PER_CHANNEL_B_S
    uplink_spread: float = 0.0  # per-client uplink spread in [0, 1)
    payload_bytes: float | None = None  # None -> n_total * 4 (f32 rows)

    def compute_seconds(self, load: float, local_steps: int = 1) -> float:
        return self.base_compute_s * local_steps / max(1.0 - load, self.min_headroom)


def default_upload_terms(timing: TimingModel, n_clients: int, n_total: int, seed: int) -> np.ndarray:
    """The per-client upload seconds both round control planes use: payload
    (``timing.payload_bytes`` or f32 rows of the packed buffer) over
    per-client uplinks drawn from ``seed``."""
    payload = timing.payload_bytes if timing.payload_bytes is not None else n_total * 4
    return client_upload_seconds(timing, n_clients, payload, np.random.default_rng(seed + 1))


def client_upload_seconds(timing: TimingModel, n_clients: int, payload: float, rng) -> np.ndarray:
    """Fixed per-client upload seconds (the bandwidth term)."""
    base = timing.uplink_b_s if timing.uplink_b_s is not None else float(PER_CHANNEL_B_S)
    scales = np.asarray(client_uplink_scales(n_clients, rng, timing.uplink_spread))
    return np.array([upload_seconds(payload, base * s) for s in scales])


def sync_round_seconds(timing: TimingModel, loads: np.ndarray, upload_s: np.ndarray,
                       local_steps: int = 1, mask: np.ndarray | None = None) -> float:
    """Simulated duration of ONE synchronous round: the server waits for
    the slowest participating client (compute under its load + upload)."""
    loads = np.asarray(loads, float)
    per = np.array([timing.compute_seconds(l, local_steps) for l in loads]) + np.asarray(
        upload_s, float)
    if mask is not None:
        per = per[np.asarray(mask) > 0]
    return float(per.max())


@dataclasses.dataclass
class AsyncRoundRecord:
    """One flush. Field names shared with ``server.RoundRecord`` so
    ``core.monitor`` renders either; the async-only fields are the
    simulated wall clock and the per-update staleness."""

    round_idx: int
    loss: float
    weights: list[float]  # staleness-discounted, staged rows only
    seconds: float  # host wall (the simulation's own cost)
    participants: list[int]  # staged clients, completion order
    loads: list[float]
    version: int = 0  # global model version this flush produced
    sim_time: float = 0.0  # simulated wall clock at flush
    staleness: list[int] = dataclasses.field(default_factory=list)
    dropped: int = 0  # stale completions discarded while filling the buffer


def discounted_weights(fed: R.FedConfig, staged: list[int], stal: list[int]) -> tuple[np.ndarray, np.ndarray]:
    """(mask (C,), w_disc (C,)) f32 of a flush: ``mask / |staged|`` times
    the polynomial discount ``(1 + s)^-alpha``, in NumPy f32 as the
    reference computes it (s = 0 gives exactly 1.0, so a fresh buffer keeps
    the undiscounted weights bit for bit)."""
    C = fed.n_clients
    mask = np.zeros(C, np.float32)
    mask[staged] = 1.0
    stal_vec = np.zeros(C, np.float32)
    stal_vec[staged] = stal
    w = mask / np.float32(len(staged))
    w_disc = (w * (1.0 + stal_vec) ** np.float32(-fed.staleness_alpha)).astype(np.float32)
    return mask, w_disc


def _check_async(fed: R.FedConfig, who: str, kind: str) -> int:
    """The checks every engine shares -> the buffer size k."""
    if fed.mode != "async":
        raise ValueError(f"{who} needs FedConfig(mode='async'), got {fed.mode!r}")
    if fed.state_layout != "flat":
        raise ValueError(f"the {kind} engine runs on the flat packed round state "
                         f"(state_layout='flat'), got {fed.state_layout!r}")
    k = fed.buffer_size or fed.n_clients
    if not 1 <= k <= fed.n_clients:
        raise ValueError(
            f"buffer_size={fed.buffer_size} must be in [1, n_clients={fed.n_clients}] (or 0 -> C)")
    if fed.max_staleness < 0:
        raise ValueError(f"max_staleness={fed.max_staleness} must be >= 0")
    return k


def _stacked_aggregator(cfg, fed: R.FedConfig, mesh, aggregator):
    agg = aggregator or R.make_aggregator(cfg, fed, mesh)
    if not agg.stacked:
        raise ValueError(
            f"async mode needs a client-stacked aggregator; {fed.aggregation!r} "
            "runs one shared model copy (fedsgd topology)")
    return agg


def _aggregate_staged(agg, packed: torch.Tensor, mask: np.ndarray, w_disc: np.ndarray,
                      agg_state: PyTree, own: slice = slice(None)) -> PyTree:
    """The registered aggregate over ``packed`` (this rank's rows ``own`` of
    the C) with the discounted weights, in place; the rank's rows with
    ``mask == 0`` (in flight) keep their contents. -> the new aggregator
    state."""
    dev = packed.device
    idle = torch.from_numpy(np.flatnonzero(mask[own] == 0)).to(dev)
    kept = packed.index_select(0, idle)  # the rank's in-flight rows
    _, agg_state = R.aggregate_sharded(agg, packed, torch.from_numpy(w_disc).to(dev), agg_state,
                                       torch.from_numpy(mask).to(dev))
    packed.index_copy_(0, idle, kept)
    return agg_state


def _build_buffered_flush(cfg, fed: R.FedConfig, optimizer, agg, mesh=None):
    """The k < C flush: the staged rows train through the sync round's
    trainer, then the staleness-weighted aggregate; the rows in flight keep
    their dispatch version. -> ``flush(state, batch, part) -> (state,
    metrics)``, ``part`` the host (C,) mask and discounted weights."""
    local_train = R.local_training(cfg, fed, optimizer, mesh)
    own = packing.packed_pspec(fed.n_clients, fed.client_axis, mesh)
    sharded = packing.mesh_axis_size(mesh, fed.client_axis) > 1

    def flush(state, batch, part):
        mask, w_disc = part["mask"], part["weights"]
        packed = state["params"]
        loss = R.train_clients(local_train, packed, state["opt"], batch, mask > 0, own)
        if sharded:
            loss = aggregators.gather_clients(loss, fed, mesh)
        agg_state = _aggregate_staged(agg, packed, mask, w_disc, state["agg"], own)
        out = {**state, "params": packed, "agg": agg_state, "round": state["round"] + 1}
        return out, R.round_metrics(loss, torch.from_numpy(mask).to(packed.device))

    return flush


class BufferedAsyncEngine:
    """Event-driven buffered aggregation (FedBuff-style) over the flat packed
    round state. One ``step_round(batch)`` pops completion events (advancing
    the clock and the load model in simulated time) until ``buffer_size``
    updates stage, then applies one flush."""

    def __init__(self, cfg, fed: R.FedConfig, optimizer, *, mesh=None, seed: int = 0,
                 dtype: torch.dtype = torch.float32, clock: SimClock | None = None,
                 load_model: explorer.ClientLoadModel | None = None,
                 timing: TimingModel | None = None, scheduler=None, aggregator=None,
                 device: str | torch.device = "cuda"):
        self.k_buf = _check_async(fed, "BufferedAsyncEngine", "async")
        if fed.participation != "full":
            raise ValueError(
                "async mode owns its own participation plane (the event "
                f"queue); set participation='full', got {fed.participation!r}")
        if fed.stream and type(self) is BufferedAsyncEngine:
            raise ValueError(
                "FedConfig(stream=True) selects the streaming flush; construct "
                "StreamingAsyncEngine (FLServer dispatches on fed.stream)")
        C = fed.n_clients
        self.cfg, self.fed, self.optimizer = cfg, fed, optimizer
        self.device = D.resolve(device)
        self.agg = _stacked_aggregator(cfg, fed, mesh, aggregator)
        self.clock = clock or SimClock()
        self.load_model = load_model or explorer.ClientLoadModel(C, seed=seed)
        self.scheduler = scheduler
        self.timing = timing or TimingModel()
        self.upload_s = default_upload_terms(self.timing, C, self.agg.ctx.spec.n_total, seed)
        self._mesh, self._dtype, self._seed = mesh, dtype, seed
        self._own = packing.packed_pspec(C, fed.client_axis, mesh)
        self._sharded = packing.mesh_axis_size(mesh, fed.client_axis) > 1
        self._init_state_and_flush()
        self.version = 0
        self.dispatch_version = np.zeros(C, np.int64)
        self.completions = 0
        self.dropped_total = 0
        self.history: list[AsyncRoundRecord] = []
        # everyone starts in flight against version 0 at t = 0; the heap's
        # (time, client) tuples pop equal completion times in client order
        self._queue: list[tuple[float, int]] = []
        self.global_row = 0  # the state row holding the current global
        for c in range(C):
            self._push(c)

    # -- state + flush program (overridden by StreamingAsyncEngine) ----------

    def _init_state_and_flush(self) -> None:
        cfg, fed, optimizer = self.cfg, self.fed, self.optimizer
        gen = R.seed_generator(cfg, self._seed, self.device)
        self.state = R.make_state(cfg, fed, optimizer, gen, self.device, self._dtype,
                                  mesh=self._mesh)
        self._full = self.k_buf == fed.n_clients
        if self._full:
            # a full buffer means every client completed (staleness 0
            # everywhere): the flush IS the sync full-participation round
            self._flush = R.build_fed_round(cfg, dataclasses.replace(fed, mode="sync"),
                                            optimizer, self._mesh)
        else:
            self._flush = _build_buffered_flush(cfg, fed, optimizer, self.agg, self._mesh)
        if self._sharded:
            # the rank's block of the global (every row starts as the dispatch)
            self._global = self.state["params"][0].clone()

    def set_state(self, state: PyTree) -> None:
        """Start from ``state`` instead of the seed's (this rank's block
        under a mesh; e.g. a state carried from the reference's by
        ``models.convert``). Only before the first flush, while every row
        holds the dispatch."""
        self.state = state
        if self._sharded:
            self._global = state["params"][0].clone()

    def _owner(self, c: int) -> int:
        """The client-axis coordinate of the rank holding client ``c``'s row."""
        return c // (self.fed.n_clients // packing.mesh_axis_size(self._mesh, self.fed.client_axis))

    def _global_view(self) -> torch.Tensor:
        if self._sharded:
            return self._global
        return self.state["params"][self.global_row]

    def _share_global(self) -> None:
        """After a flush over a sharded client axis: the rank that owns the
        global's row broadcasts its block to the others."""
        c = self.global_row
        mine = self._own.start <= c < self._own.stop
        g = (self.state["params"][c - self._own.start].clone() if mine
             else torch.empty_like(self._global))
        self._global = collectives.broadcast(g, self._mesh, self.fed.client_axis, self._owner(c))

    def global_packed_row(self) -> torch.Tensor:
        """A copy of the (N_total,) packed row holding the current global
        dispatch: the one pack/unpack edge ``server.global_params`` and
        ``serving.publish_from_engine`` read through (under a model axis
        that splits the flat dim, gathered from the blocks: every rank
        calls it together)."""
        row = self._global_view().clone()
        if self.agg.ctx.cols is not None:
            row = collectives.all_gather(row, self._mesh, "model")
        return row

    # -- event machinery -----------------------------------------------------

    def _client_seconds(self, c: int) -> float:
        load = float(self.load_model.loads[c])
        return self.timing.compute_seconds(load, self.fed.local_steps) + float(self.upload_s[c])

    def _push(self, c: int) -> None:
        heapq.heappush(self._queue, (self.clock.now() + self._client_seconds(c), c))

    def next_completion_time(self) -> float | None:
        """Earliest queued completion (the shared-clock interleave key)."""
        return self._queue[0][0] if self._queue else None

    def _apply_pending_redispatch(self, pending: set[int]) -> None:
        """Copy the current global row into every pending dropped client's
        row in one batched write. Safe to defer within a collection window:
        the global only changes at a flush."""
        if not pending:
            return
        p = self.state["params"]
        start, stop = self._own.start, self._own.stop
        mine = [c - start for c in sorted(pending) if start <= c < stop]  # the rank's rows
        if mine:
            idx = torch.tensor(mine, dtype=torch.long, device=p.device)
            p.index_copy_(0, idx, self._global_view().clone()[None].expand(len(mine), -1))
        pending.clear()

    def _drop(self, c: int) -> None:
        """A dropped completion: counted, redispatched from the current
        global (its optimizer rows persist); the row copy batches with the
        window's other drops."""
        self._pending.add(c)

    def _pre_stage(self, c: int) -> None:
        if c in self._pending:
            # a dropped client completed again before its deferred copy: it
            # must train from the global it was redispatched with
            self._apply_pending_redispatch(self._pending)

    def _post_collect(self) -> None:
        self._apply_pending_redispatch(self._pending)

    def _collect(self) -> tuple[list[int], list[int], int]:
        """Pop completion events until ``buffer_size`` updates stage ->
        (staged, staleness, dropped)."""
        staged: list[int] = []
        stal: list[int] = []
        self._pending: set[int] = set()
        dropped = 0
        while len(staged) < self.k_buf:
            t, c = heapq.heappop(self._queue)
            # a peer on a shared clock may have moved time past this event:
            # it then lands "now" (the clock never moves back)
            dt = self.clock.advance_to(max(t, self.clock.now()))
            if dt > 0:
                self.load_model.step(dt)  # loads evolve in simulated time
            self.completions += 1
            s = self.version - int(self.dispatch_version[c])
            if self.fed.max_staleness and s > self.fed.max_staleness:
                dropped += 1
                self.dropped_total += 1
                self.dispatch_version[c] = self.version
                self._drop(c)
                self._push(c)
                continue
            self._pre_stage(c)
            staged.append(c)
            stal.append(s)
        self._post_collect()
        return staged, stal, dropped

    def step_round(self, batch: PyTree) -> AsyncRoundRecord:
        """Collect ``buffer_size`` completions, flush once. ``batch``: the
        sync round's client-stacked (C, E, b, ...) tree, NumPy or tensors;
        only the staged clients' rows are trained on."""
        t_host = time.time()
        staged, stal, dropped = self._collect()
        rec = self._do_flush(staged, stal, dropped, batch, t_host)
        self.history.append(rec)
        return rec

    def _do_flush(self, staged, stal, dropped, batch, t_host) -> AsyncRoundRecord:
        mask, w_disc = discounted_weights(self.fed, staged, stal)
        part = torch.from_numpy(w_disc) if self._full else {"mask": mask, "weights": w_disc}
        self.state, metrics = self._flush(self.state, R.to_device(batch, self.device), part)
        self.version += 1
        if self.scheduler is not None:
            # async completions feed the same quality EMA sync rounds do
            client_loss = metrics["client_loss"].cpu().numpy()
            for c in staged:
                self.scheduler.report_quality(c, float(client_loss[c]))
        for c in staged:
            self.dispatch_version[c] = self.version
            self._push(c)
        self.global_row = staged[0]  # its row now holds the fresh global
        if self._sharded:
            self._share_global()
        return AsyncRoundRecord(
            round_idx=self.version - 1,
            loss=float(metrics["loss"]),
            weights=[float(x) for x in w_disc],
            seconds=time.time() - t_host,
            participants=[int(c) for c in staged],
            loads=[float(x) for x in self.load_model.loads],
            version=self.version,
            sim_time=self.clock.now(),
            staleness=[int(s) for s in stal],
            dropped=dropped,
        )


def build_row_update(cfg, fed: R.FedConfig, optimizer):
    """The single-row local update: ``update(row, batch_c) -> (trained row,
    mean loss)`` for an (N_total,) dispatch row and one client's (E, b, ...)
    batch on the row's device. The row is not changed; the trained row is a
    new tensor. The schedule replay trains every landing through it, so a
    row's update is a function of (dispatch row, batch) alone: the local
    optimizer must carry no state between rounds (``sgd(momentum=0.0)``)."""
    if not R.is_stateless(optimizer):
        raise ValueError(
            "the row update is a pure function of (dispatch row, batch): use "
            f"a stateless local optimizer (sgd(momentum=0.0)), got "
            f"{optimizer.name!r} with persistent state")
    local_train = R.local_training(cfg, fed, optimizer)

    def update(row: torch.Tensor, batch_c: PyTree) -> tuple[torch.Tensor, torch.Tensor]:
        trained = row.clone()
        loss = local_train(trained, {}, batch_c)
        return trained, loss

    return update


def _build_landing_flush(agg):
    """The arrival engine's flush: the buffered flush without its training
    step (the rows landed trained), the same discounted aggregate and
    redispatch. -> ``flush(state, part) -> state``."""

    def flush(state, part):
        agg_state = _aggregate_staged(agg, state["params"], part["mask"], part["weights"],
                                      state["agg"])
        return {**state, "agg": agg_state, "round": state["round"] + 1}

    return flush


@dataclasses.dataclass
class LandResult:
    """What one landed completion did to the engine."""

    client: int
    staleness: int
    dropped: bool  # True: staler than max_staleness — counted, redispatched
    version: int  # engine version after handling (the redispatch version)
    flush: AsyncRoundRecord | None = None  # set when this landing filled the buffer


class ArrivalAsyncEngine:
    """Buffered async engine driven by an external arrival stream (a
    recorded arrival schedule replayed on the SimClock, DESIGN.md §14).

    Same packed ``(C, N_total)`` dispatch-row state, staleness accounting,
    discount, registered aggregation and ``AsyncRoundRecord`` history as
    :class:`BufferedAsyncEngine`; there is no event heap, and updates arrive
    already trained (:func:`build_row_update`), so there are no optimizer
    rows and the local optimizer must be stateless. Row ``c`` holds what
    client ``c`` was last dispatched until its trained update lands in
    place: replaying one dispatch/land sequence reproduces the rows, hence
    the flushes, bit for bit under the dense codec.
    """

    def __init__(self, cfg, fed: R.FedConfig, optimizer, *, seed: int = 0,
                 dtype: torch.dtype = torch.float32, clock: SimClock | None = None,
                 aggregator=None, device: str | torch.device = "cuda"):
        self.k_buf = _check_async(fed, "ArrivalAsyncEngine", "arrival")
        if fed.stream:
            raise ValueError(
                "the arrival engine keeps the (C, N_total) dispatch buffer — "
                "its rows ARE the wire payloads; stream=True has no buffer to land into")
        C = fed.n_clients
        self.cfg, self.fed, self.optimizer = cfg, fed, optimizer
        self.device = D.resolve(device)
        self.agg = _stacked_aggregator(cfg, fed, None, aggregator)
        if not R.is_stateless(optimizer):
            raise ValueError(
                "the arrival engine keeps no per-client optimizer rows (updates "
                "arrive already trained); use a stateless local optimizer "
                f"(sgd(momentum=0.0)), got {optimizer.name!r} with persistent state")
        self.clock = clock or SimClock()
        # make_state's row 0 at this seed: every engine with one seed starts
        # from one global (the replay and equivalence anchor)
        row0 = R.initial_row(self.agg, R.seed_generator(cfg, seed, self.device), self.device,
                             dtype)
        packed = row0.expand(C, -1).contiguous()
        self.state = {"params": packed, "agg": self.agg.init_state(packed), "round": 0}
        self._flush = _build_landing_flush(self.agg)
        self.version = 0
        self.global_row = 0
        # rows change on every landing, so the engine keeps its own copy of
        # the current global instead of an index into the buffer
        self._global = row0[0].clone()
        self.dispatch_version = np.zeros(C, np.int64)
        self.completions = 0
        self.dropped_total = 0
        self.history: list[AsyncRoundRecord] = []
        self._staged: list[int] = []
        self._stal: list[int] = []
        self._losses: list[float] = []
        self._dropped_window = 0

    # -- durability ------------------------------------------------------------

    def export_state(self) -> dict:
        """Everything a restarted server needs to resume mid-window: the
        packed buffer, every leaf of ``state["agg"]`` (in its flattening
        order), the engine's global, dispatch versions and the host-side
        window and counters. -> ``{"arrays": {...}, "scalars": {...}}``,
        NumPy and JSON-able."""
        agg_leaves = [leaf for _, leaf in mp.flatten_with_paths(self.state["agg"])]
        arrays = {
            "params": self.state["params"].cpu().numpy().copy(),
            "global": self._global.cpu().numpy().copy(),
            "dispatch_version": self.dispatch_version.copy(),
        }
        for i, leaf in enumerate(agg_leaves):
            # a host int leaf (a round counter) is the reference's int32 scalar
            arrays[f"agg_{i}"] = (leaf.cpu().numpy().copy() if isinstance(leaf, torch.Tensor)
                                  else np.asarray(leaf, np.int32) if isinstance(leaf, int)
                                  else np.asarray(leaf))
        scalars = {
            "round": int(self.state["round"]),
            "version": int(self.version),
            "global_row": int(self.global_row),
            "completions": int(self.completions),
            "dropped_total": int(self.dropped_total),
            "n_agg_leaves": len(agg_leaves),
            "staged": [int(c) for c in self._staged],
            "stal": [int(s) for s in self._stal],
            "losses": [float(x) for x in self._losses],
            "dropped_window": int(self._dropped_window),
            "clock_t": float(self.clock.now()),
            "n_history": len(self.history),
        }
        return {"arrays": arrays, "scalars": scalars}

    def import_state(self, snap: dict) -> None:
        """Inverse of :meth:`export_state` onto a freshly built engine of
        the same configuration. The clock is advanced to the snapshot's
        time, never rewound."""
        arrays, scalars = snap["arrays"], snap["scalars"]
        paths = list(mp.flatten_with_paths(self.state["agg"]))
        n = int(scalars["n_agg_leaves"])
        if n != len(paths):
            raise ValueError(
                f"snapshot has {n} agg leaves, engine expects {len(paths)} "
                "(aggregation mismatch between snapshot meta and engine?)")
        dev, dtype = self.device, self.state["params"].dtype

        def leaf(i, like):
            a = arrays[f"agg_{i}"]
            if isinstance(like, torch.Tensor):
                return torch.tensor(a, dtype=like.dtype, device=like.device)
            return type(like)(a)

        self.state = {
            "params": torch.tensor(arrays["params"], dtype=dtype, device=dev),
            "agg": mp.unflatten(self.state["agg"], {p: leaf(i, v) for i, (p, v) in enumerate(paths)}),
            "round": int(scalars["round"]),
        }
        self._global = torch.tensor(arrays["global"], dtype=dtype, device=dev)
        self.dispatch_version = np.asarray(arrays["dispatch_version"], np.int64).copy()
        self.version = int(scalars["version"])
        self.global_row = int(scalars["global_row"])
        self.completions = int(scalars["completions"])
        self.dropped_total = int(scalars["dropped_total"])
        self._staged = [int(c) for c in scalars["staged"]]
        self._stal = [int(s) for s in scalars["stal"]]
        self._losses = [float(x) for x in scalars["losses"]]
        self._dropped_window = int(scalars["dropped_window"])
        if float(scalars["clock_t"]) > self.clock.now():
            self.clock.advance_to(float(scalars["clock_t"]))

    # -- dispatch side -------------------------------------------------------

    def global_packed_row(self) -> torch.Tensor:
        """A copy of the current global (N_total,) row: the engine's own
        copy, which only changes at a flush, never ``state["params"]
        [global_row]`` (that client's next update may have landed there)."""
        return self._global.clone()

    def staged(self) -> tuple[int, ...]:
        """Clients landed but not flushed this window."""
        return tuple(self._staged)

    def dispatch(self, c: int) -> int:
        """(Re)dispatch the current global into client ``c``'s row; returns
        the version dispatched. Refuses a staged client: its row holds a
        trained update awaiting the flush."""
        if c in self._staged:
            raise RuntimeError(
                f"client {c} is staged for the pending flush; dispatching now "
                "would overwrite its landed update")
        # skip only when row c provably holds the current global already
        if int(self.dispatch_version[c]) != self.version:
            self.state["params"][c].copy_(self._global)
        self.dispatch_version[c] = self.version
        return self.version

    def dispatch_row(self, c: int) -> np.ndarray:
        """Host copy of client ``c``'s dispatch row (the wire payload)."""
        return self.state["params"][c].float().cpu().numpy().copy()

    # -- landing side --------------------------------------------------------

    def land(self, c: int, row, *, loss: float = 0.0, t: float | None = None) -> LandResult:
        """One arrived update: advance the clock to its arrival time, apply
        the staleness gate, write the trained row in place, and flush once
        ``buffer_size`` updates have staged. A drop redispatches from the
        current global at once (counted, never silent)."""
        if c in self._staged:
            raise RuntimeError(
                f"client {c} already staged this window — the dispatch protocol "
                "sends one update per dispatch")
        if t is not None:
            self.clock.advance_to(max(float(t), self.clock.now()))
        self.completions += 1
        s = self.version - int(self.dispatch_version[c])
        if self.fed.max_staleness and s > self.fed.max_staleness:
            self.dropped_total += 1
            self._dropped_window += 1
            self.dispatch(c)
            return LandResult(client=c, staleness=s, dropped=True, version=self.version)
        self.state["params"][c].copy_(torch.as_tensor(row))
        self._staged.append(c)
        self._stal.append(s)
        self._losses.append(float(loss))
        rec = self._flush_staged() if len(self._staged) >= self.k_buf else None
        return LandResult(client=c, staleness=s, dropped=False, version=self.version, flush=rec)

    def _flush_staged(self) -> AsyncRoundRecord:
        staged, stal, losses = self._staged, self._stal, self._losses
        # the buffered engine's discount arithmetic: the replay leans on it
        mask, w_disc = discounted_weights(self.fed, staged, stal)
        self.state = self._flush(self.state, {"mask": mask, "weights": w_disc})
        self.version += 1
        for c in staged:
            self.dispatch_version[c] = self.version
        self.global_row = staged[0]
        self._global = self.state["params"][staged[0]].clone()
        rec = AsyncRoundRecord(
            round_idx=self.version - 1,
            loss=float(np.mean(losses)) if losses else 0.0,
            weights=[float(x) for x in w_disc],
            seconds=0.0,
            participants=[int(c) for c in staged],
            loads=[0.0] * self.fed.n_clients,
            version=self.version,
            sim_time=self.clock.now(),
            staleness=[int(s) for s in stal],
            dropped=self._dropped_window,
        )
        self.history.append(rec)
        self._staged, self._stal, self._losses = [], [], []
        self._dropped_window = 0
        return rec


class StreamingAsyncEngine(BufferedAsyncEngine):
    """The O(buffer_size · N) flush discipline for large federations
    (DESIGN.md §13). Same event queue, clock, staleness accounting and
    records as :class:`BufferedAsyncEngine`; the state differs:

    - ``state["ring"]`` is ``(max_staleness + 1, N_total)``: the globals of
      versions ``[version - max_staleness, version]``, exactly those a kept
      completion can reference. A drop redispatches by version alone.
    - ``state["agg"]`` holds the running ``acc`` (N,) f32 and ``wsum``. A
      flush gathers at most ``_cohort`` dispatch rows from the ring, trains
      them, and adds ``sum_q w_q trained_q`` to ``acc``; the finalize step
      divides, writes the new global into ring slot ``(version+1) % R`` and
      zeroes the accumulator.
    - Training keeps no optimizer rows (``sgd(momentum=0.0)``), and only the
      linear ``dense`` reduce can be a running sum: both are build-time
      errors otherwise.

    With one seed, batches and timing, streaming matches the buffered engine
    to reduction-order tolerance."""

    _cohort = 8  # max dispatch rows materialized per accumulate step

    def _init_state_and_flush(self) -> None:
        fed = self.fed
        if not fed.stream:
            raise ValueError("StreamingAsyncEngine needs FedConfig(stream=True)")
        if fed.max_staleness < 1:
            raise ValueError(
                "streaming flush needs max_staleness >= 1: the dispatch ring "
                "holds max_staleness+1 global versions in place of the (C, N) "
                f"buffer, got max_staleness={fed.max_staleness}")
        if fed.aggregation != "dense":
            raise ValueError(
                "streaming flush folds aggregation into a running weighted "
                f"sum; only the linear 'dense' reduce streams, got {fed.aggregation!r}")
        if not R.is_stateless(self.optimizer):
            raise ValueError(
                "streaming flush keeps no per-client optimizer rows; use a "
                f"stateless local optimizer (sgd(momentum=0.0)), "
                f"got {self.optimizer.name!r} with persistent state")
        self.ring_slots = fed.max_staleness + 1
        # make_state's row 0 at this seed: streaming and buffered start from
        # one global
        row0 = R.initial_row(self.agg, R.seed_generator(self.cfg, self._seed, self.device),
                             self.device, self._dtype)
        # the rank's column block under a model axis that splits the flat dim
        row0 = row0[:, packing.packed_cols(self.agg.ctx.spec.n_total, self._mesh)]
        n = row0.shape[1]
        self.state = {
            "ring": row0.expand(self.ring_slots, n).contiguous(),
            "agg": {"acc": torch.zeros(n, dtype=torch.float32, device=self.device),
                    "wsum": torch.zeros((), dtype=torch.float32, device=self.device)},
            "round": 0,
        }
        self._local_train = R.local_training(self.cfg, fed, self.optimizer, self._mesh)

    def _global_view(self) -> torch.Tensor:
        return self.state["ring"][self.version % self.ring_slots]

    def set_state(self, state: PyTree) -> None:
        self.state = state  # the ring holds the globals

    # drops are version-only redispatches: the ring already holds the row
    def _drop(self, c: int) -> None:
        pass

    def _pre_stage(self, c: int) -> None:
        pass

    def _post_collect(self) -> None:
        pass

    def _accumulate(self, chunk: list[int], w_q: np.ndarray, batch: PyTree) -> torch.Tensor:
        """Train one cohort's dispatch rows (those this rank owns), gathered
        from the ring, and fold their weighted sum into ``acc`` -> the
        cohort's losses (0 for a row another rank trains)."""
        ring, acc = self.state["ring"], self.state["agg"]
        losses = torch.zeros(len(chunk), dtype=torch.float32, device=self.device)
        mine = [i for i, c in enumerate(chunk) if self._own.start <= c < self._own.stop]
        if not mine:
            return losses
        chunk, w_q = [chunk[i] for i in mine], w_q[mine]
        slots = torch.from_numpy(self.dispatch_version[chunk] % self.ring_slots).to(self.device)
        rows = ring.index_select(0, slots)  # (Q, N): the only row materialization
        for i, c in zip(mine, chunk):
            losses[i] = self._local_train(rows[mine.index(i)], {}, R.to_device(
                mp.map_tree(lambda x: x[c], batch), self.device))
        w = torch.from_numpy(w_q).to(self.device)
        acc["acc"].add_(w @ rows.float())
        acc["wsum"].add_(w.sum())
        return losses

    def _finalize(self) -> None:
        ring, acc = self.state["ring"], self.state["agg"]
        if self._sharded:  # every rank's folds -> the flush's sum
            collectives.all_reduce(acc["acc"], self._mesh, self.fed.client_axis)
            collectives.all_reduce(acc["wsum"], self._mesh, self.fed.client_axis)
        g = acc["acc"] / torch.clamp_min(acc["wsum"], 1e-12)
        ring[(self.version + 1) % self.ring_slots].copy_(g.to(ring.dtype))
        acc["acc"].zero_()
        acc["wsum"].zero_()
        self.state["round"] += 1

    def _do_flush(self, staged, stal, dropped, batch, t_host) -> AsyncRoundRecord:
        C, k = self.fed.n_clients, len(staged)
        w_per = ((1.0 / np.float32(k)) * (1.0 + np.asarray(stal, np.float32))
                 ** np.float32(-self.fed.staleness_alpha)).astype(np.float32)
        Q = min(k, self._cohort)
        losses = torch.zeros(k, dtype=torch.float32, device=self.device)
        for i0 in range(0, k, Q):
            chunk = staged[i0: i0 + Q]
            losses[i0: i0 + len(chunk)] = self._accumulate(chunk, w_per[i0: i0 + len(chunk)],
                                                           batch)
        if self._sharded:  # each loss from its owner, zeros elsewhere: an exact sum
            collectives.all_reduce(losses, self._mesh, self.fed.client_axis)
        losses = losses.cpu().numpy()
        self._finalize()
        self.version += 1
        if self.scheduler is not None:
            for i, c in enumerate(staged):
                self.scheduler.report_quality(c, float(losses[i]))
        for c in staged:
            self.dispatch_version[c] = self.version
            self._push(c)
        w_disc = np.zeros(C, np.float32)
        w_disc[staged] = w_per
        return AsyncRoundRecord(
            round_idx=self.version - 1,
            loss=float(np.mean(losses)),
            weights=[float(x) for x in w_disc],
            seconds=time.time() - t_host,
            participants=[int(c) for c in staged],
            loads=[float(x) for x in self.load_model.loads],
            version=self.version,
            sim_time=self.clock.now(),
            staleness=[int(s) for s in stal],
            dropped=dropped,
        )
