"""FL_SERVER — orchestrates federated rounds (port of
``repro/core/server.py``).

The server owns the flat round state and the round function
(``core.rounds``), the Task Scheduler, the Explorer's load model, the COS
object store and the round loop. Each round the load model reports
per-client loads, ``TaskScheduler.participation`` turns them into the mask
and weight vectors, the selected clients train and the registered
aggregator merges them; the participants' losses feed the scheduler's
quality EMA. :meth:`FLServer.evaluate_round` scores the global model on
each client's holdout (mAP@0.5 through the IoU and NMS kernels) and feeds
the per-client mAP back into the same EMA; it is detection-only. An LM task
(qwen3-1.7b, mamba2-1.3b) runs the same rounds, scheduler and COS
checkpoints; its global model is a param tree.

Compact participation asks the scheduler for exactly K =
``rounds.static_budget`` clients a round and hands their ``idx`` to the
round. The fedsgd topology trains one shared copy on the cohort's batch
merged into one (``rounds.merge_clients``). A client mesh (``mesh``, a
``torch.distributed`` ``DeviceMesh``) goes to the round, or to the async
engine; every rank of it runs the same server, with the same seeds, in
step. The global model (:meth:`FLServer.global_params`) is whole on every
rank, gathered over the client and model axes, and only global rank 0
writes the COS checkpoints.

Async mode (``FedConfig.mode == "async"``, DESIGN.md §12) swaps the round
control plane for ``core.async_engine``: the buffered engine, or the
streaming one under ``FedConfig.stream``. :meth:`FLServer.run_async` drives
one flush a call on the engine's simulated clock and records per-update
staleness and the simulated time in the history the monitor renders; the
engine feeds the scheduler's quality EMA from its completions.

Shared clock (DESIGN.md §12): a server built with ``clock=`` (one
``SimClock`` handed to several servers and to the Task Manager) advances it
by every sync round's wait-for-slowest duration, and an async server hands
it to its engine, so sync rounds and async flushes interleave under
``TaskManager.step_shared_clock``. Without one, sync rounds keep the
timeless cadence (one load-model tick a round, the clock at 0).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.checkpoint import ObjectStore
from repro_torch.core import aggregators, collectives, explorer, packing, rounds
from repro_torch.core.async_engine import (AsyncRoundRecord, BufferedAsyncEngine,
                                           StreamingAsyncEngine, TimingModel,
                                           default_upload_terms, sync_round_seconds)
from repro_torch.core.scheduler import SchedulerConfig, TaskScheduler
from repro_torch.core.simclock import SimClock
from repro_torch.models import params as mp
from repro_torch.models.yolov3 import FedYOLOv3
from repro_torch.optim import Optimizer

PyTree = Any


@dataclasses.dataclass
class RoundRecord:
    round_idx: int
    loss: float
    weights: list[float]
    seconds: float
    participants: list[int] = dataclasses.field(default_factory=list)
    loads: list[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class EvalRecord:
    """One ``evaluate_round`` outcome: global + per-client mAP@0.5."""

    round_idx: int
    map50: float
    per_client_map: list[float]


class FLServer:
    def __init__(
        self,
        cfg,
        fed: rounds.FedConfig,
        optimizer: Optimizer,
        *,
        store: ObjectStore | None = None,
        scheduler: TaskScheduler | None = None,
        seed: int = 0,
        checkpoint_every: int = 0,
        task_id: str = "task",
        load_model: explorer.ClientLoadModel | None = None,
        clock: SimClock | None = None,
        timing: TimingModel | None = None,
        device: str | torch.device = "cuda",
        mesh=None,
    ):
        if fed.mode not in ("sync", "async"):
            raise ValueError(f"unknown mode {fed.mode!r}; expected sync|async")
        self.device = D.resolve(device)
        self.cfg = cfg
        self.fed = fed
        self.optimizer = optimizer
        self.store = store
        self.task_id = task_id
        self.checkpoint_every = checkpoint_every
        self.scheduler = scheduler or TaskScheduler(fed.n_clients, SchedulerConfig())
        self.load_model = load_model or explorer.ClientLoadModel(fed.n_clients, seed=seed)
        self.mesh = mesh
        # an explicitly shared clock makes sync rounds advance simulated
        # time too (wait-for-slowest), so sync and async servers interleave
        # under TaskManager.step_shared_clock; without one, sync rounds
        # keep the legacy timeless cadence
        self._shared_clock = clock is not None
        self.clock = clock or SimClock()
        self.timing = timing or TimingModel()
        # compact rounds need the scheduler to emit exactly K indices
        self._k_static = rounds.static_budget(fed) if fed.participation == "compact" else None
        # registry dispatch: an unknown mode or an unported configuration
        # fails here, before any state is allocated
        self.aggregator = rounds.make_aggregator(cfg, fed, mesh)
        self.engine: BufferedAsyncEngine | None = None
        if fed.mode == "async":
            # the engine owns the state and the flush; stream=True swaps the
            # O(C N) buffer for the ring and the running accumulator
            engine_cls = StreamingAsyncEngine if fed.stream else BufferedAsyncEngine
            self.engine = engine_cls(
                cfg, fed, optimizer, mesh=mesh, seed=seed, clock=self.clock,
                load_model=self.load_model,
                timing=self.timing, scheduler=self.scheduler, aggregator=self.aggregator,
                device=self.device)
            self.state = self.engine.state
            self._fed_round = None
            self._upload_s = self.engine.upload_s
        else:
            self.state = rounds.make_state(cfg, fed, optimizer,
                                           rounds.seed_generator(cfg, seed, self.device),
                                           self.device, mesh=mesh)
            self._fed_round = rounds.build_fed_round(cfg, fed, optimizer, mesh)
            self._upload_s = default_upload_terms(self.timing, fed.n_clients,
                                                  self.aggregator.ctx.spec.n_total, seed)
        self.history: list[RoundRecord | AsyncRoundRecord] = []
        self.eval_history: list[EvalRecord] = []
        self._evaluator = None  # (max_detections, evaluate), built lazily

    @property
    def aggregation_modes(self) -> tuple[str, ...]:
        """Every mode this server could be configured with."""
        return aggregators.names()

    def global_params(self) -> FedYOLOv3 | PyTree:
        """The dispatchable global model: a fresh :class:`FedYOLOv3` on the
        server's device, or for an LM a param tree copied out of the row
        (the reference's one-row unpack). After a sync round every row holds
        the global, so row 0 serves (fedsgd: its one shared copy; over a
        sharded client axis row 0 lives on the axis' first rank, which
        broadcasts it; over a model axis that splits the flat dim, the
        blocks are all-gathered: every rank calls this together and gets
        the whole model). An async state only guarantees some rows hold the
        fresh global, so this reads the engine's ``global_packed_row()``,
        never a fixed row. This is the pack/unpack edge: checkpoint PUT,
        evaluation and dispatch to serving. A tree state's global is row 0
        of each leaf (fedsgd: its shared tree), packed into one row."""
        if self.engine is not None:
            row = self.engine.global_packed_row()  # whole on every rank
        else:
            params = self.state["params"]
            if self.fed.state_layout == "tree":  # the leaves' row 0 (fedsgd: the tree), packed
                if self.aggregator.stacked:
                    params = mp.map_tree(lambda x: x[:1], params)
                params = rounds.tree_to_rows(self.aggregator.ctx.spec, params,
                                             self.aggregator.stacked)
            row = params if not self.aggregator.stacked else self._row0(params)
            if self.aggregator.ctx.cols is not None:
                row = collectives.all_gather(row, self.mesh, "model")
        return rounds.global_model(self.cfg, row, self.device)

    def _row0(self, packed: torch.Tensor) -> torch.Tensor:
        axis = self.fed.client_axis
        if packing.mesh_axis_size(self.mesh, axis) == 1:
            return packed[0]
        # the first rank's row 0 is global row 0
        return collectives.broadcast(packed[0].clone(), self.mesh, axis, 0)

    def _checkpoint(self, round_idx: int, loss: float) -> None:
        """A COS PUT of the global model: every rank of a mesh gathers it,
        global rank 0 alone writes."""
        import torch.distributed as dist

        model = self.global_params()
        if self.mesh is None or dist.get_rank() == 0:
            self.store.put_model(self.task_id, round_idx, model, {"loss": loss})

    def run_round(self, batch: PyTree) -> RoundRecord:
        """One sync round. ``batch`` (the cohort's, client-stacked (C, E, b,
        ...)) may hold NumPy arrays or tensors; it is moved to the server's
        device."""
        if self.engine is not None:
            raise RuntimeError(
                "FedConfig(mode='async') servers run buffered flushes — call "
                "run_async(batch) (or fit(), which dispatches on the mode)")
        t0 = time.time()
        if self._shared_clock:
            # this round's report is the load process state *now*; the round
            # then consumes wait-for-slowest simulated time and the process
            # evolves over that same span
            loads = self.load_model.loads.copy()
        else:
            loads = self.load_model.step()  # legacy: one tick per round
        sel = self.scheduler.participation(loads, k_static=self._k_static)
        part = rounds.participation_input(self.fed, sel["mask"], sel["weights"], sel.get("idx"))
        if self._shared_clock:
            # the round takes as long as its slowest selected client
            dur = sync_round_seconds(self.timing, loads, self._upload_s, self.fed.local_steps,
                                     mask=sel["mask"])
            self.clock.advance(dur)
            self.load_model.step(dur)
        batch = rounds.to_device(batch, self.device)
        if not self.aggregator.stacked:
            batch = rounds.merge_clients(batch)
        self.state, metrics = self._fed_round(self.state, batch, part)
        loss = float(metrics["loss"])
        participants = [int(c) for c in np.nonzero(sel["mask"])[0]]
        client_loss = metrics["client_loss"].cpu().numpy()
        for c in participants:
            self.scheduler.report_quality(c, float(client_loss[c]))
        rec = RoundRecord(
            len(self.history),
            loss,
            [float(w) for w in sel["weights"]],
            time.time() - t0,
            participants=participants,
            loads=[float(x) for x in loads],
        )
        self.history.append(rec)
        if self.store and self.checkpoint_every and rec.round_idx % self.checkpoint_every == 0:
            self._checkpoint(rec.round_idx, loss)
        return rec

    def run_async(self, batch: PyTree) -> AsyncRoundRecord:
        """One buffered flush on the simulated clock (DESIGN.md §12): the
        engine pops completion events until ``buffer_size`` updates stage
        (dropping and counting anything staler than max_staleness), applies
        the staleness-weighted flush and redispatches. The record (with
        per-update staleness and the simulated time) lands in the history
        the monitor renders."""
        if self.engine is None:
            raise RuntimeError("run_async needs FedConfig(mode='async')")
        rec = self.engine.step_round(batch)
        self.state = self.engine.state  # global_params and eval read through here
        self.history.append(rec)
        if self.store and self.checkpoint_every and rec.round_idx % self.checkpoint_every == 0:
            self._checkpoint(rec.round_idx, rec.loss)
        return rec

    def next_time(self) -> float:
        """Simulated completion time of this server's next round. Async
        servers report their earliest queued completion; sync servers
        estimate now + wait-for-slowest over the clients the scheduler is
        likely to select: the K fastest under its budget plus every client
        whose idle streak hit the fairness floor."""
        if self.engine is not None:
            t = self.engine.next_completion_time()
            return self.clock.now() if t is None else t
        per = np.array([self.timing.compute_seconds(l, self.fed.local_steps)
                        for l in self.load_model.loads]) + self._upload_s
        k = self._k_static or self.scheduler.cfg.max_participants or self.fed.n_clients
        k = min(k, self.fed.n_clients)
        dur = float(np.sort(per)[:k].max())
        floored = per[self.scheduler.idle_rounds >= self.scheduler.cfg.fairness_rounds]
        if floored.size:
            dur = max(dur, float(floored.max()))
        return self.clock.now() + dur

    def evaluate_round(self, eval_batch: PyTree, *, max_detections: int = 64,
                       feed_scheduler: bool = True) -> EvalRecord:
        """Detection-quality checkpoint: the global model against each
        client's eval slice. eval_batch: {"images" (C, B, H, W, 3),
        "gt_boxes"/"gt_cls"/"gt_valid" (C, B, G, ...)}, NumPy or tensors.
        The per-client mAP feeds the scheduler's quality EMA."""
        from repro_torch.core import detection  # only detection tasks need it

        if self.cfg.family != "yolo":
            raise ValueError(f"{self.cfg.name}: evaluate_round scores detection tasks (mAP@0.5)")

        if self._evaluator is None or self._evaluator[0] != max_detections:
            self._evaluator = (max_detections,
                               detection.build_evaluator(self.cfg, max_detections=max_detections))
        out = self._evaluator[1](self.global_params(), rounds.to_device(eval_batch, self.device))
        per_client = [float(x) for x in out["per_client_map"].cpu().numpy().astype(np.float64)]
        if feed_scheduler:
            for c, m in enumerate(per_client):
                self.scheduler.report_eval(c, m)
        rec = EvalRecord(max(len(self.history) - 1, 0), float(out["map"]), per_client)
        self.eval_history.append(rec)
        return rec

    def fit(self, batches: Iterator[PyTree], n_rounds: int,
            log: Callable[[str], None] = lambda m: print(m, flush=True)) -> list[RoundRecord]:
        step = self.run_async if self.engine is not None else self.run_round
        for r in range(n_rounds):
            rec = step(next(batches))
            if log and (r % max(1, n_rounds // 10) == 0 or r == n_rounds - 1):
                msg = (f"round {rec.round_idx:4d}  loss {rec.loss:.4f}  "
                       f"participants {len(rec.participants)}/{self.fed.n_clients}")
                if isinstance(rec, AsyncRoundRecord):
                    msg += (f"  sim {rec.sim_time:7.0f}s  staleness "
                            f"{np.mean(rec.staleness):.2f}  dropped {rec.dropped}")
                log(msg)
        return self.history
