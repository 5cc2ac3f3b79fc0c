"""FL_SERVER — orchestrates federated rounds (port of the sync path of
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
``torch.distributed`` ``DeviceMesh``) goes to the round; every rank of it
runs the same server, with the same seeds, in step.

The async control plane (``mode="async"``) and the shared simulated clock
belong to later slices.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.checkpoint import ObjectStore
from repro_torch.core import aggregators, explorer, packing, rounds
from repro_torch.core.scheduler import SchedulerConfig, TaskScheduler
from repro_torch.models.params import map_tree
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
        clock=None,
        device: str | torch.device = "cuda",
        mesh=None,
    ):
        if fed.mode == "async":
            raise NotImplementedError("mode='async' (the buffered engines) is ported in slice 4")
        if fed.mode != "sync":
            raise ValueError(f"unknown mode {fed.mode!r}; expected sync|async")
        if clock is not None:
            raise NotImplementedError("a shared simulated clock (TaskManager) is ported in slice 6")
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
        # compact rounds need the scheduler to emit exactly K indices
        self._k_static = rounds.static_budget(fed) if fed.participation == "compact" else None
        # registry dispatch: an unknown mode or an unported configuration
        # fails here, before any state is allocated
        self.aggregator = rounds.make_aggregator(cfg, fed, mesh)
        # an LM's initial model is drawn on the server's device (a full-width
        # model is 1.7 B values); fedyolov3's on the host, as before
        gen_device = "cpu" if cfg.family == "yolo" else self.device
        self.state = rounds.make_state(cfg, fed, optimizer,
                                       torch.Generator(device=gen_device).manual_seed(seed),
                                       self.device, mesh=mesh)
        self._fed_round = rounds.build_fed_round(cfg, fed, optimizer, mesh)
        self.history: list[RoundRecord] = []
        self.eval_history: list[EvalRecord] = []
        self._evaluator = None  # (max_detections, evaluate), built lazily

    @property
    def aggregation_modes(self) -> tuple[str, ...]:
        """Every mode this server could be configured with."""
        return aggregators.names()

    def global_params(self) -> FedYOLOv3 | PyTree:
        """The dispatchable global model from row 0 of the packed state
        (every row holds the global model after a sync round), or fedsgd's
        one shared copy: a fresh :class:`FedYOLOv3` on the server's device,
        or for an LM a param tree copied out of the row (the reference's
        one-row unpack). This is the pack/unpack edge: checkpoint PUT,
        evaluation and dispatch to serving. Over a sharded client axis row 0
        lives on the axis' first rank, which broadcasts it: every rank calls
        this together."""
        spec, tpl = self.aggregator.ctx.spec, self.aggregator.ctx.template
        row = self.state["params"] if not self.aggregator.stacked else self._row0()
        if self.cfg.family != "yolo":
            return map_tree(lambda x: x[0], packing.unpack(spec, row[None], tpl))
        views = packing.unpack_views(spec, row, tpl)
        with self.device:
            return FedYOLOv3(self.cfg, weights=views).eval()

    def _row0(self) -> torch.Tensor:
        packed = self.state["params"]
        axis = self.fed.client_axis
        if packing.mesh_axis_size(self.mesh, axis) == 1:
            return packed[0]
        import torch.distributed as dist

        group = self.mesh.get_group(axis)
        row = packed[0].clone()  # the first rank's row 0 is global row 0
        dist.broadcast(row, src=dist.get_global_rank(group, 0), group=group)
        return row

    def run_round(self, batch: PyTree) -> RoundRecord:
        """One sync round. ``batch`` (the cohort's, client-stacked (C, E, b,
        ...)) may hold NumPy arrays or tensors; it is moved to the server's
        device."""
        t0 = time.time()
        loads = self.load_model.step()  # one tick per round
        sel = self.scheduler.participation(loads, k_static=self._k_static)
        part = rounds.participation_input(self.fed, sel["mask"], sel["weights"], sel.get("idx"))
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
            self.store.put_model(self.task_id, rec.round_idx, self.global_params(), {"loss": loss})
        return rec

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
        for r in range(n_rounds):
            rec = self.run_round(next(batches))
            if log and (r % max(1, n_rounds // 10) == 0 or r == n_rounds - 1):
                log(f"round {rec.round_idx:4d}  loss {rec.loss:.4f}  "
                    f"participants {len(rec.participants)}/{self.fed.n_clients}")
        return self.history
