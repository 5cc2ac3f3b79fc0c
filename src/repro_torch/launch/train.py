"""Federated training launcher (port of the sync paths of
``repro/launch/train.py``: ``--task detection`` and ``--task lm``).

  PYTHONPATH=src python -m repro_torch.launch.train --task detection --device cpu --rounds 3
  PYTHONPATH=src python -m repro_torch.launch.train --task lm --arch qwen3-1.7b --device cpu --rounds 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-1.3b --full-size --clients 2 \
      --batch 1 --seq 1024 --rounds 3
  PYTHONPATH=src python -m repro_torch.launch.train --task detection --full-size \\
      --img-size 416 --clients 3 --participation masked --max-participants 2 \\
      --optimizer sgd --lr 1e-3 --topn 4 --batch 8 --eval-every 5 --store /tmp/cos
  PYTHONPATH=src python -m repro_torch.launch.train --task detection --device cpu \\
      --rounds 2 --agg quant4
  PYTHONPATH=src python -m repro_torch.launch.train --task detection --device cpu \\
      --rounds 2 --agg hier --clients 4 --group-size 2 --hier-base eq6
  PYTHONPATH=src python -m repro_torch.launch.train --task detection --device cpu \\
      --rounds 3 --agg quant8 --participation compact --clients 3 --max-participants 2
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --device cpu \\
      --rounds 3 --mode async --buffer-size 2 --staleness-alpha 0.5 --max-staleness 4
  PYTHONPATH=src python -m repro_torch.launch.train --task detection --device cpu \\
      --rounds 3 --mode async --stream --clients 8 --buffer-size 4
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --replay-schedule run.schedule.json
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --mode async \\
      --transport socket --clients 4 --buffer-size 2 --rounds 3 \\
      --wire-codec quant8 --record-schedule "$TMPDIR"/run.schedule.json
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --mode async \\
      --transport socket --durable-dir "$TMPDIR"/run --snapshot-every 2 --fault-plan kill@5
  PYTHONPATH=src python -m repro_torch.launch.train --restore "$TMPDIR"/run

Runs the paper's federated detection workload: FedYOLOv3 over a
partitioned synthetic scene pool, the Task Scheduler and the Explorer's
load model choosing participants, the ``--agg`` aggregation through the
CUDA kernels (``agg_impl="kernel"``: K1 for dense, eq6, static_topn,
topk_ef and the server optimizers, K5a for quant8, K7 for quant4, K8 for
secure, K6 + the base's kernel for hier), COS checkpoints every 5 rounds with
``--store``, global and per-client mAP@0.5 every ``--eval-every`` rounds
(IoU and NMS kernels). After the last round the global model is published
to a ``ModelSlot`` and 4 synthetic frames are decoded through the serving
plane's detection program: train -> evaluate -> serve.

The LM workload (``--task lm``, or ``auto`` with an LM ``--arch``: any of
the registry's ten, dense, MoE, gemma3, ssm, the zamba2 hybrid, llava and
hubert) trains on ``fed_batches``' streams (``--partition stream`` gives
each client its own Markov drift, a scenario splits a labeled pool of a
text arch; hubert trains on frames and masked cluster labels, llava on
image embeddings before its tokens) at ``--batch`` sequences of ``--seq``
positions per local step, with flash attention (K9) and the SSD chunk scan
(K10) in the forward on the card and their plain versions' gradients, and
prints the reference's summary JSON. ``--device`` defaults to ``cuda`` and never falls
back to the CPU.

As the reference's launcher does, the server runs on a 1 x 1 client mesh
(:func:`client_mesh`: a ``DeviceMesh`` with dims ``("data", "model")``,
``client_axis="data"``, on a one-rank process group, NCCL on the card and
gloo on the host), so ``--agg quant8`` takes the gathered int8 transport
(K5a, an int8 all-gather, the decode-reduce) and not the fused K4.
``--participation compact --max-participants K`` trains exactly K clients a
round. Every registered aggregator but the fedsgd topology is a ``--agg``
choice (fedsgd is reached through ``FLServer`` / ``build_fed_round``).

``--mode async`` runs the buffered FedBuff engine on a simulated clock
(``core.async_engine``, DESIGN.md §12): a flush every ``--buffer-size``
landed updates, discounted by ``(1 + staleness)^-alpha``, updates staler
than ``--max-staleness`` dropped and counted; ``--rounds`` counts flushes.
``--stream`` takes the streaming flush (a ring of global rows and a running
sum, O(buffer · N) memory; it forces ``--agg dense`` and a stateless sgd).
``--replay-schedule`` replays a recorded arrival schedule (JSON) through
the arrival engine and exits.

``--transport socket`` runs a real multi-process federation (DESIGN.md
§14): worker processes (``repro_torch.launch.worker``) train on
``--device`` and upload over TCP, and the landing loop feeds the arrival
engine in wall-clock order; ``--rounds`` counts flushes, ``--wire-codec``
picks the uplink encoding and ``--record-schedule`` writes the recorded
arrival schedule. ``--durable-dir`` journals every landing-loop event and
snapshots the engine every ``--snapshot-every`` landings; with
``--fault-plan kill@M`` the server is killed after M landings and recovers
from the snapshot and the journal on the same port. ``--restore`` rebuilds
the engine from such a directory and reports what came back.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import sys
from typing import Any

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.checkpoint import ObjectStore
from repro_torch.configs import REGISTRY, get_arch
from repro_torch.core import aggregators, monitor, serving
from repro_torch.core.rounds import FedConfig
from repro_torch.core.scheduler import SchedulerConfig, TaskScheduler
from repro_torch.core.server import FLServer
from repro_torch.data import partition, synthetic
from repro_torch.data.pipeline import detection_suite, fed_batches
from repro_torch.optim import adamw, sgd

SERVE_FRAMES = 4  # frames decoded through the serving program after training


def default_topn(cfg) -> int:
    """Paper: user-set n. Default: a quarter of the layer buckets
    (``launch/specs.py::default_topn``)."""
    return max(1, (cfg.n_layers + 1) // 4)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None,
                    help="architecture; optional with --task detection (defaults to fedyolov3)")
    ap.add_argument("--task", default="auto", choices=["auto", "lm", "detection"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu; no fallback")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="run server.evaluate_round every N rounds (and after the last)")
    ap.add_argument("--img-size", type=int, default=64, help="detection scene size")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--local-steps", type=int, default=1)
    # any registered aggregator (fedsgd is a topology, not a CLI mode here)
    ap.add_argument("--agg", default="eq6", choices=[n for n in aggregators.names() if n != "fedsgd"])
    ap.add_argument("--server-lr", type=float, default=None,
                    help="fedavgm/fedadam server step (default: 1.0 for fedavgm, 0.02 for fedadam)")
    ap.add_argument("--group-size", type=int, default=0,
                    help="hier: clients per edge group (must divide --clients; "
                    "1 or --clients delegates to the flat base bit for bit)")
    ap.add_argument("--hier-base", default="dense",
                    help="hier: the stacked aggregator composed over group rows")
    ap.add_argument("--topn", type=int, default=0)
    ap.add_argument("--mode", default="sync", choices=["sync", "async"],
                    help="round control plane: sync (wait for every selected client) or async "
                    "(buffered staleness-weighted flushes on a simulated clock)")
    ap.add_argument("--buffer-size", type=int, default=0,
                    help="async: flush after this many landed updates (0 -> clients, which "
                    "reproduces the sync round)")
    ap.add_argument("--staleness-alpha", type=float, default=0.5,
                    help="async: polynomial staleness discount (1+s)^-alpha")
    ap.add_argument("--stream", action="store_true",
                    help="async: streaming O(buffer_size*N) flush (forces --agg dense and a "
                    "stateless sgd local optimizer)")
    ap.add_argument("--max-staleness", type=int, default=0,
                    help="async: drop updates staler than this many versions (0 -> keep all)")
    ap.add_argument("--transport", default="inproc", choices=["inproc", "socket"],
                    help="inproc: simulated clients in this process; socket: real worker "
                    "processes over TCP (needs --mode async; --rounds counts flushes)")
    ap.add_argument("--wire-codec", default="dense",
                    choices=["dense", "quant8", "quant4", "topk"],
                    help="socket: UPDATE payload encoding (dense f32 rows, int8 or 4-bit "
                    "block-quantized deltas, or sparse top-k deltas; transport/codec.py)")
    ap.add_argument("--record-schedule", default="",
                    help="socket: write the recorded arrival schedule (JSON) here")
    ap.add_argument("--replay-schedule", default="",
                    help="replay a recorded arrival schedule through the arrival engine and exit")
    ap.add_argument("--durable-dir", default="",
                    help="socket: durable run directory (landing WAL + engine snapshots; the "
                    "server survives a kill)")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="socket: full-engine snapshot every N landings (0 = WAL only; needs "
                    "--durable-dir)")
    ap.add_argument("--fault-plan", default="",
                    help="socket: deterministic fault injection spec (transport/faults.py "
                    "grammar, e.g. 'client.corrupt@2:update;kill@6'); with --durable-dir a "
                    "kill@M recovers from snapshot + WAL")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="socket: seed for the fault plan's deterministic choices")
    ap.add_argument("--restore", default="",
                    help="recover an engine from a --durable-dir directory, print the recovery "
                    "report and exit")
    ap.add_argument("--participation", default="full", choices=["full", "masked", "compact"])
    ap.add_argument("--max-participants", type=int, default=0,
                    help="scheduler budget per round (0 -> clients//2, min 2)")
    ap.add_argument("--fairness-rounds", type=int, default=4,
                    help="force-include clients idle this many rounds")
    ap.add_argument("--partition", default="stream", choices=["stream", *partition.SCENARIOS],
                    help="client data split; stream means the iid control for detection")
    ap.add_argument("--alpha", type=float, default=0.5, help="dirichlet label-skew concentration")
    ap.add_argument("--topk-frac", type=float, default=0.1,
                    help="topk_ef: upload fraction k/N of the packed row")
    ap.add_argument("--topk-quant", default="none", choices=["none", "quant4"],
                    help="topk_ef: quantize the selected values to 4 bits")
    ap.add_argument("--quant4-mode", default="stochastic", choices=["stochastic", "nearest", "skip"],
                    help="quant4 rounding (skip -> dense bit for bit)")
    ap.add_argument("--quant4-seed", type=int, default=0,
                    help="quant4/topk_ef: per-round stochastic-rounding key seed")
    ap.add_argument("--secure-domain", default="int8", choices=["int8", "int4"],
                    help="secure: integer domain the masked sums run in")
    ap.add_argument("--no-secure-mask", action="store_true",
                    help="secure: skip the pairwise masks (the quantized sum only)")
    ap.add_argument("--secure-session", type=int, default=0,
                    help="secure: session key the per-round pair masks derive from")
    ap.add_argument("--batch", type=int, default=4,
                    help="images or sequences per client per local step")
    ap.add_argument("--seq", type=int, default=64, help="LM: tokens per sequence")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "sgd"])
    ap.add_argument("--full-size", action="store_true", help="use the full (non-reduced) config")
    ap.add_argument("--store", default="", help="COS object-store directory")
    ap.add_argument("--print-plan", action="store_true",
                    help="print the production launch plans of --arch at train_4k and exit")
    ap.add_argument("--seed", type=int, default=0, help="initial model and load model seed")
    return ap


@dataclasses.dataclass
class TrainRun:
    """What a run leaves behind: the server (history, evals, state) and the
    JSON summary; a detection run also the slot the trained model was
    published to, the eval holdout and the served frames' decode (None for
    an LM run)."""

    server: FLServer
    slot: serving.ModelSlot | None
    eval_batch: dict | None
    served: dict | None
    summary: dict[str, Any]


def _check_socket(args) -> None:
    """The reference launcher's checks of the socket flags."""
    if args.snapshot_every and not args.durable_dir:
        raise ValueError("--snapshot-every needs --durable-dir")
    if (args.durable_dir or args.fault_plan) and args.transport != "socket":
        raise ValueError("--durable-dir/--fault-plan belong to --transport socket")
    if args.transport == "socket":
        if args.mode != "async":
            raise ValueError("--transport socket is the async control plane over a real wire; "
                             "pass --mode async")
        if args.stream or args.task == "detection":
            raise ValueError("--transport socket runs the buffered arrival engine (lm "
                             "workload, no --stream)")
        if args.arch is None:
            raise ValueError("--arch is required")


def _check_ported(args) -> None:
    """Refuse the reference launcher's invalid flag combinations; apply its
    ``--stream`` coercions."""
    _check_socket(args)
    if args.mode == "async" and args.participation != "full":
        raise ValueError("--mode async owns its own participation plane (the event queue); "
                         "drop --participation")
    if args.agg != "hier" and (args.group_size or args.hier_base != "dense"):
        raise ValueError("--group-size/--hier-base configure the hierarchical aggregator; "
                         "pass --agg hier")
    if args.stream:
        if args.mode != "async":
            raise ValueError("--stream is an async flush discipline; pass --mode async")
        if args.agg not in ("dense", "eq6"):  # eq6 is the default; coerce it
            raise ValueError("--stream folds aggregation into a running sum; only "
                             "--agg dense streams")
        args.agg = "dense"
        args.optimizer = "sgd"
        if args.max_staleness < 1:
            args.max_staleness = 4  # the dispatch ring needs a bound


def resolve_task(args) -> str:
    """``--task auto`` -> detection for a yolo-family or absent ``--arch``,
    lm otherwise."""
    if args.task != "auto":
        return args.task
    return "detection" if args.arch is None or get_arch(args.arch).family == "yolo" else "lm"


def fed_config(args, cfg) -> FedConfig:
    """The round configuration both tasks build from the flags; the
    aggregation runs through the CUDA kernels (``agg_impl="kernel"``)."""
    return FedConfig(
        n_clients=args.clients,
        local_steps=args.local_steps,
        aggregation=args.agg,
        topn=args.topn or default_topn(cfg),
        client_axis="data",
        data_axis=None,
        participation=args.participation,
        max_participants=budget(args) if args.participation == "compact" else 0,
        mode=args.mode,
        buffer_size=args.buffer_size,
        staleness_alpha=args.staleness_alpha,
        max_staleness=args.max_staleness,
        stream=args.stream,
        agg_impl="kernel",
        # fedadam's adaptive step is about server_lr per coordinate: it needs
        # a small one out of the box
        server_lr=args.server_lr if args.server_lr is not None else (
            0.02 if args.agg == "fedadam" else 1.0),
        group_size=args.group_size,
        hier_base=args.hier_base,
        topk_frac=args.topk_frac,
        topk_quant=args.topk_quant,
        quant4_mode=args.quant4_mode,
        quant4_seed=args.quant4_seed,
        secure_domain=args.secure_domain,
        secure_mask=not args.no_secure_mask,
        secure_session=args.secure_session,
    )


def budget(args) -> int:
    """The scheduler's per-round budget: ``--max-participants``, else
    ``clients // 2`` and at least 2."""
    return args.max_participants or max(2, args.clients // 2)


def client_mesh(dev: torch.device):
    """The reference launcher's 1 x 1 client mesh for ``dev``: a
    ``DeviceMesh`` with dims ``("data", "model")`` over a one-rank process
    group. The group is initialised once per process if none exists (gloo
    for the host, and NCCL beside it where there is a card, so host and
    card meshes share it; a ``HashStore`` rendezvous, so no port and no
    network), and the mesh is built once per group and device type."""
    import torch.distributed as dist

    if not dist.is_initialized():
        nccl = torch.cuda.is_available() and dist.is_nccl_available()
        dist.init_process_group("cpu:gloo,cuda:nccl" if nccl else "gloo", store=dist.HashStore(),
                                rank=0, world_size=1)
    return _client_mesh(torch.device(dev).type, dist.group.WORLD)


@functools.cache
def _client_mesh(kind: str, world):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    config = dist.get_backend_config(world)
    want = "nccl" if kind == "cuda" else "gloo"
    if dist.get_world_size(world) != 1 or dict(b.split(":") for b in config.split(",")).get(kind) != want:
        raise RuntimeError(
            f"the 1 x 1 client mesh on {kind} needs a one-rank process group with {want} for "
            f"{kind} tensors; this process already has a {dist.get_world_size(world)}-rank group "
            f"with backends {config!r}")
    return make_host_mesh(1, 1, kind)


def make_server(args, cfg, fed: FedConfig, dev: torch.device, task_id: str) -> FLServer:
    """The FL server for parsed ``args`` on the 1 x 1 client mesh: the
    optimizer, the COS store (checkpoints every 5 rounds), the scheduler's
    :func:`budget` and fairness floor."""
    if args.stream:
        optimizer = sgd(args.lr, momentum=0.0)  # stateless: the ring keeps no opt rows
    else:
        optimizer = adamw(args.lr) if args.optimizer == "adamw" else sgd(args.lr)
    store = ObjectStore(args.store) if args.store else None
    return FLServer(
        cfg, fed, optimizer, store=store,
        scheduler=TaskScheduler(fed.n_clients, SchedulerConfig(
            max_participants=budget(args), fairness_rounds=args.fairness_rounds)),
        seed=args.seed, checkpoint_every=5 if store else 0, task_id=task_id, device=dev,
        mesh=client_mesh(dev),
    )


def _summary(server: FLServer, args, dev: torch.device) -> dict[str, Any]:
    history = server.history
    summary = {
        "final_loss": history[-1].loss,
        "rounds": len(history),
        "participation": args.participation,
        "mean_participants": sum(len(r.participants) for r in history) / len(history),
    }
    if server.engine is not None:
        stal = [s for r in history for s in r.staleness]
        summary.update(
            mode="async",
            sim_seconds=history[-1].sim_time,
            mean_staleness=(sum(stal) / len(stal)) if stal else 0.0,
            dropped=server.engine.dropped_total,
        )
    summary["device"] = _device_name(dev)
    return summary


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def replay_schedule(args) -> dict[str, Any]:
    """Replay the recorded arrival schedule at ``--replay-schedule`` through
    the arrival engine on ``--device``; raises ``ReplayMismatch`` at the
    first event whose re-derivation disagrees with the record."""
    from repro_torch.core.transport import replay as rp

    dev = D.resolve(args.device)
    schedule = rp.ArrivalSchedule.load(args.replay_schedule)
    engine = rp.replay(schedule, device=dev)
    return {
        "replayed_events": len(schedule.events),
        "flushes": len(engine.history),
        "final_loss": engine.history[-1].loss if engine.history else float("nan"),
        "dropped": engine.dropped_total,
        "deterministic": True,
        "device": _device_name(dev),
    }


def run_socket(args, log=lambda m: print(m, flush=True)) -> dict[str, Any]:
    """``--transport socket``: a real multi-process federation on
    ``--device`` (``harness.wire_run``), then the wire summary (logged) and
    the reference's JSON keys; writes the recorded schedule to
    ``--record-schedule``."""
    from repro_torch.core.transport import harness

    _check_socket(args)
    dev = D.resolve(args.device)
    meta = harness.make_meta(
        args.arch,
        reduced=not args.full_size,
        n_clients=args.clients,
        buffer_size=args.buffer_size,
        max_staleness=args.max_staleness,
        staleness_alpha=args.staleness_alpha,
        aggregation=args.agg if args.agg != "eq6" else "dense",
        local_steps=args.local_steps,
        batch=args.batch,
        seq=args.seq,
        seed=args.seed,
        lr=args.lr,
        wire_codec=args.wire_codec,
    )
    res = harness.wire_run(
        meta, args.rounds,
        durable_root=args.durable_dir or None,
        snapshot_every=args.snapshot_every,
        fault_plan=args.fault_plan,
        fault_seed=args.fault_seed,
        device=dev,
    )
    if args.record_schedule:
        res.schedule.save(args.record_schedule)
    log(monitor.render_wire(args.arch, res.history, res.stats, args.clients,
                            liveness_log=res.liveness_log))
    stal = [s for r in res.history for s in r.staleness]
    return {
        "final_loss": res.history[-1].loss if res.history else float("nan"),
        "rounds": len(res.history),
        "mode": "async",
        "transport": "socket",
        "wire_codec": args.wire_codec,
        "landed": res.stats.landed,
        "dropped": res.dropped_total,
        "mean_staleness": (sum(stal) / len(stal)) if stal else 0.0,
        "bytes_up": res.stats.bytes_up,
        "bytes_down": res.stats.bytes_down,
        "deadline_hit": res.stats.deadline_hit,
        "recovered": res.recovered,
        "snapshots": res.stats.snapshots,
        "wal_events": res.stats.wal_events,
        "crc_errors": res.stats.crc_errors,
        "faults_injected": res.stats.faults_injected,
        "device": _device_name(dev),
    }


def restore(args) -> dict[str, Any]:
    """``--restore``: recover an engine on ``--device`` from a durable run
    directory (the newest valid snapshot, then the WAL suffix through the
    row update) and report what came back."""
    from repro_torch.checkpoint.durable import DurableRun

    dev = D.resolve(args.device)
    run = DurableRun(args.restore)
    engine, replayed = run.recover_engine(device=dev)
    return {
        "restored_from": str(args.restore),
        "wal_events": run.n_events,
        "events_replayed": replayed,
        "version": engine.version,
        "flushes_recovered": len(engine.history),
        "staged_window": list(engine.staged()),
        "final_loss": engine.history[-1].loss if engine.history else float("nan"),
        "device": _device_name(dev),
    }


def train_lm(args, log=lambda m: print(m, flush=True), cfg=None) -> TrainRun:
    """Federated LM training for parsed ``args``: any LM arch of the registry
    (dense, MoE, gemma3's local/global pattern, ssm, the zamba2 hybrid,
    llava's image tokens, hubert's masked frames), reduced unless
    ``--full-size``, with the kernel branches on (``attention_impl`` /
    ``ssm_impl`` = ``"kernel"``). ``cfg`` trains that config of ``--arch``
    in place of the registry's (``chip_smoke.py`` passes published widths
    cut in depth)."""
    _check_ported(args)
    if args.arch is None:
        lms = sorted(n for n, c in REGISTRY.items() if c.family != "yolo")
        raise ValueError(f"--task lm needs --arch, one of {lms}")
    dev = D.resolve(args.device)
    if cfg is None:
        cfg = get_arch(args.arch)
        if not args.full_size:
            cfg = cfg.reduced()
    if cfg.family == "yolo":
        raise ValueError(f"--task lm needs an LM arch (got {args.arch})")
    cfg = dataclasses.replace(cfg, attention_impl="kernel", ssm_impl="kernel")
    fed = fed_config(args, cfg)
    server = make_server(args, cfg, fed, dev, args.arch)
    batches = fed_batches(cfg, fed, batch=args.batch, seq=args.seq,
                          partition_name=args.partition, alpha=args.alpha)
    server.fit(batches, args.rounds, log=log)
    summary = _summary(server, args, dev)
    if server.store:
        summary["stored_rounds"] = server.store.rounds(args.arch)
    return TrainRun(server, None, None, None, summary)


def train_detection(args, log=lambda m: print(m, flush=True)) -> TrainRun:
    """The train -> evaluate -> serve sequence for parsed ``args``."""
    _check_ported(args)
    dev = D.resolve(args.device)
    cfg = get_arch(args.arch or "fedyolov3")
    if cfg.family != "yolo":
        raise ValueError(f"--task detection needs a yolo-family arch (got {args.arch})")
    if not args.full_size:
        cfg = cfg.reduced()
    fed = fed_config(args, cfg)
    task_id = cfg.name
    server = make_server(args, cfg, fed, dev, task_id)
    store = server.store
    scenario = "iid" if args.partition == "stream" else args.partition
    gen, eval_batch, _ = detection_suite(cfg, fed, batch=args.batch, img_size=args.img_size,
                                         scenario=scenario, alpha=args.alpha)
    if args.eval_every:
        step = server.run_async if server.engine is not None else server.run_round
        for r in range(args.rounds):
            rec = step(next(gen))
            if r % args.eval_every == 0 or r == args.rounds - 1:
                ev = server.evaluate_round(eval_batch)
                per = " ".join(f"{m:.3f}" for m in ev.per_client_map)
                log(f"round {rec.round_idx:4d}  loss {rec.loss:.4f}  "
                    f"mAP@0.5 {ev.map50:.3f}  per-client [{per}]")
    else:
        server.fit(gen, args.rounds, log=log)
    history = server.history

    # serve: publish the global model, decode frames through the program
    slot = serving.ModelSlot()
    model = server.global_params()
    slot.publish(len(history), model)
    imgs, _ = synthetic.scene_images(np.random.default_rng(7), SERVE_FRAMES, args.img_size,
                                     cfg.vocab_size)
    program = serving.detection_program(cfg, FedConfig(n_clients=1).serve_max_detections, dev)
    served = serving.to_host(program(slot.snapshot().params, torch.from_numpy(imgs)))
    kept = int(served["valid"].sum())
    log(f"serving {SERVE_FRAMES} frames (version {len(history)}): {kept} detections after NMS "
        f"(top score {float(served['scores'].max()):.3f})")

    summary = {**_summary(server, args, dev), "served_version": len(history),
               "served_detections": kept}
    if store:
        summary["stored_rounds"] = store.rounds(task_id)
    if server.eval_history:
        log(monitor.render_task(task_id, history, fed.n_clients, eval_history=server.eval_history))
        summary["final_map"] = server.eval_history[-1].map50
        summary["per_client_map"] = server.eval_history[-1].per_client_map
    return TrainRun(server, slot, eval_batch, served, summary)


def print_plan(arch_name: str) -> None:
    """The reference launcher's ``--print-plan``: the single- and multi-pod
    ``train_4k`` plans of ``launch.specs.make_plan``, line for line."""
    from repro_torch.launch import specs

    for multi in (False, True):
        plan = specs.make_plan(arch_name, "train_4k", multi)
        print(f"== {plan.name}")
        print(f"   kind={plan.kind} aggregation={plan.aggregation}")
        if plan.fed:
            print(f"   clients={plan.fed.n_clients} client_axis={plan.fed.client_axis} "
                  f"data_axis={plan.fed.data_axis} microbatches={plan.fed.microbatches} "
                  f"topn={plan.fed.topn}")
        print(f"   rules={ {k: v for k, v in plan.rules.items() if v} }")


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    if args.print_plan and not (args.replay_schedule or args.restore
                                or args.transport == "socket"):
        arch = args.arch or ("fedyolov3" if args.task == "detection" else None)
        if arch is None:
            raise ValueError("--arch is required (or pass --task detection)")
        print_plan(arch)
        return {}
    if args.replay_schedule:
        summary = replay_schedule(args)
    elif args.restore:
        summary = restore(args)
    elif args.transport == "socket":
        summary = run_socket(args)
    else:
        summary = (train_lm(args) if resolve_task(args) == "lm" else train_detection(args)).summary
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main(sys.argv[1:])
    import torch.distributed as dist

    if dist.is_initialized():  # the 1 x 1 client mesh's one-rank group
        dist.destroy_process_group()
