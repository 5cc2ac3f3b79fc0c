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

The LM workload (``--task lm``, or ``auto`` with an LM ``--arch``: the dense
qwen3-1.7b and the ssm mamba2-1.3b) trains on ``fed_batches``' token streams
(``--partition stream`` gives each client its own Markov drift, a scenario
splits a labeled pool) at ``--batch`` sequences of ``--seq`` tokens per
local step, with flash attention (K9) and the SSD chunk scan (K10) in the
forward on the card and their plain versions' gradients, and prints the
reference's summary JSON. ``--device`` defaults to ``cuda`` and never falls
back to the CPU.

As the reference's launcher does, the server runs on a 1 x 1 client mesh
(:func:`client_mesh`: a ``DeviceMesh`` with dims ``("data", "model")``,
``client_axis="data"``, on a one-rank process group, NCCL on the card and
gloo on the host), so ``--agg quant8`` takes the gathered int8 transport
(K5a, an int8 all-gather, the decode-reduce) and not the fused K4.
``--participation compact --max-participants K`` trains exactly K clients a
round. Every registered aggregator but the fedsgd topology is a ``--agg``
choice (fedsgd is reached through ``FLServer`` / ``build_fed_round``).
``--mode async``, ``--transport socket``, ``--restore`` and
``--replay-schedule`` belong to later slices and raise.
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
from repro_torch.configs import get_arch
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
    ap.add_argument("--mode", default="sync", choices=["sync", "async"])
    ap.add_argument("--transport", default="inproc", choices=["inproc", "socket"])
    ap.add_argument("--restore", default="", help="durable-run recovery (a later slice)")
    ap.add_argument("--replay-schedule", default="", help="schedule replay (a later slice)")
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


def _check_ported(args) -> None:
    if args.replay_schedule:
        raise NotImplementedError("--replay-schedule (the recorded wire schedule) is slice 5")
    if args.restore:
        raise NotImplementedError("--restore (durable-run recovery) is slice 5")
    if args.transport != "inproc":
        raise NotImplementedError("--transport socket (the multi-process wire) is slice 5")
    if args.mode != "sync":
        raise NotImplementedError("--mode async (the buffered engines) is slice 4")
    if args.agg != "hier" and (args.group_size or args.hier_base != "dense"):
        raise ValueError("--group-size/--hier-base configure the hierarchical aggregator; "
                         "pass --agg hier")


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
    from torch.distributed.device_mesh import init_device_mesh

    config = dist.get_backend_config(world)
    want = "nccl" if kind == "cuda" else "gloo"
    if dist.get_world_size(world) != 1 or dict(b.split(":") for b in config.split(",")).get(kind) != want:
        raise RuntimeError(
            f"the 1 x 1 client mesh on {kind} needs a one-rank process group with {want} for "
            f"{kind} tensors; this process already has a {dist.get_world_size(world)}-rank group "
            f"with backends {config!r}")
    return init_device_mesh(kind, (1, 1), mesh_dim_names=("data", "model"))


def make_server(args, cfg, fed: FedConfig, dev: torch.device, task_id: str) -> FLServer:
    """The FL server for parsed ``args`` on the 1 x 1 client mesh: the
    optimizer, the COS store (checkpoints every 5 rounds), the scheduler's
    :func:`budget` and fairness floor."""
    optimizer = adamw(args.lr) if args.optimizer == "adamw" else sgd(args.lr)
    store = ObjectStore(args.store) if args.store else None
    return FLServer(
        cfg, fed, optimizer, store=store,
        scheduler=TaskScheduler(fed.n_clients, SchedulerConfig(
            max_participants=budget(args), fairness_rounds=args.fairness_rounds)),
        seed=args.seed, checkpoint_every=5 if store else 0, task_id=task_id, device=dev,
        mesh=client_mesh(dev),
    )


def _summary(history, args, dev: torch.device) -> dict[str, Any]:
    return {
        "final_loss": history[-1].loss,
        "rounds": len(history),
        "participation": args.participation,
        "mean_participants": sum(len(r.participants) for r in history) / len(history),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def train_lm(args, log=lambda m: print(m, flush=True)) -> TrainRun:
    """Federated LM training for parsed ``args``: qwen3-1.7b (dense) or
    mamba2-1.3b (ssm), reduced unless ``--full-size``, with the kernel
    branches on (``attention_impl`` / ``ssm_impl`` = ``"kernel"``)."""
    _check_ported(args)
    if args.arch is None:
        raise ValueError("--task lm needs --arch (qwen3-1.7b or mamba2-1.3b)")
    dev = D.resolve(args.device)
    cfg = get_arch(args.arch)
    if cfg.family == "yolo":
        raise ValueError(f"--task lm needs an LM arch (got {args.arch})")
    if not args.full_size:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, attention_impl="kernel", ssm_impl="kernel")
    fed = fed_config(args, cfg)
    server = make_server(args, cfg, fed, dev, args.arch)
    batches = fed_batches(cfg, fed, batch=args.batch, seq=args.seq,
                          partition_name=args.partition, alpha=args.alpha)
    server.fit(batches, args.rounds, log=log)
    summary = _summary(server.history, args, dev)
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
        for r in range(args.rounds):
            rec = server.run_round(next(gen))
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

    summary = {**_summary(history, args, dev), "served_version": len(history),
               "served_detections": kept}
    if store:
        summary["stored_rounds"] = store.rounds(task_id)
    if server.eval_history:
        log(monitor.render_task(task_id, history, fed.n_clients, eval_history=server.eval_history))
        summary["final_map"] = server.eval_history[-1].map50
        summary["per_client_map"] = server.eval_history[-1].per_client_map
    return TrainRun(server, slot, eval_batch, served, summary)


def main(argv: list[str] | None = None) -> dict:
    args = build_parser().parse_args(argv)
    run = train_lm(args) if resolve_task(args) == "lm" else train_detection(args)
    print(json.dumps(run.summary), flush=True)
    return run.summary


if __name__ == "__main__":
    main(sys.argv[1:])
    import torch.distributed as dist

    if dist.is_initialized():  # the 1 x 1 client mesh's one-rank group
        dist.destroy_process_group()
