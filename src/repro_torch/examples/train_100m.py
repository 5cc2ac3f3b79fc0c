"""End-to-end driver: federated training of a ~100M-parameter LM (port of
``examples/train_100m.py``).

    PYTHONPATH=src python -m repro_torch.examples.train_100m --rounds 200 [--device cpu]

The "production-shaped" example: granite-3-8b cut to 12 layers at d_model
640 (87 M parameters with its 49k vocab), trained for a few hundred
federated rounds across 4 non-IID clients with Eq. 6 upload compression
(K1 on the card), scheduler-driven participation and COS round checkpoints
every 50 rounds in ``--store``. The server runs on the launcher's 1 x 1
client mesh (``launch/train.py::client_mesh``), as the reference's example
runs on a (1, 1) mesh. ``--device`` defaults to ``cuda``; ``cpu`` runs the
kernels' plain versions. The last line is the reference's JSON summary
plus ``device``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
from typing import Any, Callable

import torch

from repro_torch import device as D
from repro_torch.checkpoint import ObjectStore
from repro_torch.configs import get_arch
from repro_torch.core.rounds import FedConfig, make_template
from repro_torch.core.scheduler import SchedulerConfig, TaskScheduler
from repro_torch.core.server import FLServer
from repro_torch.data.pipeline import fed_batches
from repro_torch.launch.train import client_mesh
from repro_torch.models.params import count_params
from repro_torch.optim import adamw

TASK_ID = "train100m"


def arch_100m():
    base = get_arch("granite-3-8b")
    return dataclasses.replace(
        base,
        name="granite-100m",
        n_layers=12,
        d_model=640,
        n_heads=8,
        n_kv_heads=4,
        head_dim=0,
        d_ff=1792,
        dtype="float32",
    )


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--store", default=os.path.join(tempfile.gettempdir(), "fedvision_cos"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu; no fallback")
    return ap


def main(argv: list[str] | None = None,
         log: Callable[[str], None] = lambda m: print(m, flush=True)) -> dict[str, Any]:
    """Run the example -> its JSON summary, with the server under ``"server"``."""
    args = build_parser().parse_args(argv)
    dev = D.resolve(args.device)
    cfg = dataclasses.replace(arch_100m(), attention_impl="kernel", ssm_impl="kernel")
    n = count_params(make_template(cfg))
    log(f"arch={cfg.name} params={n/1e6:.1f}M")
    fed = FedConfig(n_clients=args.clients, local_steps=1, aggregation="eq6",
                    topn=4, client_axis="data", data_axis=None, agg_impl="kernel")
    store = ObjectStore(args.store)
    t0 = time.time()
    server = FLServer(
        cfg, fed, adamw(3e-4), store=store, mesh=client_mesh(dev),
        scheduler=TaskScheduler(args.clients, SchedulerConfig(max_participants=args.clients)),
        checkpoint_every=50, task_id=TASK_ID, device=dev,
    )
    history = server.fit(fed_batches(cfg, fed, batch=args.batch, seq=args.seq), args.rounds,
                         log=log)
    summary = {
        "params_M": round(n / 1e6, 1),
        "rounds": len(history),
        "loss_first": round(history[0].loss, 4),
        "loss_last": round(history[-1].loss, 4),
        "wall_min": round((time.time() - t0) / 60, 1),
        "cos_rounds": store.rounds(TASK_ID),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    log(json.dumps(summary))
    return {**summary, "server": server}


if __name__ == "__main__":
    main()
    import torch.distributed as dist

    if dist.is_initialized():  # the 1 x 1 client mesh's one-rank group
        dist.destroy_process_group()
