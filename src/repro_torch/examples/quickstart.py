"""Quickstart: federated training of a small LM with the FedVision engine
(port of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--rounds 5] [--device cpu]

Four clients with non-IID token streams train locally; each round the
Yu-2017 Task Scheduler picks participants from quality/load scores (masked
participation — unselected clients skip the round), and the FL_SERVER
aggregates through the registry with the paper's Eq. 6 top-n upload
compression (K1 on the card). Any registered aggregation mode works via
``--agg``. The server runs on the launcher's 1 x 1 client mesh, as the
reference's example does. ``--device`` defaults to ``cuda``; ``cpu`` runs
the kernels' plain versions.
"""
from __future__ import annotations

import argparse
from typing import Any, Callable

from repro_torch import device as D
from repro_torch.configs import get_arch
from repro_torch.core import aggregators
from repro_torch.core.rounds import FedConfig
from repro_torch.core.scheduler import SchedulerConfig, TaskScheduler
from repro_torch.core.server import FLServer
from repro_torch.data.pipeline import fed_batches
from repro_torch.launch.train import client_mesh
from repro_torch.optim import adamw


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--agg", default="eq6", choices=[n for n in aggregators.names() if n != "fedsgd"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu; no fallback")
    return ap


def main(argv: list[str] | None = None,
         log: Callable[[str], None] = lambda m: print(m, flush=True)) -> dict[str, Any]:
    """Run the example -> its loss trajectory, mean participants and server."""
    args = build_parser().parse_args(argv)
    dev = D.resolve(args.device)
    arch = get_arch("qwen3-1.7b").reduced()
    fed = FedConfig(
        n_clients=4,
        local_steps=2,
        aggregation=args.agg,
        topn=2,
        client_axis="data",
        data_axis=None,
        participation="masked",  # scheduler-selected clients train; the rest sit out
        # fedadam's adaptive step is ~server_lr per coordinate — needs a small
        # one (see core/aggregators/server_opt.py); 1.0 is exact FedAvg otherwise
        server_lr=0.02 if args.agg == "fedadam" else 1.0,
        agg_impl="kernel",  # the port's CUDA kernels (their plain versions on the host)
    )
    server = FLServer(
        arch,
        fed,
        adamw(3e-3),
        scheduler=TaskScheduler(4, SchedulerConfig(max_participants=3)),
        mesh=client_mesh(dev),
        device=dev,
    )
    history = server.fit(fed_batches(arch, fed, batch=4, seq=48), n_rounds=args.rounds, log=log)
    first, last = history[0].loss, history[-1].loss
    mean_part = sum(len(r.participants) for r in history) / len(history)
    log(f"\nfederated loss {first:.3f} -> {last:.3f} over {len(history)} rounds "
        f"({args.agg}, mean participants {mean_part:.1f}/4)")
    assert last < first
    return {"losses": [r.loss for r in history], "mean_participants": mean_part,
            "server": server}


if __name__ == "__main__":
    main()
    import torch.distributed as dist

    if dist.is_initialized():  # the 1 x 1 client mesh's one-rank group
        dist.destroy_process_group()
