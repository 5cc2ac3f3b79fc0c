"""Full-platform demo (port of ``examples/multi_task_platform.py``): the Task
Manager coordinating two concurrent federated tasks (an LM and the
FedYOLOv3 detector), with scheduler-driven participation, client
drop/reconnect simulation, the Fig.-9-style monitor view, and secure
(pairwise-masked) aggregation shown on the side.

    PYTHONPATH=src python -m repro_torch.examples.multi_task_platform [--device cpu]

:func:`run_platform` is the reference's ``main()`` body over given configs
and sizes; ``main()`` calls it with the reference's own settings (qwen3-1.7b
reduced, fedyolov3 at img 32, batch 2, 8 and 6 rounds). Both tasks aggregate
through K1 (dense and eq6, ``agg_impl="kernel"``). The reference runs on a
1 x 1 client mesh, which changes nothing for dense or eq6: the port's
``FLServer`` takes K1 with or without one, so no mesh is passed.
``--device`` defaults to ``cuda``; ``cpu`` runs the kernels' plain versions.
"""
from __future__ import annotations

import argparse
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.configs import get_arch
from repro_torch.core import monitor, rounds, secure_agg
from repro_torch.core.client import ClientConfig, FLClient
from repro_torch.core.rounds import FedConfig
from repro_torch.core.server import FLServer
from repro_torch.core.task_manager import FederatedTask, TaskManager
from repro_torch.data.pipeline import fed_batches
from repro_torch.models.params import flatten_with_paths, map_tree
from repro_torch.optim import adamw, sgd

Log = Callable[[str], None]
Timer = Callable[[str, Callable[[], Any]], Any]


def fed_configs() -> tuple[FedConfig, FedConfig]:
    """The reference's two tasks: the LM (eq6 top-2, 3 clients) and the
    detector (dense, 2 clients)."""
    fed_lm = FedConfig(n_clients=3, local_steps=1, aggregation="eq6", topn=2, client_axis="data",
                       data_axis=None, agg_impl="kernel")
    fed_yolo = FedConfig(n_clients=2, local_steps=1, aggregation="dense", client_axis="data",
                         data_axis=None, agg_impl="kernel")
    return fed_lm, fed_yolo


def task_round(server: FLServer, batches: Iterator, task_id: str,
               timer: Timer | None = None) -> Callable[[int], dict]:
    """A task's ``run_round``: one sync round on the next batch, its record
    as a dict. ``timer(task_id, run)`` runs the round alone (the batch is
    drawn outside it) and returns its record."""
    def run(r: int) -> dict:
        batch = next(batches)
        if timer is None:
            return vars(server.run_round(batch))
        return vars(timer(task_id, lambda: server.run_round(batch)))

    return run


def drive(tm: TaskManager, clients: list[FLClient], rng: np.random.Generator,
          log: Log) -> tuple[int, list[str]]:
    """The reference's loop: a simulated drop/reconnect, then one fair-share
    pass, until no task is runnable -> (passes, the drop lines)."""
    passes, drops = 0, []
    while tm.runnable():
        # simulate a drop/reconnect each pass
        victim = clients[rng.integers(0, len(clients))]
        if rng.random() < 0.3 and victim.connected:
            alive = victim.drop()
            drops.append(f"client {victim.cfg.client_id} dropped "
                         f"({'will reconnect' if alive else 'out of reconnect budget'})")
            log(drops[-1])
        tm.step_all()
        passes += 1
    return passes, drops


def secure_error(server: FLServer, round_idx: int = 0) -> float:
    """The secure aggregation sidebar: ``secure_fedavg`` over the server's
    client trees (``unpacked_params``, the flat state's checkpoint/serve
    edge) against their plain mean -> the largest absolute gap."""
    stacked = rounds.unpacked_params(server.cfg, server.fed, server.state)
    n = server.fed.n_clients
    ups = [map_tree(lambda x, i=i: x[i], stacked) for i in range(n)]
    sec = secure_agg.secure_fedavg(ups, round_idx=round_idx)
    err = 0.0
    for (_, x), *leaves in zip(flatten_with_paths(sec), *map(flatten_with_paths, ups)):
        plain = sum(u.float() for _, u in leaves) / n
        err = max(err, float((x - plain).abs().max()))
    return err


def run_platform(lm_cfg, yolo_cfg, *, device: str | torch.device = "cuda", lm_batch: int = 2,
                 seq: int = 32, yolo_batch: int = 2, img_size: int = 32, lm_rounds: int = 8,
                 yolo_rounds: int = 6, timer: Timer | None = None,
                 log: Log = lambda m: print(m, flush=True)) -> dict[str, Any]:
    """Two tasks under one Task Manager, fair-share passes until both are
    done, both monitor views and the secure sidebar -> the servers, the
    passes, the drop lines, the views and the secure error."""
    dev = D.resolve(device)
    fed_lm, fed_yolo = fed_configs()
    lm_server = FLServer(lm_cfg, fed_lm, adamw(3e-3), seed=0, task_id="qwen3-1.7b", device=dev)
    yolo_server = FLServer(yolo_cfg, fed_yolo, sgd(1e-3), seed=0, task_id="fedyolov3", device=dev)
    lm_batches = fed_batches(lm_cfg, fed_lm, batch=lm_batch, seq=seq)
    yolo_batches = fed_batches(yolo_cfg, fed_yolo, batch=yolo_batch, seq=0, img_size=img_size)

    # clients with reconnect budgets (paper Configuration module)
    clients = [FLClient(ClientConfig(i, max_reconnects=2)) for i in range(3)]

    tm = TaskManager()
    tm.register(FederatedTask("lm", "qwen3-1.7b", lm_rounds,
                              task_round(lm_server, lm_batches, "lm", timer)))
    tm.register(FederatedTask("yolo", "fedyolov3", yolo_rounds,
                              task_round(yolo_server, yolo_batches, "yolo", timer)))

    passes, drops = drive(tm, clients, np.random.default_rng(0), log)
    log(f"\nTaskManager finished both tasks in {passes} fair-share passes\n")
    views = {
        "lm": monitor.render_task("lm", lm_server.history, fed_lm.n_clients,
                                  upload_bytes_per_round=1.7e6),
        "yolo": monitor.render_task("yolo", yolo_server.history, fed_yolo.n_clients,
                                    upload_bytes_per_round=48e6),
    }
    log(views["lm"])
    log("")
    log(views["yolo"])

    # secure aggregation sidebar: server only ever sees masked sums
    err = secure_error(lm_server)
    log(f"\nsecure aggregation: pairwise masks cancel to {err:.2e} (server never saw a raw update)")
    return {"tm": tm, "servers": {"lm": lm_server, "yolo": yolo_server}, "clients": clients,
            "passes": passes, "drops": drops, "views": views, "secure_err": err}


def main(argv: list[str] | None = None) -> dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu; no fallback")
    args = ap.parse_args(argv)
    # the reference's settings: qwen3-1.7b reduced; fedyolov3 is already CPU-sized
    return run_platform(get_arch("qwen3-1.7b").reduced(), get_arch("fedyolov3"),
                        device=args.device)


if __name__ == "__main__":
    main()
