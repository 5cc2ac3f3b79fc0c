"""The system under test: the port's federated server, built as its
launcher builds it, and the readings the check takes from it.

The server is ``repro_torch.core.server.FLServer`` with the launcher's
round configuration (``launch/train.py::fed_config``: K1 for the aggregate,
the client axis on a one-rank 1 x 1 client mesh), the LM's kernel branches
on (K10 in the SSD), the scheduler's budget at every client, no COS
checkpoint. Its initial global row is the benchmark's (``weights``), and
each round is ``FLServer.run_round`` on a batch of the benchmark's pool.
"""
from __future__ import annotations

import dataclasses
import gc

import torch

from portbench import weights
from portbench.reference import layout


def _optimizer(opt: dict):
    """The port's optimizer of the mix's name (``repro_torch.optim.<name>``)."""
    from repro_torch import optim

    kw = {k: v for k, v in opt.items() if k != "name"}
    return getattr(optim, opt["name"])(**kw)


class Program:
    def __init__(self, config: dict, mix: dict, seed: int, device: torch.device):
        from repro_torch.configs import get_arch
        from repro_torch.core.scheduler import SchedulerConfig, TaskScheduler
        from repro_torch.core.server import FLServer
        from repro_torch.launch import train

        self.config, self.mix, self.seed = config, mix, seed
        sizes = config["sizes"]
        cfg = dataclasses.replace(get_arch(config["arch"]), **sizes, **config.get("overrides", {}))
        C = mix["clients"]
        args = train.build_parser().parse_args([
            "--arch", config["arch"], "--clients", str(C), "--local-steps", str(mix["local_steps"]),
            "--agg", mix["agg"], "--topn", str(mix["topn"]), "--max-participants", str(C)])
        fed = train.fed_config(args, cfg)
        self.server = FLServer(
            cfg, fed, _optimizer(mix["optimizer"]),
            scheduler=TaskScheduler(C, SchedulerConfig(max_participants=C)),
            seed=seed, checkpoint_every=0, device=device, mesh=train.client_mesh(device))
        self.leaves = layout.leaves_of(config["family"], sizes)
        params = self.server.state["params"]
        if params.shape != (C, self.leaves[-1].offset + self.leaves[-1].size):
            raise ValueError(f"the program's row {tuple(params.shape)} is not the layout's")
        with torch.no_grad():
            weights.fill_row(params[0], self.leaves, seed)
            params[1:].copy_(params[0])
        self.server.state["agg"] = self.server.aggregator.init_state(params)

    def run_round(self, batch: dict):
        """One round -> (its loss, the samples whose update entered the
        aggregate)."""
        rec = self.server.run_round(batch)
        E, b = self.mix["local_steps"], self.mix["batch"]
        return rec.loss, len(rec.participants) * E * b

    def first_update(self) -> torch.Tensor:
        """(C, L) norms of each client's first update per leaf, worked out
        from the optimizer's state after one step: sgd's momentum holds the
        clipped gradient, adamw's first moment (1 - b1) times the gradient."""
        opt = self.server.state["opt"]
        if "mu" in opt:
            moment, scale = opt["mu"], 1.0
        else:
            moment, scale = opt["m"], 1.0 / (1.0 - self.mix["optimizer"].get("b1", 0.9))
        norms = torch.stack([torch.linalg.vector_norm(moment[:, l.offset:l.offset + l.size], dim=1)
                             for l in self.leaves], dim=1)
        return norms.double().cpu() * scale

    def change(self) -> torch.Tensor:
        """(L,) norms of the parameters' change since the initial row, per
        leaf over every client's row."""
        return weights.change_norms(self.server.state["params"], self.leaves, self.seed)

    def state_bytes(self) -> int:
        """Bytes of every tensor of the round state (params, optimizer,
        aggregator)."""
        total = 0

        def walk(node):
            nonlocal total
            if isinstance(node, dict):
                for v in node.values():
                    walk(v)
            elif isinstance(node, (list, tuple)):
                for v in node:
                    walk(v)
            elif isinstance(node, torch.Tensor):
                total += node.numel() * node.element_size()

        walk(self.server.state)
        return total

    def close(self) -> None:
        """Free the program's state and its caches on the device."""
        from repro_torch.core import packing

        self.server = None
        packing.bucket_ids_on.cache_clear()
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
