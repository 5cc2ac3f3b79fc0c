"""Wire-run orchestration: meta construction, worker processes, one call
to run a whole multi-process federation (port of
``repro/core/transport/harness.py``; DESIGN.md §14).

`make_meta` builds the run's self-description — the single dict that the
server, every worker process, and the replay harness all derive their
config/engine/batches from (it is also what `ArrivalSchedule` persists).
It carries no device: a schedule the port records replays through the
reference's `replay`, and the reverse. `wire_run` is the one-call harness
the scenario tests and ``launch/train.py --transport socket`` share: build
the engine on a WallClock on ``device``, start the `WireServer`, spawn
worker processes over real sockets (each trains on ``device`` too), serve
until the flush target, tear everything down, and hand back the schedule +
stats + final global row.

Workers are real OS processes (``python -m repro_torch.launch.worker``).
One process can host several client loops in threads (``client_ids``),
which amortizes the torch import and the model build across clients,
while scenario-specific clients (the crasher, the straggler) get their own
process so killing or delaying them touches nobody else.
"""
from __future__ import annotations

import dataclasses
import errno
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any

import numpy as np

import torch

from repro_torch.checkpoint.durable import DurableRun
from repro_torch.core.simclock import WallClock
from repro_torch.core.transport import replay as rp
from repro_torch.core.transport.faults import FaultPlan, ServerKilled
from repro_torch.core.transport.server import WireRunStats, WireServer

# shrink the reduced arch further for multi-process tests: every worker
# process builds the row update, so the model should be as small as the
# transformer stack allows while still exercising real packed rows
TINY_OVERRIDES = {"d_model": 64, "n_heads": 2, "n_kv_heads": 1, "d_ff": 128, "vocab_size": 128}

_run_counter = 0  # distinguishes WIRE_SCHEDULE_DIR dumps within one process


def make_meta(
    arch: str = "qwen3-1.7b",
    *,
    reduced: bool = True,
    overrides: dict | None = None,
    n_clients: int = 4,
    buffer_size: int = 2,
    max_staleness: int = 2,
    staleness_alpha: float = 0.5,
    aggregation: str = "dense",
    local_steps: int = 1,
    batch: int = 2,
    seq: int = 16,
    seed: int = 0,
    lr: float = 0.05,
    wire_codec: str = "dense",
    quant_block: int = 1024,
    queue_cap: int = 0,
    heartbeat_s: float = 0.2,
    heartbeat_timeout_s: float = 2.0,
) -> dict[str, Any]:
    return {
        "arch": arch,
        "reduced": reduced,
        "overrides": dict(overrides) if overrides else {},
        "n_clients": n_clients,
        "buffer_size": buffer_size,
        "max_staleness": max_staleness,
        "staleness_alpha": staleness_alpha,
        "aggregation": aggregation,
        "local_steps": local_steps,
        "batch": batch,
        "seq": seq,
        "seed": seed,
        "lr": lr,
        "transport": "socket",
        "wire_codec": wire_codec,
        "quant_block": quant_block,
        "queue_cap": queue_cap,
        "heartbeat_s": heartbeat_s,
        "heartbeat_timeout_s": heartbeat_timeout_s,
    }


def worker_cmd(meta_path: str, host: str, port: int, client_ids: list[int],
               extra: list[str] | None = None, *, device: str = "cuda") -> list[str]:
    return [
        sys.executable, "-m", "repro_torch.launch.worker",
        "--host", host, "--port", str(port),
        "--meta", meta_path,
        "--client-ids", ",".join(str(c) for c in client_ids),
        "--device", str(device),
        *(extra or []),
    ]


def spawn_worker(meta_path: str, host: str, port: int, client_ids: list[int],
                 extra: list[str] | None = None, *, device: str = "cuda") -> subprocess.Popen:
    src = Path(rp.__file__).resolve().parents[3]  # .../src
    env = {
        **os.environ,
        "PYTHONPATH": f"{src}{os.pathsep}{os.environ.get('PYTHONPATH', '')}".rstrip(os.pathsep),
    }
    return subprocess.Popen(
        worker_cmd(meta_path, host, port, client_ids, extra, device=device),
        env=env,
        stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE,
    )


@dataclasses.dataclass
class WireRunResult:
    meta: dict
    stats: WireRunStats
    schedule: rp.ArrivalSchedule
    history: list  # AsyncRoundRecord flushes, wall-clock arrival order
    global_row: np.ndarray  # final (N_total,) packed global
    dropped_total: int
    liveness_log: list[tuple[float, int, str]]
    worker_stderr: dict[str, str] = dataclasses.field(default_factory=dict)
    recovered: bool = False  # the run crossed a server kill + restore
    pre_crash_stats: WireRunStats | None = None  # first incarnation's counters
    recovery_s: float = 0.0  # host seconds from the kill to the recovered engine
    events_replayed: int = 0  # WAL events the recovery replayed past its snapshot


def _merge_stats(a: WireRunStats, b: WireRunStats) -> WireRunStats:
    """Whole-run counters across a crash: sums, maxes, ors as appropriate."""
    out = WireRunStats()
    for f in dataclasses.fields(WireRunStats):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name in ("queue_high_water", "faults_injected"):
            # high-water is a max by nature; faults_injected reads the ONE
            # shared plan's cumulative fire count on both sides of a crash
            setattr(out, f.name, max(x, y))
        elif isinstance(x, bool):
            setattr(out, f.name, x or y)
        else:
            setattr(out, f.name, x + y)
    return out


def wire_run(
    meta: dict,
    n_flushes: int,
    *,
    worker_groups: list[dict] | None = None,
    deadline_s: float = 180.0,
    land_delay_s: float = 0.0,
    port: int = 0,
    hooks=None,
    durable_root: str | Path | None = None,
    snapshot_every: int = 0,
    fault_plan: str = "",
    fault_seed: int = 0,
    recover: bool = True,
    device: str | torch.device = "cuda",
) -> WireRunResult:
    """One multi-process federation: engine + WireServer + worker processes.

    worker_groups: list of ``{"client_ids": [...], "extra": [cli flags]}``
    — one worker process per entry (default: all clients in one process).
    hooks: optional ``fn(server, workers)`` called right after workers
    spawn, before `serve` — scenario tests use it to kill a process mid-run.
    device: where the engine keeps its rows and every worker trains
    (``"cuda"`` by default; the workers get it as ``--device``).

    Durability + chaos (DESIGN.md §16): ``durable_root`` gives the run a
    `DurableRun` directory (landing WAL + snapshots every
    ``snapshot_every`` landings). ``fault_plan`` is a `faults.FaultPlan`
    spec applied on BOTH ends — the server wraps accepted sockets with its
    ``server.``-side ops (and honours ``kill@M``), worker processes get the
    same spec via ``--fault-plan`` for the ``client.``-side ops. When the
    plan kills the server and ``recover`` is set (and the run is durable),
    the harness rebuilds the engine from snapshot+WAL, rebinds the SAME
    port, and serves the remaining flushes — the still-running workers
    reconnect through their backoff loop. The result carries the COMBINED
    schedule (from the WAL — it spans the crash) and merged stats.

    With ``WIRE_SCHEDULE_DIR`` set in the environment, every run saves its
    recorded arrival schedule there (CI uploads the directory as an
    artifact on failure, so a red wire test can be replay-debugged locally
    via ``train.py --replay-schedule`` without rerunning the subprocesses).
    """
    faults = FaultPlan.parse(fault_plan, seed=fault_seed) if fault_plan else None
    durable = DurableRun(durable_root, meta) if durable_root else None
    engine = rp.make_engine(meta, clock=WallClock(), device=device)
    server = WireServer(engine, port=port, land_delay_s=land_delay_s,
                        durable=durable, snapshot_every=snapshot_every,
                        faults=faults)
    server.schedule.meta = dict(meta)
    groups = worker_groups or [{"client_ids": list(range(meta["n_clients"]))}]
    workers: list[subprocess.Popen] = []
    stderrs: dict[str, str] = {}
    pre_crash: WireRunStats | None = None
    recovered = False
    recovery_s, events_replayed = 0.0, 0
    with tempfile.TemporaryDirectory(prefix="fedwire_") as td:
        meta_path = str(Path(td) / "meta.json")
        Path(meta_path).write_text(json.dumps(meta))
        server.start()
        try:
            for g in groups:
                extra = list(g.get("extra") or [])
                if fault_plan and "--fault-plan" not in extra:
                    extra += ["--fault-plan", fault_plan,
                              "--fault-seed", str(fault_seed)]
                workers.append(
                    spawn_worker(meta_path, server.host, server.port,
                                 g["client_ids"], extra, device=str(engine.device))
                )
            if hooks is not None:
                hooks(server, workers)
            try:
                server.serve(n_flushes, deadline_s=deadline_s)
            except ServerKilled:
                if not (recover and durable is not None):
                    raise
                # -- crash recovery (DESIGN.md §16) --------------------------
                # everything below reads ONLY what survived on disk: the
                # first server's in-memory engine is dead to us, exactly as
                # it would be after a real kill -9.
                pre_crash = server.stats
                old_port = server.port
                # free the dead engine's rows on the device before the
                # recovery builds a second engine beside them
                history0 = engine.history
                server.engine = engine = None
                t_kill = time.perf_counter()
                durable2 = DurableRun(durable_root)
                events = durable2.events()
                resume_t = events[-1].t if events else 0.0
                engine2, events_replayed = durable2.recover_engine(
                    clock=WallClock(start=resume_t), device=device)
                recovery_s = time.perf_counter() - t_kill
                # the killed listener's port lingers until its blocked
                # accept() returns (kill() pops it, but a straggling
                # reconnect can re-arm the race) — retry the rebind
                for _ in range(40):
                    try:
                        server = WireServer(
                            engine2, port=old_port, land_delay_s=land_delay_s,
                            durable=durable2, snapshot_every=snapshot_every,
                            faults=faults, recovered=True,
                        )
                        break
                    except OSError as e:
                        if e.errno != errno.EADDRINUSE:
                            raise
                        time.sleep(0.25)
                else:
                    raise ConnectionError(
                        f"recovery could not rebind port {old_port}")
                server.schedule.meta = dict(meta)
                # splice histories: the recovered engine replayed flushes
                # since its snapshot; earlier rounds live in engine1's record
                cut = engine2.history[0].round_idx if engine2.history else engine2.version
                hist_prefix = [r for r in history0 if r.round_idx < cut]
                engine2.history[:0] = hist_prefix
                engine = engine2
                recovered = True
                server.start()
                server.serve(n_flushes - engine2.version, deadline_s=deadline_s)
        finally:
            server.stop()
            deadline = time.monotonic() + 20.0
            for i, p in enumerate(workers):
                try:
                    _, err = p.communicate(timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    _, err = p.communicate()
                if err:
                    stderrs[f"worker{i}"] = err.decode("utf-8", "replace")[-4000:]
    # the WAL spans the crash, so it — not either server's in-memory record
    # — is the run's full schedule once a recovery happened
    schedule = durable.schedule() if (durable is not None and recovered) else server.schedule
    if durable is not None:
        durable.close()
    dump_dir = os.environ.get("WIRE_SCHEDULE_DIR")
    if dump_dir:
        global _run_counter
        _run_counter += 1
        Path(dump_dir).mkdir(parents=True, exist_ok=True)
        schedule.save(
            Path(dump_dir) / f"schedule_{os.getpid()}_{_run_counter:03d}.json"
        )
    stats = _merge_stats(pre_crash, server.stats) if pre_crash else server.stats
    return WireRunResult(
        meta=meta,
        stats=stats,
        schedule=schedule,
        history=list(engine.history),
        global_row=engine.global_packed_row().float().cpu().numpy(),
        dropped_total=engine.dropped_total,
        liveness_log=list(server.liveness_log),
        worker_stderr=stderrs,
        recovered=recovered,
        pre_crash_stats=pre_crash,
        recovery_s=recovery_s,
        events_replayed=events_replayed,
    )
