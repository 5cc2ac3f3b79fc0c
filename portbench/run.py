"""The port's benchmark: one cell of ``BENCHMARK.json``, one run.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix, limits
and per-layer readers are files under ``portbench/`` found by name
(``portbench/spec.py``). A run:

1. set-up: builds the port's federated server as its launcher does, hands
   it the benchmark's initial row and a pool of distinct rounds made from
   ``--seed`` on the card, and drives it through the cell's first rounds
   (the window's own call and feed), reading what the check compares: each
   round's loss, each client's first update per leaf, the parameters'
   change per leaf after the first round and the last. These rounds also
   warm every shape up.
2. ``--trace 0``: the measured window, rounds closed-loop for ``--seconds``,
   ending on a synchronize at a round boundary -> the end-to-end metrics.
   ``--trace 1``: whole rounds under the profiler, one guard round at each
   end left out -> the per-layer metrics, ``busy_s``, ``window_s`` and a
   breakdown.
3. after the peak memory is read and the program's state freed, the plain
   reference (``portbench/reference``) follows the same first rounds, and
   ``correct`` is its comparison with the program (``portbench/check.py``).

The last line of standard output is the result's JSON; the numbers compared
and their limits are the last lines of standard error and the result's
last key. Without a card, or with fewer than the cell asks for, it exits 2
and prints no result; it exits 3 if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def process_age_s() -> float:
    """Seconds since this process started (``/proc``; 10 ms ticks)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start / os.sysconf("SC_CLK_TCK")


AGE0 = process_age_s()  # the process's age at T0


def _environment(root: Path) -> None:
    """Every cache inside the checkout, at fixed paths; the port's sources
    and the benchmark importable (and this file's folder not first on the
    path, where its modules would shadow others)."""
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if str(Path(p or ".").resolve()) != here]
    cache = root / "build" / "portbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    os.environ["USE_FLAX"] = "0"
    for path in (str(root), str(root / "src")):
        if path not in sys.path:
            sys.path.insert(0, path)


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name, clocks and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,power.draw,power.limit,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().replace("\n", " | ") or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def generator(mix: dict):
    """The mix's traffic generator, ``portbench/traffic/<generator>.py``,
    found by name."""
    import importlib

    return importlib.import_module(f"portbench.traffic.{mix['generator']}")


def build(cell, seed: int, device):
    """Set-up: the program with the benchmark's initial row, the pool, and
    the program's readings of the cell's first rounds."""
    import torch

    from portbench.program import Program

    marks = [("imports", time.monotonic())]
    prog = Program(cell.config, cell.mix, seed, device)
    marks.append(("program", time.monotonic()))
    pool = generator(cell.mix).pool(cell.mix, cell.config["sizes"], seed, device)
    marks.append(("pool", time.monotonic()))
    R = cell.mix["check_rounds"]
    if len(pool) < R + 1:
        raise ValueError(f"a pool of {len(pool)} rounds cannot hold {R} checked rounds and more")
    losses, first = [], None
    for r in range(R):
        losses.append(prog.run_round(pool[r])[0])
        marks.append((f"round {r + 1}", time.monotonic()))
        if r == 0:
            first, first_change = prog.first_update(), prog.change()
    readings = {"loss": torch.tensor(losses, dtype=torch.float64), "first_update": first,
                "first_change": first_change, "change": prog.change()}
    marks.append(("readings", time.monotonic()))
    log("set-up by step (s): " + ", ".join(
        f"{name} {t - prev:.3f}" for (name, t), (_, prev) in zip(marks, [("start", T0)] + marks)))
    return prog, pool, readings


def reference(cell, pool, seed: int, device, **kw) -> dict:
    from portbench.reference import fed

    return fed.follow(cell.config["family"], cell.config["sizes"], cell.mix,
                      pool[: cell.mix["check_rounds"]], seed, device, **kw)


def host_clocks() -> tuple[float, ...]:
    """(this thread's CPU seconds, the process's involuntary context
    switches, the machine's steal seconds): read around the window, they
    tell a host that computed more from one that was made to wait."""
    import resource

    try:
        with open("/proc/stat") as f:
            steal = int(f.readline().split()[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        steal = math.nan
    return time.thread_time(), resource.getrusage(resource.RUSAGE_SELF).ru_nivcsw, steal


def window(prog, pool, R: int, seconds: float, sync) -> dict:
    """Rounds closed-loop until ``seconds`` have passed, ending at a round
    boundary on a synchronize."""
    attempted = failed = samples = 0
    ends = []
    h0 = host_clocks()
    t0 = time.perf_counter()
    while True:
        attempted += 1
        try:
            loss, n = prog.run_round(pool[(R + attempted - 1) % len(pool)])
            ends.append(time.perf_counter())
        except Exception:  # a round that raises fails; the window ends with it
            traceback.print_exc()
            failed += 1
            break
        failed += not math.isfinite(loss)
        samples += n
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    t1 = time.perf_counter()
    return {"attempted": attempted, "failed": failed, "samples": samples, "seconds": t1 - t0,
            "host": [b - a for a, b in zip(h0, host_clocks())],
            "round_s": [b - a for a, b in zip([t0] + ends[:-1], ends)]}


def traced(cell, prog, pool, R: int, sizes: dict, on_card: bool) -> tuple[dict, dict]:
    from portbench import tracing

    n = cell.mix["trace_rounds"] + 2
    rec = tracing.traced_rounds(prog.run_round, [pool[(R + i) % len(pool)] for i in range(n)],
                                on_card)
    rec.update(flops_per_sample=cell.flops_per_sample(), clients=cell.mix["clients"],
               n_total=prog.leaves[-1].offset + prog.leaves[-1].size,
               n_buckets=sizes["n_layers"] + 1, state_bytes=prog.state_bytes(), sizes=sizes,
               mix=cell.mix)
    return rec, tracing.breakdown(rec)


def main(argv=None, *, device: str | None = None, root: Path = ROOT) -> int:
    """One run. ``device`` and ``root`` are for the benchmark's own tests
    (a CPU run of a small cell from a temporary copy); the command line
    always runs on the card."""
    args = parse(argv)
    _environment(ROOT)
    import torch

    from portbench import check, spec

    cell = spec.load(Path(root), args.workload)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            have = torch.cuda.device_count() if torch.cuda.is_available() else 0
            log(f"{cell.name} needs {cell.chips} CUDA device(s); this machine has {have}")
            return 2
        device = "cuda:0"
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sizes = cell.config["sizes"]
    R = cell.mix["check_rounds"]

    prog, pool, readings = build(cell, args.seed, dev)
    sync()
    setup_s = AGE0 + time.monotonic() - T0
    if on_card:
        log(f"card: {card_line()}")
    log(f"set-up {setup_s:.3f} s; first rounds' losses {readings['loss'].tolist()}")

    breakdown = None
    if args.trace:
        rec, breakdown = traced(cell, prog, pool, R, sizes, on_card)
        run = {"attempted": len(rec["samples"]), "failed": rec["failed"]}
        metrics = {}
        for m in cell.per_layer:
            if m["source"] == "device_trace" and not on_card:
                continue  # a host's trace gives no device metric
            value = cell.metric_reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": rec["busy_s"], "window_s": rec["window_s"]}
        log(f"trace: events by kind {rec['kinds']}; {len(rec['rounds'])} rounds in "
            f"{rec['window_s']:.6f} s, busy {rec['busy_s']:.6f} s; device ops {len(rec['ops'])} "
            f"in the kept rounds' spans of {rec['device_ops']} traced")
    else:
        run = window(prog, pool, R, args.seconds, sync)
        q = sorted(run["round_s"]) or [math.nan]
        log(f"window: {run['attempted']} rounds, {run['samples']} samples in "
            f"{run['seconds']:.6f} s; a round min {q[0]:.6f} median {q[len(q) // 2]:.6f} "
            f"max {q[-1]:.6f} s; host: cpu {run['host'][0]:.3f} s, involuntary switches "
            f"{run['host'][1]}, machine steal {run['host'][2]:.2f} s")
        extra = {}
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if not args.trace:
        values = {"setup_s": setup_s, "train_samples_per_s": run["samples"] / run["seconds"],
                  "peak_mem_gib": peak / 2**30}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    if on_card:
        log(f"card after the window: {card_line()}")
    prog.close()

    t_ref = time.monotonic()
    ref = reference(cell, pool, args.seed, dev)
    found = check.gaps(readings, ref)
    log(f"reference {time.monotonic() - t_ref:.3f} s; its losses {ref['loss'].tolist()}")
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    correct = run["failed"] == 0 and check.passes(found, cell.limits)

    loaded = sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)
    if loaded:
        log(f"JAX or the JAX package was loaded in this process: {loaded}")
        return 3
    log("read, not compared: " + ", ".join(f"{k} {v!r}" for k, v in found.items()
                                           if k not in cell.limits))
    compared = {k: {"value": found[k], "limit": v} for k, v in cell.limits.items()}
    for k, v in compared.items():
        print(f"compared {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr, flush=True)
    result = {
        "correct": bool(correct), "attempted": run["attempted"], "failed": run["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
                   "count": cell.chips, "memory_peak_bytes": int(peak), **extra},
        **({"breakdown": breakdown} if breakdown else {}),
        "compared": compared,
    }
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
