"""The readings that the limits in ``limits/<cell>.json`` are set from (not
run by the benchmark's runs).

    python3 portbench/calibrate.py --workload <cell> --seeds 1 2 ... [--controls 3] [--out FILE]

For each seed, in one process: the program's set-up rounds and the plain
reference's (the sound runs: their gaps are the lower readings). For the
first ``--controls`` seeds also the control, the reference computed with
TF32 on (the nearest precision below the configurations' f32 with TF32
off), and the fault of a step that leaves half of its batch out, the
reference on the first half of each batch; each put in the program's place
and compared with the f32 reference as the program is. A step that leaves
its state unchanged reads 1 on ``first_update_gap`` and ``change_gap`` and
needs no run. One JSON line a reading, on standard output and in ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1]), str(Path(__file__).resolve().parents[1] / "src")]

from portbench import run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    run._environment(run.ROOT)
    import torch

    from portbench import check, spec

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load(run.ROOT, args.workload)
    dev = torch.device("cuda:0")
    out = open(args.out, "a") if args.out else None

    def emit(**rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        prog, pool, readings = run.build(cell, seed, dev)
        torch.cuda.synchronize()
        prog.close()
        t1 = time.perf_counter()
        ref = run.reference(cell, pool, seed, dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        emit(cell=cell.name, seed=seed, kind="program", **check.gaps(readings, ref),
             loss=readings["loss"].tolist(), program_s=t1 - t0, reference_s=t2 - t1)
        if i < args.controls:
            for kind, kw in (("tf32", {"mode": "tf32"}), ("half_batch", {"fault": "half_batch"})):
                other = run.reference(cell, pool, seed, dev, **kw)
                emit(cell=cell.name, seed=seed, kind=kind, **check.gaps(other, ref),
                     loss=other["loss"].tolist())
        del pool, ref
        torch.cuda.empty_cache()
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
