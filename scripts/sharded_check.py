#!/usr/bin/env python3
"""Quick check of the sharded model on one CUDA card: ``chip_smoke.py``'s
phase 18 alone.

    python3 scripts/sharded_check.py

Builds the kernel library, then runs phase 18: two rank processes sharing
the card over a gloo group (18a fedyolov3 at full width on (1, 2) and
(2, 1) meshes against rank 0's meshless runs; 18b qwen3-1.7b at its widths
cut to 2 layers on a (1, 2) mesh, each rank's state bytes, peak, round ms,
host collective seconds and layer-gather counters; 18d mamba2-1.3b at its
widths cut to 12 layers, one fedsgd step on (1, 2) through the layer
gather: state exactly half, the gather's high-water within 2 x (rest + one
layer), K10's launches, the peak, rank 0's meshless checks), then the
launcher's 1 x 1 NCCL mesh in this process (18c). Exits non-zero without a
card or on any disagreement.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (puts this checkout's src on the path)


def main() -> int:
    if not torch.cuda.is_available():
        print("sharded_check: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch import device as D
    from repro_torch.kernels import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    dev = D.resolve("cuda")
    t0 = time.perf_counter()
    _build.library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    chip_smoke.phase18(dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
