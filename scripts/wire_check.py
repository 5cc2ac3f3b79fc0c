#!/usr/bin/env python3
"""Quick check of the socket wire on one CUDA card: ``chip_smoke.py``'s
phase 13 alone.

    python3 scripts/wire_check.py

Builds the kernel library, then runs phase 13a (the quant8 socket run at
qwen3-1.7b's full width cut to 2 layers, 3 flushes from 2 worker
processes of 2 clients each: K1 once a flush, the recorded schedule
replayed on the card within 1e-5, the landing loop's host ms by step; K1 at a flush's shape bitwise against its
plain version, with its device ms), 13b (the dense run snapshotted after
4 landings, killed after 5 and restored from snapshot + WAL, the WAL's
schedule replayed bitwise) and 13c (the launcher's socket, replay, durable
and restore paths at the reduced size), and prints the phase's seconds.
Exits non-zero without a card or on any disagreement.
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
        print("wire_check: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch import device as D
    from repro_torch.kernels import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    dev = D.resolve("cuda")
    _build.library()
    t0 = time.perf_counter()
    out = chip_smoke.phase13a(dev, card)
    print({k: v for k, v in out.items() if k != "runs"}, out["runs"], flush=True)
    print("13b K1 launches", chip_smoke.phase13b(dev, card), flush=True)
    chip_smoke.phase13c(dev, card)
    print(f"phase 13: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
