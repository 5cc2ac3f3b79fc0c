#!/usr/bin/env python3
"""Quick check of the multi-task platform on one CUDA card: ``chip_smoke.py``'s
phase 14 alone.

    python3 scripts/platform_check.py

Builds the kernel library, then runs phase 14a (``multi_task_platform``'s
two tasks at full width, qwen3-1.7b cut to 2 layers beside fedyolov3 at
416: K1 once a round, the monitor's views and JSON feeds, the secure
sidebar within 1e-3; K1 at both tasks' shapes bitwise against its plain
version), 14b (one shared SimClock under the Task Manager), 14c (the
trained detector served: 16 requests, K3 once a batch) and 14d (the
quickstart, 5 rounds). Exits non-zero without a card or on any
disagreement; the last line is phase 14's launch counts as JSON.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (puts this checkout's src on the path)


def main() -> int:
    if not torch.cuda.is_available():
        print("platform_check: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch import device as D
    from repro_torch.kernels import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    dev = D.resolve("cuda")
    _build.library()
    out = chip_smoke.phase14(dev, card)
    import torch.distributed as dist

    if dist.is_initialized():  # the quickstart's one-rank client group
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
