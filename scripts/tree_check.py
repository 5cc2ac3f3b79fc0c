#!/usr/bin/env python3
"""Quick check of the legacy tree layout on one CUDA card: ``chip_smoke.py``'s
phase 19 alone.

    python3 scripts/tree_check.py

Builds the kernel library, then runs phase 19: fedyolov3 at full width
through ``FLServer`` (dense, eq6, static_topn, quant8 on the launcher's 1 x 1
mesh and without one, 2 rounds each) and qwen3-1.7b at its widths cut to 2
layers (eq6, static_topn), every tree run bitwise against its flat twin with
exact K1, K4 and K5a launches, then ``core.fedavg`` on the card against the
packed eq6 and quant8 aggregators. Exits non-zero without a card or on any
disagreement.
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
        print("tree_check: needs a CUDA card", file=sys.stderr)
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
    chip_smoke.phase19(dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
