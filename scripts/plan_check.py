#!/usr/bin/env python3
"""Quick check of the launch tooling on one CUDA card: ``chip_smoke.py``'s
phase 17 alone.

    python3 scripts/plan_check.py

Builds the kernel library, then prints the launcher's ``--print-plan`` for
every arch (17a); dry-runs qwen3-1.7b x train_4k (single pod),
grok-1-314b x decode_32k (multi pod) and zamba2-2.7b x long_500k on the
meta device, with per-device state and peak, FLOPs, bytes, collective
bytes and the H100 roofline's terms, and the round state of grok-1-314b's
and gemma3-27b's train_4k plans on (1, 1) and (1, 4) meshes against 80 GB
(17b); and holds the 1 x 1 plan of phase 10d's qwen3-1.7b round against
one round on the card: FLOPs within 0.1%, the predicted peak within 10%,
K9 and K1 as in phase 10d, and the round against the largest roofline term
(17c). Exits non-zero without a card or on any disagreement.
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
        print("plan_check: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch import device as D
    from repro_torch.kernels import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    dev = D.resolve("cuda")
    t0 = time.perf_counter()
    _build.library()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    t1 = time.perf_counter()
    chip_smoke.phase17(dev, card)
    print(f"phase 17 took {time.perf_counter() - t1:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
