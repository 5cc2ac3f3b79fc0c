#!/usr/bin/env python3
"""Quick check of the other LM families on one CUDA card: ``chip_smoke.py``'s
phase 8 at phase 15's kernel shapes, then phase 15 alone.

    python3 scripts/families_check.py

Builds the kernel library, holds K9 and K10 against their plain versions
at the prefill shapes of granite-moe-1b-a400m, grok-1-314b, gemma3-27b,
zamba2-2.7b, llava-next-34b and minitron-8b (times beside their bounds;
the SASS tensor-core count is phase 8's in the full script), then serves
each of them at full width through the launcher (phase 15: exact K9/K10
launch counts, kernel path against plain path, decode teacher-forced
against a full forward, prefill and decode times, peak memory). Exits
non-zero without a card or on any disagreement; the last line is phase
15's launch counts as JSON.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (puts this checkout's src on the path)

# phase 15's kernel shapes: the tail of phase 8's case lists
NEW_FLASH, NEW_SSD = 5, 1


def main() -> int:
    if not torch.cuda.is_available():
        print("families_check: needs a CUDA card", file=sys.stderr)
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
    chip_smoke.FLASH_CASES = chip_smoke.FLASH_CASES[-NEW_FLASH:]
    chip_smoke.SSD_CASES = chip_smoke.SSD_CASES[-NEW_SSD:]
    chip_smoke.tensor_core_counts = lambda card: {"flash_attention.cu": None, "ssd_scan.cu": None}
    chip_smoke.phase8(dev, card)
    t1 = time.perf_counter()
    out = chip_smoke.phase15(dev, card)
    print(f"phase 15 took {time.perf_counter() - t1:.1f} s", flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
