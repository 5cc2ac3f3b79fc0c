#!/usr/bin/env python3
"""Quick check of the other LM families' training on one CUDA card:
``chip_smoke.py``'s phase 16 alone.

    python3 scripts/families_train_check.py

Builds the kernel library, then trains granite-moe-1b-a400m, hubert-xlarge,
zamba2-2.7b (18 layers), llava-next-34b (1 layer at 2880 + 1088 positions)
and gemma3-27b (a tail of 2 windowed layers) at their published widths
through the launcher, 2 rounds at C = 2 (16a: exact K9/K10/K1 launches, ms
a round, the eq6 aggregation, peak memory); holds one reduced masked eq6
round of each new family on the card against the host (16b) and the
gradients through K9 windowed, K9 at S 3968 and K10 at N 64 against the
plain versions' (16c); and runs ``examples/train_100m`` for 3 rounds
(16d). Exits non-zero without a card or on any disagreement; the last line
is phase 16's launch counts as JSON.
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


def main() -> int:
    if not torch.cuda.is_available():
        print("families_train_check: needs a CUDA card", file=sys.stderr)
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
    out = chip_smoke.phase16(dev, card)
    print(f"phase 16 took {time.perf_counter() - t1:.1f} s", flush=True)
    import torch.distributed as dist

    if dist.is_initialized():  # the launcher's one-rank client group
        dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
