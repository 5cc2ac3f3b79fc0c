#!/usr/bin/env python3
"""Quick check of the async control plane on one CUDA card: ``chip_smoke.py``'s
phase 12 alone.

    python3 scripts/async_check.py

Builds the kernel library, then runs phase 12a (buffered eq6 at
fedyolov3's full width: a full-buffer flush against the sync round
bitwise, 6 flushes with a stale landing and a drop, the rows in flight
bitwise across each, K1 once a flush, the launcher's ``--mode async``),
12b (streaming dense at 16 clients against its buffered twin, the global
within 1e-5) and 12c (the arrival engine and the replay on the reduced
qwen3, dense bitwise and quant8 within 1e-5, the snapshot round trip
bitwise). Exits non-zero without a card or on any disagreement.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (puts this checkout's src on the path)


def main() -> int:
    if not torch.cuda.is_available():
        print("async_check: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch import device as D
    from repro_torch.kernels import _build

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    dev = D.resolve("cuda")
    _build.library()
    print(chip_smoke.phase12a(dev, card), flush=True)
    chip_smoke.phase12b(dev, card)
    print(chip_smoke.phase12c(dev, card), flush=True)
    import torch.distributed as dist

    if dist.is_initialized():  # the launcher's one-rank client group
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
