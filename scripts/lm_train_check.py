#!/usr/bin/env python3
"""Quick check of the LM training path on one CUDA card: ``chip_smoke.py``'s
phase 10 alone.

    python3 scripts/lm_train_check.py

Compiles ``csrc/fedavg.cu`` (K11) alone with ``nvcc -Xptxas -v`` and prints
the registers and spills of each instantiation, builds the port's kernel
library, then runs phase 10: K11 against its plain version (10a),
gradients through K9 and K10 at full width (10b), a reduced adamw round
card against host (10c), the launcher's LM training at full width for
qwen3-1.7b and mamba2-1.3b (10d) and the compression demo's tail (10e).
A shorter call than ``chip_smoke.py`` after a change to that path (about
three minutes of command time); exits non-zero without a card or on a
failed check.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this check needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    cs.check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, torch.__version__, torch.version.cuda, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run(["/usr/local/cuda/bin/nvcc", "-gencode=arch=compute_90a,code=sm_90a",
                            "-O3", "-fmad=false", "-Xptxas", "-v", "-c",
                            str(ROOT / "src/repro_torch/kernels/csrc/fedavg.cu"),
                            "-o", str(Path(tmp) / "fedavg.o")], capture_output=True, text=True)
    print(r.stdout + r.stderr, flush=True)
    cs.check(r.returncode == 0, "fedavg.cu does not compile")

    from repro_torch import device as D
    from repro_torch.configs import get_arch
    from repro_torch.core import packing
    from repro_torch.kernels import _build
    from repro_torch.models import transformer as T

    dev = D.resolve("cuda")
    t0 = time.perf_counter()
    _build.library()
    print(f"build {time.perf_counter() - t0:.3f} s", flush=True)
    qcfg = get_arch("qwen3-1.7b")
    largest = max(sl.size for sl in packing.build_pack_spec(qcfg, T.template(qcfg)).slots)
    print(cs.phase10a(dev, card, largest), flush=True)
    cs.phase10b(dev, card)
    cs.phase10c(dev, card)
    print(cs.phase10de(dev, card), flush=True)


if __name__ == "__main__":
    main()
