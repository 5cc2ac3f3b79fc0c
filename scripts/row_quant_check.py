#!/usr/bin/env python3
"""Quick check of the row and block quantizers on one CUDA card: K5a, K5b,
K12a and K12b in ``csrc/row_quant.cu`` and the fused K4/K7 in
``csrc/quant_reduce.cu`` that share its amax reduction.

    python3 scripts/row_quant_check.py

Compiles the two sources alone with ``nvcc -Xptxas -v`` and prints the
registers and spills of every kernel instantiation, then runs
``chip_smoke.py``'s phases 11a (the four kernels against their plain
versions, bitwise, with their times) and 11b (quant8 ``aggregate`` on the
launcher's 1 x 1 mesh against the meshless K4 path, bitwise) on a random
(4, 13,312,864) buffer. A shorter first call than ``chip_smoke.py`` after a
change to these kernels; exits non-zero without a card or on a
disagreement.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    if not torch.cuda.is_available():
        print("row_quant_check: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.utils.cpp_extension import CUDA_HOME

    import chip_smoke
    from repro_torch.kernels import _build

    nvcc = str(Path(CUDA_HOME or "") / "bin" / "nvcc")
    tmp = tempfile.mkdtemp()
    for src in ("row_quant.cu", "quant_reduce.cu"):
        r = subprocess.run([nvcc, *_build.CUDA_FLAGS, "-Xptxas", "-v", "-c", str(_build.CSRC / src),
                            "-o", f"{tmp}/{src}.o"], capture_output=True, text=True)
        lines = [ln for ln in r.stderr.splitlines() if "registers" in ln or "spill" in ln or "rror" in ln]
        print(src, "nvcc exit", r.returncode, *lines, sep="\n  ", flush=True)
        if r.returncode:
            return 1
    _build.library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda")
    chip_smoke.phase11a(dev, card)
    g = torch.Generator().manual_seed(0)
    x0 = torch.randn((4, 13_312_864), generator=g)
    chip_smoke.phase11b(dev, card, (x0 + 1e-3 * torch.randn(x0.shape, generator=g), x0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
