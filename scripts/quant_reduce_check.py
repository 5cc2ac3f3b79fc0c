#!/usr/bin/env python3
"""Quick check of the fused quantized transports K4 (quant8) and K7 (quant4)
in ``csrc/quant_reduce.cu`` on one CUDA card.

    python3 scripts/quant_reduce_check.py

Builds the kernel library, then compiles ``quant_reduce.cu`` alone with
``nvcc -Xptxas -v`` and prints the registers, shared memory and spills of
every instantiation (the whole-tile kernel and the generic one, nearest and
stochastic), and how many CTAs of the whole-tile kernel fit on one SM
(the CUDA occupancy calculator; the launch assumes 4). Then runs
``chip_smoke.py``'s phase 6 alone: K4 and K7 (nearest, and stochastic under
two keys) bitwise against their plain versions at the quant round's (3,
13,312,864) and every ragged and tiling-edge case, with kernel, device,
plain and flushed-L2 times beside the byte bound (and K6 and K8, which the
phase also holds). A shorter first call than ``chip_smoke.py`` after a
change to these kernels; exits non-zero without a card, on a build
failure, a spill, a short residency or a disagreement.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# the whole-tile kernel's CTAs per SM that its persistent grid assumes
TILE_CTAS_PER_SM = 4


def main() -> int:
    if not torch.cuda.is_available():
        print("quant_reduce_check: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import _build

    lib = _build.library()
    report = _build.inspect(("quant_reduce.cu",))["quant_reduce.cu"]
    print("quant_reduce.cu nvcc exit", report["rc"], *report["ptxas"], sep="\n  ", flush=True)
    if report["rc"] or report["spill_bytes"]:
        print("quant_reduce_check: build failed or an instantiation spills", file=sys.stderr)
        return 1
    for stochastic in (0, 1):
        ctas = lib.quant_reduce_tile_residency(stochastic)
        print(f"quant_reduce_tile_kernel<{bool(stochastic)}>: {ctas} resident CTAs of 128 threads "
              f"per SM (launch assumes {TILE_CTAS_PER_SM})", flush=True)
        if ctas < TILE_CTAS_PER_SM:
            return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    chip_smoke.phase6(torch.device("cuda"), card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
