#!/usr/bin/env python3
"""Quick check of the row and block quantizers on one CUDA card: K5a, K5b,
K12a and K12b in ``csrc/row_quant.cu``, and the fused K4/K7 in
``csrc/quant_reduce.cu`` that share its tile machinery (``quant_tile.cuh``)
and its CTA amax (``block_amax.cuh``).

    python3 scripts/row_quant_check.py

Builds the kernel library, compiles the two sources alone with ``nvcc
-Xptxas -v`` and prints the registers, shared memory and spills of every
instantiation, and how many CTAs of each whole-tile kernel fit on one SM
(the CUDA occupancy calculator; the launches assume 4). Then runs
``chip_smoke.py``'s phases 11a (the four kernels against their plain
versions, bitwise, at the quant8 round's (3, 13,312,864), the whole-tile
kernel's edges, unaligned and wide-exponent rows, with kernel, device,
flushed-L2 device, plain and bound ms) and 11b (quant8 ``aggregate`` on the
launcher's 1 x 1 mesh against the meshless K4 path, bitwise) on a random
(4, 13,312,864) buffer.

A shorter first call than ``chip_smoke.py`` after a change to these kernels;
exits non-zero without a card, on a build failure, a spill, a short
residency or a disagreement.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# the whole-tile kernels' CTAs per SM that their persistent grids assume
TILE_CTAS_PER_SM = 4


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def inspect(lib) -> bool:
    """Print ptxas's registers, shared memory and spills for both sources and
    the whole-tile kernels' residency; False on a failure, a spill or a
    residency below the launches' assumption."""
    from repro_torch.kernels import _build

    reports = _build.inspect(("row_quant.cu", "quant_reduce.cu"))
    ok = True
    for src, report in reports.items():
        print(src, "nvcc exit", report["rc"], *report["ptxas"], sep="\n  ", flush=True)
        ok &= report["rc"] == 0 and not report["spill_bytes"]
    residency = {"rowquant_tile_kernel": lib.quantize_rows_tile_residency(),
                 "quant_reduce_tile_kernel<false>": lib.quant_reduce_tile_residency(0),
                 "quant_reduce_tile_kernel<true>": lib.quant_reduce_tile_residency(1)}
    for name, ctas in residency.items():
        print(f"{name}: {ctas} resident CTAs of 128 threads per SM (launch assumes "
              f"{TILE_CTAS_PER_SM})", flush=True)
        ok &= ctas >= TILE_CTAS_PER_SM
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("row_quant_check: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import _build

    lib = _build.library()
    if not inspect(lib):
        print("row_quant_check: a build failed, an instantiation spills or a whole-tile kernel's "
              "residency is short", file=sys.stderr)
        return 1
    card = card_name()
    print(card, flush=True)
    dev = torch.device("cuda")
    chip_smoke.phase11a(dev, card)
    g = torch.Generator().manual_seed(0)
    x0 = torch.randn((4, 13_312_864), generator=g)
    chip_smoke.phase11b(dev, card, (x0 + 1e-3 * torch.randn(x0.shape, generator=g), x0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
