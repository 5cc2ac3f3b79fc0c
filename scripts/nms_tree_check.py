#!/usr/bin/env python3
"""Quick check of the NMS keep-mask kernel K3 (``csrc/nms.cu``) and the
tree dequantizer K12b (``csrc/row_quant.cu``) on one CUDA card.

    python3 scripts/nms_tree_check.py

It builds the kernel library, compiles the two sources alone
with ``nvcc -Xptxas -v`` and prints the registers, shared memory and spills
of every kernel, then runs ``chip_smoke.py``'s phase 2 (K3 against its
plain version, bitwise, both instantiations), K3 at the served (8, 16) on
the served inputs of a full-width fedyolov3 (kernel, device and plain ms,
the card's launch floor and the share of it reached), and phase 11a's tree
part (K12a and K12b over fedyolov3's 19 leaves, every leaf bitwise, K12b in
one launch and past its table's capacity, with tree and device ms and the
byte bound). Exits non-zero without a card, on a build failure, a spill or a
disagreement.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402  (puts this checkout's src on the path)


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def inspect() -> bool:
    """Print ptxas's registers, shared memory and spills of both sources;
    False on a failure or a spill."""
    from repro_torch.kernels import _build

    ok = True
    for src, report in _build.inspect(("nms.cu", "row_quant.cu")).items():
        print(src, "nvcc exit", report["rc"], *report["ptxas"], sep="\n  ", flush=True)
        ok &= report["rc"] == 0 and not report["spill_bytes"]
    return ok


def served_nms(dev, card: str) -> dict:
    cfg, fed, model, imgs = chip_smoke.served_model(dev)
    batch = torch.from_numpy(imgs[chip_smoke.SCENES: chip_smoke.SCENES + 8].copy()).to(dev)
    return chip_smoke.served_nms(*chip_smoke.served_nms_operands(model, batch, fed), card)


def main() -> int:
    if not torch.cuda.is_available():
        print("nms_tree_check: needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    _build.library()
    card = card_name()
    print(card, flush=True)
    dev = torch.device("cuda")
    if not inspect():
        print("nms_tree_check: a build failed or a kernel spills", file=sys.stderr)
        return 1
    chip_smoke.phase2(dev, card)
    served_nms(dev, card)
    stats = {k: {"cases": 0, "max_abs_err": 0.0} for k in ("quantize", "dequantize")}
    chip_smoke.phase11a_tree(dev, card, chip_smoke.bitwise_holder(stats), stats)
    print(f"nms_tree_check: bitwise cases K12a {stats['quantize']['cases']}, K12b "
          f"{stats['dequantize']['cases']}  [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
