#!/usr/bin/env python3
"""Quick check of the LM kernels on one CUDA card: flash attention (K9,
``csrc/flash_attention.cu``) and the Mamba2 SSD chunk scan (K10,
``csrc/ssd_scan.cu``).

    python3 scripts/lm_kernels_check.py

Compiles each source alone with ``nvcc -Xptxas -v`` and prints the
registers and spills of every kernel instantiation, builds the port's
kernel library, then holds each kernel against its plain PyTorch version
on the card at a few shapes (the main path's among them) and prints the
largest error and the mean time of a launch (CUDA events) beside the plain
version's. A shorter first call than ``chip_smoke.py`` for a changed
kernel; exits non-zero without a card or on a disagreement.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

FLASH = [((1, 4, 2, 128, 64), True, 0, torch.float32), ((2, 4, 2, 256, 32), True, 64, torch.float32),
         ((1, 2, 1, 128, 64), False, 0, torch.float32), ((1, 4, 2, 128, 64), True, 0, torch.bfloat16),
         ((4, 16, 8, 1024, 128), True, 0, torch.float32), ((4, 16, 8, 1024, 128), True, 0, torch.bfloat16),
         ((1, 2, 2, 128, 80), False, 64, torch.float32)]
SSD = [(1, 32, 2, 8, 4, 8, torch.float32), (2, 64, 3, 16, 8, 16, torch.float32),
       (1, 128, 1, 64, 16, 32, torch.float32), (4, 1024, 64, 64, 128, 128, torch.float32),
       (4, 1024, 64, 64, 128, 128, torch.bfloat16), (2, 200, 3, 100, 7, 40, torch.float32)]
TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}


def mean_ms(fn, n: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def main() -> int:
    if not torch.cuda.is_available():
        print("lm_kernels_check: needs a CUDA card", file=sys.stderr)
        return 1
    from torch.utils.cpp_extension import CUDA_HOME

    from repro_torch.kernels import _build, ops

    nvcc = str(Path(CUDA_HOME or "") / "bin" / "nvcc")
    tmp = tempfile.mkdtemp()
    for src in ("flash_attention.cu", "ssd_scan.cu"):
        r = subprocess.run([nvcc, *_build.CUDA_FLAGS, "-Xptxas", "-v", "-c",
                            str(_build.CSRC / src), "-o", f"{tmp}/{src}.o"], capture_output=True, text=True)
        lines = [ln for ln in r.stderr.splitlines() if "registers" in ln or "spill" in ln or "rror" in ln]
        print(src, "nvcc exit", r.returncode, *lines, sep="\n  ", flush=True)
        if r.returncode:
            return 1
    _build.library()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    ok = True
    for (B, H, Hkv, S, hd), causal, window, dt in FLASH:
        q = torch.randn((B, H, S, hd), generator=g, device=dev).to(dt)
        k = torch.randn((B, Hkv, S, hd), generator=g, device=dev).to(dt)
        v = torch.randn((B, Hkv, S, hd), generator=g, device=dev).to(dt)
        a = ops.flash_attention(q, k, v, causal=causal, window=window)
        b = ops.flash_attention(q, k, v, causal=causal, window=window, impl="ref")
        torch.cuda.synchronize()
        err = float((a.float() - b.float()).abs().max())
        ok &= err <= TOL[dt]
        print("flash", (B, H, Hkv, S, hd), causal, window, dt, "err", err,
              "ms", mean_ms(lambda: ops.flash_attention(q, k, v, causal=causal, window=window)),
              "plain", mean_ms(lambda: ops.flash_attention(q, k, v, causal=causal, window=window,
                                                            impl="ref"), 2), flush=True)
    for B, S, H, P, N, Q, dt in SSD:
        x = (torch.randn((B, S, H, P), generator=g, device=dev) * 0.1).to(dt)
        dA = -(torch.randn((B, S, H), generator=g, device=dev) * 0.1).abs()
        Bm = torch.randn((B, S, N), generator=g, device=dev).to(dt)
        Cm = torch.randn((B, S, N), generator=g, device=dev).to(dt)
        a = ops.ssd_chunk_scan(x, dA, Bm, Cm, chunk=Q)
        b = ops.ssd_chunk_scan(x, dA, Bm, Cm, chunk=Q, impl="ref")
        torch.cuda.synchronize()
        errs = [float((u - w).abs().max()) for u, w in zip(a, b)]
        ok &= max(errs) <= 2e-4
        print("ssd", (B, S, H, P, N, Q), dt, "errs", errs,
              "ms", mean_ms(lambda: ops.ssd_chunk_scan(x, dA, Bm, Cm, chunk=Q)),
              "plain", mean_ms(lambda: ops.ssd_chunk_scan(x, dA, Bm, Cm, chunk=Q, impl="ref"), 2),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
