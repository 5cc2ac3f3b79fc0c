#!/usr/bin/env python3
"""Quick check of the LM kernels on one CUDA card: flash attention (K9,
``csrc/flash_attention.cu``) and the Mamba2 SSD chunk scan (K10,
``csrc/ssd_scan.cu``).

    python3 scripts/lm_kernels_check.py

Compiles each source alone with ``nvcc -Xptxas -v`` and prints the
registers and spills of every kernel instantiation and the number of
tensor-core instructions (HMMA/HGMMA) in its SASS (``cuobjdump``; "not
measured" where the toolkit has none), builds the port's kernel library,
then holds each kernel against its plain PyTorch version on the card at a
few shapes (the main path's among them, and the edges of K9's 128-row
query tiles and 64-row key tiles and of K10's head groups and 64-column
head blocks) and prints the largest error and the mean time of a launch
(CUDA events) beside the plain version's. Last, the card's own rate for
the instruction both kernels run, m16n8k8 tf32 ``mma.sync`` (a throwaway
kernel of 8 independent accumulator chains a warp, 8 warps an SM), bare
and with the 3xTF32 split of fresh operands before every product. A shorter
first call than ``chip_smoke.py`` for a changed kernel; exits non-zero
without a card, on a failed compile or on a disagreement.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

FLASH = [((1, 4, 2, 128, 64), True, 0, torch.float32), ((2, 4, 2, 256, 32), True, 64, torch.float32),
         ((1, 2, 1, 128, 64), False, 0, torch.float32), ((1, 4, 2, 128, 64), True, 0, torch.bfloat16),
         ((4, 16, 8, 1024, 128), True, 0, torch.float32), ((4, 16, 8, 1024, 128), True, 0, torch.bfloat16),
         ((1, 2, 2, 128, 80), False, 64, torch.float32),
         # a lone 64-row tile and a ragged second 128-row tile; windows across tile borders
         ((2, 4, 2, 64, 128), True, 0, torch.float32), ((1, 4, 2, 192, 64), True, 0, torch.float32),
         ((1, 4, 2, 192, 128), True, 0, torch.bfloat16), ((1, 4, 2, 384, 128), True, 100, torch.float32),
         ((1, 4, 1, 384, 64), True, 130, torch.float32), ((1, 2, 1, 256, 64), False, 96, torch.float32)]
SSD = [(1, 32, 2, 8, 4, 8, torch.float32), (2, 64, 3, 16, 8, 16, torch.float32),
       (1, 128, 1, 64, 16, 32, torch.float32), (4, 1024, 64, 64, 128, 128, torch.float32),
       (4, 1024, 64, 64, 128, 128, torch.bfloat16), (2, 200, 3, 100, 7, 40, torch.float32),
       # Q = 64; 17 heads (a ragged last group); P = 128 (two head blocks); bf16 P = 100
       (2, 1024, 8, 64, 128, 64, torch.float32), (1, 1024, 17, 64, 128, 128, torch.float32),
       (1, 256, 4, 128, 128, 128, torch.float32), (1, 256, 3, 100, 36, 64, torch.bfloat16)]
TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
MMA_RATE_CU = r"""
#include <cstdio>
#include "mma_tf32.cuh"
// 8 independent accumulator chains a warp; SPLIT: split two fresh operands
// (3xTF32) before every product of three mma
template <bool SPLIT>
__global__ void rate(float* out, int iters) {
  float d[8][4] = {};
  float x = 1.0f + threadIdx.x * 1e-3f;
  const uint32_t a = __float_as_uint(x), b = __float_as_uint(0.5f * x);
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (SPLIT) {
        const Tf32x2 s = split_tf32(x + i), t = split_tf32(x - i);
        const Tf32x2 aa[4] = {s, t, s, t};
        mma_3xtf32(d[i], aa, t, s);
      } else {
        mma_tf32(d[i], a, b, a, b, a, b);
      }
    }
    x += 1e-7f;
  }
  float s = 0.0f;
  for (int i = 0; i < 8; ++i) s += d[i][0] + d[i][1] + d[i][2] + d[i][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <bool SPLIT>
void run(const char* what, int sms) {
  const int blocks = 4 * sms, threads = 256, iters = 4000;
  float* out;
  cudaMalloc(&out, blocks * threads * sizeof(float));
  rate<SPLIT><<<blocks, threads>>>(out, 10);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  rate<SPLIT><<<blocks, threads>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flop = 2048.0 * blocks * (threads / 32) * iters * 8 * (SPLIT ? 3 : 1);
  printf("mma.sync m16n8k8 tf32 %s: %.1f TFLOP/s of tf32 products (%.1f f32-accurate) in %.4f ms (%s)\n",
         what, flop / ms / 1e9, flop / ms / 1e9 / (SPLIT ? 3 : 1), ms,
         cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}
int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  run<false>("bare", sms);
  run<true>("with the 3xTF32 split before every product", sms);
  return 0;
}
"""


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
    from repro_torch.kernels import _build, ops

    for src, info in _build.inspect(("flash_attention.cu", "ssd_scan.cu")).items():
        print(src, "nvcc exit", info["rc"], *info["ptxas"], sep="\n  ", flush=True)
        if info["rc"]:
            return 1
        mma = info["mma"]
        for name, count in (mma or {}).items():
            print(f"  SASS HMMA/HGMMA {count:6d}  {name}", flush=True)
        if mma is None:
            print("  SASS HMMA/HGMMA: not measured (no cuobjdump)", flush=True)
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
    from torch.utils.cpp_extension import CUDA_HOME

    out = _build.BUILD_DIR / "inspect"
    (out / "mma_rate.cu").write_text(MMA_RATE_CU)
    nvcc = Path(CUDA_HOME or "/usr/local/cuda") / "bin" / "nvcc"
    r = subprocess.run([str(nvcc), *_build.CUDA_FLAGS, "-I", str(_build.CSRC), "-o", str(out / "mma_rate"),
                        str(out / "mma_rate.cu")], capture_output=True, text=True)
    print(subprocess.run([str(out / "mma_rate")], capture_output=True, text=True).stdout.strip()
          if r.returncode == 0 else f"mma rate: nvcc failed: {r.stderr[-400:]}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
