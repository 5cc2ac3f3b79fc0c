// Mamba2 SSD intra-chunk block (kernel K10), for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_scan.py::ssd_chunk_scan
// (its body _kernel). The wrapper src/repro_torch/kernels/ssd_scan.py::
// ssd_chunk_scan validates the operands; the inter-chunk recurrence stays in
// PyTorch (kernels/ops.py::ssd_full), as it stays a lax.scan in the
// reference.
//
// Semantics, for every (batch b, chunk c, head h), with the chunk's Q rows
// t of xdt (B, S, H, P), dA (B, S, H) and Bm, Cm (B, S, N):
//
//   cum[t]      = dA[0] + ... + dA[t]                       (float32)
//   L[q, t]     = exp(cum[q] - cum[t]) for t <= q, else 0
//   y[q, p]     = sum_t (sum_n C[q, n] B[t, n]) L[q, t] xdt[t, p]
//   states[p,n] = sum_t xdt[t, p] exp(cum[Q-1] - cum[t]) B[t, n]
//   chunk_decay = exp(cum[Q-1]),  exp_cum[t] = exp(cum[t])
//
// all written as float32 whatever the input dtype (float32 or bfloat16 for
// xdt, Bm and Cm; dA float32).
//
// Bound. C B^T has no head axis, so the least work computes it once per
// (b, c); per (b, c, h) the causal triangle of y (2 P per pair) and the
// states (2 Q N P). At the main path's B 4, S 1024, H 64, P 64, N 128,
// Q 128 that is 6.5 GFLOP of products: 0.040 ms on the tensor cores through
// the 3xTF32 split (three tf32 products per f32 product, 495 TFLOP/s),
// 0.098 ms on the FP32 units (67 TFLOP/s), against 207.6 MB of traffic,
// 0.062 ms at 3.35 TB/s. On the tensor cores the kernel is bound by the
// bytes.
//
// Why 3xTF32 and not TF32: the outputs are held to the f32 plain version
// at 2e-4, and one tf32 pass (10 mantissa bits, 5e-4 relative per operand)
// summed over Q = N = 128 terms cannot hold that; the split (mma_tf32.cuh)
// keeps about 2^-21 per product. cuBLAS and cuDNN stay TF32-off
// (device.resolve): the split is this kernel's own.
//
// Design. One CTA of 8 warps per (b, chunk, group of heads); the group size
// is the one that minimises (waves of CTAs over the card's SMs, read from
// the device) x (the group's work plus one C B^T), so C B^T is shared by up
// to 16 heads. The CTA stages the chunk's C and B rows (Q x N) by cp.async
// and computes G = C B^T on the causal triangle only, its 72 tiles of
// 16 x 8 spread 9 to a warp and kept in registers. It then walks its units,
// a unit being a head and a block of up to 64 of its P columns: the next
// unit's xdt rows and dA load by cp.async into the other half of a double
// buffer while the current unit computes. Per unit: a block-wide scan of dA
// (every warp scans 16 rows with shuffles, then adds the totals of the warps
// before it); each warp multiplies its G tiles by L into shared memory, and
// the decay factors exp(cum[Q-1] - cum[t]) are computed once, beside them;
// y = (G * L) xdt on the tensor cores, each warp taking row blocks rb and
// 7 - rb (18 key steps together, so the triangle's work is even) and half
// of the head columns, and stopping at the diagonal: the key steps above
// it, where L is zero, are skipped; states = (xdt * decay)^T B, one 16 x 64
// tile a warp. Every product is m16n8k8 tf32 mma.sync with the 3xTF32
// split; k slot c stands for key 2c and slot c + 4 for key 2c + 1, so a
// thread's two A values of a row are one 8-byte load. y and states go from
// the fragments straight to device memory: four lanes write two adjacent
// f32 each, one whole 32-byte sector a row, so staging them through shared
// memory would save no traffic and cost a barrier and a copy a unit. Row
// strides are 4 or 8 banks modulo 32, so every fragment load of a warp
// falls on distinct banks. 204 KiB of shared memory, one CTA per SM.
// bfloat16 inputs (and f32 rows whose width is not a multiple of 4) are
// staged by plain loads, converted to f32, in the same double buffer.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "mma_tf32.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxDim = 128;  // Q, N and P at most
constexpr int kPB = 64;       // head columns per unit
constexpr int kMaxGroup = 16;
constexpr int BLD = kMaxDim + 4;  // B and C rows (floats)
constexpr int GLD = kMaxDim + 8;  // (C B^T) * L rows
constexpr int XLD = kPB + 4;      // xdt rows
constexpr int kTri = 72;          // 16 x 8 tiles of C B^T's triangle at Q = 128
constexpr int kTiles = (kTri + kWarps - 1) / kWarps;  // of them a warp holds
constexpr int kYN = 32 / kWarps;  // y's n tiles a warp: 8 of 64 columns over kWarps / 4
constexpr int kSN = 64 / kWarps;  // states' n tiles a warp: 16 of 128 columns over kWarps / 4
constexpr int kBs = kMaxDim * BLD;
constexpr int kGl = kMaxDim * GLD;  // also holds C (Q x BLD) until G is computed
constexpr int kXs = kMaxDim * XLD;
constexpr int kSmemFloats = kBs + kGl + 2 * kXs + 4 * kMaxDim + 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// the chunk's C and B rows t < Q, columns n < N, into cs and bs as f32
template <typename T>
__device__ __forceinline__ void stage_bc(float* cs, float* bs, const T* __restrict__ Cm,
                                         const T* __restrict__ Bm, long long row0, int N, int Q) {
  if (std::is_same<T, float>::value && N % 4 == 0) {
    const int n4 = N / 4;
    for (int i = threadIdx.x; i < Q * n4; i += kThreads) {
      const int r = i / n4, j = 4 * (i % n4);
      cp_async16(cs + r * BLD + j, Cm + (row0 + r) * N + j);
      cp_async16(bs + r * BLD + j, Bm + (row0 + r) * N + j);
    }
  } else {
    for (int i = threadIdx.x; i < Q * N; i += kThreads) {
      const int r = i / N, n = i % N;
      cs[r * BLD + n] = to_f32(Cm[(row0 + r) * N + n]);
      bs[r * BLD + n] = to_f32(Bm[(row0 + r) * N + n]);
    }
  }
}

// head h's dA over the chunk into das, its xdt rows t < Q, columns
// p0 .. p0 + pw - 1 into xs as f32
template <typename T>
__device__ __forceinline__ void stage_unit(float* xs, float* das, const T* __restrict__ xdt,
                                           const float* __restrict__ dA, long long row0, int H,
                                           int h, int P, int p0, int pw, int Q) {
  for (int t = threadIdx.x; t < Q; t += kThreads) cp_async4(das + t, dA + (row0 + t) * H + h);
  if (std::is_same<T, float>::value && P % 4 == 0) {
    const int w4 = pw / 4;
    for (int i = threadIdx.x; i < Q * w4; i += kThreads) {
      const int r = i / w4, j = 4 * (i % w4);
      cp_async16(xs + r * XLD + j, xdt + ((row0 + r) * H + h) * P + p0 + j);
    }
  } else {
    for (int i = threadIdx.x; i < Q * pw; i += kThreads) {
      const int r = i / pw, p = i % pw;
      xs[r * XLD + p] = to_f32(xdt[((row0 + r) * H + h) * P + p0 + p]);
    }
  }
}

// Two adjacent f32 outputs at p (columns col, col + 1 of a row that holds
// `width` columns): one 8-byte store where the row's pairs are aligned.
__device__ __forceinline__ void store_pair(float* p, int col, int width, bool paired, float a,
                                           float b) {
  if (paired && col + 1 < width) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    if (col < width) p[0] = a;
    if (col + 1 < width) p[1] = b;
  }
}

// kFull: Q = N = 128 and P a multiple of 64 (the main path's shapes), so every
// tile is whole and the tile loops have no bounds to test.
template <typename T, bool kFull>
__global__ void __launch_bounds__(kThreads, 1)
ssd_chunk_scan_kernel(const T* __restrict__ xdt, const float* __restrict__ dA,
                      const T* __restrict__ Bm, const T* __restrict__ Cm, float* __restrict__ y,
                      float* __restrict__ states, float* __restrict__ decay,
                      float* __restrict__ exp_cum, int S, int H, int P, int N, int Q,
                      int group) {
  extern __shared__ __align__(16) float smem[];
  float* bs = smem;                  // Q x BLD: B rows
  float* cs = bs + kBs;              // Q x BLD: C rows, until G is in registers
  float* gl = cs;                    // then Q x GLD: a unit's (C B^T) * L
  float* xs0 = cs + kGl;             // 2 x Q x XLD: xdt rows, double-buffered
  float* das0 = xs0 + 2 * kXs;       // 2 x Q: dA, double-buffered
  float* cum = das0 + 2 * kMaxDim;   // Q: cumsum of dA
  float* dec = cum + kMaxDim;        // Q: exp(cum[Q-1] - cum[t]), 0 past Q
  float* scr = dec + kMaxDim;        // kWarps: warp totals of the scan

  const int ch = blockIdx.x, h0 = blockIdx.y * group, b = blockIdx.z;
  const int nc = S / Q;
  const long long row0 = static_cast<long long>(b) * S + static_cast<long long>(ch) * Q;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int pblocks = (P + kPB - 1) / kPB;
  const int units = (min(h0 + group, H) - h0) * pblocks;
  const int qt16 = kFull ? 8 : (Q + 15) / 16, qs8 = kFull ? 16 : (Q + 7) / 8;
  const int ns8 = kFull ? 16 : (N + 7) / 8;

  // padded rows and columns of every tile stay zero
  for (int i = tid; i < kSmemFloats / 4; i += kThreads)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  stage_bc(cs, bs, Cm, Bm, row0, N, Q);
  cp_async_commit();
  stage_unit(xs0, das0, xdt, dA, row0, H, h0, P, 0, min(kPB, P), Q);
  cp_async_commit();
  cp_async_wait<1>();  // C and B have landed; unit 0 may still be in flight
  __syncthreads();

  // G = C B^T on the causal triangle only: its 72 tiles of 16 rows x 8
  // columns (row block rb holds tiles s = 0 .. 2 rb + 1), tile i = warp +
  // kWarps k held by this warp in gt[k]; tile (rb, s) holds rows 16 rb + g
  // (+ 8), columns 8 s + 2 c (+ 1). The triangle's work is shared evenly.
  int tile[kTiles];  // rb << 8 | s, or -1 where the tile lies outside Q
  float gt[kTiles][4];
#pragma unroll
  for (int k = 0; k < kTiles; ++k) {
    const int i = warp + kWarps * k;
    int rb = 0;
    while ((rb + 1) * (rb + 2) <= i) ++rb;
    const int s = i - rb * (rb + 1);
    tile[k] = i < kTri && rb < qt16 && s < qs8 ? rb << 8 | s : -1;
#pragma unroll
    for (int e = 0; e < 4; ++e) gt[k][e] = 0.0f;
    if (tile[k] < 0) continue;
    for (int kn = 0; kn < ns8; ++kn) {
      const float* ca = cs + (16 * rb + g) * BLD + 8 * kn + c;
      const float* bb = bs + (8 * s + g) * BLD + 8 * kn + c;
      const Tf32x2 a[4] = {split_tf32(ca[0]), split_tf32(ca[8 * BLD]), split_tf32(ca[4]),
                           split_tf32(ca[8 * BLD + 4])};
      mma_3xtf32(gt[k], a, split_tf32(bb[0]), split_tf32(bb[4]));
    }
  }

  for (int u = 0; u < units; ++u) {
    const int h = h0 + u / pblocks, p0 = (u % pblocks) * kPB, pw = min(kPB, P - p0);
    const float* xs = xs0 + (u & 1) * kXs;
    const float* das = das0 + (u & 1) * kMaxDim;
    cp_async_wait<0>();
    __syncthreads();  // unit u has landed; the previous unit's reads are done
    if (u + 1 < units) {
      const int hn = h0 + (u + 1) / pblocks, pn = ((u + 1) % pblocks) * kPB;
      stage_unit(xs0 + ((u + 1) & 1) * kXs, das0 + ((u + 1) & 1) * kMaxDim, xdt, dA, row0, H, hn,
                 P, pn, min(kPB, P - pn), Q);
    }
    cp_async_commit();

    // cum = cumsum(dA): warp w scans rows 16 w .. 16 w + 15 (lanes 0-15)
    {
      const int t = 16 * warp + (lane & 15);
      float x = lane < 16 && t < Q ? das[t] : 0.0f;
#pragma unroll
      for (int off = 1; off < 16; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, x, off, 16);
        if ((lane & 15) >= off) x += up;
      }
      if (lane == 15) scr[warp] = x;
      __syncthreads();
      float pre = 0.0f;
      for (int w = 0; w < warp; ++w) pre += scr[w];
      if (lane < 16 && t < kMaxDim) cum[t] = t < Q ? pre + x : 0.0f;
      __syncthreads();
    }
    const float last = cum[Q - 1];
    if (p0 == 0) {
      for (int t = tid; t < Q; t += kThreads) exp_cum[(row0 + t) * H + h] = expf(cum[t]);
      if (tid == 0) decay[(static_cast<long long>(b) * nc + ch) * H + h] = expf(last);
    }
    for (int t = tid; t < kMaxDim; t += kThreads) dec[t] = t < Q ? expf(last - cum[t]) : 0.0f;

    // (G * L) on this warp's tiles into shared memory: L[q, t] =
    // exp(cum[q] - cum[t]) for t <= q, else 0
#pragma unroll
    for (int k = 0; k < kTiles; ++k) {
      if (tile[k] < 0) continue;
      const int qa = 16 * (tile[k] >> 8) + g, qb = qa + 8, t0 = 8 * (tile[k] & 0xff) + 2 * c;
      const float cqa = cum[qa], cqb = cum[qb];
      const float2 ct = *reinterpret_cast<const float2*>(cum + t0);
      *reinterpret_cast<float2*>(gl + qa * GLD + t0) =
          make_float2(t0 <= qa ? gt[k][0] * expf(cqa - ct.x) : 0.0f,
                      t0 + 1 <= qa ? gt[k][1] * expf(cqa - ct.y) : 0.0f);
      *reinterpret_cast<float2*>(gl + qb * GLD + t0) =
          make_float2(t0 <= qb ? gt[k][2] * expf(cqb - ct.x) : 0.0f,
                      t0 + 1 <= qb ? gt[k][3] * expf(cqb - ct.y) : 0.0f);
    }
    __syncthreads();  // G * L and dec are complete

    // y = (G * L) xdt: this warp's row blocks rp and 7 - rp (together 18 key
    // steps for every rp) and head columns 8 kYN nq .. + 8 kYN - 1; a key
    // step s covers keys 8 s .. 8 s + 7 and stops at the diagonal, where L ends
    const int rp = warp & 3, nq = warp >> 2;
    const int pn8 = kFull ? 8 : (pw + 7) / 8;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rb = half ? 7 - rp : rp;
      if (rb >= qt16 || kYN * nq >= pn8) continue;
      float yacc[kYN][4];
#pragma unroll
      for (int n = 0; n < kYN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) yacc[n][e] = 0.0f;
      const int steps = min(qs8, 2 * rb + 2);
#pragma unroll 2
      for (int s = 0; s < steps; ++s) {
        // slot c is key 8 s + 2 c, slot c + 4 key 8 s + 2 c + 1
        const float* ga = gl + (16 * rb + g) * GLD + 8 * s + 2 * c;
        const float2 ua = *reinterpret_cast<const float2*>(ga);
        const float2 ub = *reinterpret_cast<const float2*>(ga + 8 * GLD);
        const Tf32x2 a[4] = {split_tf32(ua.x), split_tf32(ub.x), split_tf32(ua.y),
                             split_tf32(ub.y)};
        const float* x0 = xs + (8 * s + 2 * c) * XLD + 8 * kYN * nq + g;
#pragma unroll
        for (int n = 0; n < kYN; ++n)
          if (kFull || kYN * nq + n < pn8)
            mma_3xtf32(yacc[n], a, split_tf32(x0[8 * n]), split_tf32(x0[XLD + 8 * n]));
      }
      // fragments write whole 32-byte sectors: 4 lanes x 2 adjacent columns
      const int qa = 16 * rb + g;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = qa + 8 * r;
        if (!kFull && q >= Q) continue;
        float* yrow = y + ((row0 + q) * H + h) * P + p0;
#pragma unroll
        for (int n = 0; n < kYN; ++n) {
          const int p = 8 * (kYN * nq + n) + 2 * c;
          store_pair(yrow + p, p, pw, kFull || P % 2 == 0, yacc[n][2 * r], yacc[n][2 * r + 1]);
        }
      }
    }

    // states = (xdt * decay)^T B: this warp's rows 16 pm .. + 15 of the
    // unit's block, columns 8 kSN nh .. + 8 kSN - 1
    const int pm = warp & 3, nh = warp >> 2;
    if (kFull || (16 * pm < pw && 8 * kSN * nh < N)) {
      const int nn8 = kFull ? kSN : min(kSN, (N - 8 * kSN * nh + 7) / 8);
      float sacc[kSN][4];
#pragma unroll
      for (int n = 0; n < kSN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[n][e] = 0.0f;
#pragma unroll 2
      for (int s = 0; s < qs8; ++s) {
        const int t0 = 8 * s + 2 * c;  // slot c is key t0, slot c + 4 key t0 + 1
        const float* xa = xs + t0 * XLD + 16 * pm + g;
        const float d0 = dec[t0], d1 = dec[t0 + 1];
        const Tf32x2 a[4] = {split_tf32(xa[0] * d0), split_tf32(xa[8] * d0),
                             split_tf32(xa[XLD] * d1), split_tf32(xa[XLD + 8] * d1)};
        const float* bb = bs + t0 * BLD + 8 * kSN * nh + g;
#pragma unroll
        for (int n = 0; n < kSN; ++n)
          if (n < nn8) mma_3xtf32(sacc[n], a, split_tf32(bb[8 * n]), split_tf32(bb[BLD + 8 * n]));
      }
      float* sb = states + ((static_cast<long long>(b) * nc + ch) * H + h) * P * N +
                  static_cast<long long>(p0) * N;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 16 * pm + g + 8 * r;
        if (!kFull && p >= pw) continue;
#pragma unroll
        for (int n = 0; n < kSN; ++n) {
          const int col = 8 * (kSN * nh + n) + 2 * c;
          store_pair(sb + p * N + col, col, N, kFull || N % 2 == 0, sacc[n][2 * r],
                     sacc[n][2 * r + 1]);
        }
      }
    }
  }
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
    return 0;
  return n;
}

template <typename T, bool kFull>
int launch(const void* xdt, const float* dA, const void* Bm, const void* Cm, float* y,
           float* states, float* decay, float* exp_cum, int B, int S, int H, int P, int N, int Q,
           cudaStream_t stream) {
  constexpr int smem = kSmemFloats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_scan_kernel<T, kFull>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sm_count();  // one CTA per SM at this footprint
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  // the group size that minimises waves x (the group's units + one C B^T),
  // in tensor-core products: a unit is y's triangle and the states of up to
  // 64 head columns, C B^T is Q x Q x N
  const long long pairs = static_cast<long long>(B) * (S / Q);
  const double unit = 0.5 * Q * Q * kPB + static_cast<double>(kPB) * N * Q;
  const double head = unit * ((P + kPB - 1) / kPB), gcost = static_cast<double>(Q) * Q * N;
  int group = 1;
  double best = -1.0;
  for (int gs = 1; gs <= kMaxGroup; ++gs) {
    const long long ngroups = (H + gs - 1) / gs;
    if (ngroups > 65535) continue;
    const long long waves = (pairs * ngroups + sms - 1) / sms;
    const double t = static_cast<double>(waves) * (gs * head + gcost);
    if (best < 0.0 || t < best) best = t, group = gs;
  }
  if (best < 0.0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(S / Q), static_cast<unsigned>((H + group - 1) / group),
                  static_cast<unsigned>(B));
  ssd_chunk_scan_kernel<T, kFull><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(xdt), dA, static_cast<const T*>(Bm), static_cast<const T*>(Cm), y,
      states, decay, exp_cum, S, H, P, N, Q, group);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_full(bool full, const void* xdt, const float* dA, const void* Bm, const void* Cm,
                  float* y, float* states, float* decay, float* exp_cum, int B, int S, int H, int P,
                  int N, int Q, cudaStream_t s) {
  if (full)
    return launch<T, true>(xdt, dA, Bm, Cm, y, states, decay, exp_cum, B, S, H, P, N, Q, s);
  return launch<T, false>(xdt, dA, Bm, Cm, y, states, decay, exp_cum, B, S, H, P, N, Q, s);
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype 0 = float32, 1 = bfloat16
// for xdt (B, S, H, P), Bm and Cm (B, S, N); dA (B, S, H) is float32; all
// contiguous and 16-byte aligned. Outputs (float32, contiguous, 16-byte
// aligned): y (B, S, H, P), states (B, nc, H, P, N), decay (B, nc, H),
// exp_cum (B, S, H). Requires S % Q == 0 and Q, N, P in [1, 128]. Launches on
// `stream`, does not synchronise, returns the cudaError_t of the launch.
extern "C" int ssd_chunk_scan_launch(const void* xdt, const float* dA, const void* Bm,
                                     const void* Cm, float* y, float* states, float* decay,
                                     float* exp_cum, int dtype, int B, int S, int H, int P, int N,
                                     int Q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (Q < 1 || Q > kMaxDim || N < 1 || N > kMaxDim || P < 1 || P > kMaxDim || S % Q ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool full = Q == kMaxDim && N == kMaxDim && P % kPB == 0;
  if (dtype == 0)
    return dispatch_full<float>(full, xdt, dA, Bm, Cm, y, states, decay, exp_cum, B, S, H, P, N, Q,
                                s);
  if (dtype == 1)
    return dispatch_full<__nv_bfloat16>(full, xdt, dA, Bm, Cm, y, states, decay, exp_cum, B, S, H,
                                        P, N, Q, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
