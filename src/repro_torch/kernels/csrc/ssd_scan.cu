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
// xdt, Bm and Cm; dA float32). Products are explicit fmaf in float32 (no
// tensor cores: the port keeps TF32 off).
//
// Bound: operations. C B^T has no head axis, so the least work computes it
// once per (b, c) over the causal triangle; per (b, c, h) the triangle's L
// and y (2 P per pair) and the states (2 Q N P). At the main path's B 4,
// S 1024, H 64, P 64, N 128, Q 128 that is 6.6 GFLOP, 0.098 ms at
// 67 TFLOP/s, against 0.061 ms for the bytes.
//
// Design: one CTA of 256 threads per (b, chunk, group of heads). The
// chunk's C and B rows (Q x N) are staged in shared memory as float32 once
// for the group and G = C B^T is computed once into registers (the TPU
// kernel recomputes it for every head: the heads share B and C). A group is
// up to kHeads heads, fewer when the grid would not fill the card's 132 SMs
// (one CTA per (b, chunk, head) for a small call). Then, head
// by head: the head's xdt rows (Q x P) are staged, warp 0 scans dA (a
// sequential sum per lane over Q / 32 rows, then a shuffle scan of the lane
// totals), G * L overwrites C's rows, and two register-tiled products give
// y = (G * L) xdt and states = (xdt * decay)^T B. Thread (ty, tx) owns rows
// ty + 16 a and columns tx + 16 j, so Q, N and P may each be up to 128; the
// head width P is a template bound (64 or 128) so that no product runs on
// padding at the main path's P = 64. Row strides are odd so that rows read
// across lanes fall on distinct banks. 165 KiB of shared memory at full
// width (dynamic), one CTA per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 8;      // rows (and columns) per thread: 16 x 8 = 128
constexpr int kMaxDim = 16 * kTile;
constexpr int kHeads = 8;     // most heads per CTA sharing one C B^T
constexpr int kSMs = 132;     // H100 SXM

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// kPT: tiles of 16 along the head width P (P <= 16 kPT)
template <typename T, int kPT>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan_kernel(const T* __restrict__ xdt, const float* __restrict__ dA,
                      const T* __restrict__ Bm, const T* __restrict__ Cm, float* __restrict__ y,
                      float* __restrict__ states, float* __restrict__ decay,
                      float* __restrict__ exp_cum, int S, int H, int P, int N, int Q,
                      int group) {
  extern __shared__ float smem[];
  const int NLD = N | 1, QLD = Q | 1;
  float* gs = smem;                       // Q x NLD: C rows, then (C B^T) * L as Q x QLD
  float* bs = gs + Q * max(NLD, QLD);     // Q x NLD: B rows
  float* xs = bs + Q * NLD;               // Q x P: the head's xdt rows
  float* cum = xs + Q * P;                // Q
  float* dec = cum + Q;                   // Q: exp(cum[Q-1] - cum[t])

  const int c = blockIdx.x, h0 = blockIdx.y * group, b = blockIdx.z;
  const int nc = S / Q;
  const long long row0 = static_cast<long long>(b) * S + static_cast<long long>(c) * Q;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  for (int i = tid; i < Q * N; i += kThreads) {
    const int r = i / N, n = i % N;
    gs[r * NLD + n] = to_f32(Cm[(row0 + r) * N + n]);
    bs[r * NLD + n] = to_f32(Bm[(row0 + r) * N + n]);
  }
  __syncthreads();

  // G = C B^T once for the group: rows q = ty + 16 a, columns t = tx + 16 j
  float g[kTile][kTile];
#pragma unroll
  for (int a = 0; a < kTile; ++a)
#pragma unroll
    for (int j = 0; j < kTile; ++j) g[a][j] = 0.0f;
  for (int n = 0; n < N; ++n) {
    float cr[kTile], br[kTile];
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      const int q = ty + 16 * a;
      cr[a] = q < Q ? gs[q * NLD + n] : 0.0f;
      const int t = tx + 16 * a;
      br[a] = t < Q ? bs[t * NLD + n] : 0.0f;
    }
#pragma unroll
    for (int a = 0; a < kTile; ++a)
#pragma unroll
      for (int j = 0; j < kTile; ++j) g[a][j] = fmaf(cr[a], br[j], g[a][j]);
  }

  const int h_end = min(h0 + group, H);
  for (int h = h0; h < h_end; ++h) {
    __syncthreads();  // C (first head) or the previous head's G * L, xs, cum, dec are read
    for (int i = tid; i < Q * P; i += kThreads) {
      const int r = i / P, p = i % P;
      xs[r * P + p] = to_f32(xdt[((row0 + r) * H + h) * P + p]);
    }
    if (tid < 32) {  // cumsum of dA over the chunk
      const int per = (Q + 31) / 32, t0 = tid * per;
      float part = 0.0f;
      for (int i = 0; i < per; ++i) {
        const int t = t0 + i;
        if (t < Q) {
          part += dA[(row0 + t) * H + h];
          cum[t] = part;
        }
      }
      float incl = part;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.0f;
      for (int i = 0; i < per; ++i) {
        const int t = t0 + i;
        if (t < Q) cum[t] += excl;
      }
    }
    __syncthreads();
    const float last = cum[Q - 1];
    for (int t = tid; t < Q; t += kThreads) {
      dec[t] = expf(last - cum[t]);
      exp_cum[(row0 + t) * H + h] = expf(cum[t]);
    }
    if (tid == 0) decay[(static_cast<long long>(b) * nc + c) * H + h] = expf(last);
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      const int q = ty + 16 * a;
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const int t = tx + 16 * j;
        if (q < Q && t < Q) gs[q * QLD + t] = t <= q ? g[a][j] * expf(cum[q] - cum[t]) : 0.0f;
      }
    }
    __syncthreads();

    // y = (G * L) xdt: rows q = ty + 16 a, columns p = tx + 16 j
    float acc[kTile][kPT];
#pragma unroll
    for (int a = 0; a < kTile; ++a)
#pragma unroll
      for (int j = 0; j < kPT; ++j) acc[a][j] = 0.0f;
    for (int t = 0; t < Q; ++t) {
      float gr[kTile], xr[kPT];
#pragma unroll
      for (int a = 0; a < kTile; ++a) {
        const int q = ty + 16 * a;
        gr[a] = q < Q ? gs[q * QLD + t] : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kPT; ++j) {
        const int p = tx + 16 * j;
        xr[j] = p < P ? xs[t * P + p] : 0.0f;
      }
#pragma unroll
      for (int a = 0; a < kTile; ++a)
#pragma unroll
        for (int j = 0; j < kPT; ++j) acc[a][j] = fmaf(gr[a], xr[j], acc[a][j]);
    }
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      const int q = ty + 16 * a;
#pragma unroll
      for (int j = 0; j < kPT; ++j) {
        const int p = tx + 16 * j;
        if (q < Q && p < P) y[((row0 + q) * H + h) * P + p] = acc[a][j];
      }
    }

    // states (P x N) = (xdt * dec)^T B: rows p = ty + 16 a, columns n = tx + 16 j
    float st[kPT][kTile];
#pragma unroll
    for (int a = 0; a < kPT; ++a)
#pragma unroll
      for (int j = 0; j < kTile; ++j) st[a][j] = 0.0f;
    for (int t = 0; t < Q; ++t) {
      float xr[kPT], br[kTile];
      const float d = dec[t];
#pragma unroll
      for (int a = 0; a < kPT; ++a) {
        const int p = ty + 16 * a;
        xr[a] = p < P ? xs[t * P + p] * d : 0.0f;
      }
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const int n = tx + 16 * j;
        br[j] = n < N ? bs[t * NLD + n] : 0.0f;
      }
#pragma unroll
      for (int a = 0; a < kPT; ++a)
#pragma unroll
        for (int j = 0; j < kTile; ++j) st[a][j] = fmaf(xr[a], br[j], st[a][j]);
    }
    float* out = states + ((static_cast<long long>(b) * nc + c) * H + h) * P * N;
#pragma unroll
    for (int a = 0; a < kPT; ++a) {
      const int p = ty + 16 * a;
#pragma unroll
      for (int j = 0; j < kTile; ++j) {
        const int n = tx + 16 * j;
        if (p < P && n < N) out[static_cast<long long>(p) * N + n] = st[a][j];
      }
    }
  }
}

int smem_bytes(int Q, int N, int P) {
  const int NLD = N | 1, QLD = Q | 1;
  return (Q * (NLD > QLD ? NLD : QLD) + Q * NLD + Q * P + 2 * Q) * static_cast<int>(sizeof(float));
}

template <typename T, int kPT>
int launch(const void* xdt, const float* dA, const void* Bm, const void* Cm, float* y,
           float* states, float* decay, float* exp_cum, int B, int S, int H, int P, int N, int Q,
           cudaStream_t stream) {
  const int smem = smem_bytes(Q, N, P);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_scan_kernel<T, kPT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // the largest group (8, 4, 2 or 1 heads) that still gives every SM a CTA
  const long long pairs = static_cast<long long>(B) * (S / Q);
  int group = kHeads;
  while (group > 1 && pairs * ((H + group - 1) / group) < kSMs) group /= 2;
  const int ngroups = (H + group - 1) / group;
  if (ngroups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(S / Q), static_cast<unsigned>(ngroups),
                  static_cast<unsigned>(B));
  ssd_chunk_scan_kernel<T, kPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(xdt), dA, static_cast<const T*>(Bm), static_cast<const T*>(Cm), y,
      states, decay, exp_cum, S, H, P, N, Q, group);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_p(const void* xdt, const float* dA, const void* Bm, const void* Cm, float* y,
               float* states, float* decay, float* exp_cum, int B, int S, int H, int P, int N,
               int Q, cudaStream_t s) {
  if (P <= 64)
    return launch<T, 4>(xdt, dA, Bm, Cm, y, states, decay, exp_cum, B, S, H, P, N, Q, s);
  return launch<T, 8>(xdt, dA, Bm, Cm, y, states, decay, exp_cum, B, S, H, P, N, Q, s);
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype 0 = float32, 1 = bfloat16
// for xdt (B, S, H, P), Bm and Cm (B, S, N); dA (B, S, H) is float32; all
// contiguous. Outputs (float32, contiguous): y (B, S, H, P), states (B, nc,
// H, P, N), decay (B, nc, H), exp_cum (B, S, H). Requires S % Q == 0 and Q,
// N, P in [1, 128]. Launches on `stream`, does not synchronise, returns the
// cudaError_t of the launch.
extern "C" int ssd_chunk_scan_launch(const void* xdt, const float* dA, const void* Bm,
                                     const void* Cm, float* y, float* states, float* decay,
                                     float* exp_cum, int dtype, int B, int S, int H, int P, int N,
                                     int Q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  if (Q < 1 || Q > kMaxDim || N < 1 || N > kMaxDim || P < 1 || P > kMaxDim || S % Q ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_p<float>(xdt, dA, Bm, Cm, y, states, decay, exp_cum, B, S, H, P, N, Q, s);
  if (dtype == 1)
    return dispatch_p<__nv_bfloat16>(xdt, dA, Bm, Cm, y, states, decay, exp_cum, B, S, H, P, N,
                                     Q, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
