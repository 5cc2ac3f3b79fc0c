// Causal / windowed GQA flash attention, forward (kernel K9), for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attention.py::
// flash_attention (its body _kernel). The wrapper src/repro_torch/kernels/
// flash_attention.py::flash_attention validates the operands and passes
// element strides, so the model's (B, S, H, hd) projections are read in
// place through their (B, H, S, hd) views and the output is written straight
// into a (B, S, H, hd) buffer.
//
// Semantics: q (B, H, S, hd), k and v (B, Hkv, S, hd), float32 or bfloat16,
// one dtype; out (B, H, S, hd) in that dtype. Query head h reads kv head
// h / (H / Hkv). Key position t is visible to query position s when
// (!causal || t <= s) && (window == 0 || s - t < window). Online softmax as
// in the TPU kernel: q is scaled by 1/sqrt(hd) when it is staged (the TPU
// kernel's choice; the plain version divides the scores instead, which
// differs by about one rounding), masked scores are -1e30, p = exp(s - m_new)
// is zeroed where masked, l = l * exp(m_prev - m_new) + sum(p), and the output
// is acc / max(l, 1e-30). Everything is float32 (FP32 units, no tensor
// cores: the port keeps TF32 off); products are explicit fmaf, which
// -fmad=false does not split.
//
// Bound: operations. Each visible (query, key) pair costs 2 hd for q.k and
// 2 hd for p.v; at the main path's (4, 16, 1024, 128), causal, that is
// 17.2 GFLOP, 0.26 ms at 67 TFLOP/s, against 0.03 ms for the bytes.
//
// Design, simple first: one CTA of 256 threads per (b, h, 64-row query
// tile). The query tile sits in shared memory; key tiles of 64 rows are
// staged through one shared buffer, then the value tile through the same
// buffer (the loads are synchronous, so K and V need not coexist), which
// keeps the CTA at 82 KiB at hd 128 and two CTAs on each SM. Thread (ty, tx)
// owns query rows 4 ty .. 4 ty + 3 and columns tx + 16 c, so the 16 threads
// of a half-warp share their rows: the row max and row sum are half-warp
// shuffles, and the running max, sum and the (4, hd / 16) accumulator stay
// in registers. The score tile p goes through shared memory to the p.v
// product. Key tiles wholly outside the causal / window band are never
// loaded (the TPU kernel's pl.when skip). Row strides are padded so that
// the reads of a warp fall on distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 64;  // query rows and key rows per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Rows 0..63 of a (rows, HD) slab with row stride `ld` -> shared memory as
// float32 with row stride `sld`, each value times `scale`.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, int sld, const T* __restrict__ src, long long ld,
                                      float scale) {
  for (int i = threadIdx.x; i < kBlock * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    dst[r * sld + d] = to_f32(src[r * ld + d]) * scale;
  }
}

template <int HD>
constexpr int smem_floats() {
  return kBlock * (HD + 4) + kBlock * (HD + 1) + kBlock * (kBlock + 4);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, int group, int S, long long qsb, long long qsh,
                       long long qss, long long ksb, long long ksh, long long kss, long long vsb,
                       long long vsh, long long vss, long long osb, long long osh, long long oss,
                       int causal, int window, float scale) {
  constexpr int QLD = HD + 4;      // 4 rows apart -> 16 banks apart
  constexpr int KLD = HD + 1;      // K rows read across lanes -> distinct banks
  constexpr int PLD = kBlock + 4;
  constexpr int NC = HD / 16;      // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* kv = qs + kBlock * QLD;
  float* ps = kv + kBlock * KLD;

  const int q0 = blockIdx.x * kBlock, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;
  stage<T, HD>(qs, QLD, q + b * qsb + h * qsh + q0 * qss, qss, scale);

  float acc[4][NC];
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.0f;
  }

  // key tiles that hold a visible key for some row of this query tile
  int kt_end = S / kBlock;
  if (causal) kt_end = min(kt_end, (q0 + kBlock - 1) / kBlock + 1);
  const int kt_begin = window > 0 ? max(q0 - window + 1, 0) / kBlock : 0;

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBlock;
    __syncthreads();  // the previous tile's p.v reads of kv and ps are done
    stage<T, HD>(kv, KLD, kb + k0 * kss, kss, 1.0f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qr[4], kc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qr[r] = qs[(ty * 4 + r) * QLD + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kc[c] = kv[(tx + 16 * c) * KLD + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qr[r], kc[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qp = q0 + ty * 4 + r;
      bool ok[4];
      float rmax = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx + 16 * c;
        ok[c] = (!causal || kp <= qp) && (window <= 0 || qp - kp < window);
        if (!ok[c]) s[r][c] = kNegInf;
        rmax = fmaxf(rmax, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(m[r], rmax);
      const float corr = expf(m[r] - m_new);
      float rsum = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[r][c] - m_new) : 0.0f;
        ps[(ty * 4 + r) * PLD + tx + 16 * c] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      l[r] = l[r] * corr + rsum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
    }

    __syncthreads();  // every q.k read of kv is done and ps is complete
    stage<T, HD>(kv, KLD, vb + k0 * vss, vss, 1.0f);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kBlock; ++j) {
      float pr[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) pr[r] = ps[(ty * 4 + r) * PLD + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = kv[j * KLD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(pr[r], vv, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = o + b * osb + h * osh + (q0 + ty * 4 + r) * oss;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(orow + tx + 16 * c, acc[r][c] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv, int S,
           const long long* st, int causal, int window, float scale, cudaStream_t stream) {
  const int smem = smem_floats<HD>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(S / kBlock), static_cast<unsigned>(H),
                  static_cast<unsigned>(B));
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H / Hkv, S, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], st[9], st[10], st[11], causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o, int B, int H,
                int Hkv, int S, const long long* st, int causal, int window, float scale,
                cudaStream_t s) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, Hkv, S, st, causal, window, scale, s);
    case 32: return launch<T, 32>(q, k, v, o, B, H, Hkv, S, st, causal, window, scale, s);
    case 48: return launch<T, 48>(q, k, v, o, B, H, Hkv, S, st, causal, window, scale, s);
    case 64: return launch<T, 64>(q, k, v, o, B, H, Hkv, S, st, causal, window, scale, s);
    case 80: return launch<T, 80>(q, k, v, o, B, H, Hkv, S, st, causal, window, scale, s);
    case 96: return launch<T, 96>(q, k, v, o, B, H, Hkv, S, st, causal, window, scale, s);
    case 112: return launch<T, 112>(q, k, v, o, B, H, Hkv, S, st, causal, window, scale, s);
    case 128: return launch<T, 128>(q, k, v, o, B, H, Hkv, S, st, causal, window, scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype 0 = float32, 1 = bfloat16
// (q, k, v and out alike). `strides` holds 12 element strides: (batch, head,
// position) of q, k, v and out, the head_dim axis contiguous. Requires
// S % 64 == 0, hd a multiple of 16 up to 128 and H % Hkv == 0. Launches on
// `stream`, does not synchronise, returns the cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int dtype, int B, int H, int Hkv, int S, int hd,
                                      const long long* strides, int causal, int window,
                                      float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || H % Hkv || S % kBlock || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, out, B, H, Hkv, S, strides, causal, window, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, H, Hkv, S, strides, causal, window,
                                      scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
