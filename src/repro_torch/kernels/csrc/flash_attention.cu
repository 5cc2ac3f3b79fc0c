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
// is acc / max(l, 1e-30).
//
// Bound. Each visible (query, key) pair costs 2 hd operations for q.k and
// 2 hd for p.v. At the main path's (4, 16, 1024, 128), causal, that is
// 17.2 GFLOP: on the tensor cores through the 3xTF32 split (three tf32
// products per f32 product, 495 TFLOP/s) 0.104 ms, on the FP32 units
// (67 TFLOP/s) 0.26 ms, against 0.03 ms for the bytes. The kernel is bound
// by the tensor cores' operations.
//
// Why 3xTF32 and not TF32: the kernel is held to the f32 plain version at
// 2e-4. One tf32 pass keeps 10 mantissa bits (5e-4 relative per operand),
// which sums over hd = 128 terms cannot hold; the split (mma_tf32.cuh) keeps
// about 2^-21 per product. cuBLAS and cuDNN stay TF32-off (device.resolve):
// the split is this kernel's own. bfloat16 k and v are exact in tf32, so
// their products drop the hi.lo' term (two tf32 products, not three).
//
// Design. One CTA of 8 warps per (b, h, 128-row query tile), heaviest tiles
// first; warp w owns query rows 16 w .. 16 w + 15, and a warp whose rows lie
// past S (the ragged last tile: S is a multiple of 64) only helps load. The
// warp's scaled q rows stay in registers as f32 for the whole call. Key tiles
// of 64 rows: K and V of tile j + 1 load by cp.async into the second half of
// a double buffer while tile j computes, one barrier per tile. q.k^T and p.v
// are m16n8k8 tf32 mma.sync with the 3xTF32 split: q.k^T reads each thread's
// four K values of two k steps as one 16-byte load (rows padded so that the
// loads of a quarter-warp fall on distinct banks), and the score fragment
// is, value for value, the A fragment of p.v (k slot c is key 2c, slot c + 4
// key 2c + 1), so the softmax stays in registers: the row max and row sum
// are two quad shuffles each, and p never goes through shared memory. A
// warp takes a tile in two halves of 32 keys, so that q, the output
// accumulator and the scores fit its registers (233 at hd 128, no spill).
// Key tiles wholly outside the causal / window band of the CTA are never
// loaded (the TPU kernel's pl.when skip), and a warp skips the halves
// outside its own rows' band.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "mma_tf32.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows per CTA
constexpr int kKeys = 64;           // key rows per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// four consecutive values (16 bytes of f32, 8 of bf16, aligned) as f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// the split of a B operand; bfloat16 data is exact in tf32 (lo = 0)
template <bool kExact>
__device__ __forceinline__ Tf32x2 split_b(float x) {
  if (kExact) return {__float_as_uint(x), 0u};
  return split_tf32(x);
}

// Shared-memory rows (elements). K rows are read 16 bytes a lane at
// (row g, column 4 c): a row stride of 16 floats (f32) or 32 bytes (bf16)
// modulo the bank width puts a quarter-warp's (or half-warp's) loads on
// distinct banks. V rows are read one value a lane at (row 2 c, column g):
// a stride of 4 banks modulo 32 does the same. Rows stay 16-byte aligned
// for cp.async.
template <typename T, int HD>
struct Layout {
  static constexpr int kMod = sizeof(T) == 4 ? 32 : 64;
  static constexpr int KLD = HD + ((16 - HD) % kMod + kMod) % kMod;
  static constexpr int VLD = HD + 16 / static_cast<int>(sizeof(T));
  static constexpr int kStage = kKeys * (KLD + VLD);  // elements of one K + V stage
  static constexpr int kBytes = 2 * kStage * static_cast<int>(sizeof(T));
};

template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const T* __restrict__ kb,
                                          const T* __restrict__ vb, long long kss, long long vss,
                                          int k0) {
  using L = Layout<T, HD>;
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));  // elements per 16-byte chunk
  constexpr int kChunks = HD / kPer;                       // chunks per row
  for (int i = threadIdx.x; i < kKeys * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kPer;
    cp_async16(ks + r * L::KLD + c, kb + (k0 + r) * kss + c);
    cp_async16(vs + r * L::VLD + c, vb + (k0 + r) * vss + c);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o, int H, int group, int S, long long qsb, long long qsh,
                       long long qss, long long ksb, long long ksh, long long kss, long long vsb,
                       long long vsh, long long vss, long long osb, long long osh, long long oss,
                       int causal, int window, float scale) {
  using L = Layout<T, HD>;
  constexpr bool kExact = std::is_same<T, __nv_bfloat16>::value;
  constexpr int KJ = HD / 16;  // 16-column blocks of q.k^T's depth (two k steps each)
  constexpr int ND = HD / 8;   // n tiles of p.v
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int b = blockIdx.x / H, h = blockIdx.x % H, hk = h / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  // heaviest query tiles first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, c = lane % 4;
  const int r0 = q0 + 16 * warp;  // this warp's first query row
  const bool active = r0 < S;
  const T* kb = k + b * ksb + hk * ksh;
  const T* vb = v + b * vsb + hk * vsh;

  // q rows r0 + g and r0 + g + 8, columns 16 j + 4 c .. + 3, scaled
  float4 qf[KJ][2];
  if (active) {
    const T* qb = q + b * qsb + h * qsh + (r0 + g) * qss + 4 * c;
#pragma unroll
    for (int j = 0; j < KJ; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float4 x = load4(qb + r * 8 * qss + 16 * j);
        qf[j][r] = make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
      }
  }
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  // key tiles that hold a visible key for some row of this query tile
  int kt_end = S / kKeys;
  if (causal) kt_end = min(kt_end, min(q0 + kRows - 1, S - 1) / kKeys + 1);
  const int kt_begin = window > 0 ? max(q0 - window + 1, 0) / kKeys : 0;

  if (kt_begin < kt_end)
    load_tile<T, HD>(smem, smem + kKeys * L::KLD, kb, vb, kss, vss, kt_begin * kKeys);
  cp_async_commit();
  for (int kt = kt_begin, i = 0; kt < kt_end; ++kt, ++i) {
    const T* ks = smem + (i & 1) * L::kStage;
    const T* vs = ks + kKeys * L::KLD;
    cp_async_wait<0>();
    __syncthreads();  // tile kt has landed; every warp is done with the other stage
    if (kt + 1 < kt_end) {
      T* nk = smem + ((i + 1) & 1) * L::kStage;
      load_tile<T, HD>(nk, nk + kKeys * L::KLD, kb, vb, kss, vss, (kt + 1) * kKeys);
    }
    cp_async_commit();

    // the tile in two halves of 32 keys: a 16 x 32 score fragment a warp
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      // q's split is redone for every half, not hoisted out of the loop:
      // hoisted, its hi and lo halves would take 128 registers
#pragma unroll
      for (int j = 0; j < KJ; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          asm volatile("" : "+f"(qf[j][r].x), "+f"(qf[j][r].y), "+f"(qf[j][r].z), "+f"(qf[j][r].w));
      const int k0 = kt * kKeys + 32 * half;
      if (!active || (causal && k0 > r0 + 15) || (window > 0 && r0 - (k0 + 31) >= window))
        continue;  // no key of this half is visible to the warp's rows
      const bool full = (!causal || k0 + 31 <= r0) && (window <= 0 || r0 + 15 - k0 < window);
      const T* kh = ks + 32 * half * L::KLD;
      const T* vh = vs + 32 * half * L::VLD;

      // s = q k^T: 16 rows x 32 keys, n tile t holds keys 8 t + 2 c, 8 t + 2 c + 1
      float s[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[t][e] = 0.0f;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        // k step 2 j: slots c, c + 4 = columns 16 j + 4 c, + 1; step 2 j + 1: + 2, + 3
        const float4 qa = qf[j][0], qb = qf[j][1];
        const Tf32x2 a0[4] = {split_tf32(qa.x), split_tf32(qb.x), split_tf32(qa.y),
                              split_tf32(qb.y)};
        const Tf32x2 a1[4] = {split_tf32(qa.z), split_tf32(qb.z), split_tf32(qa.w),
                              split_tf32(qb.w)};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const float4 kv = load4(kh + (8 * t + g) * L::KLD + 16 * j + 4 * c);
          mma_3xtf32<kExact>(s[t], a0, split_b<kExact>(kv.x), split_b<kExact>(kv.y));
          mma_3xtf32<kExact>(s[t], a1, split_b<kExact>(kv.z), split_b<kExact>(kv.w));
        }
      }

      // online softmax on the fragment's rows g (e = 0, 1) and g + 8 (e = 2, 3)
      uint32_t ok = 0xffffu;  // bit 4 t + e: the pair is visible
      if (!full) {
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qp = r0 + g + 8 * (e >> 1), kp = k0 + 8 * t + 2 * c + (e & 1);
            if (!((!causal || kp <= qp) && (window <= 0 || qp - kp < window))) {
              ok &= ~(1u << (4 * t + e));
              s[t][e] = kNegInf;
            }
          }
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int t = 0; t < 4; ++t) mx = fmaxf(mx, fmaxf(s[t][2 * r], s[t][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        corr[r] = expf(m[r] - m_new);
        float sum = 0.0f;
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int e = 2 * r; e < 2 * r + 2; ++e) {
            const float p = (ok >> (4 * t + e)) & 1u ? expf(s[t][e] - m_new) : 0.0f;
            s[t][e] = p;
            sum += p;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[r] = l[r] * corr[r] + sum;
        m[r] = m_new;
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }

      // acc += p v: k step t covers keys 8 t .. 8 t + 7, its A fragment is s[t]
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const Tf32x2 a[4] = {split_tf32(s[t][0]), split_tf32(s[t][2]), split_tf32(s[t][1]),
                             split_tf32(s[t][3])};
        const T* v0 = vh + (8 * t + 2 * c) * L::VLD + g;
#pragma unroll
        for (int n = 0; n < ND; ++n)
          mma_3xtf32<kExact>(acc[n], a, split_b<kExact>(to_f32(v0[8 * n])),
                             split_b<kExact>(to_f32(v0[L::VLD + 8 * n])));
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = o + b * osb + h * osh + (r0 + g + 8 * r) * oss + 2 * c;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      store2(orow + 8 * n, acc[n][2 * r] / denom, acc[n][2 * r + 1] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv, int S,
           const long long* st, int causal, int window, float scale, cudaStream_t stream) {
  constexpr int smem = Layout<T, HD>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(B * H), static_cast<unsigned>((S + kRows - 1) / kRows));
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, H / Hkv, S, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
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
// position) of q, k, v and out, the head_dim axis contiguous; q, k and v
// rows start 16-byte aligned. Requires S % 64 == 0, hd a multiple of 16 up
// to 128 and H % Hkv == 0. Launches on `stream`, does not synchronise,
// returns the cudaError_t of the launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int dtype, int B, int H, int Hkv, int S, int hd,
                                      const long long* strides, int causal, int window,
                                      float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return 0;
  if (Hkv <= 0 || H % Hkv || S % kKeys || B > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, out, B, H, Hkv, S, strides, causal, window, scale, s);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, out, B, H, Hkv, S, strides, causal, window,
                                      scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
