// Packed bucket-weighted client reduction (kernel K1), for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/pack.py::packed_bucket_reduce
// (its body _reduce_kernel, launched through pl.pallas_call). The wrapper
// src/repro_torch/kernels/pack.py validates the operands; the division by
// den and the per-bucket denominator stay torch ops, as they stay outside
// the reference's kernel (core/packing.py::masked_bucket_mean).
//
// Semantics: x is the packed (C, N) f32 round state, wm the (C, B) f32
// per-(client, bucket) weights, ids the (N,) int32 bucket of each element
// (every id in [0, B)), mask the (C,) f32 participation vector. For every n
//
//   w_c    = wm[c, ids[n]] * mask[c]
//   num[n] = (...((0 + x[0, n] * w_0) + x[1, n] * w_1) ...) + x[C-1, n] * w_{C-1}
//   den[n] = (...((0 + w_0) + w_1) ...) + w_{C-1}
//
// with the clients summed in order c = 0..C-1. The plain version
// kernels/ref.py::packed_bucket_reduce is the same ordered chain, and the
// build passes -fmad=false so no product is contracted into an FMA: kernel
// and plain version are bitwise equal.
//
// Bound: bytes. The kernel reads C*N*4 + N*4 bytes and writes 2*N*4, about
// one f32 add and multiply per byte-quad moved, far below the card's
// operations-per-byte balance. At the main path's (3, 13,312,864) that is
// 319.5 MB, 0.095 ms at 3.35 TB/s. The design therefore spends nothing on
// arithmetic and everything on streaming: one thread owns 4 consecutive
// elements (16-byte loads of x, ids, num and den, neighbouring threads on
// neighbouring addresses), a grid-stride loop keeps a few blocks per SM in
// flight, and each element's weights come from a (C, B) table that the
// block stages once in shared memory (the TPU kernel's one-hot matmul over
// a bucket window has no use here). A table above 48 KB (C*B > 12,288) is
// not staged: each weight is then read through L1 with __ldg instead.
// Rows that are not 16-byte aligned (N % 4 != 0) take a scalar path.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
// the static shared-memory limit: a table this small needs no opt-in
constexpr int kMaxTableFloats = 48 * 1024 / 4;

template <bool kStaged>
__device__ __forceinline__ float weight(const float* table, const float* __restrict__ wm,
                                        const float* __restrict__ mask, int c, int b, int nb) {
  if (kStaged) return table[c * nb + b];
  return __ldg(wm + static_cast<size_t>(c) * nb + b) * __ldg(mask + c);
}

template <bool kStaged, bool kVec4>
__global__ void __launch_bounds__(kThreads)
bucket_reduce_kernel(const float* __restrict__ x, const float* __restrict__ wm,
                     const int* __restrict__ ids, const float* __restrict__ mask,
                     float* __restrict__ num, float* __restrict__ den,
                     int n_clients, long long n, int nb) {
  extern __shared__ float table[];
  if (kStaged) {
    for (int i = threadIdx.x; i < n_clients * nb; i += blockDim.x)
      table[i] = wm[i] * mask[i / nb];
    __syncthreads();
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (kVec4) {
    const long long n4 = n / 4;
    for (long long v = first; v < n4; v += stride) {
      const int4 id = reinterpret_cast<const int4*>(ids)[v];
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4 d = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int c = 0; c < n_clients; ++c) {
        const float4 xv = __ldg(reinterpret_cast<const float4*>(x + static_cast<size_t>(c) * n) + v);
        const float w0 = weight<kStaged>(table, wm, mask, c, id.x, nb);
        const float w1 = weight<kStaged>(table, wm, mask, c, id.y, nb);
        const float w2 = weight<kStaged>(table, wm, mask, c, id.z, nb);
        const float w3 = weight<kStaged>(table, wm, mask, c, id.w, nb);
        s.x = s.x + xv.x * w0;
        s.y = s.y + xv.y * w1;
        s.z = s.z + xv.z * w2;
        s.w = s.w + xv.w * w3;
        d.x = d.x + w0;
        d.y = d.y + w1;
        d.z = d.z + w2;
        d.w = d.w + w3;
      }
      reinterpret_cast<float4*>(num)[v] = s;
      reinterpret_cast<float4*>(den)[v] = d;
    }
  } else {
    for (long long i = first; i < n; i += stride) {
      const int b = ids[i];
      float s = 0.0f, d = 0.0f;
      for (int c = 0; c < n_clients; ++c) {
        const float w = weight<kStaged>(table, wm, mask, c, b, nb);
        s = s + __ldg(x + static_cast<size_t>(c) * n + i) * w;
        d = d + w;
      }
      num[i] = s;
      den[i] = d;
    }
  }
}

template <bool kStaged, bool kVec4>
cudaError_t launch(const float* x, const float* wm, const int* ids, const float* mask,
                   float* num, float* den, int n_clients, long long n, int nb,
                   cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const long long work = kVec4 ? n / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  const size_t smem = kStaged ? static_cast<size_t>(n_clients) * nb * sizeof(float) : 0;
  bucket_reduce_kernel<kStaged, kVec4><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      x, wm, ids, mask, num, den, n_clients, n, nb);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream` (PyTorch's
// current stream), does not synchronise, returns the cudaError_t of the
// launch (0 on success).
extern "C" int packed_bucket_reduce_launch(const float* x, const float* wm, const int* ids,
                                           const float* mask, float* num, float* den,
                                           int n_clients, long long n, int nb, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool staged = static_cast<long long>(n_clients) * nb <= kMaxTableFloats;
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(ids) |
                         reinterpret_cast<uintptr_t>(num) | reinterpret_cast<uintptr_t>(den);
  const bool vec4 = n % 4 == 0 && bits % 16 == 0;
  cudaError_t err;
  if (staged)
    err = vec4 ? launch<true, true>(x, wm, ids, mask, num, den, n_clients, n, nb, s)
               : launch<true, false>(x, wm, ids, mask, num, den, n_clients, n, nb, s);
  else
    err = vec4 ? launch<false, true>(x, wm, ids, mask, num, den, n_clients, n, nb, s)
               : launch<false, false>(x, wm, ids, mask, num, den, n_clients, n, nb, s);
  return static_cast<int>(err);
}
