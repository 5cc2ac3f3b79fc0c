// Participation-gated modular sum, the server side of secure aggregation
// (kernel K8), for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/mask.py::masked_u32_sum (its
// body _masked_sum_kernel). The wrapper src/repro_torch/kernels/mask.py::
// masked_u32_sum validates the operands; the pairwise masks are built by
// core/packing.py::secure_client_masks, as in the reference.
//
// Semantics: rows is the (C, N) masked client payload as 32-bit words (an
// int32 tensor holding uint32 bits), participation the (C,) f32 vector. For
// every n
//
//   out[n] = sum over c with participation[c] > 0 of rows[c, n]   (mod 2^32)
//
// in native uint32 wraparound, clients in order. Integer addition mod 2^32
// is exact in any order, so kernel, plain version (kernels/ref.py::
// masked_u32_sum) and the reference's oracle agree bit for bit, and the
// pairwise masks cancel exactly.
//
// Bound: bytes. The kernel reads C*N*4 bytes once and writes N*4, one
// integer add per word read. At the main path's (3, 13,313,024) (the padded
// N the secure aggregator reduces) that is 213.0 MB, 0.0636 ms at
// 3.35 TB/s. Design: a grid-stride loop in which one thread owns 4
// consecutive words (16-byte loads and stores), the participation test is a
// per-client predicate read once per thread, and a non-participating row is
// never read. Rows that are not 16-byte aligned (N % 4 != 0) take a scalar
// path.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
masked_sum_kernel(const unsigned* __restrict__ rows, const float* __restrict__ part,
                  unsigned* __restrict__ out, int n_clients, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (kVec4) {
    for (long long v = first; v < n / 4; v += stride) {
      uint4 acc = make_uint4(0u, 0u, 0u, 0u);
      for (int c = 0; c < n_clients; ++c) {
        if (!(__ldg(part + c) > 0.0f)) continue;
        const uint4 r = __ldg(reinterpret_cast<const uint4*>(rows + static_cast<size_t>(c) * n) + v);
        acc.x += r.x;
        acc.y += r.y;
        acc.z += r.z;
        acc.w += r.w;
      }
      reinterpret_cast<uint4*>(out)[v] = acc;
    }
  } else {
    for (long long i = first; i < n; i += stride) {
      unsigned acc = 0u;
      for (int c = 0; c < n_clients; ++c)
        if (__ldg(part + c) > 0.0f) acc += __ldg(rows + static_cast<size_t>(c) * n + i);
      out[i] = acc;
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream`, does not
// synchronise, returns the cudaError_t of the launch.
extern "C" int masked_u32_sum_launch(const unsigned* rows, const float* part, unsigned* out,
                                     int n_clients, long long n, void* stream) {
  if (n <= 0) return 0;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(rows) | reinterpret_cast<uintptr_t>(out);
  const bool vec4 = n % 4 == 0 && bits % 16 == 0;
  const long long work = vec4 ? n / 4 : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  if (vec4)
    masked_sum_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(rows, part, out,
                                                                               n_clients, n);
  else
    masked_sum_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(rows, part, out,
                                                                                n_clients, n);
  return static_cast<int>(cudaGetLastError());
}
