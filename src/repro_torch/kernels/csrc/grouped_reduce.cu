// Per-group weighted member sum, the hierarchical inner reduce (kernel K6),
// for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/pack.py::grouped_reduce (its
// body _grouped_kernel). The wrapper src/repro_torch/kernels/pack.py::
// grouped_reduce validates the operands; the per-group renormalization is
// folded into the weights by core/packing.py::grouped_weighted_mean, as in
// the reference.
//
// Semantics: x is the packed (C, N) f32 round state, wn the (C/G, G) f32
// pre-normalized member weights. For every group g and element n
//
//   out[g, n] = (...((x[gG, n] wn[g, 0]) + x[gG+1, n] wn[g, 1]) ...) + x[gG+G-1, n] wn[g, G-1]
//
// with the members summed in order. The plain version kernels/ref.py::
// grouped_reduce is the same ordered chain, and the build passes
// -fmad=false, so kernel and plain version are bitwise equal.
//
// Bound: bytes. The kernel reads C*N*4 bytes once and writes (C/G)*N*4, one
// multiply and one add per element read. At the main path's (4, 13,312,864)
// with G = 2 that is 319.5 MB, 0.0954 ms at 3.35 TB/s. Design: a 2-D grid,
// (N tile, group); one thread owns 4 consecutive elements of one group row
// (16-byte loads and stores, neighbouring threads on neighbouring
// addresses) and walks that group's members in order, reading each member's
// weight as a broadcast through L1. Rows that are not 16-byte aligned
// (N % 4 != 0) take a scalar path; the ragged edge is masked.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
grouped_reduce_kernel(const float* __restrict__ x, const float* __restrict__ wn,
                      float* __restrict__ out, int group, long long n) {
  const int g = blockIdx.y;
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float* wg = wn + static_cast<size_t>(g) * group;
  const float* xg = x + static_cast<size_t>(g) * group * n;
  float* og = out + static_cast<size_t>(g) * n;
  if (kVec4) {
    if (t >= n / 4) return;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = 0; i < group; ++i) {
      const float w = __ldg(wg + i);
      const float4 v = __ldg(reinterpret_cast<const float4*>(xg + static_cast<size_t>(i) * n) + t);
      if (i == 0) {
        acc = make_float4(v.x * w, v.y * w, v.z * w, v.w * w);
      } else {
        acc.x = acc.x + v.x * w;
        acc.y = acc.y + v.y * w;
        acc.z = acc.z + v.z * w;
        acc.w = acc.w + v.w * w;
      }
    }
    reinterpret_cast<float4*>(og)[t] = acc;
  } else {
    for (int j = 0; j < 4; ++j) {
      const long long e = t * 4 + j;
      if (e >= n) return;
      float acc = 0.0f;
      for (int i = 0; i < group; ++i) {
        const float p = __ldg(xg + static_cast<size_t>(i) * n + e) * __ldg(wg + i);
        acc = i == 0 ? p : acc + p;
      }
      og[e] = acc;
    }
  }
}

}  // namespace

// Plain C entry point, bound with ctypes. x (ngroups*group, n), wn
// (ngroups, group), out (ngroups, n). Launches on `stream`, does not
// synchronise, returns the cudaError_t of the launch.
extern "C" int grouped_reduce_launch(const float* x, const float* wn, float* out, int ngroups,
                                     int group, long long n, void* stream) {
  if (n <= 0 || ngroups <= 0) return 0;
  if (group < 1 || ngroups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out);
  const bool vec4 = n % 4 == 0 && bits % 16 == 0;
  const long long work = (n + 3) / 4;  // 4 elements per thread either way
  const dim3 grid(static_cast<unsigned>((work + kThreads - 1) / kThreads),
                  static_cast<unsigned>(ngroups));
  if (vec4)
    grouped_reduce_kernel<true><<<grid, kThreads, 0, s>>>(x, wn, out, group, n);
  else
    grouped_reduce_kernel<false><<<grid, kThreads, 0, s>>>(x, wn, out, group, n);
  return static_cast<int>(cudaGetLastError());
}
