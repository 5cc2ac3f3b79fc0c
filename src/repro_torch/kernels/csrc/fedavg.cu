// Per-leaf masked FedAvg (kernel K11), for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/fedavg.py::fedavg_masked_mean
// (its body _kernel, launched through pl.pallas_call): the legacy per-leaf
// Eq. 5 + Eq. 6 reduction that kernels/ops.py::fedavg_tree runs once per
// leaf of a client-stacked tree. The wrapper src/repro_torch/kernels/fedavg.py
// validates the operands and computes, once and in plain torch, the (C,)
// weighted mask wm = weights * mask and the 0-d denominator
// den = max(sum(wm), 1e-12), as the reference computes them outside its
// kernel.
//
// Semantics: x is a (C, N) float32 or bfloat16 leaf, flattened. For every n
//
//   acc    = (...((0 + x[0, n] * wm[0]) + x[1, n] * wm[1]) ...) + x[C-1, n] * wm[C-1]
//   out[n] = T(acc / den)
//
// in float32 (a bfloat16 x is widened exactly), the clients in order
// c = 0..C-1, each product and each sum rounded on its own (-fmad=false), a
// true IEEE division (no reciprocal), and one round-to-nearest-even cast to
// the input dtype. The plain version kernels/ref.py::fedavg_masked_mean is
// the same ordered chain, so kernel and plain version are bitwise equal.
//
// Bound: bytes. The kernel reads C*N elements and writes N, with one
// multiply and one add per element read: far below the card's
// operations-per-byte balance. At C = 2 in float32 that is 12 bytes per
// output element. The design streams: one thread per element in a
// grid-stride loop (neighbouring threads on neighbouring addresses in every
// client row), a few blocks per SM in flight, the C weights read through
// the read-only cache. The ragged tail of N is guarded in the loop; nothing
// is padded (the TPU kernel pads N to its 1024-element blocks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
fedavg_kernel(const T* __restrict__ x, const float* __restrict__ wm,
              const float* __restrict__ den_p, T* __restrict__ out, int n_clients, long long n) {
  const float den = __ldg(den_p);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float acc = 0.0f;
    for (int c = 0; c < n_clients; ++c)
      acc = acc + to_f32(x[static_cast<long long>(c) * n + i]) * __ldg(wm + c);
    store(out + i, acc / den);
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* wm, const float* den, void* out, int n_clients,
                   long long n, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  fedavg_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), wm, den, static_cast<T*>(out), n_clients, n);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. dtype 0 = float32, 1 = bfloat16
// (x and out alike). Launches on `stream` (PyTorch's current stream), does
// not synchronise, returns the cudaError_t of the launch (0 on success).
extern "C" int fedavg_masked_mean_launch(const void* x, const float* wm, const float* den,
                                         void* out, int dtype, int n_clients, long long n,
                                         void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0 ? launch<float>(x, wm, den, out, n_clients, n, s)
                                     : launch<__nv_bfloat16>(x, wm, den, out, n_clients, n, s);
  return static_cast<int>(err);
}
