// Pairwise IoU / GIoU of center-format boxes (kernel K2), for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/detect.py::pairwise_iou (its
// body _iou_kernel over _iou_tile, launched through pl.pallas_call). The
// wrapper src/repro_torch/kernels/detect.py adds and drops the optional
// batch dim and validates the operands.
//
// Semantics: a (B, N, 4) and b (B, M, 4) center-format (x, y, w, h) f32 ->
// out (B, N, M) f32, out[k, n, m] = IoU(a[k, n], b[k, m]), or GIoU with
// `giou`. The union has a 1e-9 floor, so zero-area and negative-extent
// boxes score 0 (never NaN).
//
// Bit-for-bit contract with kernels/ref.py::pairwise_iou (and the
// reference's ref.pairwise_iou_np): every op below is one IEEE-rounded f32
// add/sub/mul/div/min/max in the oracle's order, `(aa + ba) - inter` for
// the union and every product through fmaxf(., 0). The build passes
// -fmad=false, so no product is contracted into an FMA, and keeps IEEE
// division (no fast math).
//
// Bound: at the eval shape (12 images x 64 detections x 3 GT boxes) the
// kernel reads 3.2 KB and writes 9.2 KB: nanoseconds of memory time, so a
// launch bounds it. The design keeps it simple and launch-cheap: a 3-D grid
// over (M-tile, N-tile, batch) of 32x8-thread blocks; each block computes
// the corners and areas of its 8 a-boxes and 32 b-boxes once into shared
// memory, then each thread writes one output, threads along M on
// neighbouring addresses. Ragged edges are masked, not padded.

#include <cuda_runtime.h>

namespace {

constexpr int kTileM = 32;  // blockDim.x: b-boxes per block
constexpr int kTileN = 8;   // blockDim.y: a-boxes per block

__device__ __forceinline__ void corners(const float* box, float* x1, float* y1, float* x2,
                                        float* y2, float* area, int i) {
  const float cx = box[0], cy = box[1], w = box[2], h = box[3];
  const float a1 = cx - w * 0.5f, b1 = cy - h * 0.5f;
  const float a2 = cx + w * 0.5f, b2 = cy + h * 0.5f;
  x1[i] = a1;
  y1[i] = b1;
  x2[i] = a2;
  y2[i] = b2;
  area[i] = fmaxf((a2 - a1) * (b2 - b1), 0.0f);
}

__global__ void __launch_bounds__(kTileM * kTileN)
pairwise_iou_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ out, int n, int m, int giou) {
  __shared__ float ax1[kTileN], ay1[kTileN], ax2[kTileN], ay2[kTileN], aa[kTileN];
  __shared__ float bx1[kTileM], by1[kTileM], bx2[kTileM], by2[kTileM], ba[kTileM];
  const int batch = blockIdx.z;
  const int n0 = blockIdx.y * kTileN, m0 = blockIdx.x * kTileM;
  const int tid = threadIdx.y * kTileM + threadIdx.x;
  const float* ab = a + static_cast<size_t>(batch) * n * 4;
  const float* bb = b + static_cast<size_t>(batch) * m * 4;
  if (tid < kTileN) {
    if (n0 + tid < n) corners(ab + 4 * static_cast<size_t>(n0 + tid), ax1, ay1, ax2, ay2, aa, tid);
  } else if (tid >= kTileM && tid < 2 * kTileM) {
    const int j = tid - kTileM;
    if (m0 + j < m) corners(bb + 4 * static_cast<size_t>(m0 + j), bx1, by1, bx2, by2, ba, j);
  }
  __syncthreads();

  const int i = threadIdx.y, j = threadIdx.x;
  if (n0 + i >= n || m0 + j >= m) return;
  const float ix = fmaxf(fminf(ax2[i], bx2[j]) - fmaxf(ax1[i], bx1[j]), 0.0f);
  const float iy = fmaxf(fminf(ay2[i], by2[j]) - fmaxf(ay1[i], by1[j]), 0.0f);
  const float inter = fmaxf(ix * iy, 0.0f);
  const float uni = (aa[i] + ba[j]) - inter;
  float r = inter / fmaxf(uni, 1e-9f);
  if (giou) {
    const float cx = fmaxf(ax2[i], bx2[j]) - fminf(ax1[i], bx1[j]);
    const float cy = fmaxf(ay2[i], by2[j]) - fminf(ay1[i], by1[j]);
    const float carea = fmaxf(cx * cy, 0.0f);
    r = r - (carea - uni) / fmaxf(carea, 1e-9f);
  }
  out[(static_cast<size_t>(batch) * n + n0 + i) * m + m0 + j] = r;
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream` (PyTorch's
// current stream), does not synchronise, returns the cudaError_t of the
// launch (0 on success). The wrapper keeps batch and ceil(n / 8) within the
// grid's 65,535 limit.
extern "C" int pairwise_iou_launch(const float* a, const float* b, float* out, int batch, int n,
                                   int m, int giou, void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0) return 0;
  const dim3 grid((m + kTileM - 1) / kTileM, (n + kTileN - 1) / kTileN, batch);
  const dim3 block(kTileM, kTileN);
  pairwise_iou_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(a, b, out, n, m, giou);
  return static_cast<int>(cudaGetLastError());
}
