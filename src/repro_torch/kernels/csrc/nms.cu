// Sequential score-ordered NMS keep mask, one CTA per image, for sm_90a.
//
// Replaces the Pallas kernel src/repro/kernels/detect.py::_nms_kernel
// (launched by kernels/detect.py::nms through pl.pallas_call). The wrapper
// src/repro_torch/kernels/detect.py does the stable score sort, the max_keep
// cap and the inverse scatter in torch, as the reference's wrapper does
// outside its kernel; this file is only the scan.
//
// Semantics: boxes are (B, N, 4) center-format f32 sorted by descending
// score, valid (B, N) 0/1 f32. Walking i = 0..N-1, box i, if still kept,
// clears every later box j > i with IoU(i, j) > iou_thresh. A suppressed
// box never suppresses (no cascade).
//
// Bit-for-bit contract with kernels/ref.py (and the reference's
// ref.nms_np): every op below is one IEEE-rounded f32 add/sub/mul/div/min/
// max in the reference's order. The build passes -fmad=false, so no
// product is contracted into an FMA, and leaves -prec-div at its IEEE
// default (no fast math), so `/` is correctly rounded.
//
// Bound: the kernel moves 24 bytes per box (16 in, 4 valid in, 4 keep out)
// and evaluates at most N(N-1)/2 IoUs of ~14 f32 ops per image; at the
// served shape (8 images x 16 boxes) both are nanoseconds of work, so the
// launch latency bounds it. The design keeps it simple: boxes, their
// corners and areas, and the keep mask live in shared memory for the whole
// scan; each step is one barrier plus a block-strided pass over j > i.
// Dynamic shared memory is 6 floats per box, so N up to 9,685 fits the
// 227 KB a block can take.

#include <cuda_runtime.h>

namespace {

__global__ void nms_keep_kernel(const float* __restrict__ boxes,
                                const float* __restrict__ valid,
                                float* __restrict__ keep_out,
                                int n, float iou_thresh) {
  extern __shared__ float smem[];
  float* x1 = smem;
  float* y1 = x1 + n;
  float* x2 = y1 + n;
  float* y2 = x2 + n;
  float* area = y2 + n;
  float* keep = area + n;

  const int b = blockIdx.x;
  const float* bx = boxes + static_cast<size_t>(b) * n * 4;
  const float* vb = valid + static_cast<size_t>(b) * n;

  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const float cx = bx[4 * j + 0], cy = bx[4 * j + 1];
    const float w = bx[4 * j + 2], h = bx[4 * j + 3];
    const float a1 = cx - w * 0.5f, b1 = cy - h * 0.5f;
    const float a2 = cx + w * 0.5f, b2 = cy + h * 0.5f;
    x1[j] = a1;
    y1[j] = b1;
    x2[j] = a2;
    y2[j] = b2;
    area[j] = fmaxf((a2 - a1) * (b2 - b1), 0.0f);
    keep[j] = vb[j];
  }

  for (int i = 0; i < n; ++i) {
    // every write to keep[i] happened at a step < i: after this barrier
    // all threads read its final value, so the branch is block-uniform
    __syncthreads();
    if (keep[i] > 0.0f) {
      const float x1i = x1[i], y1i = y1[i], x2i = x2[i], y2i = y2[i], ai = area[i];
      for (int j = i + 1 + threadIdx.x; j < n; j += blockDim.x) {
        const float ix = fmaxf(fminf(x2i, x2[j]) - fmaxf(x1i, x1[j]), 0.0f);
        const float iy = fmaxf(fminf(y2i, y2[j]) - fmaxf(y1i, y1[j]), 0.0f);
        const float inter = fmaxf(ix * iy, 0.0f);
        const float iou = inter / fmaxf((ai + area[j]) - inter, 1e-9f);
        if (iou > iou_thresh) keep[j] = 0.0f;
      }
    }
  }
  __syncthreads();

  float* kb = keep_out + static_cast<size_t>(b) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) kb[j] = keep[j];
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream` (PyTorch's
// current stream), does not synchronise, returns the cudaError_t of the
// launch (0 on success).
extern "C" int nms_keep_launch(const float* boxes, const float* valid, float* keep,
                               int batch, int n, float iou_thresh, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const size_t smem = static_cast<size_t>(n) * 6 * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_keep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = n >= 256 ? 256 : ((n + 31) / 32) * 32;
  nms_keep_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      boxes, valid, keep, n, iou_thresh);
  return static_cast<int>(cudaGetLastError());
}
