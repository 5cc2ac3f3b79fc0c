// Score-ordered NMS keep mask for sm_90a: a parallel IoU bitmask resolved by
// one warp, and the sequential scan for images of more than 1024 boxes.
//
// Replaces the Pallas kernel src/repro/kernels/detect.py::_nms_kernel
// (launched by kernels/detect.py::nms through pl.pallas_call). The wrapper
// src/repro_torch/kernels/detect.py does the stable score sort, the max_keep
// cap and the inverse scatter in torch, as the reference's wrapper does
// outside its kernel; this file computes only the keep mask.
//
// Semantics: boxes are (B, N, 4) center-format f32 sorted by descending
// score, valid (B, N) f32 (0/1). Walking i = 0..N-1, box i, if still kept
// (valid[i] > 0 and not suppressed), clears every later box j > i with
// IoU(i, j) > iou_thresh. A suppressed box never suppresses (no cascade).
// keep[j] = 0 where j was cleared, else valid[j].
//
// Bit-for-bit contract with kernels/ref.py (and the reference's
// ref.nms_np): every op of the IoU is one IEEE-rounded f32 add/sub/mul/div/
// min/max in the reference's order. The build passes -fmad=false, so no
// product is contracted into an FMA, and leaves -prec-div at its IEEE
// default (no fast math), so `/` is correctly rounded. Both kernels below
// evaluate the same expression (iou_over), so they agree with each other
// and with the plain version wherever each is taken.
//
// Bound: the kernel moves 24 bytes per box (16 in, 4 valid in, 4 keep out)
// and evaluates at most N(N-1)/2 IoUs of ~15 f32 ops per image; at the
// served shape (8 images x 16 boxes) both are nanoseconds of work, so the
// card's launch floor (a one-element kernel's device time) bounds it. What
// costs time above that floor is the scan's chain: N steps, each a barrier,
// shared-memory reads and one dependent IEEE divide.
//
// nms_bitmask_kernel (N <= 1024) takes the divides off the chain. One CTA
// per image, a warp a row (up to 32 warps; more rows a warp past N = 32),
// one barrier:
//  1. Warp 0's ballots of valid > 0 are the live set, one 32-bit word per 32
//     boxes.
//  2. Mask, all pairs at once: bit j of row i's word j / 32 is
//     j > i && IoU(i, j) > thresh. A warp reads row i's box once (a
//     broadcast load) and, per word, a lane's box j from global memory
//     (L1), so no corners pass through shared memory; one __ballot_sync per
//     word; words left of i's own are never read. The words go to shared
//     memory: N * ceil(N / 32) of them, 64 B at the served N = 16, 512 B at
//     eval's N = 64, 128 KB at N = 1024.
//  3. Resolve, warp 0 alone after the barrier: lane w holds word w of the
//     suppressed set. Rows 32k..32k+31 decide on word k alone, so every lane
//     runs that word's chain in registers (bit r clear and live: OR in row
//     32k + r's word k, 32 fixed steps, the words loaded ahead); the rows of
//     word k still kept then OR their words into the later lanes' words,
//     independent loads with no chain.
// At the served (8, 16) the divides dominate: in throwaway builds on the
// H100 a warp a row beat 4, 2 or 1 warps an image by far, and corners read
// from L1 beat corners staged through shared memory behind a barrier
// (PERF.md §6). One CTA an image: 8 images give 8 CTAs.
// The word size caps the kernel at 1024 boxes (32 words, one per lane);
// above that, a shape-based dispatch takes nms_scan_kernel, whose shared
// memory holds 6 floats per box, so N up to 9,685.

#include <cuda_runtime.h>

namespace {

constexpr int kMaskMaxN = 1024;  // 32 words a row: one word a lane in the resolve
constexpr int kMaskWarps = 32;   // the bitmask kernel's most warps: a warp a row up to N = 32

struct Box {
  float x1, y1, x2, y2, area;
};

// box j of one image (center format) -> its corners and area
__device__ __forceinline__ Box corners(const float* bx, int j) {
  const float cx = bx[4 * j + 0], cy = bx[4 * j + 1];
  const float w = bx[4 * j + 2], h = bx[4 * j + 3];
  Box c;
  c.x1 = cx - w * 0.5f;
  c.y1 = cy - h * 0.5f;
  c.x2 = cx + w * 0.5f;
  c.y2 = cy + h * 0.5f;
  c.area = fmaxf((c.x2 - c.x1) * (c.y2 - c.y1), 0.0f);
  return c;
}

// IoU(i, j) > thresh, the reference's ops in its order
__device__ __forceinline__ bool iou_over(const Box& i, const Box& j, float thresh) {
  const float ix = fmaxf(fminf(i.x2, j.x2) - fmaxf(i.x1, j.x1), 0.0f);
  const float iy = fmaxf(fminf(i.y2, j.y2) - fmaxf(i.y1, j.y1), 0.0f);
  const float inter = fmaxf(ix * iy, 0.0f);
  return inter / fmaxf((i.area + j.area) - inter, 1e-9f) > thresh;
}

__global__ void __launch_bounds__(kMaskWarps * 32)
nms_bitmask_kernel(const float* __restrict__ boxes, const float* __restrict__ valid,
                   float* __restrict__ keep_out, int n, float iou_thresh) {
  extern __shared__ unsigned words_smem[];
  const int words = (n + 31) >> 5;
  unsigned* live = words_smem;    // bit j of word j / 32: valid[j] > 0
  unsigned* mask = live + words;  // row i at mask[i * words]

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const float* bx = boxes + static_cast<size_t>(b) * n * 4;
  const float* vb = valid + static_cast<size_t>(b) * n;

  // 1. warp 0: the live set, one ballot a word
  if (warp == 0)
    for (int k = 0; k < words; ++k) {
      const int j = (k << 5) + lane;
      const unsigned word = __ballot_sync(0xffffffffu, j < n && vb[j] > 0.0f);
      if (lane == 0) live[k] = word;
    }

  // 2. the mask: warp w takes rows w, w + warps, ...; row i's corners are one
  // broadcast load, box j = 32k + lane's a lane's; words left of i's own
  // hold no later box and are never read
  for (int i = warp; i < n; i += warps) {
    const Box bi = corners(bx, i);
    for (int k = i >> 5; k < words; ++k) {
      const int j = (k << 5) + lane;
      const bool s = j > i && j < n && iou_over(bi, corners(bx, j), iou_thresh);
      const unsigned m = __ballot_sync(0xffffffffu, s);
      if (lane == 0) mask[static_cast<size_t>(i) * words + k] = m;
    }
  }
  __syncthreads();
  if (warp != 0) return;

  // 3. resolve: lane w < words holds word w of the suppressed set
  unsigned sup = 0;
  for (int k = 0; k < words; ++k) {
    const int base = k << 5;
    const unsigned lv = live[k];  // 0 past row n - 1
    unsigned m[32];  // row base + r's word k where that row is live: loaded ahead of the chain
#pragma unroll
    for (int r = 0; r < 32; ++r)
      m[r] = lv >> r & 1u ? mask[static_cast<size_t>(base + r) * words + k] : 0u;
    unsigned s = __shfl_sync(0xffffffffu, sup, k);
    // row base + r, live and not suppressed, suppresses: a bit test and an OR a step
#pragma unroll
    for (int r = 0; r < 32; ++r)
      if (!(s >> r & 1u)) s |= m[r];
    if (lane == k) sup = s;
    // the rows of word k that stayed kept suppress in the later words
    const unsigned kept = lv & ~s;
    if (lane > k && lane < words)
      for (unsigned t = kept; t; t &= t - 1)
        sup |= mask[static_cast<size_t>(base + __ffs(t) - 1) * words + lane];
  }

  float* kb = keep_out + static_cast<size_t>(b) * n;
  for (int k = 0; k < words; ++k) {
    const unsigned s = __shfl_sync(0xffffffffu, sup, k);
    const int j = (k << 5) + lane;
    if (j < n) kb[j] = (s >> lane & 1u) ? 0.0f : vb[j];
  }
}

// The sequential scan (N > 1024): corners, areas and the keep mask stay in
// shared memory; each step i is one barrier plus a block-strided pass over
// j > i.
__global__ void nms_scan_kernel(const float* __restrict__ boxes, const float* __restrict__ valid,
                                float* __restrict__ keep_out, int n, float iou_thresh) {
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
    const Box c = corners(bx, j);
    x1[j] = c.x1;
    y1[j] = c.y1;
    x2[j] = c.x2;
    y2[j] = c.y2;
    area[j] = c.area;
    keep[j] = vb[j];
  }

  for (int i = 0; i < n; ++i) {
    // every write to keep[i] happened at a step < i: after this barrier
    // all threads read its final value, so the branch is block-uniform
    __syncthreads();
    if (keep[i] > 0.0f) {
      const Box bi = {x1[i], y1[i], x2[i], y2[i], area[i]};
      for (int j = i + 1 + threadIdx.x; j < n; j += blockDim.x)
        if (iou_over(bi, {x1[j], y1[j], x2[j], y2[j], area[j]}, iou_thresh)) keep[j] = 0.0f;
    }
  }
  __syncthreads();

  float* kb = keep_out + static_cast<size_t>(b) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) kb[j] = keep[j];
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int batch, int threads, size_t smem, cudaStream_t stream,
                   const float* boxes, const float* valid, float* keep, int n, float iou_thresh) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<batch, threads, smem, stream>>>(boxes, valid, keep, n, iou_thresh);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point, bound with ctypes. Launches on `stream` (PyTorch's
// current stream), does not synchronise, returns the cudaError_t of the
// launch (0 on success). N <= 1024 takes the bitmask kernel with a warp a
// row up to 32 warps, larger N the scan.
extern "C" int nms_keep_launch(const float* boxes, const float* valid, float* keep,
                               int batch, int n, float iou_thresh, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= kMaskMaxN) {
    const int words = (n + 31) / 32;
    const size_t smem = (words + static_cast<size_t>(n) * words) * sizeof(unsigned);
    const int warps = n < kMaskWarps ? n : kMaskWarps;
    return static_cast<int>(
        launch(nms_bitmask_kernel, batch, warps * 32, smem, s, boxes, valid, keep, n, iou_thresh));
  }
  const size_t smem = static_cast<size_t>(n) * 6 * sizeof(float);
  return static_cast<int>(
      launch(nms_scan_kernel, batch, 256, smem, s, boxes, valid, keep, n, iou_thresh));
}
