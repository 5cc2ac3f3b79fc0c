// The CTA-wide amax of one int8 scale block, shared by the quantizers that
// compute a block's scale in one CTA: the fused transports K4/K7
// (quant_reduce.cu) and the row and block quantizers K5a/K12a
// (row_quant.cu).
#pragma once

#include <cuda_runtime.h>

// Max over the CTA of each thread's `v` (v >= 0): warp shuffles, then one
// shared slot per warp and one barrier. `slots` holds blockDim.x / 32
// floats, blockDim.x is a multiple of 32. A caller that reduces in a loop
// alternates between two slot arrays, so that no thread overwrites a slot
// another thread of the previous iteration has yet to read.
static __device__ __forceinline__ float cta_amax(float v, float* slots) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, s));
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = v;
  __syncthreads();
  v = slots[0];
  for (int i = 1; i < static_cast<int>(blockDim.x >> 5); ++i) v = fmaxf(v, slots[i]);
  return v;
}
