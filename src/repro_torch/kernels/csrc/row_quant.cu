// Row-block int8 quantizers: quantize (kernels K5a and K12a) and dequantize
// (K5b and K12b), for sm_90a.
//
// Replaces the Pallas kernels src/repro/kernels/pack.py::quantize_rows (K5a,
// body _rowquant_kernel) and ::dequantize_rows (K5b, body
// _rowdequant_kernel), and the legacy block quantizers
// src/repro/kernels/quant.py::quantize (K12a, body _quant_kernel) and
// ::dequantize (K12b, body _dequant_kernel). K12a/K12b on one flat leaf are
// K5a/K5b at C = 1; K12b over a tree has a kernel of its own. The wrappers
// (kernels/pack.py and kernels/quant.py) validate the operands and allocate
// the outputs.
//
// Semantics: x is a (C, N) f32 row buffer, cut per row into scale blocks of
// `block` elements (the ragged tail of the last block reads as 0 and is not
// stored, which is the reference's zero padding). For row c and block b
//
//   scale[c, b] = fmaxf(amax_{n in b} |x[c, n]|, 1e-12f) / 127    (IEEE divide)
//   q[c, n]     = int8(clip(rintf(x[c, n] / scale[c, b]), -127, 127))
//   out[c, n]   = T(float(q[c, n]) * scale[c, b])                   (dequantize)
//
// rintf is half to even (torch.round, jnp.round); T is float32 or bfloat16,
// one round-to-nearest-even cast (__float2bfloat16_rn). Every step is one
// IEEE rounding with no FMA to contract (the build passes -fmad=false), so the
// plain versions kernels/ref.py::quantize_rows / dequantize_rows are bitwise
// equal, and so is the fused transport K4 (quant_reduce.cu), which computes
// the same scale and q inside its reduce.
//
// Bound: bytes. Quantize reads 4 bytes and writes 1 per element (plus one
// scale per block), dequantize the reverse; per element a handful of f32
// operations (an abs and a max, a divide, a round, a clip; a multiply),
// far below the card's operations-per-byte balance. At the launcher's quant8
// shape (3, 13,312,864) that is 199.85 MB each way, 0.0597 ms at 3.35 TB/s.
//
// Quantize has two instantiations.
//
// The whole-tile kernel (rowquant_tile_kernel) takes the main path: block
// 1024, N % 4 == 0, x 16-byte and q 4-byte aligned, and at least SMs x 4
// units (smaller launches: quantize_rows_launch). It runs on the tile
// machinery of K4/K7 (quant_tile.cuh). A unit of work is one (row, scale
// block) pair, 4 KB of f32; the units of all rows form one flat sequence
// (row-major, so neighbouring warps read neighbouring addresses) that the
// persistent grid's warps walk with a stride of every warp of the grid. A
// warp owns one unit at a time: its amax is five shuffles, no barrier; the
// next two units' 8 KB are in flight by cp.async in the warp's ring (128
// KB per SM) while it quantizes this one; the divide's reciprocal is
// computed once per unit (BlockDivisor), and each lane stores its q four
// int8 at a time (st.global.cs), 128 contiguous bytes per warp and store,
// and lane 0 the unit's scale. Nothing accumulates across units, so the
// order of the walk is free.
//
// The generic kernel (rowquant_kernel) keeps every other case (blocks
// 4-4096, ragged N, unaligned rows, small launches): one CTA per (scale
// block, row), grid (ceil(N / block), C), so the block's amax is a
// CTA-wide reduction (block_amax.cuh, shared with K4) over values the
// threads keep in registers: each element is read once, 16 bytes per
// thread per load, neighbouring threads on neighbouring addresses, and q is
// stored four int8 at a time. One thread writes the block's scale. Rows
// that are not aligned for the vector accesses (N % 4 != 0) take a scalar
// path with the same arithmetic.
//
// Dequantize is elementwise: one thread per four elements, a 4-byte load of
// q, its block's scale through the read-only cache, one 16-byte (f32) or
// 8-byte (bf16) store. K12b over a whole tree (kernels/ops.py::
// dequantize_tree) is one launch of the tree dequantizer (treedequant_kernel,
// below) for up to 64 leaves, where one launch a leaf left 15 of
// fedyolov3's 19 leaves near the card's launch floor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "block_amax.cuh"
#include "quant_tile.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxChunks = 4;  // float4 chunks per thread: block <= 4096
constexpr int kDequantThreads = 256;
constexpr int kTreeCapacity = 64;  // leaves a tree launch takes (kernels/quant.py::TREE_CAPACITY)
constexpr int kTreeBlock = 1024;   // the tree's scale block: one unit of work
constexpr int kTreeWarps = 8;      // warps a CTA of the tree dequantizer
constexpr int kTreeCtasPerSm = 4;  // its persistent grid: 32 warps a SM

// q of the quotient v = x / scale
__device__ __forceinline__ signed char clip_q(float v) {
  return static_cast<signed char>(fminf(fmaxf(rintf(v), -127.0f), 127.0f));
}

__device__ __forceinline__ signed char quant(float x, float scale) { return clip_q(x / scale); }

template <bool kVec4>
__global__ void __launch_bounds__(kMaxThreads)
rowquant_kernel(const float* __restrict__ x, signed char* __restrict__ q,
                float* __restrict__ scales, long long n, int block, int n_blocks) {
  __shared__ float slots[kMaxThreads / 32];
  const long long block_start = static_cast<long long>(blockIdx.x) * block;
  const float* row = x + static_cast<size_t>(blockIdx.y) * n;
  signed char* qrow = q + static_cast<size_t>(blockIdx.y) * n;
  const int span = blockDim.x * 4;  // elements one pass of the CTA covers
  const int chunks = (block + span - 1) / span;
  float v[kMaxChunks][4];
  float amax = 0.0f;
#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k) {
    const int off = k * span + threadIdx.x * 4;  // offset inside the scale block
    const long long e = block_start + off;
    if (k < chunks && off < block && kVec4 && e < n) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(row + e));
      v[k][0] = t.x;
      v[k][1] = t.y;
      v[k][2] = t.z;
      v[k][3] = t.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[k][j] = (!kVec4 && k < chunks && off + j < block && e + j < n) ? __ldg(row + e + j) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) amax = fmaxf(amax, fabsf(v[k][j]));
  }
  amax = cta_amax(amax, slots);
  const float scale = fmaxf(amax, 1e-12f) / 127.0f;
  if (threadIdx.x == 0) scales[static_cast<size_t>(blockIdx.y) * n_blocks + blockIdx.x] = scale;
#pragma unroll
  for (int k = 0; k < kMaxChunks; ++k) {
    const int off = k * span + threadIdx.x * 4;
    const long long e = block_start + off;
    if (k >= chunks || off >= block || e >= n) continue;
    if (kVec4) {
      reinterpret_cast<char4*>(qrow + e)[0] =
          make_char4(quant(v[k][0], scale), quant(v[k][1], scale), quant(v[k][2], scale),
                     quant(v[k][3], scale));
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (off + j < block && e + j < n) qrow[e + j] = quant(v[k][j], scale);
    }
  }
}

// The whole-tile instantiation: block 1024, N % 4 == 0, x 16-byte and q
// 4-byte aligned. `units` = C * nblocks < 2^31 (row, scale block) pairs, unit
// u = row * nblocks + block, which is also its scale's index. Unit indices
// are 32-bit: a 64-bit division is a long software sequence, and the warp's
// first copies wait on the divisions below.
__global__ void __launch_bounds__(kTileWarps * 32, kTileCtasPerSm)
rowquant_tile_kernel(const float* __restrict__ x, signed char* __restrict__ q,
                     float* __restrict__ scales, long long n, unsigned nblocks, unsigned units) {
  __shared__ float4 ring[kTileWarps][kTileStages][kTileSlice];
  const int lane = threadIdx.x & 31;
  float4(*slots)[kTileSlice] = ring[threadIdx.x >> 5];
  const unsigned first = blockIdx.x * kTileWarps + (threadIdx.x >> 5);
  const unsigned stride = gridDim.x * kTileWarps;
  if (first >= units) return;
  const unsigned mine = (units - 1 - first) / stride + 1;  // this warp's units
  // a step of `stride` units moves (row, block) by (drow, dblock) and a carry
  const unsigned drow = stride / nblocks, dblock = stride % nblocks;
  auto advance = [&](unsigned& row, unsigned& block) {
    row += drow;
    block += dblock;
    if (block >= nblocks) {
      block -= nblocks;
      ++row;
    }
  };

  const unsigned row0 = first / nblocks, block0 = first - row0 * nblocks;
  unsigned copy_row = row0, copy_block = block0, issued = 0;
  auto issue = [&](int slot) {  // the copies of the next unit not yet issued
    const float* src = x + copy_row * n + copy_block * static_cast<long long>(kTileBlock);
#pragma unroll
    for (int k = 0; k < kTileChunks; ++k) {
      const int off = k * 128 + lane * 4;
      // N % 4 == 0: a piece is wholly in or wholly past N
      const bool in = copy_block * static_cast<long long>(kTileBlock) + off < n;
      cp_async16_zfill(&slots[slot][k * 32 + lane], in ? src + off : src, in ? 16u : 0u);
    }
    advance(copy_row, copy_block);
    ++issued;
  };
#pragma unroll
  for (int s = 0; s < kTileStages - 1; ++s) {
    if (issued < mine) issue(s);
    cp_async_commit();  // one group per unit, empty past the last
  }

  unsigned row = row0, block = block0;
  int slot = 0;
  for (unsigned u = 0; u < mine; ++u) {
    // refill the slot unit u - 1 read (this lane's own reads of it have completed)
    if (issued < mine) issue(slot == 0 ? kTileStages - 1 : slot - 1);
    cp_async_commit();
    cp_async_wait<kTileStages - 1>();  // unit u's group has landed
    float4 v[kTileChunks];
    float amax = 0.0f;
#pragma unroll
    for (int k = 0; k < kTileChunks; ++k) {
      v[k] = slots[slot][k * 32 + lane];
      amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[k].x), fabsf(v[k].y)),
                               fmaxf(fabsf(v[k].z), fabsf(v[k].w))));
    }
    const float scale = fmaxf(warp_amax(amax), 1e-12f) / 127.0f;
    const BlockDivisor div = block_divisor(scale);
    if (lane == 0) scales[static_cast<size_t>(row) * nblocks + block] = scale;
    const long long start = block * static_cast<long long>(kTileBlock);  // in the row
    signed char* qblock = q + row * n + start;
#pragma unroll
    for (int k = 0; k < kTileChunks; ++k) {
      const int off = k * 128 + lane * 4;
      if (start + off < n)
        __stcs(reinterpret_cast<char4*>(qblock + off),
               make_char4(clip_q(divide(v[k].x, div)), clip_q(divide(v[k].y, div)),
                          clip_q(divide(v[k].z, div)), clip_q(divide(v[k].w, div))));
    }
    advance(row, block);
    slot = slot + 1 == kTileStages ? 0 : slot + 1;
  }
  cp_async_wait<0>();
}

__device__ __forceinline__ void store4(float* p, float a, float b, float c, float d) {
  reinterpret_cast<float4*>(p)[0] = make_float4(a, b, c, d);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float a, float b, float c, float d) {
  __nv_bfloat162 lo, hi;
  lo.x = __float2bfloat16_rn(a);
  lo.y = __float2bfloat16_rn(b);
  hi.x = __float2bfloat16_rn(c);
  hi.y = __float2bfloat16_rn(d);
  reinterpret_cast<__nv_bfloat162*>(p)[0] = lo;
  reinterpret_cast<__nv_bfloat162*>(p)[1] = hi;
}

__device__ __forceinline__ void store1(float* p, float a) { *p = a; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float a) { *p = __float2bfloat16_rn(a); }

template <typename T, bool kVec4>
__global__ void __launch_bounds__(kDequantThreads)
rowdequant_kernel(const signed char* __restrict__ q, const float* __restrict__ scales,
                  T* __restrict__ out, long long n, int block, int n_blocks) {
  const long long e = 4 * (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x);
  if (e >= n) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * n;
  // block % 4 == 0, so the four elements share one scale block
  const float s = __ldg(scales + static_cast<size_t>(blockIdx.y) * n_blocks + e / block);
  if (kVec4) {
    const char4 t = reinterpret_cast<const char4*>(q + base + e)[0];
    store4(out + base + e, static_cast<float>(t.x) * s, static_cast<float>(t.y) * s,
           static_cast<float>(t.z) * s, static_cast<float>(t.w) * s);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (e + j < n) store1(out + base + e + j, static_cast<float>(q[base + e + j]) * s);
  }
}

template <typename T>
cudaError_t dequant_launch(const signed char* q, const float* scales, void* out, int n_rows,
                           long long n, int block, int n_blocks, bool vec4, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((n + 4LL * kDequantThreads - 1) / (4LL * kDequantThreads)),
                  static_cast<unsigned>(n_rows));
  T* o = static_cast<T*>(out);
  if (vec4)
    rowdequant_kernel<T, true><<<grid, kDequantThreads, 0, stream>>>(q, scales, o, n, block,
                                                                       n_blocks);
  else
    rowdequant_kernel<T, false><<<grid, kDequantThreads, 0, stream>>>(q, scales, o, n, block,
                                                                        n_blocks);
  return cudaGetLastError();
}

// The tree dequantizer (K12b over a whole tree): one launch decodes up to
// kTreeCapacity leaves, each a flat q (n,) int8 with ceil(n / 1024) scales,
// into its own output in float32 or bfloat16. A unit of work is one
// (leaf, scale block) pair; the units of all leaves form one flat sequence,
// leaf after leaf (a leaf's first unit is the prefix sum of its
// predecessors' blocks), which the persistent grid's warps walk with a stride
// of every warp of the grid. A warp finds its unit's leaf by a binary search
// of the table, which the launch passes by value as a __grid_constant__
// kernel parameter: no copy to the card, no sync. Lane l decodes the unit's
// elements 4 (l + 32 k), k = 0..7: eight 4-byte int8 loads, all issued
// before any store, then one 16-byte (float32) or 8-byte (bfloat16) store
// each, so every load and store of the warp is one contiguous run (K5b's
// access pattern). A lane's 16-byte int8 load puts its four 16-byte float32
// stores 64 bytes apart: on the H100 that first design took longer than the
// 19 per-leaf launches it replaced (PERF.md §6). A leaf whose q or
// output is not 16-byte aligned, and the ragged tail past n, take a scalar
// path with the same arithmetic.
struct TreeLeaf {  // laid out as kernels/quant.py::TreeLeaf (ctypes)
  const signed char* q;
  const float* scales;
  void* out;
  long long n;      // elements, >= 1
  long long unit0;  // first unit: the blocks of the leaves before it
  int dtype;        // 0 = float32, 1 = bfloat16
  int pad;
};

struct TreeTable {
  TreeLeaf leaf[kTreeCapacity];
  int leaves;
  unsigned units;
};
static_assert(sizeof(TreeTable) <= 4096, "a kernel parameter holds at most 4 KB");

__device__ __forceinline__ float q_byte(int word, int b) {  // byte b of four packed int8
  return static_cast<float>(static_cast<signed char>(word >> (8 * b)));
}

template <typename T>
__device__ __forceinline__ void tree_unit(const TreeLeaf& leaf, long long start, float s, int lane) {
  const signed char* q = leaf.q;
  T* out = static_cast<T*>(leaf.out);
  const bool vec = ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  long long e[8];
  bool whole[8];
  int raw[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    e[k] = start + 4 * (lane + 32 * k);
    whole[k] = vec && e[k] + 4 <= leaf.n;
    raw[k] = whole[k] ? __ldg(reinterpret_cast<const int*>(q + e[k])) : 0;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    if (whole[k]) {
      store4(out + e[k], q_byte(raw[k], 0) * s, q_byte(raw[k], 1) * s, q_byte(raw[k], 2) * s,
             q_byte(raw[k], 3) * s);
    } else {
      for (long long i = e[k]; i < e[k] + 4 && i < leaf.n; ++i)
        store1(out + i, static_cast<float>(q[i]) * s);
    }
  }
}

__global__ void __launch_bounds__(kTreeWarps * 32, kTreeCtasPerSm)
treedequant_kernel(const __grid_constant__ TreeTable table) {
  const int lane = threadIdx.x & 31;
  const unsigned stride = gridDim.x * kTreeWarps;
  for (unsigned u = blockIdx.x * kTreeWarps + (threadIdx.x >> 5); u < table.units; u += stride) {
    int lo = 0, hi = table.leaves - 1;  // the last leaf whose first unit is <= u
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (table.leaf[mid].unit0 <= u)
        lo = mid;
      else
        hi = mid - 1;
    }
    const TreeLeaf& leaf = table.leaf[lo];
    const long long block = u - leaf.unit0;
    const float s = __ldg(leaf.scales + block);
    if (leaf.dtype == 0)
      tree_unit<float>(leaf, block * kTreeBlock, s, lane);
    else
      tree_unit<__nv_bfloat16>(leaf, block * kTreeBlock, s, lane);
  }
}

bool bad_shape(int n_rows, int block) {
  return block < 4 || block % 4 || block > kMaxChunks * kMaxThreads * 4 || n_rows < 1 ||
         n_rows > 65535;
}

}  // namespace

// Plain C entry points, bound with ctypes. Each launches on `stream`, does
// not synchronise and returns the cudaError_t of the launch. The wrappers
// guarantee contiguous operands, 1 <= n_rows <= 65535, block % 4 == 0,
// 4 <= block <= 4096 and n_blocks = ceil(n / block). Quantize takes the
// whole-tile kernel at block 1024 on aligned rows (N % 4 == 0) with at least
// kTileWarps units per SM (tile_grid decides), every other case the generic
// one. Below that the whole-tile kernel's warps own one unit each and have
// no copies to overlap, and a unit's 1024 elements pass through one warp
// where the generic kernel spreads them over a CTA of 8 warps, which
// finishes sooner (fedyolov3's small leaves; PERF.md §6).
extern "C" int quantize_rows_launch(const float* x, signed char* q, float* scales, int n_rows,
                                    long long n, int block, int n_blocks, void* stream) {
  if (n <= 0) return 0;
  if (bad_shape(n_rows, block)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = n % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(q) % 4 == 0;
  const long long units = static_cast<long long>(n_rows) * n_blocks;
  if (vec4 && block == kTileBlock && units < (1LL << 31)) {
    unsigned ctas = 0;
    const cudaError_t err = tile_grid<rowquant_tile_kernel>(units, kTileWarps, &ctas);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (ctas) {
      rowquant_tile_kernel<<<ctas, kTileWarps * 32, 0, s>>>(x, q, scales, n, n_blocks,
                                                             static_cast<unsigned>(units));
      return static_cast<int>(cudaGetLastError());
    }
  }
  int threads = ((block + 3) / 4 + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const dim3 grid(static_cast<unsigned>(n_blocks), static_cast<unsigned>(n_rows));
  if (vec4)
    rowquant_kernel<true><<<grid, threads, 0, s>>>(x, q, scales, n, block, n_blocks);
  else
    rowquant_kernel<false><<<grid, threads, 0, s>>>(x, q, scales, n, block, n_blocks);
  return static_cast<int>(cudaGetLastError());
}

// dtype 0 = float32, 1 = bfloat16 output.
extern "C" int dequantize_rows_launch(const signed char* q, const float* scales, void* out,
                                      int dtype, int n_rows, long long n, int block, int n_blocks,
                                      void* stream) {
  if (n <= 0) return 0;
  if (bad_shape(n_rows, block) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t out_align = dtype == 0 ? 16 : 8;
  const bool vec4 = n % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % out_align == 0;
  const cudaError_t err =
      dtype == 0 ? dequant_launch<float>(q, scales, out, n_rows, n, block, n_blocks, vec4, s)
                 : dequant_launch<__nv_bfloat16>(q, scales, out, n_rows, n, block, n_blocks, vec4, s);
  return static_cast<int>(err);
}

// The tree dequantizer: `leaves` (1..kTreeCapacity) table rows in unit
// order, `units` = the last row's unit0 + ceil(n / 1024) < 2^32; the wrapper
// (kernels/quant.py::dequantize_tree) builds the rows and validates every
// operand. Copies the rows into the kernel's parameter and launches a
// persistent grid of at most kTreeCtasPerSm CTAs a SM.
extern "C" int dequantize_tree_launch(const void* rows, int leaves, unsigned units, void* stream) {
  if (units == 0) return 0;
  if (leaves < 1 || leaves > kTreeCapacity) return static_cast<int>(cudaErrorInvalidValue);
  TreeTable table;  // TreeLeaf lives in the anonymous namespace: an extern "C" entry takes void*
  for (int i = 0; i < leaves; ++i) table.leaf[i] = static_cast<const TreeLeaf*>(rows)[i];
  table.leaves = leaves;
  table.units = units;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned need = (units + kTreeWarps - 1) / kTreeWarps;
  const unsigned cap = static_cast<unsigned>(sms) * kTreeCtasPerSm;
  treedequant_kernel<<<need < cap ? need : cap, kTreeWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(table);
  return static_cast<int>(cudaGetLastError());
}

// CTAs of the whole-tile quantizer that fit on one SM at once (the launch
// assumes kTileCtasPerSm), or minus a cudaError_t; for the check script
// (scripts/row_quant_check.py), never called on a round.
extern "C" int quantize_rows_tile_residency() { return tile_residency<rowquant_tile_kernel>(); }
