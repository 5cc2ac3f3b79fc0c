// Tensor-core helpers shared by flash attention (K9, flash_attention.cu) and
// the SSD chunk scan (K10, ssd_scan.cu): the 3xTF32 split, the m16n8k8
// tf32 mma.sync, and cp.async.
//
// 3xTF32. A tf32 operand keeps 10 mantissa bits (about 5e-4 relative), and
// one pass of TF32 products summed over 128 terms cannot be counted on to
// hold the f32 reference at 2e-4. Each f32 operand a is split as hi = a
// rounded to tf32 (to nearest, ties away: cvt.rna.tf32.f32's rounding) and
// lo = a - hi, exact in f32; then a.b ~ hi.hi' + hi.lo' + lo.hi', each
// product exact in the tensor core and summed into an f32 accumulator. The
// tensor core reads the top 19 bits of lo (tf32 truncation), so the dropped
// lo.lo' and the truncation of lo leave about 2^-21 relative per product,
// the order of f32 itself. The rounding is done on the integer pipe (add
// 0x1000 to the bit pattern, clear the low 13 bits), not by cvt.rna, which
// runs on the card's conversion unit at a fraction of the tensor cores' rate
// and made the split, not the products, the kernels' bound.
//
// m16n8k8 tf32 fragments (PTX ISA, mma.m16n8k8 .tf32), with g = lane / 4
// and c = lane % 4:
//   A (16 x 8, row): a0 (g, c), a1 (g + 8, c), a2 (g, c + 4), a3 (g + 8, c + 4)
//   B (8 x 8, col):  b0 (k = c, n = g), b1 (k = c + 4, n = g)
//   D (16 x 8):      d0 (g, 2c), d1 (g, 2c + 1), d2 (g + 8, 2c), d3 (g + 8, 2c + 1)
// Which column of the operands a k slot stands for is the caller's choice,
// as long as A and B agree: the kernels pick it so that a D fragment is an A
// fragment of the next product (k slot c -> column 2c, slot c + 4 ->
// 2c + 1), or so that a thread's four values of two k steps are adjacent in
// shared memory (one 16-byte load).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

struct Tf32x2 {
  uint32_t hi, lo;
};

// a rounded to tf32, to nearest with ties away from zero (finite a)
static __device__ __forceinline__ uint32_t to_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

static __device__ __forceinline__ Tf32x2 split_tf32(float a) {
  const uint32_t hi = to_tf32(a);
  return {hi, __float_as_uint(a - __uint_as_float(hi))};
}

// d += a * b on the tensor cores, tf32 operands, f32 accumulator
static __device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0, uint32_t a1,
                                                uint32_t a2, uint32_t a3, uint32_t b0,
                                                uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a * b with both operands split: lo.hi' and hi.lo' first, then hi.hi'.
// With kExactB the B operand is exact in tf32 (bfloat16 data), its lo is
// zero and the hi.lo' product is skipped.
template <bool kExactB = false>
static __device__ __forceinline__ void mma_3xtf32(float (&d)[4], const Tf32x2 (&a)[4],
                                                  Tf32x2 b0, Tf32x2 b1) {
  mma_tf32(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b0.hi, b1.hi);
  if (!kExactB) mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.lo, b1.lo);
  mma_tf32(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b0.hi, b1.hi);
}

static __device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; both addresses 16-byte aligned
static __device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// 4 bytes global -> shared
static __device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most kPending committed groups of this thread are in flight
template <int kPending>
static __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}
