// bf16 products on the tensor cores for kernel E-bf16
// (vit_attention_bf16.cu): mma.sync m16n8k16 with bf16 operands and fp32
// accumulation (the card's dense bf16 rate is 989 TFLOP/s on an H100 SXM;
// mma.sync reaches a part of it, wgmma all).  Kernel D-bf16
// (attention_bf16.cuh) shares the bf16 rounding and the reciprocal; its
// products are wgmma (wgmma.cuh), whose register fragments are these.
//
// Fragments of m16n8k16 (lane = 4 g + t), each 32-bit register a pair of
// bf16, the lower index in the low half: A (row-major 16 x 16)
// a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1], a2 = A[g][2t+8, 2t+9],
// a3 = A[g+8][2t+8, 2t+9]; B (16 x 8, k by n) b0 = B[2t, 2t+1][g],
// b1 = B[2t+8, 2t+9][g]; C (16 x 8, fp32) c0 = C[g][2t], c1 = C[g][2t+1],
// c2 = C[g+8][2t], c3 = C[g+8][2t+1].  So the accumulators of two adjacent
// 8-column n-tiles, rounded to bf16 pairs (c0, c1) and (c2, c3), are the A
// fragment of one 16-deep k-step: a softmax's P feeds the PV product
// straight from the registers that held its scores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace coda_bf16 {

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// (lo, hi) rounded to nearest even into one bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// 2^x on the special-function unit, subnormal results flushed to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the correctly rounded 1 / l for l >= 1 normal, without __frcp_rn's call
// to its slow path (a call serializes wgmma, and its saved registers spill):
// the special-function unit's approximation, two Newton steps in fp64 (to
// ~2^-90), one rounding
__device__ __forceinline__ float rcp_rn(float l) {
  float y0;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y0) : "f"(l));
  const double x = l;
  double y = y0;
  y = fma(y, fma(-x, y, 1.0), y);
  y = fma(y, fma(-x, y, 1.0), y);
  return (float)y;
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t smem_u32addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lanes 8j .. 8j+7
// give the 16-byte rows of matrix j, and r[j] of lane 4g + t holds its
// elements (row 2t, column g) and (row 2t+1, column g).  Rows of a [k][n]
// tile so become B fragments: rows k0 .. k0+7 give b0, k0+8 .. k0+15 b1.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32addr(row)));
}

}  // namespace coda_bf16
