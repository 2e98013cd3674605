// fp32-accurate products on the tensor cores (3xTF32), shared by kernels D
// (attention.cu) and E (vit_attention.cu).
//
// Each fp32 operand x is split into hi = tf32(x) and lo = tf32(x - hi),
// both rounded to nearest, ties away from zero, as cvt.rna.tf32.f32 would
// round them but in integer ops; lo*hi + hi*lo + hi*hi is accumulated in
// fp32 by mma.sync m16n8k8.  That keeps about 22 of fp32's 24 bits (a
// single TF32 pass keeps 11) at 495 / 3 = 165 TFLOP/s on an H100 SXM.
//
// Fragments of m16n8k8 (lane = 4 g + t): A (row-major 16 x 8) a0 = A[g][t],
// a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]; B (8 x 8, k by n)
// b0 = B[t][g], b1 = B[t+4][g]; C (16 x 8) c0 = C[g][2t], c1 = C[g][2t+1],
// c2 = C[g+8][2t], c3 = C[g+8][2t+1].

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace coda_tf32 {

// fp32 -> TF32 rounded to nearest, ties away from zero: cvt.rna.tf32.f32's
// result for finite x, in two integer ops (kernel D ran 13% faster at the
// encoder's shape than with cvt.rna, a conversion-unit instruction)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a * b in 3xTF32: the small products first, then the large one
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(c, al, bh);
  mma_tf32(c, ah, bl);
  mma_tf32(c, ah, bh);
}

}  // namespace coda_tf32
