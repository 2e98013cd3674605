// Hopper's warpgroup matrix multiply (wgmma) in inline PTX, for kernel
// D-bf16 (attention_bf16.cuh): bf16 operands, fp32 accumulation, at the
// card's dense bf16 rate (989 TFLOP/s on an H100 SXM).  Needs sm_90a.
//
// A warpgroup (4 warps, 128 threads) issues each product together.  A is
// 64 x 16 from shared memory (a descriptor) or from registers, B 16 x N from
// shared memory.  The accumulator D[64 x N] lies in the warpgroup's
// registers as mma.sync's C fragments stacked by warp: thread 4g + t of warp
// w holds, for each 8-column group j, d[4j + i] = D[16w + g + 8 (i >> 1)]
// [8j + 2t + (i & 1)].  So the accumulators of column groups 2kk and
// 2kk + 1, rounded to bf16 pairs, are A's register fragment for the
// 16-deep k-step kk (bf16_mma.cuh): a softmax's P feeds the PV product
// from the registers that held its scores.
//
// Descriptors (`desc`): the tile's shared-memory address, and for a
// swizzled tile of 32/64/128-byte rows (tma.cuh's layout, 1024-byte
// aligned) the byte stride between groups of 8 rows (8 x the row width,
// the "stride" offset) and, for an MN-major operand wider than one swizzle
// width, the byte stride between its swizzle-wide column blocks (the
// "leading" offset: m64n128's K^T tile is two [D][64-key] blocks; for an
// operand one block wide it is never read).  K-major (A: the query rows
// with d contiguous): a k-step advances the address by 32 bytes inside the
// row.  MN-major (B, `trans-b` 1: rows of keys or of d contiguous): a
// k-step advances it by 16 rows.
//
// An issue is asynchronous: `fence()` orders register and shared-memory
// writes before it, `commit()` closes a group, `wait<N>()` waits until at
// most N groups are in flight; accumulators are read only after that, and
// `fence_operand` keeps the compiler from moving their uses across it.  No
// other instruction may write an accumulator while a product is in flight
// (ptxas then serializes every wgmma of the kernel), so an accumulator
// starts with `accumulate` 0, never with stores of zeros.

#pragma once

#include <stdint.h>

namespace coda_wgmma {

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

template <int R>
__device__ __forceinline__ void fence_operand(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// an A operand in registers: kept as it is until the product has read it
template <int R>
__device__ __forceinline__ void fence_operand(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// swizzle widths and their layout codes (bits 62-63 of a descriptor)
__host__ __device__ constexpr uint64_t layout_code(int rowbytes) {
  return rowbytes == 128 ? 1 : rowbytes == 64 ? 2 : rowbytes == 32 ? 3 : 0;
}

// a descriptor of the swizzled tile at shared address `addr` with
// `rowbytes`-byte rows, its swizzle-wide column blocks `block_bytes` apart
// (for a tile one block wide, unread: set to the row-group stride)
__device__ __forceinline__ uint64_t desc(uint32_t addr, int rowbytes, uint32_t block_bytes = 0) {
  const uint64_t stride = (uint64_t)(8 * rowbytes) >> 4;
  const uint64_t lead = block_bytes ? (uint64_t)block_bytes >> 4 : stride;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (lead << 16) | (stride << 32) |
         (layout_code(rowbytes) << 62);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A K-major and B MN-major, both in
// shared memory behind descriptors; `accumulate` 0 overwrites D
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A K-major and B MN-major, both in
// shared memory behind descriptors; `accumulate` 0 overwrites D
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// D[64 x 16] (+)= A[64 x 16] B[16 x 16]: A from registers (each warp's 16
// rows as mma.sync's m16n8k16 A fragment), B MN-major in shared memory;
// `accumulate` 0 overwrites D
__device__ __forceinline__ void mma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                          uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32]: A from registers (each warp's 16
// rows as mma.sync's m16n8k16 A fragment), B MN-major in shared memory;
// `accumulate` 0 overwrites D
__device__ __forceinline__ void mma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                          uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A from registers (each warp's 16
// rows as mma.sync's m16n8k16 A fragment), B MN-major in shared memory;
// `accumulate` 0 overwrites D
__device__ __forceinline__ void mma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                          uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

}  // namespace coda_wgmma
