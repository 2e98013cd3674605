// Hopper's Tensor Memory Accelerator and mbarriers, shared by kernels
// D-bf16 (attention_bf16.cuh) and E-bf16 (vit_attention_bf16.cu).
//
// Device side: mbarrier init / arrive / expect_tx / parity wait, TMA tile
// loads and stores of a 3-D tensor map (cp.async.bulk.tensor), and the
// proxy fence that makes ordinary shared-memory stores visible to a TMA
// store.  Host side: `encode_3d`, a tensor map over a (rows of `inner`
// elements) x `mid` x `outer` array, encoded by the driver's
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint so the
// library links against the runtime alone (no -lcuda).
//
// A tile loaded with a 32/64/128-byte swizzle lands with its 16-byte chunk
// c of row r at r * rowbytes + ((c ^ ((r * rowbytes >> 7) & m)) << 4), m =
// 1, 3, 7 (Swizzle<1|2|3, 4, 3> on the byte address, the pattern wgmma's
// descriptors and ldmatrix addressing assume); the tile's base is
// 1024-byte aligned.  Coordinates past an extent read as zeros, and a store
// writes nothing there.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace coda_tma {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count));
}

// after every mbar_init of the block, before any thread uses the barriers
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.release.cta.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// this thread's arrival, and `bytes` more to come by TMA before the phase ends
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.acquire.cta.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// box of `map` at coordinates (c0, c1, c2), innermost first, into shared memory
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.tile.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until this thread's committed stores have read their shared memory
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// until this thread's committed stores are complete in global memory
__device__ __forceinline__ void tma_store_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// ordinary shared-memory stores before it are seen by a TMA store after it
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// byte offset of 16-byte chunk `c` of row `r` in a swizzled tile of
// `rowbytes`-byte rows (32, 64 or 128, the swizzle's width)
__host__ __device__ __forceinline__ uint32_t swizzled(int r, int c, int rowbytes) {
  const uint32_t o = (uint32_t)(r * rowbytes + c * 16);
  return o ^ (((o >> 7) & (uint32_t)(rowbytes / 16 - 1)) << 4);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      return nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A tensor map over `base`: `outer` blocks of `mid` rows of `inner`
// elements of `elem_bytes` bytes, rows `row_stride` elements apart and
// blocks `mid_stride` rows apart, read in boxes of box_inner x box_mid x 1
// with `swizzle_bytes` (0, 32, 64 or 128) swizzle.  Returns a cudaError_t.
inline int encode_3d(CUtensorMap* map, const void* base, int elem_bytes, long long inner,
                     long long mid, long long outer, long long row_stride, long long mid_stride,
                     int box_inner, int box_mid, int swizzle_bytes) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)mid, (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)(row_stride * elem_bytes),
                                 (cuuint64_t)(mid_stride * row_stride * elem_bytes)};
  const cuuint32_t box[3] = {(cuuint32_t)box_inner, (cuuint32_t)box_mid, 1u};
  const cuuint32_t elem_strides[3] = {1u, 1u, 1u};
  const CUtensorMapSwizzle swz = swizzle_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                 : swizzle_bytes == 32 ? CU_TENSOR_MAP_SWIZZLE_32B
                                                       : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult r = fn(map, elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                             : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                        3, const_cast<void*>(base), dims, strides, box, elem_strides,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace coda_tma
