// Kernel D-bf16's C entry points (the kernel: attention_bf16.cuh).

#include "attention_bf16.cuh"

namespace coda_d_bf16 {

// built in attention_bf16_d{16,32,64,128}.cu
#define CODA_EXTERN_LAUNCH(D, T)                                                               \
  extern template int launch<D, T>(const bf16*, const bf16*, const bf16*, const float*,       \
                                   const float*, const int64_t*, T*, float*, float*, int, int,  \
                                   int, int, int, float, uint32_t, float, int, int, cudaStream_t);
CODA_EXTERN_LAUNCH(16, bf16)
CODA_EXTERN_LAUNCH(16, float)
CODA_EXTERN_LAUNCH(32, bf16)
CODA_EXTERN_LAUNCH(32, float)
CODA_EXTERN_LAUNCH(64, bf16)
CODA_EXTERN_LAUNCH(64, float)
CODA_EXTERN_LAUNCH(128, bf16)
CODA_EXTERN_LAUNCH(128, float)
#undef CODA_EXTERN_LAUNCH

template <typename OutT>
int dispatch(const bf16* q, const bf16* k, const bf16* v, const float* qxyz,
             const float* kxyz_t, const int64_t* seed, OutT* out, float* o_part, float* ml_part,
             int b, int h, int sq, int skv, int ldk, int d, float radius, uint32_t drop_threshold,
             float keep_mult, int splits, int chunk, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16>(q, k, v, qxyz, kxyz_t, seed, out, o_part, ml_part, b, h, sq, skv, ldk, radius, drop_threshold, keep_mult, splits, chunk, stream);
    case 32: return launch<32>(q, k, v, qxyz, kxyz_t, seed, out, o_part, ml_part, b, h, sq, skv, ldk, radius, drop_threshold, keep_mult, splits, chunk, stream);
    case 64: return launch<64>(q, k, v, qxyz, kxyz_t, seed, out, o_part, ml_part, b, h, sq, skv, ldk, radius, drop_threshold, keep_mult, splits, chunk, stream);
    case 128: return launch<128>(q, k, v, qxyz, kxyz_t, seed, out, o_part, ml_part, b, h, sq, skv, ldk, radius, drop_threshold, keep_mult, splits, chunk, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

__global__ void div_check_kernel(const float* __restrict__ e, const float* __restrict__ l,
                                 float* __restrict__ fast, float* __restrict__ ieee, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    fast[i] = div_by(e[i], l[i], rcp_rn(l[i]));
    ieee[i] = __fdiv_rn(e[i], l[i]);
  }
}

}  // namespace coda_d_bf16

using coda_d_bf16::bf16;
using coda_d_bf16::dispatch;
using coda_d_bf16::div_check_kernel;

// out: bf16 where out_bf16, else fp32.  splits > 1 needs o_part (splits * b
// * h * sq * d floats) and ml_part (splits * b * h * sq * 2 floats) and
// leaves `out` to coda_attention_combine.  q, k, v, kxyz_t 16-byte aligned;
// ldk a multiple of 8.  seed: one int64 on the device, read only when
// keep_mult > 0 (dropout; 0: none).
extern "C" int coda_attention_bf16(const bf16* q, const bf16* k, const bf16* v,
                                   const float* qxyz, const float* kxyz_t, const int64_t* seed,
                                   void* out, float* o_part, float* ml_part, int b, int h, int sq,
                                   int skv, int ldk, int d, float radius, unsigned drop_threshold,
                                   float keep_mult, int out_bf16, int splits, int chunk,
                                   cudaStream_t stream) {
  if (sq < 1 || skv < 1 || ldk < skv || ldk % 8 != 0 || splits < 1 || splits > 65535 ||
      (long long)b * h > 65535 || (splits > 1 && (o_part == nullptr || ml_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (out_bf16)
    return dispatch(q, k, v, qxyz, kxyz_t, seed, static_cast<bf16*>(out), o_part, ml_part, b, h,
                    sq, skv, ldk, d, radius, drop_threshold, keep_mult, splits, chunk, stream);
  return dispatch(q, k, v, qxyz, kxyz_t, seed, static_cast<float*>(out), o_part, ml_part, b, h,
                  sq, skv, ldk, d, radius, drop_threshold, keep_mult, splits, chunk, stream);
}

// The kernel's division against __fdiv_rn on n pairs (e, l), not a launch of
// any path: chip_smoke.py's phase 18 (a) holds the kernel's own inline
// div_by (attention_bf16.cuh) bit-equal to __fdiv_rn with it, so it is built
// from the same header as the kernel.
extern "C" int coda_attention_bf16_div_check(const float* e, const float* l, float* fast,
                                             float* ieee, int n, cudaStream_t stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  div_check_kernel<<<(n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096, 256, 0, stream>>>(
      e, l, fast, ieee, n);
  return (int)cudaGetLastError();
}
