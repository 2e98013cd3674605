// Kernel D-bf16 at head width 16 (attention_bf16.cuh), both output types.

#include "attention_bf16.cuh"

namespace coda_d_bf16 {

template int launch<16, bf16>(const bf16*, const bf16*, const bf16*, const float*,
                              const float*, const int64_t*, bf16*, float*, float*, int, int,
                              int, int, int, float, uint32_t, float, int, int, cudaStream_t);
template int launch<16, float>(const bf16*, const bf16*, const bf16*, const float*,
                              const float*, const int64_t*, float*, float*, float*, int, int,
                              int, int, int, float, uint32_t, float, int, int, cudaStream_t);

}  // namespace coda_d_bf16
