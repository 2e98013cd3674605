// The attention-weight dropout's keep mask, shared by kernels D
// (attention.cu) and D-bf16 (attention_bf16.cuh), so both draw the same mask
// for the same seed: keep (query i, key j) of S_kv keys where
// mix32(mix32(seed) ^ (i * S_kv + j)) >= drop_threshold, in uint32
// arithmetic (ops/masked_attention.py :: attention_keep_mask is the same
// hash in tensor ops).

#pragma once

#include <stdint.h>

namespace coda_dropout {

// lowbias32 (C. Wellons): a bijective 32-bit mixer
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7feb352du;
  x ^= x >> 15;
  x *= 0x846ca68bu;
  x ^= x >> 16;
  return x;
}

}  // namespace coda_dropout
