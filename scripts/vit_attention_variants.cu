// Kernel E's two resident forms side by side, for
// scripts/bench_torch_attention.py: the head's K and V split into TF32 hi
// and lo once, in shared memory (the form the package launches), or kept in
// fp32 and split at every fragment load (half the shared memory, two blocks
// a multiprocessor).  The kernel is the package's own source, included.
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//          -Xcompiler -fPIC -o build/vit_attention_variants.so scripts/vit_attention_variants.cu

#include "../coda_neurips2023_tpu_torch/csrc/vit_attention.cu"

extern "C" int vit_attention_form(int presplit, const float* q, const float* k, const float* v,
                                  float* out, int bh, int s, int d, float scale,
                                  cudaStream_t stream) {
  if (bh < 1 || s < 1) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 32: return presplit ? launch<32, true>(q, k, v, out, bh, s, scale, stream)
                             : launch<32, false>(q, k, v, out, bh, s, scale, stream);
    case 64: return presplit ? launch<64, true>(q, k, v, out, bh, s, scale, stream)
                             : launch<64, false>(q, k, v, out, bh, s, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
