// Kernel C: indexed gather, out[b, r, c] = features[b, idx[b, r], c].
// features (B, N, C) f32, idx (B, R) int32 -> (B, R, C) f32, where R = M*K
// for group_points and R = M for gather_points.
//
// Replaces coda_neurips2023_tpu/ops/pallas_group_gather.py ::
// group_points_pallas.  On the TPU an arbitrary gather had to be built from
// one-hot matrix products (with a bf16x3 split to stay exact); on the card
// it is an indexed load, exact by construction.
//
// Bound on the card: bytes.  At the eval shape the grouped xyz is
// 32 * 2048 * 64 * 3 * 4 B = 50 MB written and 16 MB of indices read; the
// scene (240 KB a row) stays in L2.  One thread per output element, so
// neighbouring threads write neighbouring addresses and the reads of one
// gathered row are contiguous.  An index outside [0, N) is clamped, so the
// kernel never reads outside the row; callers pass indices from FPS and the
// ball query, which are always in range.  Forward only: the scatter-add
// backward comes with training.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void gather_kernel(const float* __restrict__ features,
                              const int32_t* __restrict__ idx,
                              float* __restrict__ out, long long total, int n,
                              int r, int c) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const int ch = (int)(t % c);
  const long long row = t / c;  // b * R + j
  const long long b = row / r;
  int i = idx[row];
  i = i < 0 ? 0 : (i >= n ? n - 1 : i);
  out[t] = features[(b * n + i) * c + ch];
}

}  // namespace

extern "C" int coda_gather(const float* features, const int32_t* idx, float* out,
                           int b, int n, int r, int c, cudaStream_t stream) {
  const long long total = (long long)b * r * c;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gather_kernel<<<(unsigned)blocks, threads, 0, stream>>>(features, idx, out, total,
                                                          n, r, c);
  return (int)cudaGetLastError();
}
