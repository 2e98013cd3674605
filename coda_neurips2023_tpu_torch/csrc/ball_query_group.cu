// Kernel F: fused ball query and coordinate gather.
// (B, N, 3) points x (B, M, 3) centres -> idx (B, M, k) int32 and
// grouped (B, M, k, 3) f32, grouped[b, m, s] = xyz[b, idx[b, m, s]].
//
// Replaces coda_neurips2023_tpu/ops/pallas_ball_query_sorted.py ::
// ball_query_and_group_sorted.  Semantics are kernel B's followed by kernel
// C's: the first k point indices, in index order, with squared distance
// < r^2; trailing slots repeat the first hit and its coordinates; a row with
// no hit is index 0 with the coordinates of point 0.
//
// On the TPU the fusion saved a separate one-hot gather pass.  Here it is
// the natural form of kernel B's scan: one warp per centre reads 32
// consecutive points at a time, and the lane that holds a hit already has
// its three coordinates in registers, so it writes them beside the index.
// The first hit's coordinates are broadcast from its lane with a shuffle for
// the fill pass, so nothing is read twice.  The distance is formed as in
// kernel B, ((dx*dx + dy*dy) + dz*dz) with round-to-nearest intrinsics, so
// the indices are bit-equal to B's and the coordinates to C's (a copy).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ball_query_group_kernel(const float* __restrict__ xyz, const float* __restrict__ centres,
                        int32_t* __restrict__ idx, float* __restrict__ grouped, int b,
                        int n, int m, int k, float r2) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= (long long)b * m) return;
  const int bi = (int)(row / m);
  const float* pts = xyz + (size_t)bi * n * 3;
  const float cx = centres[3 * row], cy = centres[3 * row + 1], cz = centres[3 * row + 2];
  int32_t* o = idx + row * k;
  float* g = grouped + row * k * 3;

  int cnt = 0;
  int first = 0;
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;
  for (int base = 0; base < n && cnt < k; base += 32) {
    const int i = base + lane;
    bool hit = false;
    float px = 0.0f, py = 0.0f, pz = 0.0f;
    if (i < n) {
      px = pts[3 * i];
      py = pts[3 * i + 1];
      pz = pts[3 * i + 2];
      const float dx = __fsub_rn(cx, px);
      const float dy = __fsub_rn(cy, py);
      const float dz = __fsub_rn(cz, pz);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      hit = d2 < r2;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (mask == 0u) continue;
    if (cnt == 0) {
      const int src = __ffs(mask) - 1;
      first = base + src;
      fx = __shfl_sync(0xffffffffu, px, src);
      fy = __shfl_sync(0xffffffffu, py, src);
      fz = __shfl_sync(0xffffffffu, pz, src);
    }
    const int slot = cnt + __popc(mask & ((1u << lane) - 1u));
    if (hit && slot < k) {
      o[slot] = i;
      g[3 * slot] = px;
      g[3 * slot + 1] = py;
      g[3 * slot + 2] = pz;
    }
    cnt += __popc(mask);
  }
  // fill: the first hit after the last one written; point 0 when none
  if (cnt == 0) {
    fx = pts[0];
    fy = pts[1];
    fz = pts[2];
  }
  for (int s = min(cnt, k) + lane; s < k; s += 32) {
    o[s] = first;
    g[3 * s] = fx;
    g[3 * s + 1] = fy;
    g[3 * s + 2] = fz;
  }
}

}  // namespace

extern "C" int coda_ball_query_group(const float* xyz, const float* centres, int32_t* idx,
                                     float* grouped, int b, int n, int m, int k, float r2,
                                     cudaStream_t stream) {
  const long long rows = (long long)b * m;
  if (rows == 0) return (int)cudaSuccess;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ball_query_group_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      xyz, centres, idx, grouped, b, n, m, k, r2);
  return (int)cudaGetLastError();
}
