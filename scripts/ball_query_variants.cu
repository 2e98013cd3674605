// The ball-query kernels B and F as they were before they took the cell grid
// (coda_neurips2023_tpu_torch/csrc/ball_query_grid.cuh): one warp a centre
// scans the scene in index order, 32 points a step, and stops at its k-th
// hit.  Kept only as the yardstick of chip_smoke.py's phase 3 and
// scripts/bench_ball_query_variants.py, which time them against the grid
// kernels in the same run; nothing in the package calls them.  Same
// semantics and the same bits as the grid kernels.
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC \
//          -o build/ball_query_variants.so scripts/ball_query_variants.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
scan_kernel(const float* __restrict__ xyz, const float* __restrict__ centres,
            int32_t* __restrict__ out, int b, int n, int m, int k, float r2) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= (long long)b * m) return;
  const int bi = (int)(row / m);
  const float* pts = xyz + (size_t)bi * n * 3;
  const float cx = centres[3 * row], cy = centres[3 * row + 1], cz = centres[3 * row + 2];
  int32_t* o = out + row * k;

  int cnt = 0;
  int first = 0;
  for (int base = 0; base < n && cnt < k; base += 32) {
    const int i = base + lane;
    bool hit = false;
    if (i < n) {
      const float dx = __fsub_rn(cx, pts[3 * i]);
      const float dy = __fsub_rn(cy, pts[3 * i + 1]);
      const float dz = __fsub_rn(cz, pts[3 * i + 2]);
      const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                 __fmul_rn(dz, dz));
      hit = d2 < r2;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (mask == 0u) continue;
    if (cnt == 0) first = base + __ffs(mask) - 1;
    const int slot = cnt + __popc(mask & ((1u << lane) - 1u));
    if (hit && slot < k) o[slot] = i;
    cnt += __popc(mask);
  }
  // fill: the first hit after the last one written, zeros when none
  const int fill = cnt > 0 ? first : 0;
  for (int s = min(cnt, k) + lane; s < k; s += 32) o[s] = fill;
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
scan_group_kernel(const float* __restrict__ xyz, const float* __restrict__ centres,
                  int32_t* __restrict__ idx, float* __restrict__ grouped, int b, int n, int m,
                  int k, float r2) {
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

extern "C" int bq_scan(const float* xyz, const float* centres, int32_t* out, int b, int n,
                       int m, int k, float r2, cudaStream_t stream) {
  const long long rows = (long long)b * m;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  scan_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      xyz, centres, out, b, n, m, k, r2);
  return (int)cudaGetLastError();
}

extern "C" int bq_group_scan(const float* xyz, const float* centres, int32_t* idx,
                             float* grouped, int b, int n, int m, int k, float r2,
                             cudaStream_t stream) {
  const long long rows = (long long)b * m;
  if (rows == 0) return (int)cudaSuccess;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  scan_group_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      xyz, centres, idx, grouped, b, n, m, k, r2);
  return (int)cudaGetLastError();
}
