// The ball-query kernels B, F and G as they were before they took the cell
// grid (coda_neurips2023_tpu_torch/csrc/ball_query_grid.cuh,
// ball_query_tile.cu).  B and F: one warp a centre scans the scene in index
// order, 32 points a step, and stops at its k-th hit.  G: a block of 64
// centres in their given order stages the scene in chunks of 2048 points
// and stops once all 64 hold k hits.  Kept only as the yardstick of
// chip_smoke.py's phase 3 and scripts/bench_ball_query_variants.py, which
// time them against the grid kernels in the same run; nothing in the
// package calls them.  Same semantics and the same bits as the grid kernels.
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

// The old kernel G: one block takes one scene and a tile of kTile = 64
// centres (8 warps, 8 centres a warp); it stages the scene through shared
// memory in chunks of kChunk points as x, y, z arrays, tests 32 staged points
// a step against each of a warp's live centres (__ballot_sync, __popc rank),
// and stops once every centre of the tile holds k hits, by a block-wide vote.
constexpr int kTileWarps = 8;
constexpr int kCentresPerWarp = 8;
constexpr int kTile = kTileWarps * kCentresPerWarp;
constexpr int kChunk = 2048;

__global__ void __launch_bounds__(kTileWarps * 32)
tile_scan_kernel(const float* __restrict__ xyz, const float* __restrict__ centres,
                 int32_t* __restrict__ out, int n, int m, int k, float r2) {
  __shared__ float sx[kChunk];
  __shared__ float sy[kChunk];
  __shared__ float sz[kChunk];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int bi = blockIdx.y;
  const float* pts = xyz + (size_t)bi * n * 3;
  const int c0 = blockIdx.x * kTile + warp * kCentresPerWarp;

  float cx[kCentresPerWarp], cy[kCentresPerWarp], cz[kCentresPerWarp];
  int cnt[kCentresPerWarp], first[kCentresPerWarp];
#pragma unroll
  for (int c = 0; c < kCentresPerWarp; ++c) {
    const int mi = c0 + c;
    const bool live = mi < m;
    const float* ctr = centres + ((size_t)bi * m + (live ? mi : 0)) * 3;
    cx[c] = ctr[0];
    cy[c] = ctr[1];
    cz[c] = ctr[2];
    cnt[c] = live ? 0 : k;  // a padding slot of the last tile counts as full
    first[c] = 0;
  }
  bool warp_full = c0 >= m;

  for (int base = 0; base < n; base += kChunk) {
    // every centre of the tile full: the rest of the scene is not read.
    // The vote is also the barrier before the chunk below is overwritten.
    if (__syncthreads_and(warp_full)) break;
    const int len = min(kChunk, n - base);
    const float* src = pts + (size_t)base * 3;
    for (int f = threadIdx.x; f < 3 * len; f += kTileWarps * 32) {
      const int i = f / 3;
      const int d = f - 3 * i;
      const float v = src[f];
      if (d == 0) sx[i] = v;
      else if (d == 1) sy[i] = v;
      else sz[i] = v;
    }
    __syncthreads();

    for (int j = 0; j < len && !warp_full; j += 32) {
      const int i = j + lane;
      const bool in = i < len;
      const float px = in ? sx[i] : 0.f;
      const float py = in ? sy[i] : 0.f;
      const float pz = in ? sz[i] : 0.f;
      bool all = true;
#pragma unroll
      for (int c = 0; c < kCentresPerWarp; ++c) {
        if (cnt[c] < k) {  // warp-uniform: every lane holds the same count
          bool hit = false;
          if (in) {
            const float dx = __fsub_rn(cx[c], px);
            const float dy = __fsub_rn(cy[c], py);
            const float dz = __fsub_rn(cz[c], pz);
            const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                       __fmul_rn(dz, dz));
            hit = d2 < r2;
          }
          const unsigned mask = __ballot_sync(0xffffffffu, hit);
          if (mask != 0u) {
            if (cnt[c] == 0) first[c] = base + j + __ffs(mask) - 1;
            const int slot = cnt[c] + __popc(mask & lower);
            if (hit && slot < k) out[((size_t)bi * m + c0 + c) * k + slot] = base + i;
            cnt[c] += __popc(mask);
          }
          all = all && cnt[c] >= k;
        }
      }
      warp_full = all;
    }
  }

  // fill: the first hit after the last one written, zeros when none
#pragma unroll
  for (int c = 0; c < kCentresPerWarp; ++c) {
    if (c0 + c >= m) continue;
    int32_t* o = out + ((size_t)bi * m + c0 + c) * k;
    const int fill = cnt[c] > 0 ? first[c] : 0;
    for (int s = min(cnt[c], k) + lane; s < k; s += 32) o[s] = fill;
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

extern "C" int bq_tile_scan(const float* xyz, const float* centres, int32_t* out, int b, int n,
                            int m, int k, float r2, cudaStream_t stream) {
  const long long tiles = ((long long)m + kTile - 1) / kTile;
  if (b <= 0 || tiles <= 0) return (int)cudaSuccess;
  if (tiles > 0x7fffffffLL || b > 65535) return (int)cudaErrorInvalidValue;
  tile_scan_kernel<<<dim3((unsigned)tiles, (unsigned)b), kTileWarps * 32, 0, stream>>>(
      xyz, centres, out, n, m, k, r2);
  return (int)cudaGetLastError();
}
