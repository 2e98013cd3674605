// Kernel G: tiled ball query, (B, N, 3) points x (B, M, 3) centres -> (B, M, k) int32.
//
// Replaces coda_neurips2023_tpu/ops/pallas_ball_query.py :: ball_query_pallas
// (the "adaptive" kernel, CODA_BQ_ALGO=adaptive) and
// pallas_ball_query_mxu.py :: ball_query_pallas_mxu (CODA_BQ_MXU=1, k = 64).
// Same function as kernel B (ball_query.cu): for each centre, the first k
// point indices, in index order, with squared distance < r^2; trailing slots
// are filled with the first hit; a row with no hit is all zeros.
//
// Design: the TPU kernel's structure, many centres sharing one staged chunk
// of points.  One block takes one scene and a tile of kTile = 64 centres
// (8 warps, 8 centres a warp).  It stages the scene through shared memory in
// chunks of kChunk = 2048 points as x, y, z arrays (24 KB), so the scene is
// read from L2 once a tile and not once a centre as in B.  A warp tests 32
// staged points a step against each of its live centres: __ballot_sync marks
// the hits, and __popc of the lower lanes' bits gives each hit its rank, the
// one-instruction form of the TPU kernel's cumsum rank (its choice between
// one-hot insertion and first-hit extraction, and the MXU kernel's hi/lo
// one-hot product, are TPU placement strategies with nothing to carry over).
// The chunk loop stops once every centre of the tile holds k hits, by a
// block-wide vote (the TPU kernel's all_full skip); a centre that never fills
// keeps the tile scanning to the end of the scene.
//
// Bound on the card: up to B*M*N distance tests (each 3 sub, 3 mul, 2 add
// and a compare in fp32), fewer where rows fill early; the bytes are the
// points once and the (B, M, k) indices once.
//
// The last chunk is cut by index (points at or past N are never tested), not
// by a far-away sentinel.  The distance is ((dx*dx + dy*dy) + dz*dz) with
// round-to-nearest intrinsics (no FMA contraction), in B's order, so G is
// bit-equal to B, to the plain PyTorch version and to the numpy golden model.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kCentresPerWarp = 8;
constexpr int kTile = kWarps * kCentresPerWarp;
constexpr int kChunk = 2048;

__global__ void __launch_bounds__(kWarps * 32)
ball_query_tile_kernel(const float* __restrict__ xyz, const float* __restrict__ centres,
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
    for (int f = threadIdx.x; f < 3 * len; f += kWarps * 32) {
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

extern "C" int coda_ball_query_tile(const float* xyz, const float* centres, int32_t* out,
                                    int b, int n, int m, int k, float r2,
                                    cudaStream_t stream) {
  const long long tiles = ((long long)m + kTile - 1) / kTile;
  if (b <= 0 || tiles <= 0) return (int)cudaSuccess;
  if (tiles > 0x7fffffffLL || b > 65535) return (int)cudaErrorInvalidValue;
  ball_query_tile_kernel<<<dim3((unsigned)tiles, (unsigned)b), kWarps * 32, 0, stream>>>(
      xyz, centres, out, n, m, k, r2);
  return (int)cudaGetLastError();
}
