// The query of kernels B (ball_query.cu) and F (ball_query_group.cu) on the
// spatial cell grid that ball_query.cu builds.  Semantics (ops/grouping.py):
// for each centre, the first k point indices, in index order, with squared
// distance < r^2; trailing slots repeat the first hit; a row with no hit is
// all zeros (F: index 0 and the coordinates of point 0).
//
// The grid of a scene: fparams = (lo_x, lo_y, lo_z, 1 / side), iparams =
// (cells along x, y, z, cells in all); the points ordered by (cell, original
// index) as float4 (x, y, z, the index's bits); starts[c] = the first slot of
// cell c (c = (cz * gy + cy) * gx + cx), starts[cells] = N.  So the cells of
// one row along x are one contiguous span of slots.
//
// One warp serves one centre.  It maps the centre's search box [c - r_w,
// c + r_w], each bound rounded outward with nextafterf, to a range of cells
// on each axis with the points' own cell function, so every point whose f32
// distance can fall below r^2 lies in the range (ops/grouping.py says why).
// Its rows (y, z) give at most 32 spans a pass; the warp packs them end to
// end and tests 128 candidates a step (4 loads a lane in flight), so a
// centre with 20 candidates takes one step whatever cells they sit in.
// __ballot_sync marks the hits, which go into the warp's buffer in shared
// memory.  The candidates are not in
// index order across cells, so the first k hits are the k smallest original
// indices among all of them (the JAX sorted kernel's extraction by minimum
// original index, in warp form): when the buffer is full the warp keeps its
// k smallest entries, each placed by its rank (the count of smaller
// entries, the indices being distinct), and from then on drops any hit
// whose index is not below the k-th; the same rank placement orders the
// survivors at the end.  A buffer of twice the rounded k therefore holds a
// cell of thousands of hits exactly, in passes.
//
// Bound on the card: the candidate tests (about 23 a centre at r = 0.2 on
// the synthetic scenes, against up to N for a scan in index order) and the
// bytes (the points once, the outputs once).  The distance is ((dx*dx +
// dy*dy) + dz*dz) with round-to-nearest intrinsics (no FMA contraction), the
// order of the plain PyTorch version and the numpy golden model.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace bq_grid {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 8;
constexpr int kUnroll = 4;  // candidates a lane loads before testing them

// The cell of coordinate x on one axis: floor((x - lo) * inv), clamped into
// [0, g - 1], NaN to 0.  Monotone in x, and shared by the build and the query.
__device__ __forceinline__ int cell_coord(float x, float lo, float inv, int g) {
  const float t = floorf(__fmul_rn(__fsub_rn(x, lo), inv));
  if (t >= (float)(g - 1)) return g - 1;
  return t >= 0.0f ? (int)t : 0;
}

__device__ __forceinline__ float sq_dist(float cx, float cy, float cz, float4 p) {
  const float dx = __fsub_rn(cx, p.x);
  const float dy = __fsub_rn(cy, p.y);
  const float dz = __fsub_rn(cz, p.z);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Places each of src[0, n) whose rank (the count of smaller entries; the
// entries are distinct) is below k at dst[rank]; returns min(n, k).
__device__ __forceinline__ int keep_smallest(const int* src, int n, int* dst, int k, int lane) {
  for (int e = lane; e < n; e += 32) {
    const int v = src[e];
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += src[j] < v;
    if (rank < k) dst[rank] = v;
  }
  __syncwarp();
  return min(n, k);
}

// Shared memory a warp takes: two buffers of `buf` entries and the spans of
// one pass of rows.
__host__ __device__ constexpr int warp_smem_ints(int buf) { return 2 * buf + 64; }

template <bool kGroup>
__global__ void __launch_bounds__(kMaxWarps * 32)
grid_query_kernel(const float4* __restrict__ pts, const int32_t* __restrict__ starts,
                  const float4* __restrict__ fparams, const int4* __restrict__ iparams,
                  const float* __restrict__ centres, const float* __restrict__ xyz,
                  int32_t* __restrict__ out, float* __restrict__ grouped, int b, int n, int m,
                  int k, int stride, int buf_len, float r2, float rw) {
  extern __shared__ int smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= (long long)b * m) return;
  int* buf = smem + warp * warp_smem_ints(buf_len);
  int* alt = buf + buf_len;
  int* span_beg = alt + buf_len;
  int* span_end = span_beg + 32;  // inclusive prefix of the span lengths

  const int bi = (int)(row / m);
  const float4 fp = fparams[bi];
  const int4 ip = iparams[bi];
  const float4* sp = pts + (size_t)bi * n;
  const int32_t* st = starts + (size_t)bi * stride;
  const float cx = centres[3 * row], cy = centres[3 * row + 1], cz = centres[3 * row + 2];
  const int x0 = cell_coord(nextafterf(__fsub_rn(cx, rw), -INFINITY), fp.x, fp.w, ip.x);
  const int x1 = cell_coord(nextafterf(__fadd_rn(cx, rw), INFINITY), fp.x, fp.w, ip.x);
  const int y0 = cell_coord(nextafterf(__fsub_rn(cy, rw), -INFINITY), fp.y, fp.w, ip.y);
  const int y1 = cell_coord(nextafterf(__fadd_rn(cy, rw), INFINITY), fp.y, fp.w, ip.y);
  const int z0 = cell_coord(nextafterf(__fsub_rn(cz, rw), -INFINITY), fp.z, fp.w, ip.z);
  const int z1 = cell_coord(nextafterf(__fadd_rn(cz, rw), INFINITY), fp.z, fp.w, ip.z);
  const int wy = y1 - y0 + 1;
  const int rows = wy * (z1 - z0 + 1);

  int cnt = 0;              // entries in buf
  int below = INT_MAX;      // a hit must lie below this index to be kept
  for (int r0 = 0; r0 < rows; r0 += 32) {
    const int r = r0 + lane;
    int beg = 0, len = 0;
    if (r < rows) {
      const int base = ((z0 + r / wy) * ip.y + y0 + r % wy) * ip.x;
      beg = st[base + x0];
      len = st[base + x1 + 1] - beg;
    }
    int incl = len;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += v;
    }
    span_beg[lane] = beg;
    span_end[lane] = incl;
    const int total = __shfl_sync(kFull, incl, 31);
    __syncwarp();
    for (int p0 = 0; p0 < total; p0 += 32 * kUnroll) {
      // kUnroll candidates a lane in flight: a centre with thousands of
      // candidates is a chain of dependent steps, and its latency is the
      // kernel's tail
      float4 q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int p = p0 + 32 * u + lane;
        q[u] = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(INT_MAX));
        if (p < total) {
          int s = 0;
          while (span_end[s] <= p) ++s;
          q[u] = sp[span_beg[s] + p - (s ? span_end[s - 1] : 0)];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int idx = __float_as_int(q[u].w);  // INT_MAX past the end: never kept
        bool hit = idx < below && sq_dist(cx, cy, cz, q[u]) < r2;
        unsigned mask = __ballot_sync(kFull, hit);
        if (mask == 0u) continue;
        if (cnt + 32 > buf_len) {  // full: keep the k smallest
          cnt = keep_smallest(buf, cnt, alt, k, lane);
          int* t = buf;
          buf = alt;
          alt = t;
          if (cnt == k) below = buf[k - 1];
          hit = hit && idx < below;
          mask = __ballot_sync(kFull, hit);
        }
        if (hit) buf[cnt + __popc(mask & ((1u << lane) - 1u))] = idx;
        cnt += __popc(mask);
        __syncwarp();
      }
    }
    __syncwarp();  // every lane has read the spans before the next pass
  }
  const int kept = keep_smallest(buf, cnt, alt, k, lane);  // alt ascending
  const int first = kept > 0 ? alt[0] : 0;
  int32_t* o = out + row * k;
  for (int s = lane; s < k; s += 32) {
    const int v = s < kept ? alt[s] : first;
    o[s] = v;
    if (kGroup) {
      const float* src = xyz + ((size_t)bi * n + v) * 3;
      float* g = grouped + (row * k + s) * 3;
      g[0] = src[0];
      g[1] = src[1];
      g[2] = src[2];
    }
  }
}

// Launches the query: the buffer holds twice min(k, n) rounded up to 32
// entries (at least k + 32, so a full buffer always has room after keeping
// k), and a block takes as many warps as fit 48 KB, at most kMaxWarps, or
// one warp with more shared memory.
template <bool kGroup>
int launch_query(const float* pts, const int32_t* starts, const float* fparams,
                 const int32_t* iparams, const float* centres, const float* xyz, int32_t* out,
                 float* grouped, int b, int n, int m, int k, int stride, float r2, float rw,
                 cudaStream_t stream) {
  const long long rows = (long long)b * m;
  if (rows == 0) return (int)cudaSuccess;
  const int kk = ((k < n ? k : n) + 31) / 32 * 32;
  const int buf_len = 2 * kk;
  const size_t warp_bytes = sizeof(int) * warp_smem_ints(buf_len);
  const size_t fit = (size_t)(48 * 1024) / warp_bytes;
  int warps = fit < (size_t)kMaxWarps ? (int)fit : kMaxWarps;
  if (warps < 1) {
    warps = 1;
    const cudaError_t err = cudaFuncSetAttribute(
        grid_query_kernel<kGroup>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)warp_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const long long blocks = (rows + warps - 1) / warps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  grid_query_kernel<kGroup><<<(unsigned)blocks, warps * 32, warps * warp_bytes, stream>>>(
      reinterpret_cast<const float4*>(pts), starts, reinterpret_cast<const float4*>(fparams),
      reinterpret_cast<const int4*>(iparams), centres, xyz, out, grouped, b, n, m, k, stride,
      buf_len, r2, rw);
  return (int)cudaGetLastError();
}

}  // namespace bq_grid
