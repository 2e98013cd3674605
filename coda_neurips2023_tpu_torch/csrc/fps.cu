// Kernel A: furthest-point sampling, (B, N, 3) f32 -> (B, npoint) int32.
//
// Replaces coda_neurips2023_tpu/ops/pallas_fps.py :: fps_pallas (_fps_kernel).
// Semantics (pallas_fps.py:16-20): index 0 is picked first; points with
// |p|^2 <= 1e-3 are never picked; the running min-distance starts at 1e10;
// each step picks the valid point with the largest min-distance, the lowest
// index winning ties.  Point 0 seeds the loop even when it is invalid.
//
// Bound on the card: the npoint steps are sequential and each one ends in a
// block-wide arg-max, so the kernel is latency-bound (two barriers a step),
// not bandwidth-bound.  One block of 1024 threads per batch row: the running
// min-distance of a row (20000 points -> 20 per thread) lives in registers
// for the whole loop.  The coordinates (240 KB a row at N = 20000) do not fit
// in shared memory; every step re-reads them, and they stay in the 50 MB L2.
//
// Distances are written out as ((dx*dx + dy*dy) + dz*dz) with
// round-to-nearest intrinsics, so nvcc cannot contract them into FMAs: the
// plain PyTorch version computes the same sum in the same order and the two
// agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  float dx = __fsub_rn(ax, bx);
  float dy = __fsub_rn(ay, by);
  float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// (value, index) arg-max that keeps the lowest index on ties.
__device__ __forceinline__ void argmax_merge(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

template <int PPT>
__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ xyz, int32_t* __restrict__ out, int n,
           int npoint) {
  __shared__ float s_val[kWarps];
  __shared__ int s_idx[kWarps];
  __shared__ int s_best;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* pts = xyz + (size_t)b * n * 3;
  int32_t* row_out = out + (size_t)b * npoint;

  // An invalid point starts (and, since every distance is >= 0, stays) at
  // -1, its candidate value; a slot past the row's end holds -2 and never wins.
  float mind[PPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int i = tid + p * kThreads;
    mind[p] = -2.0f;
    if (i < n) {
      const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
      const float mag = __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                                  __fmul_rn(z, z));
      mind[p] = mag > 1e-3f ? 1e10f : -1.0f;
    }
  }
  if (tid == 0) row_out[0] = 0;

  int last = 0;
  for (int j = 1; j < npoint; ++j) {
    const float lx = pts[3 * last], ly = pts[3 * last + 1], lz = pts[3 * last + 2];
    float best_v = -2.0f;
    int best_i = n;
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const int i = tid + p * kThreads;
      if (i < n) {
        const float d = sq_dist(pts[3 * i], pts[3 * i + 1], pts[3 * i + 2], lx, ly, lz);
        mind[p] = fminf(mind[p], d);
        // a thread's indices increase with p, so strict > keeps the first
        if (mind[p] > best_v) {
          best_v = mind[p];
          best_i = i;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best_v, off);
      const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
      argmax_merge(best_v, best_i, ov, oi);
    }
    if (lane == 0) {
      s_val[warp] = best_v;
      s_idx[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best_v = s_val[lane];
      best_i = s_idx[lane];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best_v, off);
        const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
        argmax_merge(best_v, best_i, ov, oi);
      }
      if (lane == 0) {
        s_best = best_i;
        row_out[j] = best_i;
      }
    }
    __syncthreads();
    last = s_best;
  }
}

template <int PPT>
void launch(const float* xyz, int32_t* out, int b, int n, int npoint,
            cudaStream_t stream) {
  fps_kernel<PPT><<<b, kThreads, 0, stream>>>(xyz, out, n, npoint);
}

}  // namespace

// Largest N the kernel takes: 40 points a thread (ScanNet's 40000 fit).
extern "C" int coda_fps_max_points() { return 40 * kThreads; }

extern "C" int coda_fps(const float* xyz, int32_t* out, int b, int n, int npoint,
                        cudaStream_t stream) {
  const int ppt = (n + kThreads - 1) / kThreads;
  if (ppt <= 1) launch<1>(xyz, out, b, n, npoint, stream);
  else if (ppt <= 2) launch<2>(xyz, out, b, n, npoint, stream);
  else if (ppt <= 4) launch<4>(xyz, out, b, n, npoint, stream);
  else if (ppt <= 8) launch<8>(xyz, out, b, n, npoint, stream);
  else if (ppt <= 16) launch<16>(xyz, out, b, n, npoint, stream);
  else if (ppt <= 20) launch<20>(xyz, out, b, n, npoint, stream);
  else if (ppt <= 32) launch<32>(xyz, out, b, n, npoint, stream);
  else if (ppt <= 40) launch<40>(xyz, out, b, n, npoint, stream);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
