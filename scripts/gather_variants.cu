// Layouts of the xyz gather out[b, r, :] = features[b, idx[b, r], :] tried
// for kernel C (csrc/gather.cu), timed by scripts/bench_gather_variants.py.
// Each takes features (B, N, 3), idx (B, R) int32 with R % 128 == 0.
//   v2: a lane gathers 4 consecutive floats of the warp's 384, one 16-byte store
//   v6: lane l gathers floats l, l + 32, ... (indices staged in shared memory),
//       32-bit coalesced stores: kernel C's layout
//   v8: v6 with each lane reading its row's index from device memory
//   v9: a thread a row: 3 loads, 3 stores
//   v10: a thread per 4 output floats strided by the block, as an elementwise kernel
// and the wide layouts (`gw`), features (B, N, C) with C % 4 == 0, any R:
//   w0: a thread a row, C floats one by one (kernel C at C != 3 before its
//       tile branch)
//   w1..w4: kernel C's tile branch (a warp takes 32 rows, lane l copies the
//       float4s l, l + 32, ... of the tile), kBatch loads in flight a lane:
//       w1 8 with streaming stores, w2 8 with plain stores, w3 4 with
//       streaming stores, w4 16 with streaming stores (kernel C's)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {
constexpr int kThreads = 256;
constexpr int kRows = 128;
__device__ __forceinline__ int clampi(int i, int n) { return i < 0 ? 0 : (i >= n ? n - 1 : i); }

__global__ void __launch_bounds__(kThreads) v2(const float* __restrict__ f0, const int* __restrict__ idx, float* __restrict__ out, int n, int r) {
  __shared__ __align__(16) int sidx[kThreads / 32][kRows];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x * (kThreads / 32) + warp) * kRows;
  const long long b = blockIdx.y;
  const float* f = f0 + b * n * 3;
  const int* ib = idx + b * r + row0;
  float* ob = out + (b * r + row0) * 3;
  int* si = sidx[warp];
  const int4 i4 = reinterpret_cast<const int4*>(ib)[lane];
  reinterpret_cast<int4*>(si)[lane] = make_int4(clampi(i4.x, n) * 3, clampi(i4.y, n) * 3, clampi(i4.z, n) * 3, clampi(i4.w, n) * 3);
  __syncwarp();
  float4* o4 = reinterpret_cast<float4*>(ob);
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int e = 4 * (s * 32 + lane);
    float x[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) { const int row = (e + c) / 3; x[c] = __ldg(f + si[row] + (e + c - 3 * row)); }
    o4[s * 32 + lane] = make_float4(x[0], x[1], x[2], x[3]);
  }
}

__global__ void __launch_bounds__(kThreads) v6(const float* __restrict__ f0, const int* __restrict__ idx, float* __restrict__ out, int n, int r) {
  __shared__ __align__(16) int sidx[kThreads / 32][kRows];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x * (kThreads / 32) + warp) * kRows;
  const long long b = blockIdx.y;
  const float* f = f0 + b * n * 3;
  const int* ib = idx + b * r + row0;
  float* ob = out + (b * r + row0) * 3;
  int* si = sidx[warp];
  const int4 i4 = reinterpret_cast<const int4*>(ib)[lane];
  reinterpret_cast<int4*>(si)[lane] = make_int4(clampi(i4.x, n) * 3, clampi(i4.y, n) * 3, clampi(i4.z, n) * 3, clampi(i4.w, n) * 3);
  __syncwarp();
  float x[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) { const int e = 32 * k + lane; const int row = e / 3; x[k] = __ldg(f + si[row] + (e - 3 * row)); }
#pragma unroll
  for (int k = 0; k < 12; ++k) ob[32 * k + lane] = x[k];
}

__global__ void __launch_bounds__(kThreads) v8(const float* __restrict__ f0, const int* __restrict__ idx, float* __restrict__ out, int n, int r) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x * (kThreads / 32) + warp) * kRows;
  const long long b = blockIdx.y;
  const float* f = f0 + b * n * 3;
  const int* ib = idx + b * r + row0;
  float* ob = out + (b * r + row0) * 3;
  float x[12];
#pragma unroll
  for (int k = 0; k < 12; ++k) { const int e = 32 * k + lane; const int row = e / 3; x[k] = __ldg(f + clampi(__ldg(ib + row), n) * 3 + (e - 3 * row)); }
#pragma unroll
  for (int k = 0; k < 12; ++k) ob[32 * k + lane] = x[k];
}

__global__ void __launch_bounds__(kThreads) v9(const float* __restrict__ f0, const int* __restrict__ idx, float* __restrict__ out, int n, int r) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= r) return;
  const long long b = blockIdx.y;
  const float* p = f0 + b * n * 3 + clampi(__ldg(idx + b * r + row), n) * 3;
  float* o = out + (b * r + row) * 3;
  const float x = __ldg(p), y = __ldg(p + 1), z = __ldg(p + 2);
  o[0] = x; o[1] = y; o[2] = z;
}

__global__ void __launch_bounds__(kThreads) v10(const float* __restrict__ f0, const int* __restrict__ idx, float* __restrict__ out, int n, int r) {
  const long long b = blockIdx.y;
  const float* f = f0 + b * n * 3;
  const int* ib = idx + b * r;
  float* ob = out + b * r * 3;
  const int base = blockIdx.x * kThreads * 4 + threadIdx.x;
  float x[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) { const int e = base + k * kThreads; const int row = e / 3; x[k] = e < 3 * r ? __ldg(f + clampi(__ldg(ib + row), n) * 3 + (e - 3 * row)) : 0.f; }
#pragma unroll
  for (int k = 0; k < 4; ++k) { const int e = base + k * kThreads; if (e < 3 * r) ob[e] = x[k]; }
}

__global__ void __launch_bounds__(kThreads) w0(const float* __restrict__ f0, const int* __restrict__ idx, float* __restrict__ out, int n, int r, int c) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= r) return;
  const long long b = blockIdx.y;
  const float* p = f0 + b * n * c + clampi(idx[b * r + row], n) * c;
  float* o = out + (b * r + row) * c;
  for (int ch = 0; ch < c; ++ch) o[ch] = __ldg(p + ch);
}

template <int kBatch, bool kStream>
__global__ void __launch_bounds__(kThreads) wt(const float4* __restrict__ f0, const int* __restrict__ idx, float4* __restrict__ out, int n, int r, int units) {
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * 32;
  if (row0 >= r) return;
  const int total = min(32, r - row0) * units;
  const long long b = blockIdx.y;
  const float4* f = f0 + b * n * units;
  const int* ib = idx + b * r + row0;
  float4* o = out + (b * r + row0) * units;
  const int start = lane < total / units ? clampi(__ldg(ib + lane), n) * units : 0;
  const int row_step = 32 / units, unit_step = 32 % units;
  int row = lane / units, unit = lane % units;
  for (int k0 = 0; k0 < units; k0 += kBatch) {
    float4 x[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int u = lane + 32 * (k0 + j);
      const int src = __shfl_sync(0xffffffffu, start, row);
      if (k0 + j < units && u < total) x[j] = __ldg(f + src + unit);
      row += row_step;
      unit += unit_step;
      if (unit >= units) { unit -= units; ++row; }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int u = lane + 32 * (k0 + j);
      if (k0 + j < units && u < total) {
        if (kStream) __stcs(o + u, x[j]); else o[u] = x[j];
      }
    }
  }
}
}  // namespace

extern "C" int gw(int which, const float* f, const int* idx, float* out, int b, int n, int r, int c, cudaStream_t st) {
  if (c % 4) return (int)cudaErrorInvalidValue;
  const float4* f4 = reinterpret_cast<const float4*>(f);
  float4* o4 = reinterpret_cast<float4*>(out);
  dim3 g0((r + kThreads - 1) / kThreads, b), gt((r + kThreads - 1) / kThreads, b);  // 8 warps x 32 rows
  switch (which) {
    case 0: w0<<<g0, kThreads, 0, st>>>(f, idx, out, n, r, c); break;
    case 1: wt<8, true><<<gt, kThreads, 0, st>>>(f4, idx, o4, n, r, c / 4); break;
    case 2: wt<8, false><<<gt, kThreads, 0, st>>>(f4, idx, o4, n, r, c / 4); break;
    case 3: wt<4, true><<<gt, kThreads, 0, st>>>(f4, idx, o4, n, r, c / 4); break;
    case 4: wt<16, true><<<gt, kThreads, 0, st>>>(f4, idx, o4, n, r, c / 4); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int gv(int which, const float* f, const int* idx, float* out, int b, int n, int r, cudaStream_t st) {
  const int rpb = kThreads / 32 * kRows;
  dim3 g1((r + rpb - 1) / rpb, b), g9((r + kThreads - 1) / kThreads, b), g10((3 * r + 4 * kThreads - 1) / (4 * kThreads), b);
  switch (which) {
    case 2: v2<<<g1, kThreads, 0, st>>>(f, idx, out, n, r); break;
    case 6: v6<<<g1, kThreads, 0, st>>>(f, idx, out, n, r); break;
    case 8: v8<<<g1, kThreads, 0, st>>>(f, idx, out, n, r); break;
    case 9: v9<<<g9, kThreads, 0, st>>>(f, idx, out, n, r); break;
    case 10: v10<<<g10, kThreads, 0, st>>>(f, idx, out, n, r); break;
  }
  return (int)cudaGetLastError();
}
