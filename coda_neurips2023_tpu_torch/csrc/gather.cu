// Kernel C: indexed gather, out[b, r, c] = features[b, idx[b, r], c].
// features (B, N, C) f32, idx (B, R) int32 -> (B, R, C) f32, where R = M*K
// for group_points and R = M for gather_points.
//
// Replaces coda_neurips2023_tpu/ops/pallas_group_gather.py ::
// group_points_pallas.  On the TPU an arbitrary gather had to be built from
// one-hot matrix products (with a bf16x3 split to stay exact); on the card
// it is an indexed load, exact by construction: the output is bit-equal to
// the plain version's.
//
// Bound on the card: bytes.  At the eval shape the grouped xyz is
// 32 * 2048 * 64 * 3 * 4 B = 50 MB written and 16 MB of indices read; the
// scene (240 KB a row) stays in L2.  At the masked encoder's interim set
// abstraction, 256-d features (32, 2048, 256) -> (32, 1024, 32, 256), 1.07
// GB is written against 67 MB of features, each row read about 16 times.
// The batch row comes from blockIdx.y, so every offset inside a row is
// 32-bit arithmetic (the wrapper checks R*C and N*C < 2^31) with no 64-bit
// division.  Each index is read once and clamped into [0, N), so the kernel
// never reads outside the row; callers pass indices from FPS and the ball
// query, which are always in range.  Three branches, chosen at launch:
//   * C = 3 (xyz, every caller on the eval and training paths): a warp
//     takes 128 rows.  It reads their indices once, as one 16-byte load a
//     lane where aligned, into shared memory; then lane l gathers floats
//     l, l + 32, ..., l + 352 of the rows' 384 (all twelve loads in flight
//     at once) and writes them back in the same order.  Neighbouring lanes
//     read neighbouring floats of a row, so one sector serves a row's
//     three, and each store is 128 contiguous bytes a warp.  (Measured on
//     the card, this beat a lane gathering four consecutive floats and
//     writing them as one 16-byte store: scripts/bench_gather_variants.py.)
//   * C % 4 == 0 with features and output 16-byte aligned: `gather_tile_kernel`
//     on float4 units (16-byte loads and stores);
//   * any other C or alignment: the same kernel on single floats.
//   `gather_tile_kernel`: a warp takes a tile of 32 rows.  Lane j loads row
//   j's index (one coalesced load for the tile) and the lanes read it by
//   shuffle.  The tile's output is 32 * U contiguous units (U = C / 4 or C
//   units a row), and lane l copies units l, l + 32, l + 64, ...: a warp a
//   row at U >= 32 (at C = 256 each lane takes two float4s of a row), a
//   group of U lanes a row below that, so every load reads contiguous bytes
//   of one or a few rows and every store writes 32 contiguous units.  A
//   lane keeps kBatch loads in flight (at C = 256 eight rows) before their
//   stores, and the stores stream (st.global.cs, evict-first), so the
//   output does not push the features out of L2; the grid is batch-major,
//   so the blocks in flight read a few batch rows' features.  On the card
//   (scripts/bench_gather_variants.py, C = 256): 16 loads in flight beat 8
//   by 2-3% and 4 by 4-5%; streaming stores beat plain ones by 9%.
// The scatter-add backward is plain PyTorch (ops/grouping.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int clamp_index(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
}

constexpr int kRowsPerWarp = 128;

__global__ void __launch_bounds__(kThreads)
gather3_kernel(const float* __restrict__ features, const int32_t* __restrict__ idx,
               float* __restrict__ out, int n, int r) {
  __shared__ __align__(16) int rows_idx[kThreads / 32][kRowsPerWarp];  // index * 3
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = (blockIdx.x * (kThreads / 32) + warp) * kRowsPerWarp;
  if (row0 >= r) return;
  const int rows = min(kRowsPerWarp, r - row0);
  const long long b = blockIdx.y;
  const float* f = features + b * n * 3;
  const int32_t* ib = idx + b * r + row0;
  float* ob = out + (b * r + row0) * 3;
  int* si = rows_idx[warp];
  if (rows == kRowsPerWarp && aligned16(ib)) {
    const int4 i4 = reinterpret_cast<const int4*>(ib)[lane];
    reinterpret_cast<int4*>(si)[lane] =
        make_int4(clamp_index(i4.x, n) * 3, clamp_index(i4.y, n) * 3, clamp_index(i4.z, n) * 3,
                  clamp_index(i4.w, n) * 3);
  } else {
    for (int j = lane; j < rows; j += 32) si[j] = clamp_index(ib[j], n) * 3;
  }
  __syncwarp();
  if (rows == kRowsPerWarp) {
    float x[3 * kRowsPerWarp / 32];
#pragma unroll
    for (int k = 0; k < 3 * kRowsPerWarp / 32; ++k) {
      const int e = 32 * k + lane;
      const int row = e / 3;
      x[k] = __ldg(f + si[row] + (e - 3 * row));
    }
#pragma unroll
    for (int k = 0; k < 3 * kRowsPerWarp / 32; ++k) ob[32 * k + lane] = x[k];
  } else {
    for (int e = lane; e < 3 * rows; e += 32) {
      const int row = e / 3;
      ob[e] = __ldg(f + si[row] + (e - 3 * row));
    }
  }
}

constexpr int kTileRows = 32;  // rows a warp takes: an index a lane
constexpr int kBatch = 16;     // units a lane loads before it stores them

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_tile_kernel(const T* __restrict__ features, const int32_t* __restrict__ idx,
                   T* __restrict__ out, int n, int r, int units) {
  const int lane = threadIdx.x & 31;
  const int row0 = (blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5)) * kTileRows;
  if (row0 >= r) return;
  const int total = min(kTileRows, r - row0) * units;  // this tile's units
  const long long b = blockIdx.y;
  const T* f = features + b * n * units;
  const int32_t* ib = idx + b * r + row0;
  T* o = out + (b * r + row0) * units;
  const int start = lane < total / units ? clamp_index(__ldg(ib + lane), n) * units : 0;
  // unit u = lane + 32 k lies in row u / units at u % units; k + 1 moves
  // the lane on 32 units, so its row and place step without a division
  const int row_step = 32 / units, unit_step = 32 % units;
  int row = lane / units, unit = lane % units;
  for (int k0 = 0; k0 < units; k0 += kBatch) {  // a full tile is 32 * units units
    T x[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int u = lane + 32 * (k0 + j);
      const int src = __shfl_sync(0xffffffffu, start, row);
      if (k0 + j < units && u < total) x[j] = __ldg(f + src + unit);
      row += row_step;
      unit += unit_step;
      if (unit >= units) {
        unit -= units;
        ++row;
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int u = lane + 32 * (k0 + j);
      if (k0 + j < units && u < total) __stcs(o + u, x[j]);
    }
  }
}

template <typename T>
void launch_tile(const T* features, const int32_t* idx, T* out, int b, int n, int r, int units,
                 cudaStream_t stream) {
  const int rows_per_block = kThreads / 32 * kTileRows;
  const dim3 grid((unsigned)((r + rows_per_block - 1) / rows_per_block), (unsigned)b);
  gather_tile_kernel<T><<<grid, kThreads, 0, stream>>>(features, idx, out, n, r, units);
}

}  // namespace

extern "C" int coda_gather(const float* features, const int32_t* idx, float* out,
                           int b, int n, int r, int c, cudaStream_t stream) {
  if (b == 0 || r == 0 || c == 0) return (int)cudaSuccess;
  if (b > 65535 || n < 1 || (long long)r * c > 0x7fffffffLL || (long long)n * c > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (c == 3) {
    const int rows_per_block = kThreads / 32 * kRowsPerWarp;
    const dim3 grid((unsigned)((r + rows_per_block - 1) / rows_per_block), (unsigned)b);
    gather3_kernel<<<grid, kThreads, 0, stream>>>(features, idx, out, n, r);
  } else if (c % 4 == 0 && aligned16(features) && aligned16(out)) {
    launch_tile(reinterpret_cast<const float4*>(features), idx, reinterpret_cast<float4*>(out),
                b, n, r, c / 4, stream);
  } else {
    launch_tile(features, idx, out, b, n, r, c, stream);
  }
  return (int)cudaGetLastError();
}
