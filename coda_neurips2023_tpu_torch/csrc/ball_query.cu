// Kernel B: ball query, (B, N, 3) points x (B, M, 3) centres -> (B, M, k) int32,
// on a spatial cell grid, and the grid's build (shared with kernel F).
//
// Replaces coda_neurips2023_tpu/ops/pallas_ball_query_sorted.py ::
// ball_query_pallas_sorted and its fallback, pallas_ball_query.py ::
// ball_query_pallas_v3.  Semantics (ops/grouping.py:7-12): for each centre,
// the first k point indices, in index order, with squared distance < r^2;
// trailing slots are filled with the first hit; a row with no hit is all
// zeros.  r^2 arrives already rounded to f32 from the Python float(r)**2.
//
// What bounded the scan this replaces: one warp a centre read the scene in
// index order up to its k-th hit, and at r = 0.2 most centres never fill,
// so nearly all of B*M*N distance tests ran (1.3e9 at the eval shape).  The
// JAX sorted kernel cut that work with a sort along one axis and a window of
// candidates; here a cell grid cuts it to the points of the cells around a
// centre (ball_query_grid.cuh), tens instead of 20,000.
//
// The build, per call (ops/grouping.py :: grid_build):
//   1. grid_cells_kernel, one block a scene: the bounding box; the cell side,
//      the first of side0 * 2^j (exact f32 doublings) that gives at most
//      `cap` cells, one cell after 64 sides; and every point's key, the
//      scene's index times `stride` (cap + 1) plus its cell id;
//   2. a stable torch.sort of the B * N keys as one array in the wrapper (the
//      JAX package also sorts outside its kernel, with an XLA argsort), so
//      the points of a cell stay in index order;
//   3. grid_pack_kernel, one thread a slot and a cell: the points in that
//      order as float4 (x, y, z, original index), and each cell's first
//      slot by a binary search of the sorted keys.
// The side rule and the cell function are the plain version's
// (grouping.py :: grid_params_plain, _cell_coord) op for op in f32 with
// round-to-nearest intrinsics, so both build the same grid.
//
// Kernel G (ball_query_tile.cu) builds the same grid with its centres
// (m > 0): the cells kernel also gives each centre the key (b + scene) *
// stride + the Morton key of its own cell (grouping.py :: _tile_key_bits,
// _tile_keys_plain), after the points' keys in the same array, so the one
// sort also orders each scene's centres, and every point key stays below
// every centre key; the pack kernel then writes each scene's centres in that
// order as float4 (x, y, z, the bits of their row scene * m + index).

#include "ball_query_grid.cuh"

namespace {

constexpr int kCellThreads = 512;
constexpr int kPackThreads = 256;
constexpr int kDoublings = 64;
constexpr float kAxisCells = 1048576.0f;  // 2^20: an axis's count saturates here

// The Morton key of a centre's cell: the coordinates shifted right by
// `shift`, their low `bits` interleaved from the lowest, x, y, z in turn, an
// axis dropping out once its bits are spent (grouping.py :: _tile_keys_plain).
__device__ __forceinline__ int morton_key(const int (&c)[3], int4 bits, int4 shift) {
  const int q[3] = {c[0] >> shift.x, c[1] >> shift.y, c[2] >> shift.z};
  const int nb[3] = {bits.x, bits.y, bits.z};
  int key = 0, pos = 0;
  for (int j = 0; j < bits.w; ++j) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      if (j < nb[a]) key |= ((q[a] >> j) & 1) << pos++;
    }
  }
  return key;
}

__global__ void __launch_bounds__(kCellThreads)
grid_cells_kernel(const float* __restrict__ xyz, const float* __restrict__ centres,
                  float4* __restrict__ fparams, int4* __restrict__ iparams,
                  int32_t* __restrict__ keys, int n, int m, float side0, int cap) {
  __shared__ float s_red[6][kCellThreads / 32];
  __shared__ float4 s_fp;
  __shared__ int4 s_ip;
  __shared__ int4 s_bits, s_shift;  // the centres' Morton key (w: the most bits an axis has)
  const int bi = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* p = xyz + (size_t)bi * n * 3;

  float v[6] = {INFINITY, INFINITY, INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int i = threadIdx.x; i < n; i += kCellThreads) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float x = p[3 * i + a];
      v[a] = fminf(v[a], x);
      v[3 + a] = fmaxf(v[3 + a], x);
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const float o = __shfl_xor_sync(bq_grid::kFull, v[a], d);
      v[a] = a < 3 ? fminf(v[a], o) : fmaxf(v[a], o);
    }
    if (lane == 0) s_red[a][warp] = v[a];
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float lo[3], ext[3];
    for (int a = 0; a < 3; ++a) {
      float mn = s_red[a][0], mx = s_red[3 + a][0];
      for (int w = 1; w < kCellThreads / 32; ++w) {
        mn = fminf(mn, s_red[a][w]);
        mx = fmaxf(mx, s_red[3 + a][w]);
      }
      lo[a] = mn;
      ext[a] = __fsub_rn(mx, mn);
    }
    float s = side0, inv = 0.0f;
    int g[3] = {1, 1, 1};
    bool fits = false;
    for (int j = 0; j < kDoublings && !fits; ++j) {
      inv = __fdiv_rn(1.0f, s);
      long long total = 1;
      for (int a = 0; a < 3; ++a) {
        const float t = floorf(__fmul_rn(ext[a], inv));
        g[a] = (t < kAxisCells ? (int)t : (int)kAxisCells) + 1;
        total *= g[a];
      }
      fits = total <= cap;
      s = __fmul_rn(s, 2.0f);
    }
    if (!fits) {
      inv = __fdiv_rn(1.0f, side0);
      g[0] = g[1] = g[2] = 1;
    }
    s_fp = make_float4(lo[0], lo[1], lo[2], inv);
    s_ip = make_int4(g[0], g[1], g[2], g[0] * g[1] * g[2]);
    fparams[bi] = s_fp;
    iparams[bi] = s_ip;
    // the key's bits: while the axes' bit lengths add up to more than
    // floor(log2(stride)), the longest (x before y before z) gives one up,
    // so every key lies below the scene's stride
    int full[3], bits[3];
    for (int a = 0; a < 3; ++a) full[a] = bits[a] = 32 - __clz(g[a] - 1);
    const int budget = 31 - __clz(cap + 1);
    while (bits[0] + bits[1] + bits[2] > budget) {
      if (bits[0] >= bits[1] && bits[0] >= bits[2]) --bits[0];
      else if (bits[1] >= bits[2]) --bits[1];
      else --bits[2];
    }
    s_bits = make_int4(bits[0], bits[1], bits[2], max(bits[0], max(bits[1], bits[2])));
    s_shift = make_int4(full[0] - bits[0], full[1] - bits[1], full[2] - bits[2], 0);
  }
  __syncthreads();
  const float4 fp = s_fp;
  const int4 ip = s_ip;
  int32_t* key = keys + (size_t)bi * n;
  const int scene = bi * (cap + 1);
  for (int i = threadIdx.x; i < n; i += kCellThreads) {
    const int cx = bq_grid::cell_coord(p[3 * i], fp.x, fp.w, ip.x);
    const int cy = bq_grid::cell_coord(p[3 * i + 1], fp.y, fp.w, ip.y);
    const int cz = bq_grid::cell_coord(p[3 * i + 2], fp.z, fp.w, ip.z);
    key[i] = scene + (cz * ip.y + cy) * ip.x + cx;
  }
  if (m == 0) return;
  const float* c = centres + (size_t)bi * m * 3;
  int32_t* ckey = keys + (size_t)gridDim.x * n + (size_t)bi * m;
  const int cscene = (gridDim.x + bi) * (cap + 1);
  for (int j = threadIdx.x; j < m; j += kCellThreads) {
    const int cell[3] = {bq_grid::cell_coord(c[3 * j], fp.x, fp.w, ip.x),
                         bq_grid::cell_coord(c[3 * j + 1], fp.y, fp.w, ip.y),
                         bq_grid::cell_coord(c[3 * j + 2], fp.z, fp.w, ip.z)};
    ckey[j] = cscene + morton_key(cell, s_bits, s_shift);
  }
}

__global__ void __launch_bounds__(kPackThreads)
grid_pack_kernel(const float* __restrict__ xyz, const float* __restrict__ centres,
                 const int32_t* __restrict__ skeys, const int64_t* __restrict__ perm,
                 const int4* __restrict__ iparams, float4* __restrict__ pts,
                 int32_t* __restrict__ starts, float4* __restrict__ sorted_centres, int b, int n,
                 int m, int stride) {
  const long long t = (long long)blockIdx.x * kPackThreads + threadIdx.x;
  const long long slots = (long long)b * n;
  if (t < slots) {  // slot t: the point sorted there
    const int bi = (int)(t / n);
    const long long src = perm[t];  // bi * n + the original index
    const float* q = xyz + src * 3;
    pts[t] = make_float4(q[0], q[1], q[2], __int_as_float((int)(src - (long long)bi * n)));
  } else if (t < slots + (long long)b * m) {  // the centres, after every point
    const long long row = perm[t] - slots;  // bi * m + the centre's index
    const float* q = centres + row * 3;
    sorted_centres[t - slots] = make_float4(q[0], q[1], q[2], __int_as_float((int)row));
  }
  if (t < (long long)b * stride) {  // cell entry t: its first slot
    const int bi = (int)(t / stride);
    const int c = (int)(t - (long long)bi * stride);
    if (c > iparams[bi].w) return;
    // the first of the scene's sorted keys at or past bi * stride + c: a
    // binary search, so an empty stretch of cells costs no thread more
    const int32_t* seg = skeys + (size_t)bi * n;
    const int target = bi * stride + c;
    int lo = 0, hi = n;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (seg[mid] < target) lo = mid + 1; else hi = mid;
    }
    starts[t] = lo;
  }
}

}  // namespace

// centres may be null with m = 0 (kernels B and F), and sorted_centres with it.
extern "C" int coda_bq_grid_cells(const float* xyz, const float* centres, float* fparams,
                                  int32_t* iparams, int32_t* keys, int b, int n, int m,
                                  float side0, int cap, cudaStream_t stream) {
  if (b == 0) return (int)cudaSuccess;
  grid_cells_kernel<<<b, kCellThreads, 0, stream>>>(
      xyz, centres, reinterpret_cast<float4*>(fparams), reinterpret_cast<int4*>(iparams), keys,
      n, m, side0, cap);
  return (int)cudaGetLastError();
}

extern "C" int coda_bq_grid_pack(const float* xyz, const float* centres, const int32_t* skeys,
                                 const int64_t* perm, const int32_t* iparams, float* pts,
                                 int32_t* starts, float* sorted_centres, int b, int n, int m,
                                 int stride, cudaStream_t stream) {
  const long long slots = (long long)b * (n + m), entries = (long long)b * stride;
  const long long threads = slots > entries ? slots : entries;
  if (threads == 0) return (int)cudaSuccess;
  const long long blocks = (threads + kPackThreads - 1) / kPackThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  grid_pack_kernel<<<(unsigned)blocks, kPackThreads, 0, stream>>>(
      xyz, centres, skeys, perm, reinterpret_cast<const int4*>(iparams),
      reinterpret_cast<float4*>(pts), starts, reinterpret_cast<float4*>(sorted_centres), b, n,
      m, stride);
  return (int)cudaGetLastError();
}

extern "C" int coda_ball_query(const float* pts, const int32_t* starts, const float* fparams,
                               const int32_t* iparams, const float* centres, int32_t* out, int b,
                               int n, int m, int k, int stride, float r2, float rw,
                               cudaStream_t stream) {
  return bq_grid::launch_query<false>(pts, starts, fparams, iparams, centres, nullptr, out,
                                      nullptr, b, n, m, k, stride, r2, rw, stream);
}
