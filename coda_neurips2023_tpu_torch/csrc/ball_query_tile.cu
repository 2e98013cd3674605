// Kernel G: ball query, (B, N, 3) points x (B, M, 3) centres -> (B, M, k) int32,
// for a tile of nearby centres at once on kernel B's cell grid.
//
// Replaces coda_neurips2023_tpu/ops/pallas_ball_query.py :: ball_query_pallas
// (the "adaptive" kernel, CODA_BQ_ALGO=adaptive) and
// pallas_ball_query_mxu.py :: ball_query_pallas_mxu (CODA_BQ_MXU=1, k = 64).
// Same function as kernel B (ball_query.cu): for each centre, the first k
// point indices, in index order, with squared distance < r^2; trailing slots
// repeat the first hit; a row with no hit is all zeros.
//
// The TPU kernels share one staged chunk of the scene among many centres.
// Here the chunk is what a tile of nearby centres reads, no more:
//   1. the build (ball_query.cu, ops/grouping.py :: grid_build, with the
//      centres): B's grid (points as float4 (x, y, z, index) ordered by
//      (cell, index), each cell's first slot), and in the same sort each
//      scene's centres ordered by the Morton key of their own cell, written
//      as float4 (x, y, z, row);
//   2. this query: a block takes T consecutive centres of that order (a
//      tile; T = 8 on the paths, 16, 32 and 64 for the bench; 8 warps).
//      Each centre reads the cells of its widened box, rounded outward,
//      with B's cell function, so no hit is missed (ops/grouping.py's
//      docstring).  The tile's union is the (y, z) rows some centre reads,
//      each one contiguous run of slots from the least to the greatest x
//      cell those centres read on it.  Each thread stages one row's run
//      into a ring of two shared-memory stages by asynchronous copy, all
//      completing on the stage's mbarrier: a run of kBulkMin points or more
//      by one 1-D bulk copy (TMA's cp.async.bulk), a shorter one (the
//      median run holds 5 points) by 16-byte cp.async; the next chunk is in
//      flight while the warps test one.
//   3. A warp serves T / 8 centres in turn.  A centre tests its own cells
//      among the staged points (their slots, from B's `starts`, placed in
//      the staged runs of its rows), packed 32 candidates a step, with B's
//      round-to-nearest distance, and __ballot_sync marks the hits.  The
//      runs are not in index order, so each centre keeps its hits in a
//      buffer of twice the rounded k in shared memory and reduces it to its
//      k smallest original indices by rank when it fills (B's keep_smallest,
//      the JAX sorted kernel's extraction by minimum index), dropping later
//      hits at or above the k-th; a clump of thousands of hits stays exact.
//      No early stop by count: off index order it would be wrong.  The
//      result goes to the centre's own row.
//
// Bound on the card: the bytes (the points once, the indices once) and the
// distance tests.  The old G, a scan in index order (now
// scripts/ball_query_variants.cu), ran nearly all B*M*N tests, since most
// centres at r = 0.2 never fill.  Here a centre tests B's candidates (23 on
// the synthetic scenes at a cell side of the widened radius), and a tile
// of 8 stages about 19 points a centre from L2, where B loads each
// centre's candidates one warp a centre, as a chain of dependent loads.
// What bounds G on the card is each block's chain (its centres, its rows'
// first slots, the copies, the tests), most of all in a dense tile, which
// stages thousands of points through one block (PERF.md).

#include "ball_query_grid.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;  // chunks in flight: kStages - 1 while one is tested
constexpr int kStagePoints = 512;  // float4 slots a stage (8 KB)
// the shortest run staged by one bulk copy, in points (runs of 1, 8, 32 or
// 128 points and up, or none, measured alike: PERF.md)
constexpr int kBulkMin = 32;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cta.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// `bytes` more expected on `bar` this phase (no arrival)
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// 16 bytes from global to shared memory by the executing thread (L2 only)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

// `bar` gets this thread's arrival once its cp.async copies so far have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// This thread's piece of one chunk, positions [from, to) of the pass's runs
// laid end to end: the part of its own run (positions [run, run + len),
// slots from `beg` in the grid) that falls in it, by one bulk copy if the
// run is long, else a cp.async a point; then its arrival on `bar`.
__device__ __forceinline__ void stage_piece(float4* stage, uint64_t* bar, const float4* sp,
                                            int from, int to, int run, int len, int beg) {
  const int lo = max(from, run), hi = min(to, run + len);
  if (lo < hi) {
    const float4* src = sp + beg + (lo - run);
    float4* dst = stage + (lo - from);
    if (len >= kBulkMin) {
      const uint32_t bytes = (uint32_t)(hi - lo) * sizeof(float4);
      mbar_expect_tx(bar, bytes);
      bulk_copy(dst, src, bytes, bar);
    } else {
      for (int p = 0; p < hi - lo; ++p) cp_async16(dst + p, src + p);
    }
  }
  cp_async_arrive(bar);
}

#ifdef CODA_TILE_CLOCKS
// A measurement build's marks (scripts/bench_ball_query_variants.py builds
// of the first kClockBlocks blocks, %globaltimer at its start (mark 0) and
// end (6), clock64 at its start (1), once its first pass's runs are known
// (2), once its first chunk has landed (3), after its last test (4) and at
// its end (5), and its SM (7).
constexpr int kClockBlocks = 1 << 16;
constexpr int kClockMarks = 8;
__device__ long long tile_clocks[kClockBlocks * kClockMarks];

__device__ __forceinline__ void clock_mark(int mark, bool global_time) {
  const long long blk = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  if (threadIdx.x != 0 || blk >= kClockBlocks) return;
  long long t = clock64();
  if (global_time) asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  tile_clocks[blk * kClockMarks + mark] = t;
  if (mark == 0) {
    int sm;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
    tile_clocks[blk * kClockMarks + 7] = sm;
  }
}
#define TILE_MARK(mark, global_time) clock_mark(mark, global_time)
#define TILE_END() (__syncthreads(), clock_mark(5, false), clock_mark(6, true))
#else
#define TILE_MARK(mark, global_time)
#define TILE_END()
#endif

// Shared memory of a block, in this order: the stages, the tile's centres,
// the stages' mbarriers, the centres' cell ranges, the rows of a pass, the
// warps' sums and parts, a warp's rows, each centre's cells in a pass's
// runs, hit count and bound, a hit buffer per centre and a scratch buffer
// per warp.
__host__ __device__ constexpr size_t smem_bytes(int tile, int buf_len) {
  return sizeof(float4) * (kStages * kStagePoints + tile) + sizeof(uint64_t) * kStages +
         sizeof(int) * (72 * tile + 2 * kThreads + 68 * kWarps +
                        (size_t)(tile + kWarps) * buf_len);
}

template <int T>
__global__ void __launch_bounds__(kThreads)
tile_query_kernel(const float4* __restrict__ pts, const int32_t* __restrict__ starts,
                  const float4* __restrict__ fparams, const int4* __restrict__ iparams,
                  const float4* __restrict__ sorted_centres, int32_t* __restrict__ out, int n,
                  int m, int k, int stride, int buf_len, float r2, float rw) {
  constexpr int kPer = T / kWarps;  // centres a warp
  constexpr int kBoxWarps = (T + 31) / 32;  // the warps holding the centres' cells
  extern __shared__ __align__(16) unsigned char smem[];
  float4* stage = reinterpret_cast<float4*>(smem);
  float4* ctr = stage + kStages * kStagePoints;  // the tile's centres (x, y, z, row)
  uint64_t* full = reinterpret_cast<uint64_t*>(ctr + T);
  int* box = reinterpret_cast<int*>(full + kStages);  // x0, x1, y0, y1, z0, z1: T each
  int* span_beg = box + 6 * T;          // a pass's row: its run's first slot in the grid,
  int* span_end = span_beg + kThreads;  // and its end in the pass's runs laid end to end
  int* warp_sum = span_end + kThreads;  // kWarps; the bounding rows' partials, 4 a warp
  int* row_at = warp_sum + 4 * kWarps + 64 * (threadIdx.x >> 5);  // a centre's rows in a
  int* row_end = row_at + 32;                                     // chunk: start, prefix
  int* own = warp_sum + 4 * kWarps + 64 * kWarps;  // a centre's cells on each of its rows:
                                                   // 32 starts, 32 ends in a pass's runs
  int* cnt = own + 64 * T;  // a centre's hits so far
  int* below = cnt + T;  // the bound a hit's index must stay below (-1: a padding centre)
  int* bufs = below + T;
  int* scratch = bufs + T * buf_len + (threadIdx.x >> 5) * buf_len;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const int bi = blockIdx.y;
  const int first = blockIdx.x * T;  // the tile's first centre in the scene's order
  const float4 fp = fparams[bi];
  const int4 ip = iparams[bi];
  const float4* sp = pts + (size_t)bi * n;
  const int32_t* st = starts + (size_t)bi * stride;

  TILE_MARK(0, true);
  TILE_MARK(1, false);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (warp < kBoxWarps) {  // each centre's cells; a padding centre's range is empty
    int x0 = INT_MAX, x1 = -1, y0 = INT_MAX, y1 = -1, z0 = INT_MAX, z1 = -1;
    float4 c = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(-1));
    if (tid < T && first + tid < m) {
      c = sorted_centres[(size_t)bi * m + first + tid];
      x0 = bq_grid::cell_coord(nextafterf(__fsub_rn(c.x, rw), -INFINITY), fp.x, fp.w, ip.x);
      x1 = bq_grid::cell_coord(nextafterf(__fadd_rn(c.x, rw), INFINITY), fp.x, fp.w, ip.x);
      y0 = bq_grid::cell_coord(nextafterf(__fsub_rn(c.y, rw), -INFINITY), fp.y, fp.w, ip.y);
      y1 = bq_grid::cell_coord(nextafterf(__fadd_rn(c.y, rw), INFINITY), fp.y, fp.w, ip.y);
      z0 = bq_grid::cell_coord(nextafterf(__fsub_rn(c.z, rw), -INFINITY), fp.z, fp.w, ip.z);
      z1 = bq_grid::cell_coord(nextafterf(__fadd_rn(c.z, rw), INFINITY), fp.z, fp.w, ip.z);
    }
    if (tid < T) {
      ctr[tid] = c;
      cnt[tid] = 0;
      below[tid] = __float_as_int(c.w) >= 0 ? INT_MAX : -1;
      box[tid] = x0;
      box[T + tid] = x1;
      box[2 * T + tid] = y0;
      box[3 * T + tid] = y1;
      box[4 * T + tid] = z0;
      box[5 * T + tid] = z1;
    }
    // the tile's bounding rows: this warp's part
    const int ylo = __reduce_min_sync(bq_grid::kFull, y0), yhi = __reduce_max_sync(bq_grid::kFull, y1);
    const int zlo = __reduce_min_sync(bq_grid::kFull, z0), zhi = __reduce_max_sync(bq_grid::kFull, z1);
    if (lane < 4) {
      warp_sum[kWarps + 4 * warp + lane] = lane == 0 ? ylo : lane == 1 ? yhi : lane == 2 ? zlo : zhi;
    }
  }
  __syncthreads();
  int uy0 = INT_MAX, uy1 = -1, uz0 = INT_MAX, uz1 = -1;
#pragma unroll
  for (int w = 0; w < kBoxWarps; ++w) {
    uy0 = min(uy0, warp_sum[kWarps + 4 * w]);
    uy1 = max(uy1, warp_sum[kWarps + 4 * w + 1]);
    uz0 = min(uz0, warp_sum[kWarps + 4 * w + 2]);
    uz1 = max(uz1, warp_sum[kWarps + 4 * w + 3]);
  }
  const int wy = uy1 - uy0 + 1;
  const int rows = wy * (uz1 - uz0 + 1);

  uint32_t g = 0;  // chunks tested so far: stage g % kStages, parity (g / kStages) & 1
  for (int r0 = 0; r0 < rows; r0 += kThreads) {
    // a pass over rows r0 on, a thread a row: the least and greatest x cell
    // the tile's centres read on it, by atomics from each centre's rows
    span_beg[tid] = INT_MAX;
    span_end[tid] = -1;
    __syncthreads();
    if (tid < T && below[tid] >= 0) {
      const int x0 = box[tid], x1 = box[T + tid];
      for (int z = box[4 * T + tid]; z <= box[5 * T + tid]; ++z) {
        for (int y = box[2 * T + tid]; y <= box[3 * T + tid]; ++y) {
          const int ur = (z - uz0) * wy + (y - uy0) - r0;
          if (ur >= 0 && ur < kThreads) {
            atomicMin(&span_beg[ur], x0);
            atomicMax(&span_end[ur], x1);
          }
        }
      }
    }
    __syncthreads();
    // the row's run of slots (none if no centre reads it)
    int beg = 0, len = 0;
    if (span_end[tid] >= 0) {
      const int y = uy0 + (r0 + tid) % wy, z = uz0 + (r0 + tid) / wy;
      const int base = (z * ip.y + y) * ip.x;
      beg = st[base + span_beg[tid]];
      len = st[base + span_end[tid] + 1] - beg;
    }
    int incl = len;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(bq_grid::kFull, incl, d);
      if (lane >= d) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    int total = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w == warp) incl += total;
      total += warp_sum[w];
    }
    span_beg[tid] = beg;
    span_end[tid] = incl;
    if (r0 == 0) TILE_MARK(2, false);
    __syncthreads();  // the pass's runs are known to every warp

    // the pass's runs end to end, cut into chunks of a stage; chunks c + 1
    // to c + kStages - 1 are in flight while every warp tests chunk c, each
    // thread copying its own row's piece of a chunk
    const int chunks = (total + kStagePoints - 1) / kStagePoints;
    for (int c = 0; c < min(chunks, kStages - 1); ++c) {
      const int s = (g + c) % kStages;
      stage_piece(stage + s * kStagePoints, &full[s], sp, c * kStagePoints,
                  min(total, (c + 1) * kStagePoints), incl - len, len, beg);
    }

    // each of the warp's centres, a lane a row of its cells (at most 16
    // with a cell side of at least the widened radius): the slots of its x
    // cells there, from B's `starts`, placed in the pass's runs
    {
      int lo[kPer], hi[kPer];
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int j = warp * kPer + e;
        const int y0 = box[2 * T + j], wye = box[3 * T + j] - y0 + 1, z0 = box[4 * T + j];
        lo[e] = hi[e] = 0;
        if (below[j] >= 0 && lane < wye * (box[5 * T + j] - z0 + 1)) {
          const int y = y0 + lane % wye, z = z0 + lane / wye;
          const int ur = (z - uz0) * wy + (y - uy0) - r0;
          if (ur >= 0 && ur < kThreads) {
            const int base = (z * ip.y + y) * ip.x;
            // row ur's run starts at pass position span_end[ur - 1], grid slot span_beg[ur]
            const int shift = (ur ? span_end[ur - 1] : 0) - span_beg[ur];
            lo[e] = st[base + box[j]] + shift;
            hi[e] = st[base + box[T + j] + 1] + shift;
          }
        }
      }
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        own[(warp * kPer + e) * 64 + lane] = lo[e];
        own[(warp * kPer + e) * 64 + 32 + lane] = hi[e];
      }
      __syncwarp();
    }

    for (int c = 0; c < chunks; ++c, ++g) {
      const int from = c * kStagePoints, to = min(total, from + kStagePoints);
      if (c + kStages - 1 < chunks) {
        // the stage chunk c + kStages - 1 takes was last read by chunk
        // c - 1, which every thread finished before the barrier that ended it
        const int s = (g + kStages - 1) % kStages;
        const int next = (c + kStages - 1) * kStagePoints;
        stage_piece(stage + s * kStagePoints, &full[s], sp, next,
                    min(total, next + kStagePoints), incl - len, len, beg);
      }
      mbar_wait(&full[g % kStages], (g / kStages) & 1u);
      if (c == 0) TILE_MARK(3, false);
      const float4* chunk = stage + (g % kStages) * kStagePoints;
      // the warp's centres in turn, each over its own cells cut to this chunk
      for (int e = 0; e < kPer; ++e) {
        const int j = warp * kPer + e;
        int below_e = below[j];
        if (below_e < 0) continue;  // a padding centre
        int cnt_e = cnt[j];
        const float4 ce = ctr[j];
        const int nrows = (box[3 * T + j] - box[2 * T + j] + 1) * (box[5 * T + j] - box[4 * T + j] + 1);
        const int a = max(from, own[j * 64 + lane]);
        const int piece = max(0, min(to, own[j * 64 + 32 + lane]) - a);
        int pincl = piece;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int v = __shfl_up_sync(bq_grid::kFull, pincl, d);
          if (lane >= d) pincl += v;
        }
        row_at[lane] = a - from;
        row_end[lane] = pincl;
        const int cand = __shfl_sync(bq_grid::kFull, pincl, 31);
        const int used = min(32, nrows);  // lanes that carry a row
        int* buf = bufs + j * buf_len;
        __syncwarp();
        for (int p0 = 0; p0 < cand; p0 += 32) {
          const int p = p0 + lane;
          float4 q = make_float4(0.0f, 0.0f, 0.0f, __int_as_float(INT_MAX));  // never kept
          if (p < cand) {
            int s = 0;  // the row holding candidate p: rows ending at or before it
            for (int i = 0; i < used; ++i) s += row_end[i] <= p;
            q = chunk[row_at[s] + p - (s ? row_end[s - 1] : 0)];
          }
          const int idx = __float_as_int(q.w);
          bool hit = idx < below_e && bq_grid::sq_dist(ce.x, ce.y, ce.z, q) < r2;
          unsigned mask = __ballot_sync(bq_grid::kFull, hit);
          if (mask == 0u) continue;
          if (cnt_e + 32 > buf_len) {  // full: keep the k smallest
            cnt_e = bq_grid::keep_smallest(buf, cnt_e, scratch, k, lane);
            for (int i = lane; i < cnt_e; i += 32) buf[i] = scratch[i];
            __syncwarp();
            if (cnt_e == k) below_e = buf[k - 1];
            hit = hit && idx < below_e;
            mask = __ballot_sync(bq_grid::kFull, hit);
          }
          if (hit) buf[cnt_e + __popc(mask & lower)] = idx;
          cnt_e += __popc(mask);
          __syncwarp();
        }
        if (lane == 0) {
          cnt[j] = cnt_e;
          below[j] = below_e;
        }
        __syncwarp();  // the rows and the state are read before the next centre's land
      }
      __syncthreads();
    }
    __syncthreads();  // the pass's runs and sums are read before the next pass
  }
  TILE_MARK(4, false);

  for (int e = 0; e < kPer; ++e) {
    const int j = warp * kPer + e;
    if (below[j] < 0) continue;  // a padding centre
    const int kept = bq_grid::keep_smallest(bufs + j * buf_len, cnt[j], scratch, k,
                                            lane);  // ascending in scratch
    const int first_hit = kept > 0 ? scratch[0] : 0;
    int32_t* o = out + (size_t)__float_as_int(ctr[j].w) * k;
    for (int s = lane; s < k; s += 32) o[s] = s < kept ? scratch[s] : first_hit;
    __syncwarp();  // scratch is read before the next centre's ranks land there
  }
  TILE_END();
}

// The hit buffer holds twice min(k, n) rounded up to 32 entries (at least
// k + 32, so a full buffer always has room after keeping k); a block above
// 48 KB of shared memory asks for it first.
template <int T>
int launch_tile(const float* pts, const int32_t* starts, const float* fparams,
                const int32_t* iparams, const float* sorted_centres, int32_t* out, int b, int n,
                int m, int k, int stride, float r2, float rw, cudaStream_t stream) {
  const long long tiles = ((long long)m + T - 1) / T;
  if (b == 0 || tiles == 0) return (int)cudaSuccess;
  if (tiles > 0x7fffffffLL || b > 65535) return (int)cudaErrorInvalidValue;
  const int kk = ((k < n ? k : n) + 31) / 32 * 32;
  const int buf_len = 2 * kk;
  const size_t bytes = smem_bytes(T, buf_len);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        tile_query_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  tile_query_kernel<T><<<dim3((unsigned)tiles, (unsigned)b), kThreads, bytes, stream>>>(
      reinterpret_cast<const float4*>(pts), starts, reinterpret_cast<const float4*>(fparams),
      reinterpret_cast<const int4*>(iparams), reinterpret_cast<const float4*>(sorted_centres),
      out, n, m, k, stride, buf_len, r2, rw);
  return (int)cudaGetLastError();
}

}  // namespace

#ifdef CODA_TILE_CLOCKS
// The measurement build's marks of the last launch, kClockMarks a block, and
// their reset to zero before a launch.
extern "C" int coda_tile_clocks(long long* host, int blocks) {
  const size_t count = (size_t)(blocks < kClockBlocks ? blocks : kClockBlocks) * kClockMarks;
  return (int)cudaMemcpyFromSymbol(host, tile_clocks, sizeof(long long) * count);
}

extern "C" int coda_tile_clocks_reset() {
  void* p = nullptr;
  const cudaError_t err = cudaGetSymbolAddress(&p, tile_clocks);
  return err != cudaSuccess ? (int)err : (int)cudaMemset(p, 0, sizeof(tile_clocks));
}
#endif

// sorted_centres: each scene's centres in tile order as float4 (x, y, z,
// row scene * m + index), from the build's pack kernel; tile: 8, 16, 32 or
// 64 centres a block.
extern "C" int coda_ball_query_tile(const float* pts, const int32_t* starts,
                                    const float* fparams, const int32_t* iparams,
                                    const float* sorted_centres, int32_t* out, int b, int n,
                                    int m, int k, int stride, float r2, float rw, int tile,
                                    cudaStream_t stream) {
  switch (tile) {
    case 8:
      return launch_tile<8>(pts, starts, fparams, iparams, sorted_centres, out, b, n, m, k,
                            stride, r2, rw, stream);
    case 16:
      return launch_tile<16>(pts, starts, fparams, iparams, sorted_centres, out, b, n, m, k,
                             stride, r2, rw, stream);
    case 32:
      return launch_tile<32>(pts, starts, fparams, iparams, sorted_centres, out, b, n, m, k,
                             stride, r2, rw, stream);
    case 64:
      return launch_tile<64>(pts, starts, fparams, iparams, sorted_centres, out, b, n, m, k,
                             stride, r2, rw, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
