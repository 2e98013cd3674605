// Kernel A: furthest-point sampling, (B, N, 3) f32 -> (B, npoint) int32,
// one thread-block cluster a scene.
//
// Replaces coda_neurips2023_tpu/ops/pallas_fps.py :: fps_pallas (_fps_kernel).
// Semantics (pallas_fps.py:16-20): index 0 is picked first, even when it is
// invalid; points with |p|^2 <= 1e-3 are never picked; the running
// min-distance starts at 1e10; each step picks the valid point with the
// largest min-distance, the lowest index winning ties.
//
// Bound on the card: the npoint steps are sequential, and each ends in an
// arg-max over the scene that every thread must see before the next step
// starts.  A step's floor is its synchronisation, not its 10 operations a
// point.  A scene (240 KB of coordinates at N = 20000) fits neither one
// SM's shared memory nor its registers; so a cluster of CS blocks (CS = 1,
// 2, 4 or 8, chosen by ops/sampling.py :: fps_cluster_size) takes it, each
// block (512 threads, an SM to itself) a contiguous slice of ceil(N / CS)
// points, and each thread keeps its points' x, y, z and running minimum in
// registers for the whole loop (10 points a thread at N = 20000, CS = 4):
// the scene is read once.  A step:
//   1. each thread updates its minima against the last pick and keeps its
//      best (value, index, x, y, z); two warp reductions (redux.sync) find
//      the warp's (value, index), and the lane holding it writes the warp's
//      candidate to shared memory; one block barrier;
//   2. warp 0 finds the block's candidate the same way, and lanes 0 .. CS-1
//      push it into every block of the cluster, itself included, with
//      st.async: a remote store into distributed shared memory that
//      completes bytes on the receiving block's mbarrier;
//   3. each block waits on its own mbarrier for the CS candidates of the
//      step (expect_tx of CS x 20 bytes), and every thread merges them in
//      rank order, so every block reaches the same winner and its
//      coordinates: no global load and no cluster-wide barrier sits on the
//      loop's path.  Rank 0 writes out[b, j].
// The receiving slots and mbarriers are double-buffered by the step's
// parity.  A block pushes step s + 2's candidate only after it has all of
// step s + 1's, and a block pushes step s + 1's only after every one of its
// threads has read step s's slots, so a slot is never overwritten before it
// is read.
//
// Distances are written out as ((dx*dx + dy*dy) + dz*dz) with
// round-to-nearest intrinsics, so nvcc cannot contract them into FMAs: the
// plain PyTorch version computes the same sum in the same order and the two
// agree bit for bit.  Every merge keeps the larger value, then the lower
// index, an order-free rule, so slices, warps and lanes may merge in any
// order and give the plain version's first arg-max.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr uint32_t kCandBytes = 20;  // (value, x, y, z) and the index
// Dynamic shared memory a block reserves and leaves unused, more than half
// an SM's 228 KB, so that no two blocks share an SM: a second block would
// take the issue slots of another scene's sequential loop, and clusters are
// placed one block an SM, as fps_cluster_size assumes.
constexpr int kReservedSmem = 120 * 1024;

__device__ __forceinline__ float sq_dist(float ax, float ay, float az,
                                         float bx, float by, float bz) {
  float dx = __fsub_rn(ax, bx);
  float dy = __fsub_rn(ay, by);
  float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// an unsigned key in the order of the float (no NaN here)
__device__ __forceinline__ uint32_t order_key(float v) {
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The index of the warp's (value, index) arg-max, the lowest index on ties,
// in every lane: two warp reductions (redux.sync), the largest value, then
// the lowest index holding it.
__device__ __forceinline__ int warp_argmax(float v, int i) {
  const uint32_t key = order_key(v);
  const uint32_t top = __reduce_max_sync(0xffffffffu, key);
  return (int)__reduce_min_sync(0xffffffffu, key == top ? (uint32_t)i : 0xffffffffu);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// the same shared-memory variable in block `rank` of the cluster
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void push_candidate(uint32_t cand, uint32_t idx, uint32_t bar,
                                               float4 c, int i) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n"
      :: "r"(cand), "f"(c.x), "f"(c.y), "f"(c.z), "f"(c.w), "r"(bar) : "memory");
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n"
               :: "r"(idx), "r"(i), "r"(bar) : "memory");
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// WORK false keeps the loop's block barrier, pushes, waits and merge and
// drops the points' work and the warp reductions: the loop's floor.
template <int PPT, bool WORK>
__global__ void __launch_bounds__(kThreads, 1)
fps_kernel(const float* __restrict__ xyz, int32_t* __restrict__ out, int n, int npoint,
           int chunk) {
  __shared__ float4 s_part[kWarps];  // a warp's candidate: (value, x, y, z)
  __shared__ int s_part_i[kWarps];
  __shared__ float4 r_cand[2][kMaxCluster];  // the cluster's candidates, by rank
  __shared__ int r_idx[2][kMaxCluster];
  __shared__ __align__(8) uint64_t r_bar[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* pts = xyz + (size_t)b * n * 3;
  int32_t* row_out = out + (size_t)b * npoint;
  const int base = rank * chunk;
  const int end = min(n, base + chunk);

  if (tid == 0) {
    mbar_init(&r_bar[0], 1);
    mbar_init(&r_bar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // An invalid point starts (and, since every distance is >= 0, stays) at
  // -1, its candidate value; a slot past the slice's end holds -2 and never wins.
  float px[PPT], py[PPT], pz[PPT], mind[PPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const int i = base + tid + p * kThreads;
    px[p] = py[p] = pz[p] = 0.0f;
    mind[p] = -2.0f;
    if (WORK && i < end) {
      px[p] = pts[3 * i];
      py[p] = pts[3 * i + 1];
      pz[p] = pts[3 * i + 2];
      const float mag = __fadd_rn(__fadd_rn(__fmul_rn(px[p], px[p]), __fmul_rn(py[p], py[p])),
                                  __fmul_rn(pz[p], pz[p]));
      mind[p] = mag > 1e-3f ? 1e10f : -1.0f;
    }
  }
  if (rank == 0 && tid == 0) row_out[0] = 0;
  cluster_barrier();  // every block's mbarriers exist before the first push

  // lane r < cs of warp 0 pushes to rank r: its slot there, and mbarrier
  uint32_t push_cand[2], push_idx[2], push_bar[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r = lane < cs ? lane : 0;
    push_cand[k] = map_rank(smem_u32(&r_cand[k][rank]), r);
    push_idx[k] = map_rank(smem_u32(&r_idx[k][rank]), r);
    push_bar[k] = map_rank(smem_u32(&r_bar[k]), r);
  }

  float lx = pts[0], ly = pts[1], lz = pts[2];
  for (int j = 1; j < npoint; ++j) {
    const int buf = (j - 1) & 1;
    const uint32_t parity = ((j - 1) >> 1) & 1;
    if (tid == 0) mbar_expect_tx(&r_bar[buf], kCandBytes * cs);
    float4 c = make_float4(-2.0f, 0.0f, 0.0f, 0.0f);
    int ci = n;
    if (WORK) {
      // a slot past the slice holds -2 and the coordinates 0, so it never
      // beats the initial -2: no bounds test
#pragma unroll
      for (int p = 0; p < PPT; ++p) {
        mind[p] = fminf(mind[p], sq_dist(px[p], py[p], pz[p], lx, ly, lz));
        // a thread's indices increase with p, so strict > keeps the first
        if (mind[p] > c.x) {
          c = make_float4(mind[p], px[p], py[p], pz[p]);
          ci = base + tid + p * kThreads;
        }
      }
    }
    // the lowest lane holding the warp's candidate writes it
    int win = WORK ? warp_argmax(c.x, ci) : ci;
    unsigned holder = __ballot_sync(0xffffffffu, ci == win);
    if (lane == __ffs(holder) - 1) {
      s_part[warp] = c;
      s_part_i[warp] = ci;
    }
    __syncthreads();
    if (warp == 0) {
      c = make_float4(-2.0f, 0.0f, 0.0f, 0.0f);
      ci = n;
      if (lane < kWarps) {
        c = s_part[lane];
        ci = s_part_i[lane];
      }
      win = WORK ? warp_argmax(c.x, ci) : ci;
      holder = __ballot_sync(0xffffffffu, ci == win);
      const int src = __ffs(holder) - 1;
      c.x = __shfl_sync(0xffffffffu, c.x, src);
      c.y = __shfl_sync(0xffffffffu, c.y, src);
      c.z = __shfl_sync(0xffffffffu, c.z, src);
      c.w = __shfl_sync(0xffffffffu, c.w, src);
      ci = __shfl_sync(0xffffffffu, ci, src);
      if (lane < cs) push_candidate(push_cand[buf], push_idx[buf], push_bar[buf], c, ci);
    }
    mbar_wait(&r_bar[buf], parity);
    c = r_cand[buf][0];
    ci = r_idx[buf][0];
    for (int r = 1; r < cs; ++r) {
      const float4 o = r_cand[buf][r];
      const int oi = r_idx[buf][r];
      if (o.x > c.x || (o.x == c.x && oi < ci)) {
        c = o;
        ci = oi;
      }
    }
    if (rank == 0 && tid == 0) row_out[j] = ci;
    lx = c.y;
    ly = c.z;
    lz = c.w;
  }
  cluster_barrier();  // no block leaves while a push may still target it
}

// a launch of b clusters of cs blocks; attr outlives cfg's use
void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute (&attr)[1], int b, int cs,
                    cudaStream_t stream) {
  cfg = {};
  cfg.gridDim = dim3((unsigned)(b * cs));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kReservedSmem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

// Clusters of cs blocks the card runs at once (0: none fits), or -error;
// asked once an instantiation and size (the first card's answer), so that
// the query does not cost the host its time at every launch.
template <int PPT, bool WORK>
int resident_clusters(int cs) {
  static const cudaError_t smem = cudaFuncSetAttribute(
      fps_kernel<PPT, WORK>, cudaFuncAttributeMaxDynamicSharedMemorySize, kReservedSmem);
  if (smem != cudaSuccess) return -(int)smem;
  static int known[kMaxCluster + 1] = {};  // clusters + 1; 0: not asked yet
  if (known[cs] == 0) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    cluster_config(cfg, attr, 1, cs, 0);
    int clusters = 0;
    const cudaError_t err = cudaOccupancyMaxActiveClusters(&clusters, fps_kernel<PPT, WORK>, &cfg);
    if (err != cudaSuccess) return -(int)err;
    known[cs] = clusters + 1;
  }
  return known[cs] - 1;
}

template <int PPT, bool WORK>
int launch(const float* xyz, int32_t* out, int b, int n, int npoint, int cs, int chunk,
           cudaStream_t stream) {
  // a cluster this size must fit the card at all, or the launch could not run
  const int clusters = resident_clusters<PPT, WORK>(cs);
  if (clusters < 0) return -clusters;
  if (clusters == 0) return (int)cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  cluster_config(cfg, attr, b, cs, stream);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, fps_kernel<PPT, WORK>, xyz, out, n, npoint,
                                             chunk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Must equal ops/sampling.py :: FPS_CLUSTER_SIZES.
bool valid_cluster(int cs) { return cs == 1 || cs == 2 || cs == 4 || cs == kMaxCluster; }

}  // namespace

// Must equal ops/sampling.py :: FPS_THREADS and FPS_MAX_POINTS_PER_THREAD.
extern "C" int coda_fps(const float* xyz, int32_t* out, int b, int n, int npoint, int cs,
                        cudaStream_t stream) {
  if (b < 1 || n < 1 || npoint < 1 || !valid_cluster(cs) || (long long)b * cs > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int chunk = (n + cs - 1) / cs;
  const int ppt = (chunk + kThreads - 1) / kThreads;
#define CODA_FPS_CASE(P) \
  if (ppt <= P) return launch<P, true>(xyz, out, b, n, npoint, cs, chunk, stream);
  CODA_FPS_CASE(1) CODA_FPS_CASE(2) CODA_FPS_CASE(3) CODA_FPS_CASE(4) CODA_FPS_CASE(5)
  CODA_FPS_CASE(6) CODA_FPS_CASE(8) CODA_FPS_CASE(10) CODA_FPS_CASE(12) CODA_FPS_CASE(16)
  CODA_FPS_CASE(20) CODA_FPS_CASE(24) CODA_FPS_CASE(32) CODA_FPS_CASE(40)
#undef CODA_FPS_CASE
  return (int)cudaErrorInvalidValue;  // more than 40 points a thread
}

// The loop of coda_fps at cluster size cs with the points' work taken out
// (every step's block barrier, pushes, wait and merge): a timing of the
// floor of the sequential loop.  Writes out like coda_fps.
extern "C" int coda_fps_barrier_floor(const float* xyz, int32_t* out, int b, int n, int npoint,
                                      int cs, cudaStream_t stream) {
  if (b < 1 || n < 1 || npoint < 1 || !valid_cluster(cs)) return (int)cudaErrorInvalidValue;
  return launch<1, false>(xyz, out, b, n, npoint, cs, (n + cs - 1) / cs, stream);
}

// How many clusters of cs blocks of kernel A the card runs at once
// (cudaOccupancyMaxActiveClusters, one block an SM): the SMs of a cluster
// share a GPC, so this can fall short of SMs / cs.  A negative value is a
// CUDA error.
extern "C" int coda_fps_resident_clusters(int cs) {
  if (!valid_cluster(cs)) return -(int)cudaErrorInvalidValue;
  return resident_clusters<1, true>(cs);
}
