// Kernel B: ball query, (B, N, 3) points x (B, M, 3) centres -> (B, M, k) int32.
//
// Replaces coda_neurips2023_tpu/ops/pallas_ball_query_sorted.py ::
// ball_query_pallas_sorted and its fallback, pallas_ball_query.py ::
// ball_query_pallas_v3.  Semantics (ops/grouping.py:7-12): for each centre,
// the first k point indices, in index order, with squared distance < r^2;
// trailing slots are filled with the first hit; a row with no hit is all
// zeros.  r^2 arrives already rounded to f32 from the Python float(r)**2.
//
// Bound on the card: a centre with fewer than k neighbours scans all N
// points, so the work is up to B*M*N distance tests (32 * 2048 * 20000 =
// 1.3e9 at the eval shape) and the point reads come from L2 (a scene is
// 240 KB).  One warp per centre: the warp reads 32 consecutive points at a
// time, __ballot_sync marks the hits, __popc of the lower lanes' bits gives
// each hit its slot, so the hits land in index order without a sort, and the
// warp stops as soon as it holds k hits.  The TPU kernels' block sort and
// lane window were placement tricks for the TPU's vector layout and are not
// carried over.
//
// The distance is ((dx*dx + dy*dy) + dz*dz) with round-to-nearest
// intrinsics (no FMA contraction), the order of the plain PyTorch version
// and of the numpy golden model.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
ball_query_kernel(const float* __restrict__ xyz, const float* __restrict__ centres,
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

}  // namespace

extern "C" int coda_ball_query(const float* xyz, const float* centres, int32_t* out,
                               int b, int n, int m, int k, float r2,
                               cudaStream_t stream) {
  const long long rows = (long long)b * m;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ball_query_kernel<<<(unsigned)blocks, kWarpsPerBlock * 32, 0, stream>>>(
      xyz, centres, out, b, n, m, k, r2);
  return (int)cudaGetLastError();
}
