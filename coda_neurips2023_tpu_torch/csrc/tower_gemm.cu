// Kernel H: the frozen CLIP image tower's fp32 linear layers, Y =
// epilogue(X W^T + b).  X (M, K) fp32 row-major; W (N, K) fp32, nn.Linear's
// layout, given as its TF32 parts w_hi = tf32(W), w_lo = tf32(W - w_hi)
// (split once a weight by the wrapper, ops/tower_gemm.py); b (N,).  The
// epilogue, a template parameter:
//   kBias      Y = X W^T + b                    (the attention's qkv)
//   kGelu      Y = QuickGELU(X W^T + b)         (the MLP's c_fc)
//   kResidual  Y = R + (X W^T + b), R (M, N)    (out_proj, c_proj)
//   kQkv       X W^T + b with N = 3 H D written straight into q, k and v's
//              (3, B, H, S, D) layout, M = B S, for kernel E (no permute and
//              no copies after the product)
// Any M (the ragged edge masked); K % 4 == 0, N % 8 == 0.
//
// Replaces no Pallas kernel: the JAX package leaves the tower's Dense layers
// to XLA.  Added because those GEMMs were 78% of the CLIP-crop eval's device
// time on cuBLAS's fp32 SIMT kernels (about 48 TFLOP/s), and their bias,
// QuickGELU and residual passes most of the rest of its elementwise time.
//
// Bound on the card: operations, at the fp32-accurate tensor-core rate.
// Each product is 3xTF32, hi*hi + hi*lo + lo*hi (tf32_mma.cuh, as kernels
// D and E), at 495 / 3 = 165 TFLOP/s on an H100 SXM.  ViT-B/16's four layers
// a block at 197 tokens are 2 M K N = 33.7 GFLOP a crop over 12 blocks;
// bytes (X, W's two parts, Y) are a few per cent of the operations' time.
//
// Design (Hopper):
//   * A block of three warpgroups computes a 128 x 128 tile of Y.  Warpgroup
//     0 is the producer: after `setmaxnreg` gives its registers away, one
//     thread keeps TMA loads (tma.cuh) in flight into a ring of 4 stages,
//     each 32 deep in K: X's 128 rows and the W tile's two parts, all in the
//     128-byte swizzle, behind a `full` mbarrier (the bytes landed) and an
//     `empty` one (the 8 consumer warps released it).  Tensor maps read
//     zeros past M and K, so no row is padded.
//   * Warpgroups 1 and 2 take 64 rows each over the tile's 128 columns:
//     wgmma m64n128k8 .tf32 (wgmma.cuh), 64 fp32 accumulators a thread.
//   * The weights come split (the tower is frozen, so they are split once
//     and kept): B = w_hi or w_lo straight from shared memory.  The
//     activations are split in registers: each thread reads its A fragment
//     of a k-step (4 floats, conflict-free in the swizzle) from the stage,
//     rounds hi and lo to nearest (`tf32_rna`: wgmma itself would drop the
//     low 13 bits) and issues lo*hi, hi*lo, hi*hi with A from registers.
//     Splitting in shared memory would need a second copy of the X tile a
//     stage; splitting in a pass before the kernel, 3 M K floats more of
//     device memory traffic a call.
//   * fp32-level sums: the tensor cores' fp32 accumulator truncates each sum
//     it forms, so three products a k-step into one accumulator lose about
//     an ulp of it each, always towards zero: over K = 3072 that was 1.5e-5
//     of the output, 20 times cuBLAS's fp32 error.  So each stage's
//     products accumulate from zero and then join fp32 sums in registers,
//     added with rounding to nearest (as FP8 GEMMs promote their partial
//     sums): 2.2e-7 of the output at K = 3072, below cuBLAS's 7e-7 (both
//     against float64 on an H100 SXM; chip_smoke.py phase 23 prints the
//     error against the plain path).  The 64 sums a thread are why a warpgroup
//     takes 64 rows and not 128: the registers would not hold 128 sums
//     beside 128 accumulators.
//   * Two register sets of A alternate by k-step: before a set is written
//     again, `wait<1>` leaves only the last k-step's products in flight.  At
//     a stage's first k-step `wait<0>` drains the stage before, whose
//     accumulators join the sums and whose buffers go back to the producer.
//     No accumulator or A register is written while a product that reads it
//     is in flight, and the kernel holds no call (the QuickGELU takes the
//     special-function unit's exp and reciprocal): either would make ptxas
//     serialize every wgmma.
//   * The epilogue adds the bias (and the activation or the residual) to
//     the sums and stores pairs of floats straight from registers; each
//     quad of a warp writes 32 contiguous bytes of a row.
//   * No split K: each output is summed by one block in one order, so the
//     result is the same from run to run.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using coda_tf32::split_tf32;

constexpr int kConsumers = 2;                  // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int BM = 64 * kConsumers;            // rows of Y a block
constexpr int BN = 128;                        // columns of Y a block
constexpr int BK = 32;                         // K a stage: one 128-byte row of floats
constexpr int kStages = 4;
constexpr int X_BYTES = BM * BK * 4;
constexpr int W_BYTES = BN * BK * 4;           // each of w_hi and w_lo
constexpr int STAGE = X_BYTES + 2 * W_BYTES;
constexpr int SMEM = 1024 + kStages * STAGE + 2 * kStages * 8;  // alignment, stages, barriers
constexpr float kGeluScale = 1.702f;           // QuickGELU: x sigmoid(1.702 x)
constexpr float kLog2e = 1.4426950408889634f;

enum Epilogue { kBias = 0, kGelu = 1, kResidual = 2, kQkv = 3 };

__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// x sigmoid(1.702 x) = x / (1 + 2^(-1.702 log2(e) x)); for x below about -52
// the power is inf and its reciprocal 0
__device__ __forceinline__ float quick_gelu(float x) {
  return x * rcp_approx(1.0f + ex2_approx(-kGeluScale * kLog2e * x));
}

// one k-step: the thread's A fragment, hi and lo
struct AFrag {
  uint32_t hi[4];
  uint32_t lo[4];
};

template <int EPI>
__global__ void __launch_bounds__(kThreads, 1)
tower_gemm_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_whi,
                  const __grid_constant__ CUtensorMap tm_wlo, const float* __restrict__ bias,
                  const float* __restrict__ residual, float* __restrict__ y, int m, int n, int k,
                  int seq, int heads, int head_dim) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * STAGE);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int ktiles = (k + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      coda_tma::mbar_init(&full[s], 1);
      coda_tma::mbar_init(&empty[s], 4 * kConsumers);
    }
    coda_tma::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      coda_tma::prefetch_map(&tm_x);
      coda_tma::prefetch_map(&tm_whi);
      coda_tma::prefetch_map(&tm_wlo);
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % kStages;
        coda_tma::mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        coda_tma::mbar_arrive_expect_tx(&full[s], STAGE);
        unsigned char* st = smem + s * STAGE;
        coda_tma::tma_load_3d(st, &tm_x, &full[s], kt * BK, m0, 0);
        coda_tma::tma_load_3d(st + X_BYTES, &tm_whi, &full[s], kt * BK, n0, 0);
        coda_tma::tma_load_3d(st + X_BYTES + W_BYTES, &tm_wlo, &full[s], kt * BK, n0, 0);
      }
    }
  } else {
    // a consumer; one if-else to the end, so setmaxnreg holds in each branch
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = wg - 1;
    const int lane = tid & 31;
    const int w = (tid >> 5) & 3;
    const int g = lane >> 2;  // the accumulator rows 16w + g and 16w + g + 8
    const int t = lane & 3;   // its columns 8j + 2t and 8j + 2t + 1
    const uint32_t smem_base = coda_tma::smem_u32(smem);
    // byte offset of the thread's row 16w + g in a stage's X tile, and word t
    // of a 16-byte chunk; rows g and g + 8 share the swizzle's XOR g
    const uint32_t x_row = (uint32_t)(64 * cw + 16 * w + g) * 128u + 4u * t;

    float acc[64];  // the stage's products, from the tensor cores
    float sum[64];  // the stages before, summed in fp32
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = 0.0f;
    AFrag frag[2];

    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % kStages;
      coda_tma::mbar_wait(&full[s], (kt / kStages) & 1);
      const uint32_t st = smem_base + s * STAGE;
#pragma unroll
      for (int kk = 0; kk < BK / 8; ++kk) {
        AFrag& f = frag[kk & 1];
        // A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]
        const uint32_t c0 = st + x_row + ((uint32_t)((2 * kk) ^ g) << 4);
        const uint32_t c1 = st + x_row + ((uint32_t)((2 * kk + 1) ^ g) << 4);
        const float xv[4] = {lds(c0), lds(c0 + 8 * 128), lds(c1), lds(c1 + 8 * 128)};
        if (kk == 0) {
          // the stage before is done: its products join the sums, and its
          // buffers go back to the producer
          coda_wgmma::wait<0>();
          if (kt > 0) {
            coda_wgmma::fence_operand(acc);
#pragma unroll
            for (int i = 0; i < 64; ++i) sum[i] += acc[i];
            if (lane == 0) coda_tma::mbar_arrive(&empty[(kt - 1) % kStages]);
          }
        } else {
          // the products that read this register set (two k-steps back) are done
          coda_wgmma::wait<1>();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(xv[i], f.hi[i], f.lo[i]);
        const uint64_t d_hi = coda_wgmma::desc(st + X_BYTES + 32 * kk, 128);
        const uint64_t d_lo = coda_wgmma::desc(st + X_BYTES + W_BYTES + 32 * kk, 128);
        coda_wgmma::fence_operand(acc);
        coda_wgmma::fence();
        coda_wgmma::mma_rs_tf32_n128(acc, f.lo, d_hi, kk > 0 ? 1 : 0);
        coda_wgmma::mma_rs_tf32_n128(acc, f.hi, d_lo, 1);
        coda_wgmma::mma_rs_tf32_n128(acc, f.hi, d_hi, 1);
        coda_wgmma::commit();
        coda_wgmma::fence_operand(acc);
      }
    }
    coda_wgmma::wait<0>();
    coda_wgmma::fence_operand(acc);
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] += acc[i];

    // the epilogue, straight from the sums
    const int wdim = n / 3;  // kQkv: H D
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + 64 * cw + 16 * w + g + 8 * h;
      if (row >= m) continue;
      long long row_base = (long long)row * n;
      if (EPI == kQkv) {
        const int bi = row / seq;
        row_base = ((long long)bi * heads * seq + (row - bi * seq)) * head_dim;
      }
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col >= n) continue;
        const float2 bb = *reinterpret_cast<const float2*>(bias + col);
        float v0 = sum[4 * j + 2 * h] + bb.x;
        float v1 = sum[4 * j + 2 * h + 1] + bb.y;
        long long idx = row_base + col;
        if (EPI == kGelu) {
          v0 = quick_gelu(v0);
          v1 = quick_gelu(v1);
        } else if (EPI == kResidual) {
          const float2 r = *reinterpret_cast<const float2*>(residual + idx);
          v0 = r.x + v0;
          v1 = r.y + v1;
        } else if (EPI == kQkv) {
          // column (which, head, d) of q, k, v: (3, B, H, S, D)
          const int which = col / wdim;
          const int rem = col - which * wdim;
          const int head = rem / head_dim;
          idx = (long long)which * m * wdim + row_base + (long long)head * seq * head_dim +
                (rem - head * head_dim);
        }
        *reinterpret_cast<float2*>(y + idx) = make_float2(v0, v1);
      }
    }
  }
}

template <int EPI>
int launch(const float* x, const float* w_hi, const float* w_lo, const float* bias,
           const float* residual, float* y, int m, int n, int k, int seq, int heads,
           int head_dim, cudaStream_t stream) {
  CUtensorMap maps[3];
  int err = coda_tma::encode_3d(&maps[0], x, 4, k, m, 1, k, m, BK, BM, 128);
  if (!err) err = coda_tma::encode_3d(&maps[1], w_hi, 4, k, n, 1, k, n, BK, BN, 128);
  if (!err) err = coda_tma::encode_3d(&maps[2], w_lo, 4, k, n, 1, k, n, BK, BN, 128);
  if (err) return err;
  static const cudaError_t attr = cudaFuncSetAttribute(
      tower_gemm_kernel<EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  // n-tiles fastest: the blocks in flight share their X rows and all of W in L2
  const dim3 grid((unsigned)((n + BN - 1) / BN), (unsigned)((m + BM - 1) / BM));
  tower_gemm_kernel<EPI><<<grid, kThreads, SMEM, stream>>>(
      maps[0], maps[1], maps[2], bias, residual, y, m, n, k, seq, heads, head_dim);
  return (int)cudaGetLastError();
}

}  // namespace

// x, w_hi, w_lo 16-byte aligned (their tensor maps), bias, residual and y
// 8-byte aligned; residual only for epilogue 2, seq, heads and head_dim
// only for epilogue 3 (m = B seq, n = 3 heads head_dim, head_dim even)
extern "C" int coda_tower_gemm(const float* x, const float* w_hi, const float* w_lo,
                               const float* bias, const float* residual, float* y, int m, int n,
                               int k, int epilogue, int seq, int heads, int head_dim,
                               cudaStream_t stream) {
  if (m < 1 || n < 8 || n % 8 || k < 4 || k % 4) return (int)cudaErrorInvalidValue;
  switch (epilogue) {
    case kBias:
      return launch<kBias>(x, w_hi, w_lo, bias, residual, y, m, n, k, 1, 1, 2, stream);
    case kGelu:
      return launch<kGelu>(x, w_hi, w_lo, bias, residual, y, m, n, k, 1, 1, 2, stream);
    case kResidual:
      if (residual == nullptr) return (int)cudaErrorInvalidValue;
      return launch<kResidual>(x, w_hi, w_lo, bias, residual, y, m, n, k, 1, 1, 2, stream);
    case kQkv:
      if (seq < 1 || heads < 1 || head_dim < 2 || head_dim % 2 || m % seq ||
          n != 3 * heads * head_dim)
        return (int)cudaErrorInvalidValue;
      return launch<kQkv>(x, w_hi, w_lo, bias, residual, y, m, n, k, seq, heads, head_dim,
                          stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
