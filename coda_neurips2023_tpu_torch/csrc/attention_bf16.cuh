// Kernel D-bf16: softmax attention, optionally radius-masked, with bf16
// operands.  q (B, H, Sq, D) already scaled by 1/sqrt(D); k (B, H, D, Skv),
// rows `ldk` >= Skv keys apart (a multiple of 8); v (B, H, Skv, D), all
// bf16; qxyz (B, Sq, 3), kxyz_t (B, 3, Skv) fp32, rows `ldk` apart -> (B, H,
// Sq, D), bf16 or fp32 (the wrapper's q dtype).
//
// Replaces coda_neurips2023_tpu/ops/pallas_masked_attention.py ::
// masked_attention at compute_dtype="bfloat16" (_kernel, _reference): the
// scores are fp32 sums of bf16 products; with radius > 0 a key is allowed
// where sqrt(max(|q|^2 + |k|^2 - 2 q.k, 0)) < radius, decided from the fp32
// coordinates in kernel D's order (attention.cu), a disallowed score set to
// finfo(f32).min; the softmax is fp32, p = e / sum e is rounded to bf16
// before the PV product, which sums in fp32; the output is rounded to the
// output dtype once.
//
// Training: with keep_mult > 0 the attention weights are dropped as flax's
// bf16 MultiHeadDotProductAttention drops them (broadcast_dropout), after p
// is rounded to bf16: one keep mask over (query, key), shared by every
// batch row and head, the kept p times keep_mult (flax's bf16 multiplier
// bf16(1) / bf16(1 - rate), from the wrapper) and that product rounded to
// bf16 again (exact in fp32 before that rounding: both factors hold 8
// significant bits).  The mask is kernel D's (dropout_hash.cuh, the same
// mask for the same seed): keep where mix32(mix32(seed) ^ (i * S_kv + j))
// >= drop_threshold, j the key's index in the whole row (a split chunk's
// offset plus its own index) and S_kv the true key count, not the padded
// `ldk`; the seed one int64 read from device memory (no host sync), read
// only where keep_mult > 0.  The sum l takes the weights before the drop.
//
// Two passes over the block's keys, which the rounding point forces (an
// online softmax keeps p unnormalized to the end, and a row of 2048 keys
// does not fit in registers): pass 0 forms the scores for the rows' max m
// and sum l, pass 1 forms them again and rounds p = e / l to bf16 for PV.
// The recomputed QK^T costs half the products again.  With split keys each
// chunk normalizes by its own l_s and writes O_s * l_s, so kernel D's
// combine (sum_s O_s e^(m_s - M) / sum_s l_s e^(m_s - M)) is unchanged.
//
// Bound on the card: operations.  Per (batch, head) 2 Sq Skv D flops of PV
// and 2 x 2 Sq Skv D of QK^T, 206 GFLOP an encoder layer at B=32, H=4,
// S=2048, D=64 (0.21 ms at the dense bf16 rate), and two exps a pair, 1.07
// G on the special-function units' 16 a clock an SM (≈ 0.29 ms: what bounds
// the kernel in practice, with the fp32 work around each exp); the
// decoder's cross-attention (Sq=128, Skv=2048, D=128) by bytes: K read
// twice, V once.
//
// Design (Hopper): a block of three warpgroups takes 128 query rows, one
// block an SM.
//   * Warpgroup 0 is the producer: after `setmaxnreg` gives its registers to
//     the others, one thread issues TMA loads (tma.cuh) into a ring of
//     kStages stages, each behind a `full` mbarrier (the bytes landed) and
//     an `empty` one (the 8 consumer warps released it): the K^T tile in
//     64-key sub-tiles [D][64] with 128-byte swizzle, in pass 1 the V tile
//     [TK][min(D, 64)] (32/64/128-byte swizzle by D), and the keys' x, y,
//     z where the mask needs them.  The query tile comes once.  Tensor maps
//     over (B*H, rows, columns) read zeros past Sq and Skv, so no row is
//     padded and no tail is loaded by hand (K^T's rows need a multiple of 8
//     keys: the wrapper pads them where Skv is not).
//   * Warpgroups 1 and 2 take 64 query rows each.  QK^T is wgmma
//     m64n128k16 (m64n64k16 at D = 128; wgmma.cuh), Q and the K^T tile from
//     shared memory (K^T MN-major, the descriptor's transpose bit).  PV is wgmma with P as
//     the register A operand: the score accumulators, rounded to bf16
//     pairs, are that operand's fragments; V MN-major from shared memory.
//     In pass 1 tile t's QK^T and tile t - 1's PV are issued together and
//     tile t's p forms while the PV runs; the two consumers take turns to
//     issue (named barriers), so one's softmax runs under the other's
//     products (both as in FlashAttention-3).
//   * Per pair: pass 0 takes each tile's row max before its sum, so the
//     running sum is rescaled once a tile; pass 1 divides by one correctly
//     rounded reciprocal r of l a row and two FMAs, q0 = e r, q = fma(fma(
//     -q0, l, e), r, q0), the IEEE quotient for e in [0, 1] and l >= 1
//     where the remainder is exact (chip_smoke.py phase 18 (a) holds it
//     bit-equal to __fdiv_rn); the exponential is the special-function
//     unit's ex2, flushing subnormal weights (< 2^-126 of the row's
//     largest) to zero.  No element loop holds a branch: a uniform branch
//     per element splits the compiler's schedule, and took twice the time.
//   * The radius test runs once, without a square root: pass 0 compares
//     the fp32 d^2 with the least t whose __fsqrt_rn reaches the radius
//     (the same decision, the root being monotone) and writes each pair's
//     allowed bit to shared memory (a word a thread and 64-key sub-tile,
//     so each thread reads back what it wrote, with no barrier); pass 1
//     reads it.  A chunk too long for the words in shared memory tests
//     again in pass 1.
//   * No call anywhere in the kernel, and no accumulator or A register
//     written while a product is in flight: either makes ptxas serialize
//     every wgmma (its C7510-C7515 notes in the build log).
//   * The keep test is branch-free integer work a pair (one add to a row's
//     base index, the mixer's two multiplies and three shifts, a compare and
//     a select), inlined; p is rounded to bf16 two at a time by the packed
//     conversion and widened back by a shift.  Dropout is a template
//     parameter: the kernel without it is the eval kernel opcode for opcode
//     (a uniform branch a tile that picked a version made the eval kernel
//     6% slower on the card).
//
// This header holds the kernel and its launch; attention_bf16_d{16,32,64,128}.cu
// instantiate them a head width each, so nvcc builds the four at once, and
// attention_bf16.cu holds the C entry points.

#pragma once

#include <cfloat>
#include <cmath>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_mma.cuh"
#include "dropout_hash.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace coda_d_bf16 {

using coda_bf16::ex2;
using coda_bf16::pack_bf16;
using coda_bf16::rcp_rn;
using coda_dropout::mix32;
using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;  // consumer warpgroups, 64 query rows each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kStages = 4;
constexpr int kMaxSmemBytes = 232448;  // a block's limit on sm_90
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int TQ = 64 * kConsumers;        // query rows a block
  static constexpr int TK = D <= 64 ? 128 : 64;     // keys a tile
  static constexpr int KSUB = TK / 64;              // 64-key sub-tiles of K^T
  static constexpr int DV = D < 64 ? D : 64;        // d columns of a Q or V sub-tile
  static constexpr int VSUB = D / DV;               // d sub-tiles (2 at D = 128)
  static constexpr int ROWB = 2 * DV;               // their row bytes: the swizzle width
  static constexpr int Q_SUB = 64 * ROWB;
  static constexpr int Q_BYTES = kConsumers * VSUB * Q_SUB;
  static constexpr int K_SUB = D * 128;             // [D][64 keys]
  static constexpr int K_BYTES = KSUB * K_SUB;
  static constexpr int V_SUB = TK * ROWB;           // [TK][DV]
  static constexpr int V_BYTES = VSUB * V_SUB;
  static constexpr int X_BYTES = 3 * TK * 4;        // the keys' x, y, z
  static constexpr int STAGE = (K_BYTES + V_BYTES + X_BYTES + 1023) / 1024 * 1024;
  static constexpr int BAR_BYTES = 128;
  // the 1024-byte alignment of the tiles, the tiles, the barriers
  static constexpr int FIXED = 1024 + Q_BYTES + kStages * STAGE + BAR_BYTES;
};

// the allowed bits of a chunk of `chunk` keys: a word a consumer thread and
// 64-key sub-tile
__host__ __device__ inline int bits_bytes(int chunk) {
  return 4 * 128 * kConsumers * ((chunk + 63) / 64);
}

// (a0*b0 + a1*b1) + a2*b2, rounded step by step (attention.cu's sum3)
__device__ __forceinline__ float sum3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

// Kernel code without calls: a rounded division or square root brings in
// ptxas' slow-path subroutine, and a call in the function serializes every
// wgmma in it.

// e / l, the IEEE quotient, for l >= 1 and e in [0, 1], r = rcp_rn(l): q0 =
// e r and one correction from the remainder e - q0 l, which is exact while
// q0 l has no bits below 2^-149: for e = 0 or e >= 2^-80 with l < 2^23
// (`div_exact`).  A smaller e (a weight 2^-80 of the row's largest) takes
// the quotient to ~2^-96 in fp64 and rounds it once (`div_small`), on a
// branch of its own: fp64 code under a predicate would cost every pair.
__device__ __forceinline__ bool div_exact(float e) { return e == 0.0f || e >= 0x1p-80f; }

__device__ __forceinline__ float div_fast(float e, float l, float r) {
  const float q0 = __fmul_rn(e, r);
  return __fmaf_rn(__fmaf_rn(-q0, l, e), r, q0);
}

__device__ __forceinline__ float div_small(float e, float l, float r) {
  const double x = l, ed = e;
  const double y = fma((double)r, fma(-x, (double)r, 1.0), (double)r);
  const double qd = ed * y;
  return (float)fma(fma(-qd, x, ed), y, qd);
}

__device__ __forceinline__ float div_by(float e, float l, float r) {
  return div_exact(e) ? div_fast(e, l, r) : div_small(e, l, r);
}

template <int D, typename OutT, bool DROP>
__global__ void __launch_bounds__(kThreads, 1)
attention_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_x, const float* __restrict__ qxyz,
                      const int64_t* __restrict__ seed_ptr, OutT* __restrict__ out,
                      float* __restrict__ o_part, float* __restrict__ ml_part, int h, int sq,
                      int skv, int chunk, float d2_below, int use_bits, uint32_t drop_threshold,
                      float keep_mult) {
  using C = Cfg<D>;
  constexpr int TK = C::TK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* q_s = smem;
  unsigned char* stage_s = smem + C::Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(stage_s + kStages * C::STAGE);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;
  uint32_t* bits = reinterpret_cast<uint32_t*>(reinterpret_cast<unsigned char*>(full) +
                                               C::BAR_BYTES);

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int q0 = blockIdx.x * C::TQ;
  const int bh = blockIdx.y;
  const int b = bh / h;
  const int kbeg = blockIdx.z * chunk;
  const int kend = min(skv, kbeg + chunk);
  const int ntiles = (kend - kbeg + TK - 1) / TK;
  const bool masked = d2_below > 0.0f;
  const bool retest = masked && !use_bits;  // the mask tested again in pass 1

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      coda_tma::mbar_init(&full[s], 1);
      coda_tma::mbar_init(&empty[s], 4 * kConsumers);
    }
    coda_tma::mbar_init(qbar, 1);
    coda_tma::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {
    // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      coda_tma::prefetch_map(&tm_k);
      coda_tma::prefetch_map(&tm_v);
      coda_tma::mbar_arrive_expect_tx(qbar, C::Q_BYTES);
      for (int c = 0; c < kConsumers; ++c)
        for (int u = 0; u < C::VSUB; ++u)
          coda_tma::tma_load_3d(q_s + (c * C::VSUB + u) * C::Q_SUB, &tm_q, qbar, u * C::DV,
                                q0 + 64 * c, bh);
      for (int it = 0; it < 2 * ntiles; ++it) {
        const int s = it % kStages;
        coda_tma::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        const bool pass1 = it >= ntiles;
        const int k0 = kbeg + (it - (pass1 ? ntiles : 0)) * TK;
        const bool with_x = pass1 ? retest : masked;
        coda_tma::mbar_arrive_expect_tx(
            &full[s], C::K_BYTES + (pass1 ? C::V_BYTES : 0) + (with_x ? C::X_BYTES : 0));
        unsigned char* st = stage_s + s * C::STAGE;
        for (int j = 0; j < C::KSUB; ++j)
          coda_tma::tma_load_3d(st + j * C::K_SUB, &tm_k, &full[s], k0 + 64 * j, 0, bh);
        if (pass1)
          for (int u = 0; u < C::VSUB; ++u)
            coda_tma::tma_load_3d(st + C::K_BYTES + u * C::V_SUB, &tm_v, &full[s], u * C::DV,
                                  k0, bh);
        if (with_x)
          coda_tma::tma_load_3d(st + C::K_BYTES + C::V_BYTES, &tm_x, &full[s], k0, 0, b);
      }
    }
  } else {
    // a consumer; one if-else to the end, so setmaxnreg holds in each branch
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = wg - 1;
    const int tw = tid - 128;  // the thread among the consumers
    const int lane = tid & 31;
    const int w = (tid >> 5) & 3;
    const int g = lane >> 2;   // the accumulator rows 16w + g and 16w + g + 8
    const int t = lane & 3;    // its columns 8j + 2t and 8j + 2t + 1
    const int row0 = q0 + 64 * cw + 16 * w + g;
    uint32_t seed = 0u;
    if constexpr (DROP) seed = mix32((uint32_t)(*seed_ptr));

    float qx[2][4];  // x, y, z, |q|^2 of the thread's two rows
    if (masked) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float* p = qxyz + ((long long)b * sq + min(row0 + 8 * i, sq - 1)) * 3;
        const float x = p[0], y = p[1], z = p[2];
        qx[i][0] = x;
        qx[i][1] = y;
        qx[i][2] = z;
        qx[i][3] = sum3(x, x, y, y, z, z);
      }
    }
    const uint32_t q_addr = coda_tma::smem_u32(q_s + cw * C::VSUB * C::Q_SUB);

    float o[C::VSUB][C::DV / 2];  // set by the first PV product
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.0f, 0.0f};  // this thread's share until pass 0 ends
    float r_l[2] = {0.0f, 0.0f};    // 1 / the rows' sums, correctly rounded

    // S = Q K^T for the warpgroup's 64 rows and load `it`'s TK keys, issued
    // once the load has landed
    auto issue_qk = [&](float (&sc)[C::KSUB][32], int it) {
      coda_tma::mbar_wait(&full[it % kStages], (it / kStages) & 1);
      const uint32_t k_addr = coda_tma::smem_u32(stage_s + (it % kStages) * C::STAGE);
      coda_wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint64_t da = coda_wgmma::desc(
            q_addr + (16 * kk / C::DV) * C::Q_SUB + (16 * kk % C::DV) * 2, C::ROWB);
        const uint64_t dk = coda_wgmma::desc(k_addr + kk * 16 * 128, 128, C::K_SUB);
        if constexpr (C::KSUB == 2)  // both 64-key halves in one m64n128: their
          // accumulators lie back to back, as m64n128 lays out its 128 columns
          coda_wgmma::mma_ss_n128(*reinterpret_cast<float(*)[64]>(&sc[0][0]), da, dk, kk > 0);
        else
          coda_wgmma::mma_ss_n64(sc[0], da, dk, kk > 0);
      }
      coda_wgmma::commit();
    };
    // O (+)= P V for load `it`'s V tile: the first tile of pass 1 sets O
    auto issue_pv = [&](uint32_t (&pa)[TK / 16][4], int it) {
      const bool first = it == ntiles;
      const uint32_t v_addr =
          coda_tma::smem_u32(stage_s + (it % kStages) * C::STAGE + C::K_BYTES);
      coda_wgmma::fence();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
#pragma unroll
        for (int u = 0; u < C::VSUB; ++u) {
          const uint64_t dv = coda_wgmma::desc(v_addr + u * C::V_SUB + kk * 16 * C::ROWB, C::ROWB);
          const int acc = !first || kk > 0;
          if constexpr (C::DV == 64) coda_wgmma::mma_rs_n64(o[u], pa[kk], dv, acc);
          else if constexpr (C::DV == 32) coda_wgmma::mma_rs_n32(o[u], pa[kk], dv, acc);
          else coda_wgmma::mma_rs_n16(o[u], pa[kk], dv, acc);
        }
      }
      coda_wgmma::commit();
    };
    // load `it`'s shared memory is read: release it to the producer
    auto release = [&](int it) {
      __syncwarp();
      if (lane == 0) coda_tma::mbar_arrive(&empty[it % kStages]);
    };
    // the two consumers take turns to issue their products (FlashAttention-3's
    // ping-pong): one's softmax runs under the other's products
    // (named barriers 1 and 2, 256 threads: a consumer waits on its own
    // before it issues and arrives on the other's after; the other's first
    // turn and last arrival are left out, so no barrier is left half-full)
    auto turn_begin = [&]() {
      asm volatile("bar.sync %0, 256;\n" :: "r"(1 + cw) : "memory");
    };
    auto turn_end = [&](bool last) {
      if (!(cw == 1 && last)) asm volatile("bar.arrive %0, 256;\n" :: "r"(2 - cw) : "memory");
    };
    auto fence_s = [&](float (&sc)[C::KSUB][32]) {
#pragma unroll
      for (int j = 0; j < C::KSUB; ++j) coda_wgmma::fence_operand(sc[j]);
    };
    auto fence_o = [&]() {
#pragma unroll
      for (int u = 0; u < C::VSUB; ++u) coda_wgmma::fence_operand(o[u]);
    };
    // masks (kernel D's) on tile `tile` of `pass`, then the rows' max: past
    // the chunk's last key no key at all; a disallowed key finfo(f32).min,
    // decided in pass 0 (its bit kept) and read back in pass 1
    // Mode 0: no mask; 1: the allowed bits; 2: the distance test (bits kept
    // where `use_bits`).  No branch inside the element loops, so the
    // compiler interleaves the elements' instructions.
    auto mask_as = [&](auto mode, float (&sc)[C::KSUB][32], int tile, const float* xs) {
      constexpr int MODE = decltype(mode)::value;
#pragma unroll
      for (int j = 0; j < C::KSUB; ++j) {
        uint32_t* word = bits + (tile * C::KSUB + j) * (128 * kConsumers) + tw;
        uint32_t allowed_bits = 0u, made = 0u;
        if constexpr (MODE == 1) allowed_bits = *word;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int col = 64 * j + 8 * c + 2 * t + e2;
            float x = 0.0f, y = 0.0f, z = 0.0f, k2 = 0.0f;
            if constexpr (MODE == 2) {
              x = xs[col];
              y = xs[TK + col];
              z = xs[2 * TK + col];
              k2 = sum3(x, x, y, y, z, z);
            }
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int e = 4 * c + 2 * i + e2;
              bool allowed;
              if constexpr (MODE == 2) {
                const float cross = sum3(qx[i][0], x, qx[i][1], y, qx[i][2], z);
                const float d2 =
                    fmaxf(__fsub_rn(__fadd_rn(qx[i][3], k2), __fmul_rn(2.0f, cross)), 0.0f);
                allowed = d2 < d2_below;  // __fsqrt_rn(d2) < radius
                made |= (uint32_t)allowed << e;
              } else {
                allowed = (allowed_bits >> e) & 1u;
              }
              sc[j][e] = allowed ? sc[j][e] : -FLT_MAX;
            }
          }
        }
        if constexpr (MODE == 2) {
          if (use_bits) *word = made;
        }
      }
    };
    // masks (kernel D's) on tile `tile` of a pass: a disallowed key
    // finfo(f32).min, decided in pass 0 (its bit kept) and read back in pass
    // 1; past the chunk's last key no key at all
    auto mask = [&](float (&sc)[C::KSUB][32], int tile, bool pass1) {
      const int k0 = kbeg + tile * TK;
      const float* xs = reinterpret_cast<const float*>(
          stage_s + ((pass1 ? ntiles : 0) + tile) % kStages * C::STAGE + C::K_BYTES + C::V_BYTES);
      if (masked && (!pass1 || retest)) mask_as(std::integral_constant<int, 2>(), sc, tile, xs);
      else if (masked) mask_as(std::integral_constant<int, 1>(), sc, tile, xs);
      if (k0 + TK > kend) {
#pragma unroll
        for (int j = 0; j < C::KSUB; ++j)
#pragma unroll
          for (int e = 0; e < 32; ++e)
            if (k0 + 64 * j + 8 * (e >> 2) + 2 * t + (e & 1) >= kend) sc[j][e] = -INFINITY;
      }
    };
    // pass 0 on tile `tile`: its max before its sum, one rescale of the sum
    auto stats = [&](float (&sc)[C::KSUB][32], int tile) {
      mask(sc, tile, false);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < C::KSUB; ++j)
#pragma unroll
        for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[j][e]);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float m = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        const float m_new = fmaxf(m_run[i], m);  // finite: every tile holds a key
        float lsum = 0.0f;
        // (s - m) first: an all-masked row has s = m = -FLT_MAX and weight 1
#pragma unroll
        for (int j = 0; j < C::KSUB; ++j)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            lsum += ex2((sc[j][4 * c + 2 * i] - m_new) * kLog2e) +
                    ex2((sc[j][4 * c + 2 * i + 1] - m_new) * kLog2e);
        l_run[i] = l_run[i] * ex2((m_run[i] - m_new) * kLog2e) + lsum;
        m_run[i] = m_new;
      }
    };
    // pass 1 on tile `tile`: p = e / l rounded to bf16, P's A fragments (16
    // keys a k-step: the accumulators of column groups 2 kk, 2 kk + 1); with
    // DROP each p kept times keep_mult, rounded again, or 0
    auto probs = [&](float (&sc)[C::KSUB][32], uint32_t (&pa)[TK / 16][4], int tile) {
      mask(sc, tile, true);
      bool small = false;
      // the hash's (i * S_kv + j) at the thread's two rows and its first key
      // of the tile: element e of k-step kk lies 16 kk + 8 (e >> 2) + (e & 1)
      // keys further
      const uint32_t key0 = (uint32_t)(kbeg + tile * TK + 2 * t);
      const uint32_t ij0[2] = {(uint32_t)row0 * (uint32_t)skv + key0,
                               (uint32_t)(row0 + 8) * (uint32_t)skv + key0};
      auto pack = [&](bool exact_only) {
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk) {
          const float* p = sc[kk / 4] + 8 * (kk % 4);
          float q[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int i = (e >> 1) & 1;
            const float ex = ex2((p[e] - m_run[i]) * kLog2e);
            if (exact_only) {
              small |= !div_exact(ex);
              q[e] = div_fast(ex, l_run[i], r_l[i]);
            } else {
              q[e] = div_by(ex, l_run[i], r_l[i]);
            }
          }
          if constexpr (DROP) {
#pragma unroll
            for (int e = 0; e < 8; e += 2) {
              const uint32_t two = pack_bf16(q[e], q[e + 1]);  // p rounded to bf16
              const uint32_t ij = ij0[(e >> 1) & 1] + (uint32_t)(16 * kk + 8 * (e >> 2));
              q[e] = mix32(seed ^ ij) >= drop_threshold
                         ? __uint_as_float(two << 16) * keep_mult : 0.0f;
              q[e + 1] = mix32(seed ^ (ij + 1u)) >= drop_threshold
                             ? __uint_as_float(two & 0xffff0000u) * keep_mult : 0.0f;
            }
          }
          pa[kk][0] = pack_bf16(q[0], q[1]);
          pa[kk][1] = pack_bf16(q[2], q[3]);
          pa[kk][2] = pack_bf16(q[4], q[5]);
          pa[kk][3] = pack_bf16(q[6], q[7]);
        }
      };
      pack(true);
      if (small) pack(false);  // a weight below 2^-80 of its row's largest
    };

    coda_tma::mbar_wait(qbar, 0);
    // Pass 0: each tile's QK^T, then its max and sum (the other warpgroup's
    // products run meanwhile).  Score arrays live inside an iteration: an
    // accumulator carried across iterations would be moved by the register
    // allocator while a product is in flight.
    if (cw == 1) asm volatile("bar.arrive 1, 256;\n" ::: "memory");  // the first turn is 0's
    for (int tile = 0; tile < ntiles; ++tile) {
      float sc[C::KSUB][32];
      turn_begin();
      issue_qk(sc, tile);
      turn_end(false);
      coda_wgmma::wait<0>();
      fence_s(sc);
      stats(sc, tile);
      release(tile);
    }
    // the rows' whole sums, shared by the quad that holds each row
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_run[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l_run[i] = l;
      r_l[i] = rcp_rn(l);
    }
    // Pass 1: tile t's QK^T and tile t - 1's PV are issued together, and tile
    // t's p forms while the PV runs (FlashAttention-3's pipelining inside a
    // warpgroup).  P of tile t - 1 stays in its registers until its PV is done.
    // tile t's p into `made` while tile t - 1's PV reads `cur`
    auto step1 = [&](uint32_t (&cur)[TK / 16][4], uint32_t (&made)[TK / 16][4], int tile) {
      float sc[C::KSUB][32];
      turn_begin();
      issue_qk(sc, ntiles + tile);
      issue_pv(cur, ntiles + tile - 1);
      turn_end(false);
      coda_wgmma::wait<1>();  // the QK^T; the PV may still run
      fence_s(sc);
      probs(sc, made, tile);
      coda_wgmma::wait<0>();
      fence_o();
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) coda_wgmma::fence_operand(cur[kk]);
      release(ntiles + tile - 1);
    };
    auto last_pv = [&](uint32_t (&cur)[TK / 16][4]) {
      turn_begin();
      issue_pv(cur, 2 * ntiles - 1);
      turn_end(true);
      coda_wgmma::wait<0>();
      fence_o();
      release(2 * ntiles - 1);
    };
    // two sets of P, taking turns, so no register of P is moved
    uint32_t pa[TK / 16][4], pb[TK / 16][4];
    {
      float sc[C::KSUB][32];
      turn_begin();
      issue_qk(sc, ntiles);
      turn_end(false);
      coda_wgmma::wait<0>();
      fence_s(sc);
      probs(sc, pa, 0);
    }
    int tile = 1;
    for (; tile + 1 < ntiles; tile += 2) {
      step1(pa, pb, tile);
      step1(pb, pa, tile + 1);
    }
    if (tile < ntiles) {
      step1(pa, pb, tile);
      last_pv(pb);
    } else {
      last_pv(pa);
    }

    const bool split = gridDim.z > 1;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      if (row >= sq) continue;
      if (!split) {
        OutT* op = out + ((long long)bh * sq + row) * D + 2 * t;
#pragma unroll
        for (int u = 0; u < C::VSUB; ++u)
#pragma unroll
          for (int c = 0; c < C::DV / 8; ++c) {
            const float a0 = o[u][4 * c + 2 * i], a1 = o[u][4 * c + 2 * i + 1];
            if constexpr (sizeof(OutT) == 2)
              *reinterpret_cast<uint32_t*>(op + u * 64 + 8 * c) = pack_bf16(a0, a1);
            else
              *reinterpret_cast<float2*>(op + u * 64 + 8 * c) = make_float2(a0, a1);
          }
      } else {
        // the chunk's output un-normalized again: O_s = o_s l_s
        const float l = l_run[i];
        const long long prow = ((long long)blockIdx.z * gridDim.y + bh) * sq + row;
        float* op = o_part + prow * D + 2 * t;
#pragma unroll
        for (int u = 0; u < C::VSUB; ++u)
#pragma unroll
          for (int c = 0; c < C::DV / 8; ++c)
            *reinterpret_cast<float2*>(op + u * 64 + 8 * c) =
                make_float2(o[u][4 * c + 2 * i] * l, o[u][4 * c + 2 * i + 1] * l);
        if (t == 0)
          *reinterpret_cast<float2*>(ml_part + 2 * prow) = make_float2(m_run[i], l);
      }
    }
  }
}

// the least t with sqrt(t) >= radius, correctly rounded (IEEE sqrt on the
// host is __fsqrt_rn's function): the root is monotone, so __fsqrt_rn(d2) <
// radius exactly where d2 < t, and the kernel takes no square root a pair
inline float sqrt_threshold(float radius) {
  float t = radius * radius;
  while (t > 0.0f && std::sqrt(std::nextafter(t, 0.0f)) >= radius) t = std::nextafter(t, 0.0f);
  while (std::sqrt(t) < radius) t = std::nextafter(t, INFINITY);
  return t;
}

template <int D, typename OutT>
int launch(const bf16* q, const bf16* k, const bf16* v, const float* qxyz, const float* kxyz_t,
           const int64_t* seed, OutT* out, float* o_part, float* ml_part, int b, int h, int sq,
           int skv, int ldk, float radius, uint32_t drop_threshold, float keep_mult, int splits,
           int chunk, cudaStream_t stream) {
  using C = Cfg<D>;
  if (chunk % C::TK != 0 || (long long)(splits - 1) * chunk >= skv ||
      (long long)splits * chunk < skv || (keep_mult > 0.0f && seed == nullptr))
    return (int)cudaErrorInvalidValue;  // every chunk must hold a key, and all keys a chunk
  const bool masked = radius > 0.0f;
  const long long bh = (long long)b * h;
  CUtensorMap tq, tk, tv, tx;
  int err = coda_tma::encode_3d(&tq, q, 2, D, sq, bh, D, sq, C::DV, 64, C::ROWB);
  if (!err) err = coda_tma::encode_3d(&tk, k, 2, skv, D, bh, ldk, D, 64, D, 128);
  if (!err) err = coda_tma::encode_3d(&tv, v, 2, D, skv, bh, D, skv, C::DV, C::TK, C::ROWB);
  if (!err && masked) err = coda_tma::encode_3d(&tx, kxyz_t, 4, skv, 3, b, ldk, 3, C::TK, 3, 0);
  else tx = tk;  // never read
  if (err) return err;
  const int use_bits = masked && C::FIXED + bits_bytes(chunk) <= kMaxSmemBytes;
  const int smem = C::FIXED + (use_bits ? bits_bytes(chunk) : 0);
  // once an instantiation: the limit, not this call's bytes
  static const cudaError_t attr[2] = {
      cudaFuncSetAttribute(attention_bf16_kernel<D, OutT, false>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes),
      cudaFuncSetAttribute(attention_bf16_kernel<D, OutT, true>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes)};
  const bool drop = keep_mult > 0.0f;
  if (attr[drop] != cudaSuccess) return (int)attr[drop];
  const dim3 grid((unsigned)((sq + C::TQ - 1) / C::TQ), (unsigned)bh, (unsigned)splits);
  auto kernel = drop ? attention_bf16_kernel<D, OutT, true> : attention_bf16_kernel<D, OutT, false>;
  kernel<<<grid, kThreads, smem, stream>>>(
      tq, tk, tv, tx, qxyz, seed, out, o_part, ml_part, h, sq, skv, chunk,
      masked ? sqrt_threshold(radius) : 0.0f, use_bits, drop_threshold, keep_mult);
  return (int)cudaGetLastError();
}

}  // namespace coda_d_bf16
