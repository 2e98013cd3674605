// Kernel D: softmax attention, optionally radius-masked, fp32-accurate on
// the tensor cores.  q (B, H, Sq, D) already scaled by 1/sqrt(D);
// k (B, H, D, Skv); v (B, H, Skv, D); qxyz (B, Sq, 3); kxyz_t (B, 3, Skv)
// -> (B, H, Sq, D).
//
// Replaces coda_neurips2023_tpu/ops/pallas_masked_attention.py ::
// masked_attention (_kernel, _impl).  Semantics: scores = q . k; with
// radius > 0 a key is allowed where sqrt(max(|q|^2 + |k|^2 - 2 q.k, 0)) <
// radius (radius is already squared by the caller, a reference quirk kept
// verbatim), and a disallowed score is set to finfo(f32).min before the
// softmax, so a row with no allowed key comes out uniform, as in JAX.  The
// squared norms, the cross term and d2 are rounded in the plain version's
// order (fp32 on CUDA cores), so a key near the radius is allowed or not by
// both alike.
//
// Bound on the card: operations.  The two products are 2 * 2 * Sq * Skv * D
// flops per (batch, head), 137 GFLOP per encoder layer at B=32, H=4,
// S=2048, D=64.  On fp32 CUDA cores (67 TFLOP/s) that alone is 2.05 ms.  The
// kernel runs both products on the tensor cores in 3xTF32: each fp32
// operand x is split into hi = tf32(x) and lo = tf32(x - hi) (rounded to
// nearest, ties away, as cvt.rna, but in integer ops), and
// lo*hi + hi*lo + hi*hi is accumulated in fp32 by mma.sync m16n8k8; that
// keeps about 22 of fp32's 24 bits (single-pass TF32 keeps 11, too few for
// the port's fp32 parity), at 495 / 3 = 165 TFLOP/s.
//
// Layout (FlashAttention-2): a block of 4 warps takes 128 query rows, two
// 16-row MMA tiles a warp, so each K and V fragment, loaded and split once,
// feeds two products and each warp has independent MMAs to interleave.  It
// walks its keys in tiles of 32 (16 at D = 128, where the output
// accumulators take 128 registers a lane); two blocks fit an SM.  Up to
// D = 64 the query tile is split into hi and lo once, in shared memory.  The
// K^T and V tiles are double-buffered in shared memory with cp.async, the
// next tile loading while the current one is multiplied.  Scores stay in
// the MMA accumulator fragments; the online softmax (running max and sum,
// rescale) runs in registers, with shuffles inside each group of four
// lanes that share a row.  P feeds the PV product
// straight from those registers: the accumulator holds keys 2t and 2t+1 of
// an 8-key group in lane t of a quad, and the PV product takes them as its
// k-indices t and t+4, reading V's rows in the same order, so no shuffle or
// shared-memory round trip is needed.  Shared-memory row strides are padded
// so every fragment load is free of bank conflicts.
//
// Split keys: when (B*H) x ceil(Sq/TQ) blocks cannot fill the card (the
// decoder's cross-attention: 128 queries over 2048 keys), the wrapper cuts
// Skv into `splits` chunks of `chunk` keys (a multiple of TK), one chunk a
// block (grid z).  Each block then writes its unnormalized output, running
// max m and running sum l to scratch, and combine_kernel merges the chunks:
// M = max m_s, L = sum l_s e^(m_s - M), O = sum O_s e^(m_s - M) / L.  No
// chunk is all padding, so every m_s is finite; a row whose every key is
// radius-masked has m_s = -FLT_MAX in each chunk and comes out uniform.
//
// Training: with dropout > 0 the attention weights are dropped as flax's
// MultiHeadDotProductAttention drops them (broadcast_dropout): one keep mask
// over (query, key), shared by every batch row and head, kept weights scaled
// by 1 / (1 - dropout).  The mask is a counter-based hash of the query and
// key index and a seed read from device memory (so drawing it costs the host
// no sync): keep where mix32(mix32(seed) ^ (i * S_kv + j)) >= drop_threshold
// (dropout * 2^32, from the wrapper), and scale by keep_scale (1 / (1 -
// dropout) in f32, 0 for no dropout), evaluated at each accumulator
// element's (row, column).  The plain version forms the same hash.  The
// softmax's running sum takes the weights before the drop, as the weights
// are normalized before flax drops them.

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dropout_hash.cuh"
#include "tf32_mma.cuh"

namespace {

using coda_dropout::mix32;
using coda_tf32::mma_3xtf32;
using coda_tf32::split_tf32;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int MT = 2;                  // 16-row MMA tiles a warp
  static constexpr int TQ = 16 * MT * kWarps;   // query rows a block
  static constexpr int TK = D <= 64 ? 32 : 16;  // keys a tile
  // the query tile split into TF32 hi and lo once, in shared memory (both
  // fit beside two stages up to D = 64), rather than at every key tile
  static constexpr bool Q_SPLIT = D <= 64;
  static constexpr int QS = D + 4;              // Qs row stride (floats)
  static constexpr int KS = TK + 8;             // K^T tile [D][TK] row stride
  static constexpr int VS = D + 4;              // V tile [TK][D] row stride
  static constexpr int K_FLOATS = D * KS;
  static constexpr int V_FLOATS = TK * VS;
  static constexpr int STAGE = K_FLOATS + V_FLOATS + 4 * TK;  // + keys' x, y, z
  static constexpr size_t SMEM =
      (size_t)((Q_SPLIT ? 2 : 1) * TQ * QS + 4 * TQ + 2 * STAGE) * sizeof(float);
};


// (a0*b0 + a1*b1) + a2*b2, rounded step by step (no FMA contraction), the
// order of the plain PyTorch version: the mask is decided on identical bits.
__device__ __forceinline__ float sum3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes, or zeros where src_bytes is 0
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Start the copies of keys k0 .. k0+TK-1 (zeros at and past kend) into one
// stage: the K^T tile, the V tile and, when masked, the keys' coordinates
// (clamped to the last key).  `vec`: 16-byte copies (Skv % 4 == 0 and q, k,
// v 16-byte aligned), else 4-byte ones.
template <int D>
__device__ __forceinline__ void load_tile(float* stage, const float* kb, const float* vb,
                                          const float* kxyz_b, int k0, int kend, int skv,
                                          bool vec, bool masked) {
  using C = Cfg<D>;
  constexpr int TK = C::TK;
  float* Ks = stage;
  float* Vs = Ks + C::K_FLOATS;
  float* Xs = Vs + C::V_FLOATS;
  const int tid = threadIdx.x;
  if (vec) {
    for (int e = tid; e < D * (TK / 4); e += kThreads) {
      const int d = e / (TK / 4), c = (e % (TK / 4)) * 4;
      const bool in = k0 + c < kend;  // kend % 4 == 0: a vector is all in or all out
      cp_async16(Ks + d * C::KS + c, in ? kb + (size_t)d * skv + k0 + c : kb, in ? 16 : 0);
    }
    for (int e = tid; e < TK * (D / 4); e += kThreads) {
      const int c = e / (D / 4), d = (e % (D / 4)) * 4;
      const bool in = k0 + c < kend;
      cp_async16(Vs + c * C::VS + d, in ? vb + (size_t)(k0 + c) * D + d : vb, in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < D * TK; e += kThreads) {
      const int d = e / TK, c = e % TK;
      const bool in = k0 + c < kend;
      cp_async4(Ks + d * C::KS + c, in ? kb + (size_t)d * skv + k0 + c : kb, in ? 4 : 0);
    }
    for (int e = tid; e < TK * D; e += kThreads) {
      const int c = e / D, d = e % D;
      const bool in = k0 + c < kend;
      cp_async4(Vs + c * C::VS + d, in ? vb + (size_t)(k0 + c) * D + d : vb, in ? 4 : 0);
    }
  }
  if (masked) {
    for (int e = tid; e < 3 * TK; e += kThreads) {
      const int a = e / TK, c = e % TK;
      cp_async4(Xs + a * TK + c, kxyz_b + (size_t)a * skv + min(k0 + c, skv - 1), 4);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ qxyz,
                 const float* __restrict__ kxyz_t, float* __restrict__ out,
                 float* __restrict__ o_part, float* __restrict__ ml_part, int h, int sq,
                 int skv, int chunk, float radius, const int64_t* __restrict__ seed_ptr,
                 uint32_t drop_threshold, float keep_scale, bool vec) {
  using C = Cfg<D>;
  constexpr int MT = C::MT;
  constexpr int TQ = C::TQ;
  constexpr int TK = C::TK;
  constexpr int NT = TK / 8;  // score n-tiles (8 keys each) a tile
  constexpr int KD = D / 8;   // k-steps of QK^T, n-tiles of the output
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                                  // fp32, then TF32 hi
  float* Ql = Qs + TQ * C::QS;                       // TF32 lo (Q_SPLIT)
  float* qx = Qs + (C::Q_SPLIT ? 2 : 1) * TQ * C::QS;  // [4][TQ]: x, y, z, |q|^2
  float* stages = qx + 4 * TQ;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // the accumulator rows g and g + 8 of each 16-row tile
  const int t = lane & 3;   // its columns 2t and 2t + 1 of each 8-wide n-tile
  const int q0 = blockIdx.x * TQ;
  const long long bh = blockIdx.y;
  const long long b = bh / h;
  const int kbeg = blockIdx.z * chunk;
  const int kend = min(skv, kbeg + chunk);
  const bool masked = radius > 0.0f;
  const bool drop = keep_scale > 0.0f;
  const uint32_t seed = drop ? mix32((uint32_t)(*seed_ptr)) : 0u;

  const float* qb = q + bh * sq * D;
  const float* kb = k + bh * D * skv;
  const float* vb = v + bh * skv * D;
  const float* kxyz_b = masked ? kxyz_t + b * 3 * skv : nullptr;

  const int ntiles = (kend - kbeg + TK - 1) / TK;
  // the query tile (zeros past the last query) rides with the first key tile
  if (vec) {
    for (int e = tid; e < TQ * (D / 4); e += kThreads) {
      const int r = e / (D / 4), d = (e % (D / 4)) * 4;
      const bool in = q0 + r < sq;
      cp_async16(Qs + r * C::QS + d, in ? qb + (long long)(q0 + r) * D + d : qb, in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < TQ * D; e += kThreads) {
      const int r = e / D, d = e % D;
      const bool in = q0 + r < sq;
      cp_async4(Qs + r * C::QS + d, in ? qb + (long long)(q0 + r) * D + d : qb, in ? 4 : 0);
    }
  }
  load_tile<D>(stages, kb, vb, kxyz_b, kbeg, kend, skv, vec, masked);
  cp_async_commit();

  if (masked && tid < TQ) {
    const int gq = min(q0 + tid, sq - 1);
    const float* p = qxyz + (b * sq + gq) * 3;
    const float x = p[0], y = p[1], z = p[2];
    qx[tid] = x;
    qx[TQ + tid] = y;
    qx[2 * TQ + tid] = z;
    qx[3 * TQ + tid] = sum3(x, x, y, y, z, z);
  }

  // block-local row of accumulator element e of m-tile mt: rw + 16 mt + 8 (e >> 1)
  const int rw = warp * 16 * MT + g;
  float o[MT][KD][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < KD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.0f;
  float m_run[MT][2], l_run[MT][2];  // l_run: this lane's share of the row sums
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_run[mt][i] = -INFINITY;
      l_run[mt][i] = 0.0f;
    }

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = kbeg + it * TK;
    if (it + 1 < ntiles)
      load_tile<D>(stages + ((it + 1) & 1) * C::STAGE, kb, vb, kxyz_b, k0 + TK, kend, skv, vec,
                   masked);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed
    __syncthreads();
    if (C::Q_SPLIT && it == 0) {
      for (int e = tid; e < TQ * D; e += kThreads) {
        const int i = (e / D) * C::QS + e % D;
        uint32_t hi, lo;
        split_tf32(Qs[i], hi, lo);
        Qs[i] = __uint_as_float(hi);
        Ql[i] = __uint_as_float(lo);
      }
      __syncthreads();
    }
    const float* Ks = stages + (it & 1) * C::STAGE;
    const float* Vs = Ks + C::K_FLOATS;
    const float* Xs = Vs + C::V_FLOATS;

    // S = Q K^T for the warp's 16 MT rows and the tile's TK keys
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int qi = (rw + 16 * mt) * C::QS + kk * 8 + t;
        constexpr int off[4] = {0, 8 * C::QS, 4, 8 * C::QS + 4};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (C::Q_SPLIT) {
            ah[mt][c] = __float_as_uint(Qs[qi + off[c]]);
            al[mt][c] = __float_as_uint(Ql[qi + off[c]]);
          } else {
            split_tf32(Qs[qi + off[c]], ah[mt][c], al[mt][c]);
          }
        }
      }
      const float* kp = Ks + (kk * 8 + t) * C::KS + g;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t bh2[2], bl2[2];
        split_tf32(kp[j * 8], bh2[0], bl2[0]);
        split_tf32(kp[4 * C::KS + j * 8], bh2[1], bl2[1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_3xtf32(s[mt][j], ah[mt], al[mt], bh2, bl2);
      }
    }

    // masks, then the online softmax of rows (mt, e >> 1)
    const bool ragged = k0 + TK > kend;  // the chunk's last tile runs past its last key
    float mx[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mx[mt][0] = mx[mt][1] = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          float val = s[mt][j][e];
          if (ragged && k0 + c >= kend) {
            val = -INFINITY;  // past the chunk's last key: not a key at all
          } else if (masked) {
            const int r = rw + 16 * mt + 8 * (e >> 1);
            const float x = Xs[c], y = Xs[TK + c], z = Xs[2 * TK + c];
            const float cross = sum3(qx[r], x, qx[TQ + r], y, qx[2 * TQ + r], z);
            const float d2 = fmaxf(__fsub_rn(__fadd_rn(qx[3 * TQ + r], sum3(x, x, y, y, z, z)),
                                             __fmul_rn(2.0f, cross)),
                                   0.0f);
            if (!(__fsqrt_rn(d2) < radius)) val = -FLT_MAX;
          }
          s[mt][j][e] = val;
          mx[mt][e >> 1] = fmaxf(mx[mt][e >> 1], val);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float alpha[2], lsum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float m = fmaxf(mx[mt][i], __shfl_xor_sync(0xffffffffu, mx[mt][i], 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        const float m_new = fmaxf(m_run[mt][i], m);  // finite: every tile holds a key
        alpha[i] = exp2f((m_run[mt][i] - m_new) * kLog2e);  // 0 on the first tile
        m_run[mt][i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // (s - m) first: an all-masked row has s = m = -FLT_MAX and weight 1
          float p = exp2f((s[mt][j][e] - m_run[mt][e >> 1]) * kLog2e);
          lsum[e >> 1] += p;
          if (drop) {
            const uint32_t i = (uint32_t)(q0 + rw + 16 * mt + 8 * (e >> 1));
            const uint32_t ij = i * (uint32_t)skv + (uint32_t)(k0 + j * 8 + 2 * t + (e & 1));
            p = mix32(seed ^ ij) >= drop_threshold ? p * keep_scale : 0.0f;
          }
          s[mt][j][e] = p;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_run[mt][i] = l_run[mt][i] * alpha[i] + lsum[i];
#pragma unroll
      for (int n = 0; n < KD; ++n) {
        o[mt][n][0] *= alpha[0];
        o[mt][n][1] *= alpha[0];
        o[mt][n][2] *= alpha[1];
        o[mt][n][3] *= alpha[1];
      }
    }

    // O += P V: the accumulator's keys 2t and 2t+1 of group j are the A
    // fragment's k-indices t and t+4, so V is read at rows 2t and 2t+1
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        split_tf32(s[mt][j][0], ah[mt][0], al[mt][0]);
        split_tf32(s[mt][j][2], ah[mt][1], al[mt][1]);
        split_tf32(s[mt][j][1], ah[mt][2], al[mt][2]);
        split_tf32(s[mt][j][3], ah[mt][3], al[mt][3]);
      }
      const float* vp = Vs + (j * 8 + 2 * t) * C::VS + g;
#pragma unroll
      for (int n = 0; n < KD; ++n) {
        uint32_t bh2[2], bl2[2];
        split_tf32(vp[n * 8], bh2[0], bl2[0]);
        split_tf32(vp[C::VS + n * 8], bh2[1], bl2[1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma_3xtf32(o[mt][n], ah[mt], al[mt], bh2, bl2);
      }
    }
    __syncthreads();  // the stage is consumed before the next load overwrites it
  }

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_run[mt][i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = q0 + rw + 16 * mt + 8 * i;
      if (row >= sq) continue;
      if (!split) {
        float* op = out + (bh * sq + row) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < KD; ++n)
          *reinterpret_cast<float2*>(op + n * 8) =
              make_float2(o[mt][n][2 * i] / l, o[mt][n][2 * i + 1] / l);
      } else {
        const long long prow = ((long long)blockIdx.z * gridDim.y + bh) * sq + row;
        float* op = o_part + prow * D + 2 * t;
#pragma unroll
        for (int n = 0; n < KD; ++n)
          *reinterpret_cast<float2*>(op + n * 8) = make_float2(o[mt][n][2 * i], o[mt][n][2 * i + 1]);
        if (t == 0)
          *reinterpret_cast<float2*>(ml_part + 2 * prow) = make_float2(m_run[mt][i], l);
      }
    }
  }
}

// out[row, :] = sum_s O_s e^(m_s - M) / sum_s l_s e^(m_s - M), M = max_s m_s;
// o_part (splits, rows, D), ml_part (splits, rows, 2); one thread per 4
// columns.  Kernel D-bf16 (attention_bf16.cuh) writes the same partials; its
// output may be bf16, rounded once here.
template <typename OutT>
__global__ void combine_kernel(const float* __restrict__ o_part,
                               const float* __restrict__ ml_part, OutT* __restrict__ out,
                               long long rows, int d, int splits) {
  const int quads = d / 4;
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * quads) return;
  const long long row = e / quads;
  const int c = (int)(e % quads) * 4;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, ml_part[2 * (s * rows + row)]);
  float l = 0.0f;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int s = 0; s < splits; ++s) {
    const float2 ml = *reinterpret_cast<const float2*>(ml_part + 2 * (s * rows + row));
    const float w = expf(ml.x - m);
    l += ml.y * w;
    const float4 x = *reinterpret_cast<const float4*>(o_part + (s * rows + row) * d + c);
    acc.x += x.x * w;
    acc.y += x.y * w;
    acc.z += x.z * w;
    acc.w += x.w * w;
  }
  if constexpr (sizeof(OutT) == 2) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(acc.x / l, acc.y / l);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(acc.z / l, acc.w / l);
    *reinterpret_cast<uint2*>(out + row * d + c) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
  } else {
    *reinterpret_cast<float4*>(out + row * d + c) =
        make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* qxyz,
           const float* kxyz_t, float* out, float* o_part, float* ml_part, int b, int h, int sq,
           int skv, float radius, const int64_t* seed, uint32_t drop_threshold,
           float keep_scale, int splits, int chunk, cudaStream_t stream) {
  using C = Cfg<D>;
  if (chunk % C::TK != 0 || (long long)(splits - 1) * chunk >= skv ||
      (long long)splits * chunk < skv)
    return (int)cudaErrorInvalidValue;  // every chunk must hold a key, and all keys a chunk
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const bool vec = skv % 4 == 0 && chunk % 4 == 0 && ((uintptr_t)q % 16) == 0 &&
                   ((uintptr_t)k % 16) == 0 && ((uintptr_t)v % 16) == 0;
  const dim3 grid((unsigned)((sq + C::TQ - 1) / C::TQ), (unsigned)(b * h), (unsigned)splits);
  attention_kernel<D><<<grid, kThreads, C::SMEM, stream>>>(
      q, k, v, qxyz, kxyz_t, out, o_part, ml_part, h, sq, skv, chunk, radius, seed,
      drop_threshold, keep_scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// seed: one int64 on the device, read only when keep_scale > 0.  splits > 1
// needs o_part (splits * b * h * sq * d floats) and ml_part (splits * b * h *
// sq * 2 floats) and leaves `out` to coda_attention_combine.
extern "C" int coda_attention(const float* q, const float* k, const float* v,
                              const float* qxyz, const float* kxyz_t, float* out,
                              float* o_part, float* ml_part, int b, int h, int sq, int skv,
                              int d, float radius, const int64_t* seed,
                              unsigned drop_threshold, float keep_scale, int splits, int chunk,
                              cudaStream_t stream) {
  if (sq < 1 || skv < 1 || splits < 1 || splits > 65535 || (long long)b * h > 65535 ||
      (splits > 1 && (o_part == nullptr || ml_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 16: return launch<16>(q, k, v, qxyz, kxyz_t, out, o_part, ml_part, b, h, sq, skv, radius, seed, drop_threshold, keep_scale, splits, chunk, stream);
    case 32: return launch<32>(q, k, v, qxyz, kxyz_t, out, o_part, ml_part, b, h, sq, skv, radius, seed, drop_threshold, keep_scale, splits, chunk, stream);
    case 64: return launch<64>(q, k, v, qxyz, kxyz_t, out, o_part, ml_part, b, h, sq, skv, radius, seed, drop_threshold, keep_scale, splits, chunk, stream);
    case 128: return launch<128>(q, k, v, qxyz, kxyz_t, out, o_part, ml_part, b, h, sq, skv, radius, seed, drop_threshold, keep_scale, splits, chunk, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// out: bf16 where out_bf16, else fp32
extern "C" int coda_attention_combine(const float* o_part, const float* ml_part, void* out,
                                      int b, int h, int sq, int d, int splits, int out_bf16,
                                      cudaStream_t stream) {
  if (d % 4 != 0 || splits < 1) return (int)cudaErrorInvalidValue;
  const long long rows = (long long)b * h * sq;
  const long long total = rows * (d / 4);
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (out_bf16)
    combine_kernel<<<blocks, threads, 0, stream>>>(o_part, ml_part,
                                                   static_cast<__nv_bfloat16*>(out), rows, d,
                                                   splits);
  else
    combine_kernel<<<blocks, threads, 0, stream>>>(o_part, ml_part, static_cast<float*>(out),
                                                   rows, d, splits);
  return (int)cudaGetLastError();
}
