// Kernel D-bf16: softmax attention, optionally radius-masked, with bf16
// operands.  q (B, H, Sq, D) already scaled by 1/sqrt(D); k (B, H, D, Skv);
// v (B, H, Skv, D), all bf16; qxyz (B, Sq, 3), kxyz_t (B, 3, Skv) fp32
// -> (B, H, Sq, D), bf16 or fp32 (the wrapper's q dtype).
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
// Bound on the card: operations.  2 * 2 * Sq * Skv * D flops per (batch,
// head), 137 GFLOP per encoder layer at B=32, H=4, S=2048, D=64: 0.14 ms at
// the dense bf16 rate, against 84 MB of bf16 q, k, v and output (0.025 ms).
//
// Layout: kernel D's (attention.cu): a block of 4 warps takes 128 query
// rows, two 16-row MMA tiles a warp; keys in tiles of 32 (16 at D = 128),
// the K^T and V tiles double-buffered in shared memory with cp.async; the
// same key split (`splits` chunks of `chunk` keys, grid z) and the same
// partials (m, l, unnormalized O) for combine_kernel.  Where D runs 3xTF32
// m16n8k8, this runs bf16 mma.sync m16n8k16 (bf16_mma.cuh): no hi/lo split.
// The query tile stays in shared memory as bf16 and its A fragments are
// plain 32-bit loads; K^T and V tiles are [k][n] for both products, so their
// B fragments come by ldmatrix.trans.
//
// Two passes over the block's keys: the first forms the scores for the rows'
// max m and sum l (an online rescale), the second forms them again and
// rounds the normalized p = e / l to bf16 where the TPU kernel rounds it (an
// online softmax keeps p unnormalized to the end, and would round elsewhere).
// The recomputed QK^T costs half the products again.  With split keys each
// chunk normalizes by its own l_s and writes O_s * l_s, so the combine's
// sum_s O_s e^(m_s - M) / sum_s l_s e^(m_s - M) is unchanged.
//
// Shared-memory row strides are padded (Q and V to D + 8, K^T to TK + 8
// bf16) so every 32-bit load and every ldmatrix phase is free of bank
// conflicts.  No dropout: the bf16 detector runs this only at eval.

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"

namespace {

using coda_bf16::ld_u32;
using coda_bf16::ldmatrix_x4_trans;
using coda_bf16::mma_bf16;
using coda_bf16::pack_bf16;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int MT = 2;                  // 16-row MMA tiles a warp
  static constexpr int TQ = 16 * MT * kWarps;   // query rows a block
  static constexpr int TK = D <= 64 ? 32 : 16;  // keys a tile (kernel D's)
  static constexpr int QS = D + 8;              // Qs row stride (bf16)
  static constexpr int KS = TK + 8;             // K^T tile [D][TK] row stride
  static constexpr int VS = D + 8;              // V tile [TK][D] row stride
  static constexpr int K_ELEMS = D * KS;
  static constexpr int V_ELEMS = TK * VS;
  // a stage: the K^T and V tiles (bf16), then the keys' x, y, z (fp32)
  static constexpr size_t STAGE_BYTES = (size_t)(K_ELEMS + V_ELEMS) * 2 + 3 * TK * 4;
  static constexpr size_t Q_BYTES = (size_t)TQ * QS * 2;
  static constexpr size_t SMEM = Q_BYTES + 4 * TQ * 4 + 2 * STAGE_BYTES;
};

// (a0*b0 + a1*b1) + a2*b2, rounded step by step (attention.cu's sum3)
__device__ __forceinline__ float sum3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(coda_bf16::smem_u32addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(coda_bf16::smem_u32addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Start the copies of keys k0 .. k0+TK-1 (zeros at and past kend) into one
// stage: the K^T tile, with `with_v` the V tile and, when masked, the keys'
// coordinates (clamped to the last key).  `vec`: 16-byte copies (Skv and
// the chunk multiples of 8, q, k, v 16-byte aligned); else element by
// element, synchronously.
template <int D>
__device__ __forceinline__ void load_tile(unsigned char* stage, const bf16* kb, const bf16* vb,
                                          const float* kxyz_b, int k0, int kend, int skv,
                                          bool vec, bool masked, bool with_v) {
  using C = Cfg<D>;
  constexpr int TK = C::TK;
  bf16* Ks = reinterpret_cast<bf16*>(stage);
  bf16* Vs = Ks + C::K_ELEMS;
  float* Xs = reinterpret_cast<float*>(Vs + C::V_ELEMS);
  const int tid = threadIdx.x;
  if (vec) {
    for (int e = tid; e < D * (TK / 8); e += kThreads) {
      const int d = e / (TK / 8), c = (e % (TK / 8)) * 8;
      const bool in = k0 + c < kend;  // kend % 8 == 0: a vector is all in or all out
      cp_async16(Ks + d * C::KS + c, in ? kb + (size_t)d * skv + k0 + c : kb, in ? 16 : 0);
    }
    if (with_v) {
      for (int e = tid; e < TK * (D / 8); e += kThreads) {
        const int c = e / (D / 8), d = (e % (D / 8)) * 8;
        const bool in = k0 + c < kend;
        cp_async16(Vs + c * C::VS + d, in ? vb + (size_t)(k0 + c) * D + d : vb, in ? 16 : 0);
      }
    }
  } else {
    const bf16 zero = __float2bfloat16(0.0f);
    for (int e = tid; e < D * TK; e += kThreads) {
      const int d = e / TK, c = e % TK;
      Ks[d * C::KS + c] = k0 + c < kend ? kb[(size_t)d * skv + k0 + c] : zero;
    }
    if (with_v) {
      for (int e = tid; e < TK * D; e += kThreads) {
        const int c = e / D, d = e % D;
        Vs[c * C::VS + d] = k0 + c < kend ? vb[(size_t)(k0 + c) * D + d] : zero;
      }
    }
  }
  if (masked) {
    for (int e = tid; e < 3 * TK; e += kThreads) {
      const int a = e / TK, c = e % TK;
      cp_async4(Xs + a * TK + c, kxyz_b + (size_t)a * skv + min(k0 + c, skv - 1), 4);
    }
  }
}

template <int D, typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const float* __restrict__ qxyz,
                      const float* __restrict__ kxyz_t, OutT* __restrict__ out,
                      float* __restrict__ o_part, float* __restrict__ ml_part, int h, int sq,
                      int skv, int chunk, float radius, bool vec) {
  using C = Cfg<D>;
  constexpr int MT = C::MT;
  constexpr int TQ = C::TQ;
  constexpr int TK = C::TK;
  constexpr int NT = TK / 8;   // score n-tiles (8 keys each) a tile
  constexpr int KD = D / 16;   // k-steps of QK^T
  constexpr int ND = D / 8;    // n-tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);                       // [TQ][QS]
  float* qx = reinterpret_cast<float*>(smem + C::Q_BYTES);        // [4][TQ]: x, y, z, |q|^2
  unsigned char* stages = smem + C::Q_BYTES + 4 * TQ * sizeof(float);

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

  const bf16* qb = q + bh * sq * D;
  const bf16* kb = k + bh * D * skv;
  const bf16* vb = v + bh * skv * D;
  const float* kxyz_b = masked ? kxyz_t + b * 3 * skv : nullptr;
  const int ntiles = (kend - kbeg + TK - 1) / TK;

  // the query tile (zeros past the last query) rides with pass 0's first tile
  if (vec) {
    for (int e = tid; e < TQ * (D / 8); e += kThreads) {
      const int r = e / (D / 8), d = (e % (D / 8)) * 8;
      const bool in = q0 + r < sq;
      cp_async16(Qs + r * C::QS + d, in ? qb + (long long)(q0 + r) * D + d : qb, in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < TQ * D; e += kThreads) {
      const int r = e / D, d = e % D;
      Qs[r * C::QS + d] = q0 + r < sq ? qb[(long long)(q0 + r) * D + d] : __float2bfloat16(0.0f);
    }
  }
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
  float o[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mt][n][e] = 0.0f;
  float m_run[MT][2], l_run[MT][2];  // l_run: this lane's share until pass 0 ends
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_run[mt][i] = -INFINITY;
      l_run[mt][i] = 0.0f;
    }

  for (int pass = 0; pass < 2; ++pass) {
    const bool with_v = pass == 1;
    load_tile<D>(stages, kb, vb, kxyz_b, kbeg, kend, skv, vec, masked, with_v);
    cp_async_commit();
    for (int it = 0; it < ntiles; ++it) {
      const int k0 = kbeg + it * TK;
      if (it + 1 < ntiles)
        load_tile<D>(stages + ((it + 1) & 1) * C::STAGE_BYTES, kb, vb, kxyz_b, k0 + TK, kend,
                     skv, vec, masked, with_v);
      cp_async_commit();
      cp_async_wait<1>();  // this tile's copies have landed
      __syncthreads();
      const bf16* Ks = reinterpret_cast<const bf16*>(stages + (it & 1) * C::STAGE_BYTES);
      const bf16* Vs = Ks + C::K_ELEMS;
      const float* Xs = reinterpret_cast<const float*>(Vs + C::V_ELEMS);

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
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const bf16* qp = Qs + (rw + 16 * mt) * C::QS + kk * 16 + 2 * t;
          a[mt][0] = ld_u32(qp);
          a[mt][1] = ld_u32(qp + 8 * C::QS);
          a[mt][2] = ld_u32(qp + 8);
          a[mt][3] = ld_u32(qp + 8 * C::QS + 8);
        }
        // K^T rows d = 16 kk + 0..7 / 8..15 of n-tiles j and j + 1
        const bf16* krow = Ks + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * C::KS +
                           8 * (lane >> 4);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t b4[4];
          ldmatrix_x4_trans(b4, krow + j * 8);
          const uint32_t b0[2] = {b4[0], b4[1]}, b1[2] = {b4[2], b4[3]};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16(s[mt][j], a[mt], b0);
            mma_bf16(s[mt][j + 1], a[mt], b1);
          }
        }
      }

      // masks (kernel D's), then pass 0's max and sum or pass 1's p
      const bool ragged = k0 + TK > kend;  // the chunk's last tile runs past its last key
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float mx[2] = {-INFINITY, -INFINITY};
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
            mx[e >> 1] = fmaxf(mx[e >> 1], val);
          }
        }
        if (pass == 0) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float m = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
            const float m_new = fmaxf(m_run[mt][i], m);  // finite: every tile holds a key
            float lsum = 0.0f;
            // (s - m) first: an all-masked row has s = m = -FLT_MAX and weight 1
#pragma unroll
            for (int j = 0; j < NT; ++j)
              lsum += exp2f((s[mt][j][2 * i] - m_new) * kLog2e) +
                      exp2f((s[mt][j][2 * i + 1] - m_new) * kLog2e);
            l_run[mt][i] = l_run[mt][i] * exp2f((m_run[mt][i] - m_new) * kLog2e) + lsum;
            m_run[mt][i] = m_new;
          }
        }
      }

      if (pass == 1) {
        // O += P V, 16 keys a k-step: P's A fragment from groups 2 kk, 2 kk + 1;
        // V rows (keys) 16 kk + 0..7 / 8..15 of output n-tiles n and n + 1
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) {
          uint32_t pa[MT][4];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const float* p = s[mt][2 * kk + hh];
              pa[mt][2 * hh] =
                  pack_bf16(__fdiv_rn(exp2f((p[0] - m_run[mt][0]) * kLog2e), l_run[mt][0]),
                            __fdiv_rn(exp2f((p[1] - m_run[mt][0]) * kLog2e), l_run[mt][0]));
              pa[mt][2 * hh + 1] =
                  pack_bf16(__fdiv_rn(exp2f((p[2] - m_run[mt][1]) * kLog2e), l_run[mt][1]),
                            __fdiv_rn(exp2f((p[3] - m_run[mt][1]) * kLog2e), l_run[mt][1]));
            }
          }
          const bf16* vrow = Vs + (kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * C::VS +
                             8 * (lane >> 4);
#pragma unroll
          for (int n = 0; n < ND; n += 2) {
            uint32_t b4[4];
            ldmatrix_x4_trans(b4, vrow + n * 8);
            const uint32_t b0[2] = {b4[0], b4[1]}, b1[2] = {b4[2], b4[3]};
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) {
              mma_bf16(o[mt][n], pa[mt], b0);
              mma_bf16(o[mt][n + 1], pa[mt], b1);
            }
          }
        }
      }
      __syncthreads();  // the stage is consumed before the next load overwrites it
    }
    if (pass == 0) {
      // the rows' whole sums, shared by the quad that holds each row
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float l = l_run[mt][i];
          l += __shfl_xor_sync(0xffffffffu, l, 1);
          l += __shfl_xor_sync(0xffffffffu, l, 2);
          l_run[mt][i] = l;
        }
    }
  }

  const bool split = gridDim.z > 1;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + rw + 16 * mt + 8 * i;
      if (row >= sq) continue;
      if (!split) {
        OutT* op = out + (bh * sq + row) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          if constexpr (sizeof(OutT) == 2) {
            *reinterpret_cast<uint32_t*>(op + n * 8) = pack_bf16(o[mt][n][2 * i], o[mt][n][2 * i + 1]);
          } else {
            *reinterpret_cast<float2*>(op + n * 8) = make_float2(o[mt][n][2 * i], o[mt][n][2 * i + 1]);
          }
        }
      } else {
        // the chunk's output un-normalized again: O_s = o_s l_s
        const float l = l_run[mt][i];
        const long long prow = ((long long)blockIdx.z * gridDim.y + bh) * sq + row;
        float* op = o_part + prow * D + 2 * t;
#pragma unroll
        for (int n = 0; n < ND; ++n)
          *reinterpret_cast<float2*>(op + n * 8) =
              make_float2(o[mt][n][2 * i] * l, o[mt][n][2 * i + 1] * l);
        if (t == 0)
          *reinterpret_cast<float2*>(ml_part + 2 * prow) = make_float2(m_run[mt][i], l);
      }
    }
  }
}

template <int D, typename OutT>
int launch(const bf16* q, const bf16* k, const bf16* v, const float* qxyz, const float* kxyz_t,
           OutT* out, float* o_part, float* ml_part, int b, int h, int sq, int skv, float radius,
           int splits, int chunk, cudaStream_t stream) {
  using C = Cfg<D>;
  if (chunk % C::TK != 0 || (long long)(splits - 1) * chunk >= skv ||
      (long long)splits * chunk < skv)
    return (int)cudaErrorInvalidValue;  // every chunk must hold a key, and all keys a chunk
  cudaError_t err = cudaFuncSetAttribute(
      attention_bf16_kernel<D, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const bool vec = skv % 8 == 0 && chunk % 8 == 0 && ((uintptr_t)q % 16) == 0 &&
                   ((uintptr_t)k % 16) == 0 && ((uintptr_t)v % 16) == 0;
  const dim3 grid((unsigned)((sq + C::TQ - 1) / C::TQ), (unsigned)(b * h), (unsigned)splits);
  attention_bf16_kernel<D, OutT><<<grid, kThreads, C::SMEM, stream>>>(
      q, k, v, qxyz, kxyz_t, out, o_part, ml_part, h, sq, skv, chunk, radius, vec);
  return (int)cudaGetLastError();
}

template <typename OutT>
int dispatch(const bf16* q, const bf16* k, const bf16* v, const float* qxyz,
             const float* kxyz_t, OutT* out, float* o_part, float* ml_part, int b, int h, int sq,
             int skv, int d, float radius, int splits, int chunk, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16>(q, k, v, qxyz, kxyz_t, out, o_part, ml_part, b, h, sq, skv, radius, splits, chunk, stream);
    case 32: return launch<32>(q, k, v, qxyz, kxyz_t, out, o_part, ml_part, b, h, sq, skv, radius, splits, chunk, stream);
    case 64: return launch<64>(q, k, v, qxyz, kxyz_t, out, o_part, ml_part, b, h, sq, skv, radius, splits, chunk, stream);
    case 128: return launch<128>(q, k, v, qxyz, kxyz_t, out, o_part, ml_part, b, h, sq, skv, radius, splits, chunk, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// out: bf16 where out_bf16, else fp32.  splits > 1 needs o_part (splits * b
// * h * sq * d floats) and ml_part (splits * b * h * sq * 2 floats) and
// leaves `out` to coda_attention_combine.
extern "C" int coda_attention_bf16(const bf16* q, const bf16* k, const bf16* v,
                                   const float* qxyz, const float* kxyz_t, void* out,
                                   float* o_part, float* ml_part, int b, int h, int sq, int skv,
                                   int d, float radius, int out_bf16, int splits, int chunk,
                                   cudaStream_t stream) {
  if (sq < 1 || skv < 1 || splits < 1 || splits > 65535 || (long long)b * h > 65535 ||
      (splits > 1 && (o_part == nullptr || ml_part == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (out_bf16)
    return dispatch(q, k, v, qxyz, kxyz_t, static_cast<bf16*>(out), o_part, ml_part, b, h, sq,
                    skv, d, radius, splits, chunk, stream);
  return dispatch(q, k, v, qxyz, kxyz_t, static_cast<float*>(out), o_part, ml_part, b, h, sq,
                  skv, d, radius, splits, chunk, stream);
}
