// Kernel E-bf16: unmasked softmax attention for the bf16 CLIP ViT image
// tower.  q, k, v (B, H, S, D) bf16, contiguous, q unscaled -> out (B, H, S,
// D) bf16 = softmax(q k^T * scale) v, scale = 1/sqrt(D), over all S keys.
//
// Replaces coda_neurips2023_tpu/ops/pallas_vit_attention.py :: vit_attention
// at its own operands (_attn_kernel with bf16 q, k, v): the scores are fp32
// sums of bf16 products, scaled in fp32 (a power-of-two scale, which the
// TPU kernel folds into q in bf16, scales exactly either way); the softmax is
// fp32, p = e * (1 / sum e) is rounded to bf16 before the PV product, which
// sums in fp32; the output is rounded to bf16 once.
//
// Bound on the card: operations.  4 S^2 D flops per (crop, head), 9.9 MFLOP
// at ViT-B/16's S = 197, D = 64, against 4 S D 2 B = 101 KB moved; the two
// products at the dense bf16 rate, the softmax on the fp32 CUDA cores.
//
// Design.  A block owns one (crop, head): the head's K and V, bf16, stay
// resident in shared memory (2 x 208 x 72 x 2 B = 60 KB at S = 197, D = 64,
// half kernel E's fp32 bytes), so no key is split off and nothing is
// combined.  Thirteen warps take the head's 16-row query tiles (13 at S =
// 197; a longer S loops).  A warp holds its tile's q as bf16 A fragments in
// registers and makes two passes over the keys in chunks of 64: the first
// forms the scores for the rows' max and sum (an online rescale), the second
// forms them again and rounds the normalized p to bf16 where the TPU kernel
// rounds it, which an online softmax (p unnormalized until the end) could
// not.  The recomputed QK^T costs a third more tensor-core work.  The score
// accumulators of two 8-key groups are P's A fragment for a 16-key k-step
// (bf16_mma.cuh); V's B fragments come from shared memory by
// ldmatrix.trans, K's by plain 32-bit loads (K is [key][d], B's n by k).
// Rows of K and V in shared memory are padded to D + 8 bf16, so both are
// free of bank conflicts.
//
// The ragged S = 197: keys are padded to a multiple of 16 (208) with zero
// rows of K and V, and a score at or past S is set to -inf before the max,
// so it enters neither the max nor the sum; query rows are padded to a
// multiple of 16, computed on zeros and never stored.

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

constexpr int kWarps = 13;  // one warp a 16-row query tile at S = 197
constexpr int kThreads = 32 * kWarps;
constexpr int kTK = 64;  // keys a score chunk
constexpr size_t kMaxSmemBytes = 232448;  // a block's limit on sm_90
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ inline int key_rows(int s) { return (s + 15) / 16 * 16; }

// Must equal coda_neurips2023_tpu_torch/ops/vit_attention.py :: _smem_bytes.
template <int D>
size_t smem_bytes(int s) {
  return sizeof(bf16) * 2 * (size_t)key_rows(s) * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
vit_attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out, int s,
                          float scale) {
  constexpr int KS = D + 8;  // row stride of K and V in shared memory (bf16)
  constexpr int KD = D / 16;  // k-steps of QK^T
  constexpr int ND = D / 8;   // n-tiles of the output
  constexpr int NT = kTK / 8;
  constexpr int D8 = D / 8;   // 16-byte vectors a row
  const int rows = key_rows(s);
  const long long bh = blockIdx.x;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [rows][KS]
  bf16* Vs = Ks + rows * KS;                     // [rows][KS]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bf16* qb = q + bh * s * D;
  const uint4* k16 = reinterpret_cast<const uint4*>(k + bh * s * D);
  const uint4* v16 = reinterpret_cast<const uint4*>(v + bh * s * D);

  // the head's K and V, zero rows past s
  for (int e = tid; e < rows * D8; e += kThreads) {
    const int r = e / D8, i = r * KS + (e % D8) * 8;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    *reinterpret_cast<uint4*>(Ks + i) = r < s ? k16[e] : zero;
    *reinterpret_cast<uint4*>(Vs + i) = r < s ? v16[e] : zero;
  }
  __syncthreads();

  const int qtiles = (s + 15) / 16;
  for (int tile = warp; tile < qtiles; tile += kWarps) {
    const int r0 = tile * 16;
    // the tile's q as A fragments: a[c] of k-step kk is the pair at row
    // r0 + g + 8 (c & 1), columns 16 kk + 2t + 8 (c >> 1)
    uint32_t qa[KD][4];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = r0 + g + 8 * (c & 1);
        qa[kk][c] = row < s ? ld_u32(qb + (long long)row * D + kk * 16 + 2 * t + 8 * (c >> 1))
                            : 0u;
      }
    }

    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.0f, 0.0f};  // this lane's share of rows g and g + 8's sums
    float o[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
    float inv_l[2];

    // pass 0: the rows' max and sum; pass 1: p, rounded, times V
    for (int pass = 0; pass < 2; ++pass) {
      for (int c0 = 0; c0 < rows; c0 += kTK) {
        const int nt = min(NT, (rows - c0) / 8);  // 8-key groups in this chunk (even)
        float sc[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (j < nt) {
              const bf16* kp = Ks + (c0 + j * 8 + g) * KS + kk * 16 + 2 * t;
              const uint32_t b[2] = {ld_u32(kp), ld_u32(kp + 8)};
              mma_bf16(sc[j], qa[kk], b);
            }
          }
        }
        // scale; keys at and past s (and groups past nt) are no keys at all
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = c0 + j * 8 + 2 * t + (e & 1);
            const float val = key < s ? __fmul_rn(sc[j][e], scale) : -INFINITY;
            sc[j][e] = val;
            mx[e >> 1] = fmaxf(mx[e >> 1], val);
          }
        }
        if (pass == 0) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float m = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
            m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
            const float m_new = fmaxf(m_run[i], m);  // finite: every chunk starts below s
            float lsum = 0.0f;
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                lsum += exp2f((sc[j][2 * i + e] - m_new) * kLog2e);
            l_run[i] = l_run[i] * exp2f((m_run[i] - m_new) * kLog2e) + lsum;
            m_run[i] = m_new;
          }
          continue;
        }
        // O += P V, 16 keys a k-step: P's A fragment from groups 2 kk, 2 kk + 1
#pragma unroll
        for (int kk = 0; kk < NT / 2; ++kk) {
          if (2 * kk < nt) {
            uint32_t pa[4];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float* p = sc[2 * kk + h];
              pa[2 * h] = pack_bf16(exp2f((p[0] - m_run[0]) * kLog2e) * inv_l[0],
                                    exp2f((p[1] - m_run[0]) * kLog2e) * inv_l[0]);
              pa[2 * h + 1] = pack_bf16(exp2f((p[2] - m_run[1]) * kLog2e) * inv_l[1],
                                        exp2f((p[3] - m_run[1]) * kLog2e) * inv_l[1]);
            }
            // lanes 8j .. 8j+7 name the rows of matrix j: keys +0..7 / +8..15
            // of n-tiles n and n + 1
            const int key = c0 + kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
            const bf16* vrow = Vs + key * KS + 8 * (lane >> 4);
#pragma unroll
            for (int n = 0; n < ND; n += 2) {
              uint32_t b4[4];
              ldmatrix_x4_trans(b4, vrow + n * 8);
              const uint32_t b0[2] = {b4[0], b4[1]}, b1[2] = {b4[2], b4[3]};
              mma_bf16(o[n], pa, b0);
              mma_bf16(o[n + 1], pa, b1);
            }
          }
        }
      }
      if (pass == 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float l = l_run[i];
          l += __shfl_xor_sync(0xffffffffu, l, 1);
          l += __shfl_xor_sync(0xffffffffu, l, 2);
          inv_l[i] = 1.0f / l;
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r0 + g + 8 * i;
      if (row < s) {
        bf16* op = out + (bh * s + row) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < ND; ++n)
          *reinterpret_cast<uint32_t*>(op + n * 8) = pack_bf16(o[n][2 * i], o[n][2 * i + 1]);
      }
    }
  }
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, int bh, int s, float scale,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>(s);
  if (bytes > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  // once an instantiation, for every S: the limit, not this call's bytes
  static const cudaError_t attr = cudaFuncSetAttribute(
      vit_attention_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kMaxSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  vit_attention_bf16_kernel<D><<<(unsigned)bh, kThreads, bytes, stream>>>(q, k, v, out, s, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int coda_vit_attention_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                       int bh, int s, int d, float scale, cudaStream_t stream) {
  if (bh < 1 || s < 1) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 32: return launch<32>(q, k, v, out, bh, s, scale, stream);
    case 64: return launch<64>(q, k, v, out, bh, s, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
