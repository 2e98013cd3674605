// Kernel E: unmasked softmax attention for the CLIP ViT image tower,
// fp32-accurate on the tensor cores.  q, k, v (B, H, S, D), contiguous, q
// unscaled -> out (B, H, S, D) = softmax(q k^T * scale) v, scale = 1/sqrt(D),
// softmax over all S keys.
//
// Replaces coda_neurips2023_tpu/ops/pallas_vit_attention.py :: vit_attention
// (_vit_attention_impl, _attn_kernel).  The TPU kernel kept a whole (H, S,
// S) f32 score block of one crop in VMEM and ran both products on the MXU.
//
// Bound on the card: operations.  4 S^2 D flops per (crop, head), 9.9
// MFLOP at ViT-B/16's S = 197, D = 64, against 4 S D 4 B = 202 KB moved:
// the two products run in 3xTF32 (tf32_mma.cuh) at 165 TFLOP/s, the
// softmax on the fp32 CUDA cores.
//
// Design.  A block owns one (crop, head): the head's whole K and V are
// loaded once and stay resident in shared memory, so no key is split off
// and nothing is combined.  In the form kept (kPreSplit), K and V are split
// into TF32 hi and lo once, as they are stored: 4 x 200 x 68 x 4 B = 213 KB
// at S = 197, D = 64, one block a multiprocessor, and every fragment load
// after that is a plain load.  The other form keeps K and V in fp32 (106
// KB) and splits each fragment as it is loaded, the split that bounded
// kernel D; scripts/bench_torch_attention.py times both.  Thirteen warps
// take the head's 16-row query tiles (13 at S = 197, one each; a longer S
// loops).  A warp holds its tile's q as fp32 A fragments in registers,
// scaled first, and splits them at each use: at D = 64 the scale 1/8 is a
// power of two and folding it into q is exact, as the TPU kernel does; at
// D = 32 the scores are scaled instead.  It walks the keys in
// chunks of 64 with an online softmax (running max and sum in registers, as
// kernel D) and feeds P from the accumulator registers straight into PV:
// the accumulator holds keys 2t and 2t+1 of an 8-key group in lane t of a
// quad, which PV takes as its k-indices t and t+4, reading V's rows in that
// order.  Rows of K and V in shared memory are padded to D + 4 floats, so
// every fragment load is free of bank conflicts.
//
// The ragged S = 197 = 12 x 16 + 5 query rows = 24 x 8 + 5 keys: keys are
// padded to a multiple of 8 (200, 1.5% over 197) with zero rows of K and V,
// and a score at or past S is set to -inf before the max, so it enters
// neither the max nor the sum; query rows are padded to a multiple of 16
// (208, 5.6% over 197), computed on zeros and never stored.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

using coda_tf32::mma_3xtf32;
using coda_tf32::split_tf32;

constexpr int kWarps = 13;  // one warp a 16-row query tile at S = 197
constexpr int kThreads = 32 * kWarps;
constexpr int kTK = 64;  // keys a score chunk
// the resident form: K and V split into TF32 hi and lo once, in shared memory
constexpr bool kPreSplit = true;
constexpr size_t kMaxSmemBytes = 232448;  // a block's limit on sm_90
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ inline int key_rows(int s) { return (s + 7) / 8 * 8; }

// Must equal coda_neurips2023_tpu_torch/ops/vit_attention.py :: _smem_bytes.
template <int D, bool PRESPLIT>
size_t smem_bytes(int s) {
  return sizeof(float) * (PRESPLIT ? 4 : 2) * (size_t)key_rows(s) * (D + 4);
}

template <int D, bool PRESPLIT>
__global__ void __launch_bounds__(kThreads, 1)
vit_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, int s,
                     float qscale, float sscale) {
  constexpr int KS = D + 4;  // row stride of K and V in shared memory (floats)
  constexpr int KD = D / 8;  // k-steps of QK^T, n-tiles of the output
  constexpr int NT = kTK / 8;
  constexpr int D4 = D / 4;
  const int rows = key_rows(s);
  const long long bh = blockIdx.x;

  extern __shared__ __align__(16) float smem[];
  float* Kh = smem;             // [rows][KS]: K, or its TF32 hi
  float* Vh = Kh + rows * KS;   // V, or its hi
  float* Kl = Vh + rows * KS;   // PRESPLIT: K's TF32 lo
  float* Vl = Kl + rows * KS;   // PRESPLIT: V's lo

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const float* qb = q + bh * s * D;
  const float4* k4 = reinterpret_cast<const float4*>(k + bh * s * D);
  const float4* v4 = reinterpret_cast<const float4*>(v + bh * s * D);

  // the head's K and V, zero rows past s
#pragma unroll 4
  for (int e = tid; e < rows * D4; e += kThreads) {
    const int r = e / D4, i = r * KS + (e % D4) * 4;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 kx = r < s ? k4[e] : zero;
    const float4 vx = r < s ? v4[e] : zero;
    if (PRESPLIT) {
      uint32_t h[8], l[8];
      split_tf32(kx.x, h[0], l[0]);
      split_tf32(kx.y, h[1], l[1]);
      split_tf32(kx.z, h[2], l[2]);
      split_tf32(kx.w, h[3], l[3]);
      split_tf32(vx.x, h[4], l[4]);
      split_tf32(vx.y, h[5], l[5]);
      split_tf32(vx.z, h[6], l[6]);
      split_tf32(vx.w, h[7], l[7]);
      *reinterpret_cast<uint4*>(Kh + i) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(Kl + i) = make_uint4(l[0], l[1], l[2], l[3]);
      *reinterpret_cast<uint4*>(Vh + i) = make_uint4(h[4], h[5], h[6], h[7]);
      *reinterpret_cast<uint4*>(Vl + i) = make_uint4(l[4], l[5], l[6], l[7]);
    } else {
      *reinterpret_cast<float4*>(Kh + i) = kx;
      *reinterpret_cast<float4*>(Vh + i) = vx;
    }
  }
  __syncthreads();

  const int qtiles = (s + 15) / 16;
  for (int tile = warp; tile < qtiles; tile += kWarps) {
    const int r0 = tile * 16;
    // the tile's q as A fragments, scaled (split at each use, which keeps
    // the registers of 13 warps in bounds): element c of k-step kk is
    // q[r0 + g + 8 (c & 1)][8 kk + t + 4 (c >> 1)]
    float qf[KD][4];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int row = r0 + g + 8 * (c & 1);
        qf[kk][c] = row < s ? __fmul_rn(__ldg(qb + (long long)row * D + kk * 8 + t + 4 * (c >> 1)),
                                        qscale)
                            : 0.0f;
      }
    }

    float o[KD][4];
#pragma unroll
    for (int n = 0; n < KD; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
    float m_run[2] = {-INFINITY, -INFINITY};
    float l_run[2] = {0.0f, 0.0f};  // this lane's share of rows g and g + 8's sums

    for (int c0 = 0; c0 < rows; c0 += kTK) {
      const int nt = min(NT, (rows - c0) / 8);  // 8-key groups in this chunk
      float sc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t qh[4], ql[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) split_tf32(qf[kk][c], qh[c], ql[c]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j < nt) {
            const int i = (c0 + j * 8 + g) * KS + kk * 8 + t;
            uint32_t bh2[2], bl2[2];
            if (PRESPLIT) {
              bh2[0] = __float_as_uint(Kh[i]);
              bh2[1] = __float_as_uint(Kh[i + 4]);
              bl2[0] = __float_as_uint(Kl[i]);
              bl2[1] = __float_as_uint(Kl[i + 4]);
            } else {
              split_tf32(Kh[i], bh2[0], bl2[0]);
              split_tf32(Kh[i + 4], bh2[1], bl2[1]);
            }
            mma_3xtf32(sc[j], qh, ql, bh2, bl2);
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
          const float val = key < s ? __fmul_rn(sc[j][e], sscale) : -INFINITY;
          sc[j][e] = val;
          mx[e >> 1] = fmaxf(mx[e >> 1], val);
        }
      }
      float alpha[2], lsum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float m = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        const float m_new = fmaxf(m_run[i], m);  // finite: every chunk starts below s
        alpha[i] = exp2f((m_run[i] - m_new) * kLog2e);  // 0 on the first chunk
        m_run[i] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f((sc[j][e] - m_run[e >> 1]) * kLog2e);
          lsum[e >> 1] += p;
          sc[j][e] = p;
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_run[i] = l_run[i] * alpha[i] + lsum[i];
#pragma unroll
      for (int n = 0; n < KD; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }

      // O += P V: keys 2t and 2t+1 of group j are the A fragment's k-indices
      // t and t+4, so V is read at rows 2t and 2t+1
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt) {
          uint32_t ah[4], al[4];
          split_tf32(sc[j][0], ah[0], al[0]);
          split_tf32(sc[j][2], ah[1], al[1]);
          split_tf32(sc[j][1], ah[2], al[2]);
          split_tf32(sc[j][3], ah[3], al[3]);
          const int i0 = (c0 + j * 8 + 2 * t) * KS + g;
#pragma unroll
          for (int n = 0; n < KD; ++n) {
            const int i = i0 + n * 8;
            uint32_t bh2[2], bl2[2];
            if (PRESPLIT) {
              bh2[0] = __float_as_uint(Vh[i]);
              bh2[1] = __float_as_uint(Vh[i + KS]);
              bl2[0] = __float_as_uint(Vl[i]);
              bl2[1] = __float_as_uint(Vl[i + KS]);
            } else {
              split_tf32(Vh[i], bh2[0], bl2[0]);
              split_tf32(Vh[i + KS], bh2[1], bl2[1]);
            }
            mma_3xtf32(o[n], ah, al, bh2, bl2);
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_run[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = r0 + g + 8 * i;
      if (row < s) {
        float* op = out + (bh * s + row) * D + 2 * t;
#pragma unroll
        for (int n = 0; n < KD; ++n)
          *reinterpret_cast<float2*>(op + n * 8) =
              make_float2(o[n][2 * i] / l, o[n][2 * i + 1] / l);
      }
    }
  }
}

template <int D, bool PRESPLIT>
int launch(const float* q, const float* k, const float* v, float* out, int bh, int s,
           float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D, PRESPLIT>(s);
  if (bytes > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  // once an instantiation, for every S: the limit, not this call's bytes
  static const cudaError_t attr = cudaFuncSetAttribute(
      vit_attention_kernel<D, PRESPLIT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kMaxSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  // a power-of-two scale folds into q exactly; any other scales the scores
  int exponent;
  const bool fold = frexpf(scale, &exponent) == 0.5f;
  vit_attention_kernel<D, PRESPLIT><<<(unsigned)bh, kThreads, bytes, stream>>>(
      q, k, v, out, s, fold ? scale : 1.0f, fold ? 1.0f : scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int coda_vit_attention(const float* q, const float* k, const float* v, float* out,
                                  int bh, int s, int d, float scale, cudaStream_t stream) {
  if (bh < 1 || s < 1) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 32: return launch<32, kPreSplit>(q, k, v, out, bh, s, scale, stream);
    case 64: return launch<64, kPreSplit>(q, k, v, out, bh, s, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
