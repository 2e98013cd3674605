// Kernel D: softmax attention, optionally radius-masked, fp32 on CUDA cores.
// q (B, H, Sq, D) already scaled by 1/sqrt(D); k (B, H, D, Skv);
// v (B, H, Skv, D); qxyz (B, Sq, 3); kxyz_t (B, 3, Skv) -> (B, H, Sq, D).
//
// Replaces coda_neurips2023_tpu/ops/pallas_masked_attention.py ::
// masked_attention (_kernel, _impl).  Semantics: scores = q . k; with
// radius > 0 a key is allowed where sqrt(max(|q|^2 + |k|^2 - 2 q.k, 0)) <
// radius (radius is already squared by the caller, a reference quirk kept
// verbatim), and a disallowed score is set to finfo(f32).min before the
// softmax, so a row with no allowed key comes out uniform, as in JAX.  The
// squared norms, the cross term and d2 are rounded in the plain version's
// order, so a key near the radius is allowed or not by both alike.
//
// Bound on the card: the two products, 2 * 2 * S_q * S_kv * D flops per
// (batch, head): 137 GFLOP per encoder layer at B=32, H=4, S=2048, D=64, on
// fp32 CUDA cores (67 TFLOP/s peak), since the operands are fp32.  The TPU kernel kept a whole
// (H, TQ, S) score block in VMEM; a block here has at most 227 KB of shared
// memory, so the kernel is flash-style: one block per (batch*head, 64-query
// tile) walks the keys in tiles of 64 with an online softmax, and neither
// the (S_q, S_kv) scores nor the mask ever reach device memory.  256
// threads; each owns a 4 x 4 patch of the score tile and a 4 x D/16 patch of
// the output accumulator in registers.  Tensor cores (wgmma) and bf16
// operands are later work.

#include <cfloat>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTQ = 64;  // query rows per block
constexpr int kTK = 64;  // keys per tile
constexpr int kThreads = 256;

// (a0*b0 + a1*b1) + a2*b2, rounded step by step (no FMA contraction), the
// order of the plain PyTorch version: the mask is decided on identical bits.
__device__ __forceinline__ float sum3(float a0, float b0, float a1, float b1,
                                      float a2, float b2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(a0, b0), __fmul_rn(a1, b1)), __fmul_rn(a2, b2));
}

template <int D>
constexpr size_t smem_floats() {
  return kTQ * (D + 1)       // Qs, padded rows
         + D * kTK           // Ks
         + kTK * D           // Vs
         + kTQ * (kTK + 1)   // Ss, padded rows
         + 3 * kTQ           // running max, running sum, rescale factor
         + 4 * kTQ           // query x, y, z, |q|^2
         + 4 * kTK;          // key x, y, z, |k|^2
}

template <int D>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ qxyz,
                 const float* __restrict__ kxyz_t, float* __restrict__ out, int h,
                 int sq, int skv, float radius) {
  constexpr int DJ = D / 16;  // output columns a thread owns
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTQ * (D + 1);
  float* Vs = Ks + D * kTK;
  float* Ss = Vs + kTK * D;
  float* row_m = Ss + kTQ * (kTK + 1);
  float* row_l = row_m + kTQ;
  float* row_a = row_l + kTQ;
  float* qx = row_a + kTQ;   // [4][kTQ]
  float* kx = qx + 4 * kTQ;  // [4][kTK]

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const long long bh = blockIdx.x;
  const long long b = bh / h;
  const int q0 = blockIdx.y * kTQ;
  const bool masked = radius > 0.0f;

  const float* qb = q + bh * sq * D;
  const float* kb = k + bh * D * skv;
  const float* vb = v + bh * skv * D;

  for (int e = tid; e < kTQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    Qs[r * (D + 1) + d] = (q0 + r < sq) ? qb[(long long)(q0 + r) * D + d] : 0.0f;
  }
  if (tid < kTQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.0f;
    if (masked) {
      const int gq = min(q0 + tid, sq - 1);
      const float* p = qxyz + (b * sq + gq) * 3;
      const float x = p[0], y = p[1], z = p[2];
      qx[tid] = x;
      qx[kTQ + tid] = y;
      qx[2 * kTQ + tid] = z;
      qx[3 * kTQ + tid] = sum3(x, x, y, y, z, z);
    }
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < skv; k0 += kTK) {
    __syncthreads();  // the previous tile's Ks, Vs and Ss are consumed
    for (int e = tid; e < D * kTK; e += kThreads) {
      const int d = e / kTK, c = e % kTK;
      Ks[d * kTK + c] = (k0 + c < skv) ? kb[(long long)d * skv + k0 + c] : 0.0f;
    }
    for (int e = tid; e < kTK * D; e += kThreads) {
      const int c = e / D, d = e % D;
      Vs[c * D + d] = (k0 + c < skv) ? vb[(long long)(k0 + c) * D + d] : 0.0f;
    }
    if (masked && tid < kTK) {
      const int gk = min(k0 + tid, skv - 1);
      const float* p = kxyz_t + b * 3 * skv;
      const float x = p[gk], y = p[skv + gk], z = p[2 * skv + gk];
      kx[tid] = x;
      kx[kTK + tid] = y;
      kx[2 * kTK + tid] = z;
      kx[3 * kTK + tid] = sum3(x, x, y, y, z, z);
    }
    __syncthreads();

    // scores for rows ty*4 + i, columns tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Ks[d * kTK + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        float val = s[i][j];
        if (k0 + c >= skv) {
          val = -INFINITY;  // past the last key: not a key at all
        } else if (masked) {
          const float cross = sum3(qx[r], kx[c], qx[kTQ + r], kx[kTK + c],
                                   qx[2 * kTQ + r], kx[2 * kTK + c]);
          const float d2 = fmaxf(
              __fsub_rn(__fadd_rn(qx[3 * kTQ + r], kx[3 * kTK + c]), __fmul_rn(2.0f, cross)),
              0.0f);
          if (!(__fsqrt_rn(d2) < radius)) val = -FLT_MAX;
        }
        Ss[r * (kTK + 1) + c] = val;
      }
    }
    __syncthreads();

    // online softmax: warp w updates rows 8w .. 8w+7
    const int lane = tid & 31;
    const int warp = tid >> 5;
    for (int r = warp * (kTQ / 8); r < (warp + 1) * (kTQ / 8); ++r) {
      float x[kTK / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < kTK / 32; ++c) {
        x[c] = Ss[r * (kTK + 1) + lane + 32 * c];
        mx = fmaxf(mx, x[c]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < kTK / 32; ++c) {
        const float p = expf(x[c] - m_new);
        Ss[r * (kTK + 1) + lane + 32 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);  // 0 on the first tile
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
        row_a[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = row_a[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < kTK; ++c) {
      float p[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ss[(ty * 4 + i) * (kTK + 1) + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }

  float* ob = out + bh * sq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r < sq) {
      const float l = row_l[r];
#pragma unroll
      for (int j = 0; j < DJ; ++j) ob[(long long)(q0 + r) * D + tx + 16 * j] = acc[i][j] / l;
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* qxyz,
           const float* kxyz_t, float* out, int b, int h, int sq, int skv,
           float radius, cudaStream_t stream) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(b * h), (unsigned)((sq + kTQ - 1) / kTQ));
  attention_kernel<D><<<grid, kThreads, bytes, stream>>>(q, k, v, qxyz, kxyz_t, out,
                                                          h, sq, skv, radius);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int coda_attention(const float* q, const float* k, const float* v,
                              const float* qxyz, const float* kxyz_t, float* out,
                              int b, int h, int sq, int skv, int d, float radius,
                              cudaStream_t stream) {
  if ((sq + kTQ - 1) / kTQ > 65535) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 16: return launch<16>(q, k, v, qxyz, kxyz_t, out, b, h, sq, skv, radius, stream);
    case 32: return launch<32>(q, k, v, qxyz, kxyz_t, out, b, h, sq, skv, radius, stream);
    case 64: return launch<64>(q, k, v, qxyz, kxyz_t, out, b, h, sq, skv, radius, stream);
    case 128: return launch<128>(q, k, v, qxyz, kxyz_t, out, b, h, sq, skv, radius, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
