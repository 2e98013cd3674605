// Kernel E: unmasked softmax attention for the CLIP ViT image tower, fp32 on
// CUDA cores.  q, k, v (B, H, S, D), contiguous, q unscaled -> out (B, H, S, D)
// = softmax(q k^T * scale) v, scale = 1/sqrt(D), softmax over all S keys.
//
// Replaces coda_neurips2023_tpu/ops/pallas_vit_attention.py :: vit_attention
// (_vit_attention_impl, _attn_kernel).  The TPU kernel kept a whole
// (H, S, S) f32 score block of one crop in VMEM and ran both products on the
// MXU.  Here a block owns one (crop*head, 64-query tile): at ViT-B/16's
// S = 197, D = 64 the whole K and V of the head (2 x 197 x 64 x 4 B = 101 KB)
// and the tile's 64 x S scores fit in the 227 KB of shared memory, so the
// softmax is an exact two-pass row softmax (max, then sum of exponentials)
// with no online rescaling, and no score reaches device memory.  Tiles of one
// head are adjacent in the grid, so the four loads of a head's K and V after
// the first come from L2.
//
// Bound on the card: 4 * S^2 * D flops per (crop, head), 0.12 GFLOP, against
// 3 * S * D * 4 B = 151 KB read and 50 KB written: about 600 flops a byte,
// so the fp32 CUDA cores (67 TFLOP/s peak) bound it.  256 threads; a thread
// owns a 4 x 4 patch of each 64-key slice of the scores and a 4 x D/16 patch
// of the output in registers.  S = 197 is ragged for every tile: K rows past
// S are zero and their scores never enter the softmax; query rows past S are
// computed on zeros and not stored.  Tensor cores (wgmma), bf16 operands and
// more than one block a multiprocessor are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTQ = 64;  // query rows per block
constexpr int kTK = 64;  // keys per score slice
constexpr int kThreads = 256;
constexpr size_t kMaxSmemBytes = 232448;  // a block's limit on sm_90

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Must equal coda_neurips2023_tpu_torch/ops/vit_attention.py :: _smem_bytes.
template <int D>
size_t smem_bytes(int s) {
  const size_t sp = (size_t)round_up(s, kTK);
  return sizeof(float) * (sp * (D + 1)           // Ks, padded rows
                          + (size_t)s * D        // Vs
                          + kTQ * (D + 1)        // Qs, padded rows
                          + kTQ * (sp + 1)       // Ss, padded rows
                          + kTQ);                // 1 / row sum
}

template <int D>
__global__ void __launch_bounds__(kThreads)
vit_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out, int s,
                     float scale) {
  constexpr int DJ = D / 16;  // output columns a thread owns
  constexpr int D4 = D / 4;
  const int sp = round_up(s, kTK);
  const int ntiles = (s + kTQ - 1) / kTQ;
  const long long bh = blockIdx.x / ntiles;
  const int q0 = (blockIdx.x % ntiles) * kTQ;

  extern __shared__ float smem[];
  float* Ks = smem;                  // [sp][D + 1]
  float* Vs = Ks + sp * (D + 1);     // [s][D]; sp * (D + 1) is a multiple of 4
  float* Qs = Vs + s * D;            // [kTQ][D + 1]
  float* Ss = Qs + kTQ * (D + 1);    // [kTQ][sp + 1]
  float* row_inv = Ss + kTQ * (sp + 1);

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const float4* q4 = reinterpret_cast<const float4*>(q + (bh * s + q0) * D);
  const float4* k4 = reinterpret_cast<const float4*>(k + bh * s * D);
  const float4* v4 = reinterpret_cast<const float4*>(v + bh * s * D);

  for (int e = tid; e < sp * D4; e += kThreads) {
    const int r = e / D4, c = (e % D4) * 4;
    const float4 x = r < s ? k4[e] : make_float4(0.f, 0.f, 0.f, 0.f);
    float* dst = Ks + r * (D + 1) + c;
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
  }
  for (int e = tid; e < s * D4; e += kThreads) reinterpret_cast<float4*>(Vs)[e] = v4[e];
  for (int e = tid; e < kTQ * D4; e += kThreads) {
    const int r = e / D4, c = (e % D4) * 4;
    const float4 x = q0 + r < s ? q4[e] : make_float4(0.f, 0.f, 0.f, 0.f);
    float* dst = Qs + r * (D + 1) + c;
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
  }
  __syncthreads();

  // scores, 64 keys at a time: rows ty*4 + i, keys c0 + tx + 16*j
  for (int c0 = 0; c0 < sp; c0 += kTK) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[(c0 + tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ss[(ty * 4 + i) * (sp + 1) + c0 + tx + 16 * j] = acc[i][j] * scale;
  }
  __syncthreads();

  // exact row softmax over the s real keys: warp w takes rows 8w .. 8w+7;
  // Ss keeps exp(x - max), row_inv the reciprocal of the row's sum
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int r = warp * (kTQ / 8); r < (warp + 1) * (kTQ / 8); ++r) {
    float* row = Ss + r * (sp + 1);
    float mx = -INFINITY;
    for (int c = lane; c < s; c += 32) mx = fmaxf(mx, row[c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.0f;
    for (int c = lane; c < s; c += 32) {
      const float p = expf(row[c] - mx);
      row[c] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) row_inv[r] = 1.0f / sum;
  }
  __syncthreads();

  // out = p v: rows ty*4 + i, columns tx + 16*j
  float o[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[i][j] = 0.0f;
#pragma unroll 4
  for (int c = 0; c < s; ++c) {
    float p[4], vv[DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = Ss[(ty * 4 + i) * (sp + 1) + c];
#pragma unroll
    for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DJ; ++j) o[i][j] = fmaf(p[i], vv[j], o[i][j]);
  }
  float* ob = out + (bh * s + q0) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r < s) {
      const float inv = row_inv[r];
#pragma unroll
      for (int j = 0; j < DJ; ++j) ob[(long long)r * D + tx + 16 * j] = o[i][j] * inv;
    }
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* out, int bh, int s,
           float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>(s);
  if (bytes > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)bh * ((s + kTQ - 1) / kTQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      vit_attention_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  vit_attention_kernel<D><<<(unsigned)blocks, kThreads, bytes, stream>>>(q, k, v, out, s, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int coda_vit_attention(const float* q, const float* k, const float* v, float* out,
                                  int bh, int s, int d, float scale, cudaStream_t stream) {
  if (bh < 1 || s < 1) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 32: return launch<32>(q, k, v, out, bh, s, scale, stream);
    case 64: return launch<64>(q, k, v, out, bh, s, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
