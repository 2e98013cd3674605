// Kernel E-bf16: unmasked softmax attention for the bf16 CLIP ViT image
// tower.  q, k, v (B, H, S, D) bf16, contiguous, q unscaled -> out (B, H, S,
// D) bf16 = softmax(q k^T * scale) v, scale = 1/sqrt(D), over all S keys.
//
// Replaces coda_neurips2023_tpu/ops/pallas_vit_attention.py :: vit_attention
// at its own operands (_attn_kernel with bf16 q, k, v): the scores are fp32
// sums of bf16 products; the softmax is fp32, p = e * (1 / sum e) is rounded
// to bf16 before the PV product, which sums in fp32; the output is rounded
// to bf16 once.  The scale enters the exponent, e = 2^fma(s, scale log2 e,
// -m scale log2 e) with m the row's largest unscaled score (the TPU kernel
// folds it into q in bf16; the long branch multiplies the scores in fp32).
//
// Bound on the card: bytes.  A (crop, head) reads q, k, v and writes the
// output, 4 S D 2 = 101 KB at ViT-B/16's S = 197, D = 64, against 4 S^2 D =
// 9.9 MFLOP on the tensor cores: 155 MB and 0.046 ms at 128 crops x 12 heads,
// where the products take 0.016 ms at the dense bf16 rate.  In practice the
// warps' mma.sync, exps and fp32 work a head take as long as its bytes.
//
// Design (S <= 256, the tower's 197).  Persistent blocks, one an SM, walk
// over the (crop, head) pairs.  A head's q, k and v are each contiguous; a
// TMA copy (tma.cuh: 3-D tensor maps over (B*H, S, D), a box of the head's
// rows padded to a multiple of 16, zeros past S) brings them into one of
// two buffers, the block's next head always in flight while this one
// computes.  Rows are 64 or 128 bytes, unpadded, in the 64- or 128-byte
// swizzle, so every ldmatrix phase is free of bank conflicts.  The block's
// heads' 16-row query tiles (13 at S = 197) are dealt to eight warps in
// one sequence (two an SM sub-partition: the registers for a whole score
// row, no spill), so no warp waits at a head's end.  A warp forms its tile's whole
// score row in registers with bf16 mma.sync m16n8k16 (bf16_mma.cuh; 104
// fp32 a thread at S = 197): the exact row max, one exp a pair, the sum,
// p = e * (1 / sum) rounded to bf16 into P's A fragments, then PV, V's B
// fragments by ldmatrix.trans.  One pass: no score is formed twice.  The
// warp writes its bf16 output over its own q rows in shared memory.  Every
// warp steps through every head of its block (waiting on the head's buffer
// even where it holds none of its tiles, at S < 128); the last of the eight
// to pass a head (a counter a buffer) issues the TMA store of the head's
// output (clipped at S) and, once the store has read the buffer, the copies
// of the block's head two on into it.
//
// For S > 256 (up to `max_sequence`) the row does not fit in registers: the
// long branch keeps K and V of a head in shared memory, rows padded to D + 8
// bf16, and makes two passes over the keys in chunks of 64 (the rows' max
// and sum, then p and PV), with the query tiles in registers.
//
// The ragged S: keys past S are zero rows of K and V, and their scores are
// set to -inf before the max, so they enter neither the max nor the sum;
// query rows past S are computed on zeros and never stored.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "tma.cuh"

namespace {

using coda_bf16::ld_u32;
using coda_bf16::ldmatrix_x4_trans;
using coda_bf16::mma_bf16;
using coda_bf16::ex2;
using coda_bf16::pack_bf16;
using coda_bf16::rcp_rn;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 13;  // the long branch: warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kTK = 64;  // the long branch: keys a score chunk
constexpr int kMaxSmemBytes = 232448;  // a block's limit on sm_90
constexpr int kOnePassMax = 256;       // the longest S of the one-pass branch
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ inline int key_rows(int s) { return (s + 15) / 16 * 16; }

// Must equal coda_neurips2023_tpu_torch/ops/vit_attention.py :: _smem_bytes.
template <int D>
size_t smem_bytes(int s) {
  return sizeof(bf16) * 2 * (size_t)key_rows(s) * (D + 8);
}

// The one-pass branch at NK 16-row tiles (S <= 16 NK): its warps, its
// buffers (q, k, v of a head, twice) and its shared memory.
template <int D, int NK>
struct OnePass {
  // two warps an SM sub-partition, up to 255 registers a thread: 104 or 128
  // scores a thread and no spill (twelve warps, at 168 registers, spilled;
  // thirteen would have 128)
  static constexpr int WARPS = 8;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int ROWB = 2 * D;               // row bytes, the swizzle width
  static constexpr int T_BYTES = (16 * NK * ROWB + 1023) / 1024 * 1024;
  static constexpr int BUF = 3 * T_BYTES;
  static constexpr int SMEM = 1024 + 2 * BUF + 64;
};

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans_at(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

template <int D, int NK>
__global__ void __launch_bounds__(OnePass<D, NK>::THREADS, 1)
vit_attention_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_o, int bh, int s,
                          float scale) {
  using C = OnePass<D, NK>;
  constexpr int ROWB = C::ROWB;
  constexpr int KD = D / 16;  // k-steps of QK^T
  constexpr int ND = D / 8;   // n-tiles of the output
  constexpr int NT = 2 * NK;  // 8-key n-tiles of the scores
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * C::BUF);
  unsigned* done = reinterpret_cast<unsigned*>(full + 2);  // warps past a buffer's head

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const uint32_t bytes = 3u * 16 * NK * ROWB;
  const int heads = (bh - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;  // this block's
  const int qtiles = (s + 15) / 16;

  // q, k, v of the block's head i into buffer i & 1
  auto load = [&](int i) {
    unsigned char* b = smem + (i & 1) * C::BUF;
    const int head = blockIdx.x + i * gridDim.x;
    coda_tma::mbar_arrive_expect_tx(&full[i & 1], bytes);
    coda_tma::tma_load_3d(b, &tm_q, &full[i & 1], 0, 0, head);
    coda_tma::tma_load_3d(b + C::T_BYTES, &tm_k, &full[i & 1], 0, 0, head);
    coda_tma::tma_load_3d(b + 2 * C::T_BYTES, &tm_v, &full[i & 1], 0, 0, head);
  };
  if (tid == 0) {
    coda_tma::mbar_init(&full[0], 1);
    coda_tma::mbar_init(&full[1], 1);
    done[0] = done[1] = 0u;
    coda_tma::mbar_fence_init();
    for (int i = 0; i < 2 && i < heads; ++i) load(i);
  }
  __syncthreads();

  // The block's heads' query tiles in one sequence, dealt to the warps in
  // turn, so no warp waits for the others at a head's end (13 tiles on 8
  // warps).  Every warp steps through every head of the block in order:
  // it waits on the head's buffer (also where it holds none of the head's
  // tiles), computes its tiles of the head and then checks in on the
  // buffer; the last of the eight to check in stores the head's output and
  // loads the head two on into the buffer.  So a buffer is reloaded only
  // once every warp has passed its head, and a warp's parity wait always
  // finds the buffer's phase for its head in progress or just completed
  // (at a short S, where a warp holds tiles of only some heads, waiting on
  // a later head's parity could otherwise pass on a load still in flight).
  const int lr = lane & 7;  // ldmatrix: lane l names row 8m + (l & 7) of its
  const int xr = ((lr * ROWB) >> 7) & (ROWB / 16 - 1);  // matrix, so its XOR is l's
  for (int hi = 0; hi < heads; ++hi) {  // the block's head
    const int buf = hi & 1;
    coda_tma::mbar_wait(&full[buf], (hi >> 1) & 1);
    const uint32_t qs = coda_tma::smem_u32(smem + buf * C::BUF);
    // this warp's tiles of the head: the sequence's numbers gt = warp (mod
    // WARPS) in [hi qtiles, (hi + 1) qtiles)
    const int first = hi * qtiles + ((warp - hi * qtiles) % C::WARPS + C::WARPS) % C::WARPS;
    for (int gt = first; gt < (hi + 1) * qtiles; gt += C::WARPS) {
      const int tile = gt - hi * qtiles;
      const uint32_t ks = qs + C::T_BYTES;
      const uint32_t vs = qs + 2 * C::T_BYTES;
      const int r0 = tile * 16;
      // S = Q K^T over all keys: q's A fragments of k-step kk by ldmatrix
      // (matrices: rows +0..7 / +8..15, columns 16 kk + 0..7 / +8..15); K's
      // B fragments of n-tiles j, j + 1 (keys 8j + 0..7 / 8j + 8..15,
      // columns 16 kk + 0..7 / +8..15)
      const uint32_t q_row = qs + (r0 + lr + 8 * ((lane >> 3) & 1)) * ROWB;
      const uint32_t k_row = ks + (lr + 8 * (lane >> 4)) * ROWB;
      float sc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t qa[4];
        ldmatrix_x4(qa, q_row + (((2 * kk + (lane >> 4)) ^ xr) << 4));
        const uint32_t k_at = k_row + (((2 * kk + ((lane >> 3) & 1)) ^ xr) << 4);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t b4[4];
          ldmatrix_x4(b4, k_at + j * 8 * ROWB);
          const uint32_t b0[2] = {b4[0], b4[1]}, b1[2] = {b4[2], b4[3]};
          mma_bf16(sc[j], qa, b0);
          mma_bf16(sc[j + 1], qa, b1);
        }
      }
      // keys at and past s are no keys at all (only the n-tiles that reach s
      // test); the row max of the unscaled scores, scale > 0
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (8 * j + 8 > s) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * j + 2 * t + (e & 1) >= s) sc[j][e] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
      // e = 2^((s - m) scale log2 e), the scale folded into the exponent's FMA
      const float c = scale * kLog2e;
      float mc[2], inv_l[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float m = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        mc[i] = m * c;
      }
      float l[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] = ex2(fmaf(sc[j][e], c, -mc[e >> 1]));
          l[e >> 1] += sc[j][e];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        inv_l[i] = rcp_rn(l[i]);
      }
      // p rounded to bf16: P's A fragment of k-step kk from n-tiles 2 kk, 2 kk + 1
      uint32_t pa[NK][4];
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float* p = sc[2 * kk + hh];
          pa[kk][2 * hh] = pack_bf16(__fmul_rn(p[0], inv_l[0]), __fmul_rn(p[1], inv_l[0]));
          pa[kk][2 * hh + 1] = pack_bf16(__fmul_rn(p[2], inv_l[1]), __fmul_rn(p[3], inv_l[1]));
        }
      }
      float o[ND][4];
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
      // O = P V: V's B fragments by ldmatrix.trans (matrices: keys 16 kk +
      // 0..7 / +8..15 of output n-tiles n and n + 1)
      const uint32_t v_row = vs + (lr + 8 * ((lane >> 3) & 1)) * ROWB;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
#pragma unroll
        for (int n = 0; n < ND; n += 2) {
          uint32_t b4[4];
          ldmatrix_x4_trans_at(b4, v_row + kk * 16 * ROWB + (((n + (lane >> 4)) ^ xr) << 4));
          const uint32_t b0[2] = {b4[0], b4[1]}, b1[2] = {b4[2], b4[3]};
          mma_bf16(o[n], pa[kk], b0);
          mma_bf16(o[n + 1], pa[kk], b1);
        }
      }
      // the output over the warp's own q rows (read only by this warp, and
      // already read), in the same swizzle
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + g + 8 * i;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
          const uint32_t a = qs + coda_tma::swizzled(row, n, ROWB) + 4 * t;
          asm volatile("st.shared.b32 [%0], %1;\n"
                       :: "r"(a), "r"(pack_bf16(o[n][2 * i], o[n][2 * i + 1])) : "memory");
        }
      }
    }
    // the warp's tiles' output is in shared memory: the last warp to check
    // in stores the head and reloads the buffer
    coda_tma::fence_async_shared();
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(&done[buf], 1u) == (unsigned)C::WARPS - 1) {
        __threadfence_block();
        done[buf] = 0u;
        coda_tma::tma_store_3d(&tm_o, smem + buf * C::BUF, 0, 0, blockIdx.x + hi * gridDim.x);
        coda_tma::tma_store_commit();
        if (hi + 2 < heads) {
          coda_tma::tma_store_wait_read();
          load(hi + 2);
        }
      }
    }
    __syncwarp();
  }
  if (lane == 0) coda_tma::tma_store_wait_all();  // this thread's stores
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
vit_attention_bf16_long_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
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

template <int D, int NK>
int launch_one_pass(const bf16* q, const bf16* k, const bf16* v, bf16* out, int bh, int s,
                    float scale, cudaStream_t stream) {
  using C = OnePass<D, NK>;
  CUtensorMap maps[4];
  const bf16* ptrs[4] = {q, k, v, out};
  for (int i = 0; i < 4; ++i) {
    const int err = coda_tma::encode_3d(&maps[i], ptrs[i], 2, D, s, bh, D, s, D, 16 * NK, C::ROWB);
    if (err) return err;
  }
  static const cudaError_t attr = cudaFuncSetAttribute(
      vit_attention_bf16_kernel<D, NK>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (attr != cudaSuccess) return (int)attr;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = bh < sms ? bh : sms;  // one a SM, each walking over heads
  vit_attention_bf16_kernel<D, NK><<<blocks, C::THREADS, C::SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], bh, s, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, int bh, int s, float scale,
           cudaStream_t stream) {
  if (s <= 208) return launch_one_pass<D, 13>(q, k, v, out, bh, s, scale, stream);
  if (s <= kOnePassMax) return launch_one_pass<D, 16>(q, k, v, out, bh, s, scale, stream);
  const size_t bytes = smem_bytes<D>(s);
  if (bytes > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  // once an instantiation, for every S: the limit, not this call's bytes
  static const cudaError_t attr = cudaFuncSetAttribute(
      vit_attention_bf16_long_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  vit_attention_bf16_long_kernel<D><<<(unsigned)bh, kThreads, bytes, stream>>>(q, k, v, out, s,
                                                                               scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v and out 16-byte aligned (the one-pass branch's tensor maps)
extern "C" int coda_vit_attention_bf16(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                                       int bh, int s, int d, float scale, cudaStream_t stream) {
  if (bh < 1 || s < 1) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 32: return launch<32>(q, k, v, out, bh, s, scale, stream);
    case 64: return launch<64>(q, k, v, out, bh, s, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
