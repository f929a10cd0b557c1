// WMMA device code of the window-attention forward kernel
// (window_attention.cu): window geometry, warp reductions, strip products
// (bf16 x bf16 -> f32, 16x16x16 tiles) and the per-head windowed attention
// forward on one 64-token window held in shared memory. Every other window
// kernel runs on wgmma (swin_block_sm90.cuh, swin_block_bwd_sm90.cuh).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {
namespace wmma_attn {

constexpr int kWs = 8;         // window side
constexpr int kTok = 64;       // tokens per window
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPad16 = 8;      // bf16 row padding, elements
constexpr int kPad32 = 4;      // f32 row padding, elements

__host__ __device__ inline size_t round_up(size_t v, size_t a) {
  return (v + a - 1) / a * a;
}

__device__ inline float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ inline float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// One warp's 64x16 output strip: c[tm] += A[tm*16:(tm+1)*16, :K] @ B[:K, :16]
// for the four row tiles tm. A is row-major with leading dimension lda; B
// (row-major, ldb) is a 16-column tile of a weight in global memory, so each
// of its fragments is read once per strip instead of once per output tile.
__device__ inline void mma_strip(FragC (&c)[4], const bf16* A, int lda,
                                 const bf16* B, int ldb, int K) {
  for (int k0 = 0; k0 < K; k0 += 16) {
    FragB bm;
    wmma::load_matrix_sync(bm, B + (size_t)k0 * ldb, ldb);
#pragma unroll
    for (int tm = 0; tm < 4; ++tm) {
      FragA a;
      wmma::load_matrix_sync(a, A + tm * 16 * lda + k0, lda);
      wmma::mma_sync(c[tm], a, bm, c[tm]);
    }
  }
}

__device__ inline void zero_strip(FragC (&c)[4]) {
#pragma unroll
  for (int tm = 0; tm < 4; ++tm) wmma::fill_fragment(c[tm], 0.f);
}

__device__ inline void load_strip(FragC (&c)[4], const float* src, int ld) {
#pragma unroll
  for (int tm = 0; tm < 4; ++tm)
    wmma::load_matrix_sync(c[tm], src + tm * 16 * ld, ld, wmma::mem_row_major);
}

__device__ inline void store_strip(float* dst, const FragC (&c)[4], int ld) {
#pragma unroll
  for (int tm = 0; tm < 4; ++tm)
    wmma::store_matrix_sync(dst + tm * 16 * ld, c[tm], ld, wmma::mem_row_major);
}


// ---------------------------------------------------------------------------
// Per-head attention on one window. Every thread of the block calls these;
// each ends with __syncthreads().
// ---------------------------------------------------------------------------

// Shared-memory buffers of one window's attention (row strides in elements).
struct AttnBufs {
  const bf16* hbuf;  // [64][ldh]    the normalised window, A of the qkv product
  int ldh;
  bf16* qkv;         // [64][ldqkv]  one head's q | k | v
  int ldqkv;
  float* stg;        // staging: qkv sums [64][ldstg], logits and dP [64][lds],
  int ldstg, lds, ldo32;  // P @ v [64][ldo32]
  bf16* pbuf;        // [64][ldp]    softmax weights
  int ldp;
};

struct AttnWeights {
  const bf16* wqkv;       // [C, 3C]
  const bf16* bqkv;       // [3C]
  const float* rel_bias;  // [heads, 64, 64]
  const float* mask;      // this window's [64, 64] SW-MSA mask, or null
  int C, hd;
  float scale;
};

// q | k | v of head h: hbuf @ wqkv[:, head columns] summed in f32, plus the
// bias, rounded to bf16 into S.qkv.
__device__ inline void attn_head_qkv(const AttnBufs& S, const AttnWeights& W,
                                     int h) {
  const int warp = threadIdx.x / 32;
  const int C = W.C, hd = W.hd;
  for (int tn = warp; tn < 3 * hd / 16; tn += kWarps) {
    const int part = (tn * 16) / hd, colin = (tn * 16) % hd;
    FragC c[4];
    zero_strip(c);
    mma_strip(c, S.hbuf, S.ldh, W.wqkv + part * C + h * hd + colin, 3 * C, C);
    store_strip(S.stg + tn * 16, c, S.ldstg);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < kTok * 3 * hd; idx += kThreads) {
    const int t = idx / (3 * hd), j = idx % (3 * hd);
    const int col = (j / hd) * C + h * hd + j % hd;
    const bf16 v = __float2bfloat16(S.stg[t * S.ldstg + j] +
                                    __bfloat162float(W.bqkv[col]));
    S.qkv[t * S.ldqkv + j] = v;
  }
  __syncthreads();
}

// P = softmax(scale * q k^T + rel_bias[h] + mask) in f32, from S.qkv, rounded
// to bf16 into S.pbuf.
__device__ inline void attn_head_softmax(const AttnBufs& S,
                                         const AttnWeights& W, int h) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hd = W.hd;
  for (int tile = warp; tile < 16; tile += kWarps) {
    const int tm = tile / 4, tn = tile % 4;
    FragC c;
    wmma::fill_fragment(c, 0.f);
    for (int k0 = 0; k0 < hd; k0 += 16) {
      FragA a;
      FragBt bt;
      wmma::load_matrix_sync(a, S.qkv + tm * 16 * S.ldqkv + k0, S.ldqkv);
      wmma::load_matrix_sync(bt, S.qkv + tn * 16 * S.ldqkv + hd + k0, S.ldqkv);
      wmma::mma_sync(c, a, bt, c);
    }
    wmma::store_matrix_sync(S.stg + tm * 16 * S.lds + tn * 16, c, S.lds,
                            wmma::mem_row_major);
  }
  __syncthreads();
  const float* rb = W.rel_bias + (size_t)h * kTok * kTok;
  for (int t = warp; t < kTok; t += kWarps) {
    float s0 = S.stg[t * S.lds + lane] * W.scale + rb[t * kTok + lane];
    float s1 = S.stg[t * S.lds + lane + 32] * W.scale + rb[t * kTok + lane + 32];
    if (W.mask) {
      s0 += W.mask[t * kTok + lane];
      s1 += W.mask[t * kTok + lane + 32];
    }
    const float m = warp_max(fmaxf(s0, s1));
    const float e0 = expf(s0 - m), e1 = expf(s1 - m);
    const float sum = warp_sum(e0 + e1);
    S.pbuf[t * S.ldp + lane] = __float2bfloat16(e0 / sum);
    S.pbuf[t * S.ldp + lane + 32] = __float2bfloat16(e1 / sum);
  }
  __syncthreads();
}

// The head's output P @ v in f32 -> S.stg as [64][ldo32].
__device__ inline void attn_head_pv(const AttnBufs& S, int hd) {
  const int warp = threadIdx.x / 32;
  const int o_nt = hd / 16;
  for (int tile = warp; tile < 4 * o_nt; tile += kWarps) {
    const int tm = tile / o_nt, tn = tile % o_nt;
    FragC c;
    wmma::fill_fragment(c, 0.f);
    for (int k0 = 0; k0 < kTok; k0 += 16) {
      FragA a;
      FragB bm;
      wmma::load_matrix_sync(a, S.pbuf + tm * 16 * S.ldp + k0, S.ldp);
      wmma::load_matrix_sync(bm, S.qkv + k0 * S.ldqkv + 2 * hd + tn * 16,
                             S.ldqkv);
      wmma::mma_sync(c, a, bm, c);
    }
    wmma::store_matrix_sync(S.stg + tm * 16 * S.ldo32 + tn * 16, c, S.ldo32,
                            wmma::mem_row_major);
  }
  __syncthreads();
}

// Rounds the head's output (S.stg, f32) to bf16 into obuf [64][ldo] and adds
// its share of the output projection: acc[64][lda] += obuf @ wproj[h*hd.., :].
__device__ inline void attn_head_project(const AttnBufs& S, int h, int C,
                                         int hd, bf16* obuf, int ldo,
                                         float* acc, int lda,
                                         const bf16* wproj) {
  const int warp = threadIdx.x / 32;
  for (int idx = threadIdx.x; idx < kTok * hd; idx += kThreads) {
    const int t = idx / hd, j = idx % hd;
    obuf[t * ldo + j] = __float2bfloat16(S.stg[t * S.ldo32 + j]);
  }
  __syncthreads();
  for (int tn = warp; tn < C / 16; tn += kWarps) {
    FragC c[4];
    load_strip(c, acc + tn * 16, lda);
    mma_strip(c, obuf, ldo, wproj + (size_t)h * hd * C + tn * 16, C, hd);
    store_strip(acc + tn * 16, c, lda);
  }
  __syncthreads();
}

}  // namespace wmma_attn
}  // namespace
