// Device code shared by the fused Swin-block forward (swin_block.cu) and
// backward (swin_block_bwd.cu) kernels: window geometry, warp reductions,
// the tanh GELU and its derivative, and WMMA strip products
// (bf16 x bf16 -> f32, 16x16x16 tiles).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kWs = 8;         // window side
constexpr int kTok = 64;       // tokens per window
constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPad16 = 8;      // bf16 row padding, elements
constexpr int kPad32 = 4;      // f32 row padding, elements
constexpr int kMaxPerLane = 12;  // C / 32 register slots per lane (C <= 384)

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

__device__ inline float gelu_tanh(float z) {
  const float t = tanhf(0.7978845608028654f * (z + 0.044715f * z * z * z));
  return 0.5f * z * (1.0f + t);
}

__device__ inline float gelu_tanh_grad(float z) {
  const float t = tanhf(0.7978845608028654f * (z + 0.044715f * z * z * z));
  const float du = 0.7978845608028654f * (1.0f + 3.0f * 0.044715f * z * z);
  return 0.5f * (1.0f + t) + 0.5f * z * (1.0f - t * t) * du;
}

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> FragAt;
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

// The same strip against a transposed weight: c[tm] += A[.., :K] @ Bt[:16, :K]^T
// where Bt points at 16 rows of a row-major weight with leading dimension ldb.
__device__ inline void mma_strip_bt(FragC (&c)[4], const bf16* A, int lda,
                                    const bf16* Bt, int ldb, int K) {
  for (int k0 = 0; k0 < K; k0 += 16) {
    FragBt bm;
    wmma::load_matrix_sync(bm, Bt + k0, ldb);
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

}  // namespace
