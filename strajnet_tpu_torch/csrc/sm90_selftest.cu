// Self-test of the Hopper building blocks in swin_block_sm90.cuh, one product
// each, for the tests that run on a card: the hand-written operand layout
// with wgmma from shared memory and from registers, the accumulator-to-A
// hand-over, the transposed store, and the TMA + 128-byte-swizzle split-K
// pass. Each entry point returns the CUDA error code of its launch.

#include "swin_block_sm90.cuh"

namespace {

using namespace sm90;

// a: [64, 64] row-major; w: [64, 96] row-major (k, n).
//   out_ss = a @ w        A from shared memory, B packed like a ring tile
//   out_rs = (a @ I) @ w  the first product's accumulator rounded to bf16 as
//                         the second's A fragments
//   out_t  = a @ a        B written by st_transposed from accumulator fragments
__global__ void __launch_bounds__(128)
layout_selftest_kernel(const bf16* a, const bf16* w, float* out_ss, float* out_rs,
                       float* out_t) {
  __shared__ __align__(128) uint8_t sa[64 * 64 * 2];
  __shared__ __align__(128) uint8_t sw[64 * 96 * 2];
  __shared__ __align__(128) uint8_t si[64 * 64 * 2];
  __shared__ __align__(128) uint8_t st[64 * 64 * 2];
  const Lane L = make_lane();
  for (int i = threadIdx.x; i < 64 * 64; i += 128) {
    const int r = i / 64, k = i % 64;
    *reinterpret_cast<bf16*>(sa + kmaj_off(r, k, 64)) = a[i];
    *reinterpret_cast<bf16*>(si + kmaj_off(r, k, 64)) =
        __float2bfloat16(r == k ? 1.f : 0.f);
  }
  for (int i = threadIdx.x; i < 8 * 96; i += 128)
    pack_block(sw + i * 16, [&](int k, int n) { return w[k * 96 + n]; }, i / 96,
               i % 96);
  fence_proxy_async();
  __syncthreads();

  float acc[48];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_n96<0, 0>(acc, kmaj_desc(smem_u32(sa), 64, kk),
                       kmaj_desc(smem_u32(sw), 96, kk), kk != 0);
  wgmma_commit();
  wgmma_wait0();
#pragma unroll
  for (int j = 0; j < 12; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out_ss[(L.row0 + 8 * (e / 2)) * 96 + 8 * j + 2 * L.t + e % 2] = acc[4 * j + e];

  float idn[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_ss_n64<0, 0>(idn, kmaj_desc(smem_u32(sa), 64, kk),
                       kmaj_desc(smem_u32(si), 64, kk), kk != 0);
  wgmma_commit();
  wgmma_wait0();
  uint32_t af[4][4];
  acc_to_afrag<8>(idn, af);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_n96<0>(acc, af[kk], kmaj_desc(smem_u32(sw), 96, kk), kk != 0);
  wgmma_commit();
  wgmma_wait0();
#pragma unroll
  for (int j = 0; j < 12; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out_rs[(L.row0 + 8 * (e / 2)) * 96 + 8 * j + 2 * L.t + e % 2] = acc[4 * j + e];

#pragma unroll
  for (int j = 0; j < 8; ++j)
    st_transposed(st, 64, L, 8 * j + 2 * L.t, af[j / 2][(j % 2) * 2],
                  af[j / 2][(j % 2) * 2 + 1]);
  fence_proxy_async();
  __syncthreads();
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_n64<0>(idn, af[kk], kmaj_desc(smem_u32(st), 64, kk), kk != 0);
  wgmma_commit();
  wgmma_wait0();
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out_t[(L.row0 + 8 * (e / 2)) * 64 + 8 * j + 2 * L.t + e % 2] = idn[4 * j + e];
}

// a, b: [64 tokens, 64] row-major. out = a^T @ b with both operands read
// MN-major without swizzle from the token-blocked layout [col / 8][token][8].
// swap != 0 exchanges the roles of the descriptor's two strides.
__global__ void __launch_bounds__(128)
blocked_selftest_kernel(const bf16* a, const bf16* b, float* out, int swap) {
  __shared__ __align__(128) uint8_t sa[64 * 64 * 2];
  __shared__ __align__(128) uint8_t sb[64 * 64 * 2];
  const Lane L = make_lane();
  for (int i = threadIdx.x; i < 64 * 64; i += 128) {
    const int tok = i / 64, c = i % 64;
    *reinterpret_cast<bf16*>(sa + kmaj_off(tok, c, 64)) = a[i];
    *reinterpret_cast<bf16*>(sb + kmaj_off(tok, c, 64)) = b[i];
  }
  fence_proxy_async();
  __syncthreads();
  float acc[32];
  const uint32_t kgroup = 128, mblock = 1024;   // 8 tokens; 8 columns
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = make_desc(smem_u32(sa) + kk * 256, swap ? mblock : kgroup,
                                  swap ? kgroup : mblock, kLayoutNone);
    const uint64_t db = make_desc(smem_u32(sb) + kk * 256, swap ? mblock : kgroup,
                                  swap ? kgroup : mblock, kLayoutNone);
    wgmma_ss_n64<1, 1>(acc, da, db, kk != 0);
  }
  wgmma_commit();
  wgmma_wait0();
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[(L.row0 + 8 * (e / 2)) * 64 + 8 * j + 2 * L.t + e % 2] = acc[4 * j + e];
}

}  // namespace

extern "C" {

int sm90_blocked_selftest(const void* a, const void* b, void* out, int swap,
                          void* stream) {
  blocked_selftest_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<float*>(out), swap);
  return (int)cudaGetLastError();
}

int sm90_layout_selftest(const void* a, const void* w, void* out_ss, void* out_rs,
                         void* out_t, void* stream) {
  layout_selftest_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(w),
      static_cast<float*>(out_ss), static_cast<float*>(out_rs),
      static_cast<float*>(out_t));
  return (int)cudaGetLastError();
}

// out[M, N] (f32) += a[ntok, M]^T @ b[ntok, N]: the split-K pass alone.
int sm90_atb_accum(const void* a, const void* b, void* out, int M, int N,
                   long long ntok, void* stream) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_atb<false>(static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                         static_cast<float*>(out), M, N, ntok, sms,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
