// Self-test of the Hopper building blocks in swin_block_sm90.cuh, one product
// each, for the tests that run on a card: the hand-written operand layout
// with wgmma from shared memory and from registers, the accumulator-to-A
// hand-over, the transposed store, the token-blocked operands of the split-K
// pass, and the two shifted operands of the decoder tail (decoder_tail.cu).
// Each entry point returns the CUDA error code of its launch.

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
                                  swap ? kgroup : mblock);
    const uint64_t db = make_desc(smem_u32(sb) + kk * 256, swap ? mblock : kgroup,
                                  swap ? kgroup : mblock);
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

// The decoder tail's two A operands, at 16 channels per tap. Both are
// channel-blocked in shared memory, [channel / 8][pixel or entry][8], so that
// a tap's shift is an offset of the descriptor's start address:
//   out_main[m, :] = sum over taps (u, v) of x[8 wg + m / 8 + u, m % 8 + v, :]
//                    @ w[16 tap : 16 tap + 16, :]
//     x [17, 9, 16] (an 8-row group of A is eight pixels of one input row, the
//     groups one pixel row, 9 * 16 bytes, apart), w [64, 96];
//   out_conv[m, :] = sum over taps of e[64 wg + m + 8 u + v, :]
//                    @ ky[16 tap : 16 tap + 16, :]
//     e [144, 16] (entries 16 bytes apart), ky [64, 8]: wgmma m64n8k16.
__global__ void __launch_bounds__(128)
tail_selftest_kernel(const bf16* x, const bf16* w, const bf16* e, const bf16* ky,
                     float* out_main, float* out_conv, int wg) {
  __shared__ __align__(128) uint8_t xs[2 * 153 * 16];
  __shared__ __align__(128) uint8_t sw[64 * 96 * 2];
  __shared__ __align__(128) uint8_t es[2 * 144 * 16];
  __shared__ __align__(128) uint8_t sk[64 * 8 * 2];
  const Lane L = make_lane();
  for (int i = threadIdx.x; i < 153 * 16; i += 128) {
    const int pix = i / 16, ch = i % 16;
    *reinterpret_cast<bf16*>(xs + ((ch / 8) * 153 + pix) * 16 + (ch % 8) * 2) = x[i];
  }
  for (int i = threadIdx.x; i < 144 * 16; i += 128) {
    const int ent = i / 16, ch = i % 16;
    *reinterpret_cast<bf16*>(es + ((ch / 8) * 144 + ent) * 16 + (ch % 8) * 2) = e[i];
  }
  for (int i = threadIdx.x; i < 8 * 96; i += 128)
    pack_block(sw + i * 16, [&](int k, int n) { return w[k * 96 + n]; }, i / 96,
               i % 96);
  for (int i = threadIdx.x; i < 8 * 8; i += 128)
    pack_block(sk + i * 16, [&](int k, int n) { return ky[k * 8 + n]; }, i / 8, i % 8);
  fence_proxy_async();
  __syncthreads();

  float acc[48], d[4];
  wgmma_fence();
#pragma unroll
  for (int tap = 0; tap < 4; ++tap) {
    const int u = tap >> 1, v = tap & 1;
    wgmma_ss_n96<0, 0>(
        acc, make_desc(smem_u32(xs) + ((8 * wg + u) * 9 + v) * 16, 153 * 16, 9 * 16),
        kmaj_desc(smem_u32(sw), 96, tap), tap != 0);
    wgmma_ss_n8<0, 0>(
        d, make_desc(smem_u32(es) + (64 * wg + 8 * u + v) * 16, 144 * 16, 128),
        kmaj_desc(smem_u32(sk), 8, tap), tap != 0);
  }
  wgmma_commit();
  wgmma_wait0();
#pragma unroll
  for (int j = 0; j < 12; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      out_main[(L.row0 + 8 * (i / 2)) * 96 + 8 * j + 2 * L.t + i % 2] = acc[4 * j + i];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out_conv[(L.row0 + 8 * (i / 2)) * 8 + 2 * L.t + i % 2] = d[i];
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

int sm90_tail_selftest(const void* x, const void* w, const void* e, const void* ky,
                       void* out_main, void* out_conv, int wg, void* stream) {
  tail_selftest_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(e), static_cast<const bf16*>(ky),
      static_cast<float*>(out_main), static_cast<float*>(out_conv), wg);
  return (int)cudaGetLastError();
}

}  // extern "C"
