// Device code that the two backward window kernels share: the Swin-block
// backward (swin_block_bwd.cu) and the window-attention backward
// (window_attention.cu), which is the former without its LayerNorms and MLP.
// Both are persistent wgmma kernels on swin_block_sm90.cuh, one consumer
// warpgroup per 8x8 window:
//
// - column sums of the small gradients by a reduce-scatter of shuffles;
// - a [64, C] window of a [B, H, W, C] tensor, scaled, into a wgmma A operand,
//   the weight-gradient scratch and a column sum;
// - d(merged) = d(att) @ wproj^T and the backward of the heads;
// - d(h1) = dqkv @ wqkv^T from the scratch the heads wrote;
// - the packing of wproj^T and wqkv^T into ring tiles.

#pragma once

#include "swin_block_sm90.cuh"

namespace {
namespace sm90 {

constexpr int kHeadBufBytes = 36864;   // per-head tiles of the backward

// Column sums of four neighbouring 8-column blocks at once. v[2 b + e] is this
// thread's sum over its two rows of column col0 + 8 b + e (col0 = 8 jb + 2 t).
// The eight lanes that share t hold the warp's other rows: a reduce-scatter
// over them (8 shuffles instead of 24 for a plain butterfly) leaves each of
// 16 lanes with the warp's sum of one column pair, which it adds to the
// window's column sums in shared memory (float atomics on shared memory are
// compare-and-swap loops: few and spread over the lanes).
__device__ __forceinline__ void colsum4(float* cs, int col0, const float (&v)[8],
                                        const Lane& L) {
  const int lane = L.tid & 31;
  const bool hi4 = lane & 16, hi3 = lane & 8;
  float k4[4], k2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float recv = __shfl_xor_sync(0xffffffffu, hi4 ? v[i] : v[i + 4], 16);
    k4[i] = (hi4 ? v[i + 4] : v[i]) + recv;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float recv = __shfl_xor_sync(0xffffffffu, hi3 ? k4[i] : k4[i + 2], 8);
    k2[i] = (hi3 ? k4[i + 2] : k4[i]) + recv;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) k2[i] += __shfl_xor_sync(0xffffffffu, k2[i], 4);
  if (!(lane & 4)) {
    float* dst = cs + col0 + 8 * ((hi4 ? 2 : 0) + (hi3 ? 1 : 0));
    atomicAdd(dst, k2[0]);
    atomicAdd(dst + 1, k2[1]);
  }
}

// Adds n column sums into their gradient and zeroes them. The caller puts
// the warpgroup's barrier before (the sums are complete) and after.
__device__ __forceinline__ void colsum_flush(float* cs, int n, float* dst,
                                             const Lane& L) {
  for (int c = L.tid; c < n; c += 128) {
    atomicAdd(dst + c, cs[c]);
    cs[c] = 0.f;
  }
}

// src[window] * scale, rounded to bf16, into the A operand `buf` ([64, C]
// K-major) and into `rows_out` ([64, C] token-blocked); its f32 column sums
// into cs[0:C] (shared or device memory). Loads in accumulator-fragment
// order, a batch's loads before its first store. The caller orders the
// writes before the wgmma that reads buf (fence_proxy_async and the
// warpgroup's barrier).
template <int C>
__device__ __forceinline__ void scaled_window(const bf16* src, const Window& win,
                                              float scale, uint8_t* buf,
                                              bf16* rows_out, float* cs,
                                              const Lane& L) {
#pragma unroll 1
  for (int jb = 0; jb < C / 8; jb += 12) {
    uint32_t ld[12][2];
#pragma unroll
    for (int i = 0; i < 12; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        ld[i][half] = *reinterpret_cast<const uint32_t*>(
            src + win.ofs<C>(L.row0 + 8 * half) + 8 * (jb + i) + 2 * L.t);
    float sz[24];
#pragma unroll
    for (int i = 0; i < 12; ++i) {
      const int col = 8 * (jb + i) + 2 * L.t;
      float sx = 0.f, sy = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = L.row0 + 8 * half;
        const float2 v = unpack_bf16(ld[i][half]);
        const float zx = scale * v.x, zy = scale * v.y;
        const uint32_t r = pack_bf16(zx, zy);
        *reinterpret_cast<uint32_t*>(buf + kmaj_off(row, col, 64)) = r;
        *reinterpret_cast<uint32_t*>(rows_out + blk_off(row, col)) = r;
        sx += zx;
        sy += zy;
      }
      sz[2 * i] = sx;
      sz[2 * i + 1] = sy;
    }
#pragma unroll
    for (int i = 0; i < 12; i += 4)
      colsum4(cs, 8 * (jb + i) + 2 * L.t,
              *reinterpret_cast<const float(*)[8]>(&sz[2 * i]), L);
  }
}

// Backward of one head from its q | k | v (the window's scratch block, this
// thread's own elements), d(out) as A fragments `doa`, and the tiles in `hb`. Writes
// dq | dk | dv (bf16) over q | k | v, adds dS into drel and the rounded
// dq | dk | dv into the column sums cs[0:3C] (dbqkv). dS = P (dP - rowsum(dP P))
// takes the softmax weights rounded to bf16 (kRoundedP, the Swin-block
// backward of the TPU) or in f32 (its window-attention backward).
template <int C, bool kRoundedP>
__device__ __noinline__ void head_backward(const BlockArgs& p, const Window& win,
                                              int h, uint32_t (*doa)[4], bf16* qkv_rows,
                                              uint8_t* hb, float* drel, float* cs,
                                              int bar_id, const Lane& L) {
  uint8_t* kdir = hb;             // [64 keys, 32]   k
  uint8_t* vdir = hb + 4096;      // [64 keys, 32]   v
  uint8_t* kt = hb + 8192;        // [32, 64 keys]   k^T
  uint8_t* qt = hb + 12288;       // [32, 64]        q^T
  uint8_t* dot = hb + 16384;      // [32, 64]        d(out)^T
  uint8_t* pt = hb + 20480;       // [64 keys, 64]   P^T
  uint8_t* dst = hb + 28672;      // [64 keys, 64]   dS^T
  uint32_t qa[2][4];
  uint32_t ld[4][3][2];   // all loads before the first store
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int part = 0; part < 3; ++part)
#pragma unroll
      for (int half = 0; half < 2; ++half)
        ld[j][part][half] = *reinterpret_cast<const uint32_t*>(
            qkv_rows + blk_off(L.row0 + 8 * half, part * C + h * kHd + 8 * j + 2 * L.t));
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int d = 8 * j + 2 * L.t;
    const uint32_t q0 = ld[j][0][0], q1 = ld[j][0][1];
    const uint32_t k0 = ld[j][1][0], k1 = ld[j][1][1];
    const uint32_t v0 = ld[j][2][0], v1 = ld[j][2][1];
    qa[j / 2][(j % 2) * 2] = q0;
    qa[j / 2][(j % 2) * 2 + 1] = q1;
    st_transposed(qt, 32, L, d, q0, q1);
    st_direct(kdir, 64, L, d, k0, k1);
    st_transposed(kt, 32, L, d, k0, k1);
    st_direct(vdir, 64, L, d, v0, v1);
    st_transposed(dot, 32, L, d, doa[j / 2][(j % 2) * 2], doa[j / 2][(j % 2) * 2 + 1]);
  }
  fence_proxy_async();
  named_bar_sync(bar_id, 128);

  const float* mask_w = p.mask ? p.mask + (size_t)win.wi * kTok * kTok : nullptr;
  float s[32];
  head_softmax(s, qa, smem_u32(kdir), p.rel_bias + (size_t)h * kTok * kTok, mask_w,
               p.scale, L);
  uint32_t pa[4][4];
  acc_to_afrag<8>(s, pa);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    st_transposed(pt, 64, L, 8 * j + 2 * L.t, pa[j / 2][(j % 2) * 2],
                  pa[j / 2][(j % 2) * 2 + 1]);
  // dP = d(out) v^T
  float dp[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    wgmma_rs_n64<0>(dp, doa[kk], kmaj_desc(smem_u32(vdir), 64, kk), kk != 0);
  wgmma_commit();
  wgmma_wait0();
  // dS = P (dP - rowsum(dP P)); drel += dS
  float dotp[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (kRoundedP) {
        const float2 pv = unpack_bf16(pa[j / 2][(j % 2) * 2 + half]);
        s[4 * j + 2 * half] = pv.x;
        s[4 * j + 2 * half + 1] = pv.y;
      }
      dotp[half] += dp[4 * j + 2 * half] * s[4 * j + 2 * half] +
                    dp[4 * j + 2 * half + 1] * s[4 * j + 2 * half + 1];
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) dotp[half] = quad_sum(dotp[half]);
  float* dr = drel + (size_t)h * kTok * kTok;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float2 ds;
      ds.x = s[4 * j + 2 * half] * (dp[4 * j + 2 * half] - dotp[half]);
      ds.y = s[4 * j + 2 * half + 1] * (dp[4 * j + 2 * half + 1] - dotp[half]);
      s[4 * j + 2 * half] = ds.x;
      s[4 * j + 2 * half + 1] = ds.y;
      atomicAdd(reinterpret_cast<float2*>(dr + (L.row0 + 8 * half) * kTok + 8 * j +
                                          2 * L.t),
                ds);
    }
  }
  uint32_t dsa[4][4];
  acc_to_afrag<8>(s, dsa);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    st_transposed(dst, 64, L, 8 * j + 2 * L.t, dsa[j / 2][(j % 2) * 2],
                  dsa[j / 2][(j % 2) * 2 + 1]);
  fence_proxy_async();
  named_bar_sync(bar_id, 128);   // P^T and dS^T of all four warps are in place

  // dq = dS k, dk = dS^T q (both times scale), dv = P^T d(out)
  float g3[3][16];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs_n32<0>(g3[0], dsa[kk], kmaj_desc(smem_u32(kt), 32, kk), kk != 0);
    wgmma_ss_n32<0, 0>(g3[1], kmaj_desc(smem_u32(dst), 64, kk),
                       kmaj_desc(smem_u32(qt), 32, kk), kk != 0);
    wgmma_ss_n32<0, 0>(g3[2], kmaj_desc(smem_u32(pt), 64, kk),
                       kmaj_desc(smem_u32(dot), 32, kk), kk != 0);
  }
  wgmma_commit();
  wgmma_wait0();
#pragma unroll
  for (int part = 0; part < 3; ++part) {
    const float sc = part < 2 ? p.scale : 1.0f;
    float sq[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = part * C + h * kHd + 8 * j + 2 * L.t;
      const uint32_t v0 = pack_bf16(g3[part][4 * j] * sc, g3[part][4 * j + 1] * sc);
      const uint32_t v1 =
          pack_bf16(g3[part][4 * j + 2] * sc, g3[part][4 * j + 3] * sc);
      *reinterpret_cast<uint32_t*>(qkv_rows + blk_off(L.row0, col)) = v0;
      *reinterpret_cast<uint32_t*>(qkv_rows + blk_off(L.row0 + 8, col)) = v1;
      const float2 f0 = unpack_bf16(v0), f1 = unpack_bf16(v1);
      sq[2 * j] = f0.x + f1.x;
      sq[2 * j + 1] = f0.y + f1.y;
    }
    colsum4(cs, part * C + h * kHd + 2 * L.t, sq, L);
  }
  named_bar_sync(bar_id, 128);   // the tiles are free for the next head
}

// d(merged) = d(att) @ wproj^T per 96 columns (three heads; d(att) is the A
// operand at a_addr, kNks ring tiles of wproj^T each), then those heads'
// backward. Ends on the warpgroup's barrier.
template <int C, bool kRoundedP>
__device__ __forceinline__ void merged_and_heads_backward(
    const BlockArgs& p, const Window& win, uint32_t a_addr, bf16* qkv_rows,
    uint8_t* hb, float* drel, float* cs, Ring& ring, int bar_id, const Lane& L) {
  using K = Cfg<C>;
#pragma unroll 1
  for (int nc = 0; nc < K::kNc; ++nc) {
    uint32_t doa[6][4];
    {
      float dm[48];
      mma_smem_n96<C>(dm, a_addr, ring);
      acc_to_afrag<12>(dm, doa);
    }
#pragma unroll
    for (int hh = 0; hh < 3; ++hh)
      head_backward<C, kRoundedP>(p, win, 3 * nc + hh, &doa[2 * hh], qkv_rows, hb,
                                  drel, cs, bar_id, L);
  }
}

// d(h1) = dqkv @ wqkv^T in passes of kCw columns over the heads; dqkv comes
// back from the scratch as the fragments this thread wrote. Per pass, head
// and 96 output columns two ring tiles [48, 96]. `store(col, half, sums)`
// takes the f32 pair of row L.row0 + 8 half, columns col and col + 1.
template <int C, typename Store>
__device__ __forceinline__ void dqkv_times_wqkv_t(const bf16* qkv_rows, Ring& ring,
                                                  const Lane& L, Store store) {
  using K = Cfg<C>;
#pragma unroll 1
  for (int pass = 0; pass < K::kPasses; ++pass) {
    float acc[K::kCw / 2];
#pragma unroll
    for (int i = 0; i < K::kCw / 2; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int h = 0; h < K::kHeads; ++h) {
      uint32_t a[6][4];
#pragma unroll
      for (int kk = 0; kk < 6; ++kk) {
        // rows 8 apart are 64 elements apart, columns 8 apart one block (512)
        const bf16* r0 = qkv_rows + blk_off(L.row0, (kk / 2) * C + h * kHd +
                                                        16 * (kk % 2) + 2 * L.t);
        a[kk][0] = *reinterpret_cast<const uint32_t*>(r0);
        a[kk][1] = *reinterpret_cast<const uint32_t*>(r0 + 64);
        a[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 512);
        a[kk][3] = *reinterpret_cast<const uint32_t*>(r0 + 576);
      }
#pragma unroll
      for (int nb = 0; nb < K::kNb; ++nb) {
        float(&sub)[48] = *reinterpret_cast<float(*)[48]>(&acc[48 * nb]);
        mma_regs_n96<3>(sub, &a[0], ring, true);
        mma_regs_n96<3>(sub, &a[3], ring, true);
      }
    }
#pragma unroll
    for (int jc = 0; jc < K::kCw / 8; ++jc) {
      const int col = pass * K::kCw + 8 * jc + 2 * L.t;
#pragma unroll
      for (int half = 0; half < 2; ++half)
        store(col, half, make_float2(acc[4 * jc + 2 * half], acc[4 * jc + 2 * half + 1]));
    }
  }
}

// ---- ring tiles of the two products above ----
// 16-byte block `r` of tile `tile` of wproj^T: per 96 columns of d(merged),
// kNks tiles [kKs, 96].
template <int C>
__device__ __forceinline__ void pack_wproj_t_block(uint8_t* o, const bf16* wproj,
                                                   int tile, int r) {
  using K = Cfg<C>;
  const int k8 = r / 96, n = r % 96;
  const int nc = tile / K::kNks, ks = tile % K::kNks;
  pack_block(o, [&](int k, int) {
    return wproj[(size_t)(nc * 96 + n) * C + ks * K::kKs + k]; }, k8, n);
}
constexpr int kWqkvTTileBlocks = 576;   // 16-byte blocks of a [48, 96] tile

// The same of wqkv^T: per pass, head, 96 output columns and half, [48, 96]
// of the rows q|k|v of the head.
template <int C>
__device__ __forceinline__ void pack_wqkv_t_block(uint8_t* o, const bf16* wqkv,
                                                  int tile, int r) {
  using K = Cfg<C>;
  const int k8 = r / 96, n = r % 96;
  const int half = tile % 2, nb = tile / 2 % K::kNb;
  const int h = tile / (2 * K::kNb) % K::kHeads;
  const int pass = tile / (2 * K::kNb * K::kHeads);
  pack_block(o, [&](int k, int) {
    const int kq = 48 * half + k;
    return wqkv[(size_t)(pass * K::kCw + nb * 96 + n) * 3 * C + (kq / kHd) * C +
                h * kHd + kq % kHd]; }, k8, n);
}

}  // namespace sm90
}  // namespace
