// Fused Swin-transformer block backward for Hopper (sm_90a).
//
// Replaces strajnet_tpu/ops/pallas_swin_block.py::_bwd_kernel (reached
// through _make_block_fn.bwd_call / block_bwd). Given the block's inputs and
// the output cotangent dy it recomputes the forward and emits dx and the 13
// parameter gradients. Nothing but x is saved by the forward.
//
// Three kernels:
//
// 1. pack_bwd_kernel packs the four weights, and their transposes for the
//    input-gradient products, into tiles in the order of use and in the
//    shared-memory operand layout of swin_block_sm90.cuh.
// 2. swin_block_bwd_window_kernel, persistent, two windows per block step:
//    one consumer warpgroup owns one 8x8 window, a producer warp streams the
//    packed tiles through a ring of shared-memory stages (cp.async.bulk,
//    mbarriers). The warpgroup recomputes the forward's attention half with
//    the forward kernel's own device functions, then walks back: MLP
//    (z1 and dg1 per 64 hidden columns -> g1, dz1), dh2, LN2, d(merged), the
//    heads (dP, dS, dq, dk, dv in registers; the transposed products take
//    P^T and dS^T from shared memory), dh1, LN1 -> dx. The A operand of every
//    product is in registers or in shared memory, written by the warpgroup
//    itself a phase earlier. The small gradients are summed over the
//    window's rows by a reduce-scatter of shuffles into f32 column sums in
//    shared memory, which a warpgroup keeps over all its windows and adds to
//    device memory once at the end (C <= 192; at C=384, for want of room,
//    after each phase); drel takes one f32 pair per thread and head.
//    For each of the four weight gradients dW = A^T B it writes the two bf16
//    operands into scratch (LN1 output and dqkv; merged heads and datt; LN2
//    output and dz1; GELU output and dz2), token-blocked per window
//    ([column / 8][token][8], blk_off): an accumulator fragment then stores
//    128 contiguous bytes per warp and column block. (Row-major, 16 bytes per
//    row, these stores alone took half of the MLP phase.)
// 3. atb_accum_sm90_kernel (swin_block_sm90.cuh) sums dW over all
//    tokens: a TPU grid is sequential and sums in scratch that persists
//    across grid steps; here blocks run in no order, so the sum is this
//    split-K pass. It fetches the token-blocked operands with plain bulk
//    copies and reads them MN-major without swizzle.
//
// Rounding points follow the TPU kernel: every product takes bf16 operands
// (dz2, dz1, datt, the per-head d(out), ds, dq/dk/dv are rounded before use)
// and accumulates in f32; dbqkv sums the rounded dqkv; db1, db2, dbproj, the
// LayerNorm gradients and drel sum f32 values; dx is rounded once at the end.
// tanh (GELU and its derivative) and exp (softmax) are the hardware's
// approximations, whose error is below the bf16 rounding that follows.
//
// What bounds it on the H100: by count, operations (3x the forward's matrix
// products; 36 C bytes of bf16 scratch and 8 C bytes of f32 parking per token
// are a sixth of the bytes bound's time). As built, at C=96 and C=192 the
// chain of dependent instructions of one warpgroup per window (four warps,
// one per scheduler, two windows per SM): the tensor cores idle above 90 % of
// the time there; what helped was fewer instructions (hardware tanh, column
// sums by reduce-scatter), dense stores, and code small enough for the
// instruction cache (the per-head functions are not inlined). At C=384 the
// weight ring: shared memory leaves it two 12 KB stages, and the 5.9 MB of
// tiles a window pair streams wait on their round trips.
//
// Accumulators that sum over a loop ([64, C] f32: dh2 over the hidden
// chunks, dh1 over the heads) take C / 2 registers a thread, so at C=384
// they run in two passes of 192 columns; their A operands (dz1, dqkv) come
// back from the scratch as the fragments this very thread wrote, so a pass
// repeats no product. What a later phase needs in full rows (dh2, dr1, dh1
// in f32; r1 in bf16) is parked in device memory the launch owns, in an
// order in which a warp's accesses are contiguous (park_idx), and every
// thread reads back only the elements it wrote. Shared memory: two [64, C]
// bf16 operands per window (h1/r1/h2 and dz2/datt), 36 KB of per-head tiles
// (at C=384 they lie over whichever operand is dead), the column sums, the
// ring: 225 KB at C=384.

#include "swin_block_bwd_sm90.cuh"

namespace {

using namespace sm90;

template <int C>
struct BwdCfg {
  using K = Cfg<C>;
  // at C=384 the per-head tiles lie over a [64, C] operand that is dead
  static constexpr bool kOverlay = K::kBufBytes >= kHeadBufBytes;
  static constexpr int kStages = kOverlay ? 2 : (C > 96 ? 3 : 5);
  // Column sums of the small gradients, f32 in shared memory. Where there is
  // room (C <= 192) each gradient has its own columns and a warpgroup sums
  // over all its windows, adding to device memory once at the end; at C=384
  // three C-wide segments are reused and added after each phase, and db1
  // goes to device memory from every warp.
  static constexpr bool kPersist = !kOverlay;
  static constexpr int kDb2 = 0;
  static constexpr int kDln2s = kPersist ? C : 0;
  static constexpr int kDln2b = kPersist ? 2 * C : C;
  static constexpr int kDbproj = kPersist ? 3 * C : 2 * C;
  static constexpr int kDbqkv = kPersist ? 4 * C : 0;
  static constexpr int kDln1s = kPersist ? 7 * C : 0;
  static constexpr int kDln1b = kPersist ? 8 * C : C;
  static constexpr int kDb1 = 9 * C;   // kPersist only
  __host__ __device__ static constexpr int sums(int hidden) {
    return kPersist ? 9 * C + hidden : 3 * C;
  }
  __host__ __device__ static constexpr int per_wg(int hidden) {
    return 2 * K::kBufBytes + (kOverlay ? 0 : kHeadBufBytes) + sums(hidden) * 4;
  }
  __host__ __device__ static constexpr int smem(int hidden) {
    return kConsumers * per_wg(hidden) + kStages * K::kStageBytes +
           2 * kStages * 8 + 128;
  }
};

struct BwdArgs {
  const bf16* dy;
  bf16* dx;
  // f32 gradients summed with atomics (zeroed before the launch)
  float* dbqkv;
  float* dbproj;
  float* drel;
  float* dln1s;
  float* dln1b;
  float* dln2s;
  float* dln2b;
  float* db1;
  float* db2;
  // scratch: per window one [64, M] block in the token-blocked layout
  // (blk_off), windows in launch order
  bf16* h1;      // [N, C]   LN1 output
  bf16* qkv;     // [N, 3C]  q|k|v, then dq|dk|dv
  bf16* merged;  // [N, C]   concatenated head outputs
  bf16* datt;    // [N, C]
  bf16* h2;      // [N, C]   LN2 output
  bf16* dz2;     // [N, C]
  bf16* g1;      // [N, hidden]  GELU output
  bf16* dz1;     // [N, hidden]
  // parking, per window 64 * C values in the threads' own order (park_idx)
  uint32_t* r1;  // [N, C / 2] bf16 pairs
  float2* dr1;   // [N, C / 2] dh2, then dr1
  float2* dh1;   // [N, C / 2]
};

// Backward of a LayerNorm over the window's rows in fragment order: dh is the
// gradient of the normalised output (the window's parked f32 pairs), val
// the LayerNorm's input, res what is added to the result. Sums d(scale) and
// d(bias) into cs_scale and cs_bias; hands every result pair to out, whose
// return values it sums over the rows into cs_extra unless that is null.
template <int C, typename Val, typename Res, typename Out>
__device__ __forceinline__ void layernorm_backward(const float2* dh, const float* gamma,
                                                   const float (&mu)[2],
                                                   const float (&inv)[2],
                                                   float* cs_scale, float* cs_bias,
                                                   float* cs_extra, Val val, Res res,
                                                   Out out,
                                                   const Lane& L) {
  // Column blocks in batches of kLb: all of a batch's loads are issued before
  // its first store or atomic, so that they are in flight together (the
  // compiler keeps a load behind any earlier store it might alias).
  constexpr int kLb = 4;
  float s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll 1
  for (int jb = 0; jb < C / 8; jb += kLb) {
    float2 gm[kLb], d[kLb][2], v[kLb][2];
#pragma unroll
    for (int i = 0; i < kLb; ++i) {
      const int col = 8 * (jb + i) + 2 * L.t;
      gm[i] = *reinterpret_cast<const float2*>(gamma + col);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        d[i][half] = dh[park_idx((jb + i) * 2 + half, L)];
        v[i][half] = val(half, col);
      }
    }
    float ss[2 * kLb], sb[2 * kLb];
#pragma unroll
    for (int i = 0; i < kLb; ++i) {
      ss[2 * i] = ss[2 * i + 1] = sb[2 * i] = sb[2 * i + 1] = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float2 dd = d[i][half];
        const float xh0 = (v[i][half].x - mu[half]) * inv[half];
        const float xh1 = (v[i][half].y - mu[half]) * inv[half];
        s1[half] += dd.x * gm[i].x + dd.y * gm[i].y;
        s2[half] += dd.x * gm[i].x * xh0 + dd.y * gm[i].y * xh1;
        ss[2 * i] += dd.x * xh0;
        ss[2 * i + 1] += dd.y * xh1;
        sb[2 * i] += dd.x;
        sb[2 * i + 1] += dd.y;
      }
    }
    colsum4(cs_scale, 8 * jb + 2 * L.t, ss, L);
    colsum4(cs_bias, 8 * jb + 2 * L.t, sb, L);
  }
  float m1[2], m2[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    m1[half] = quad_sum(s1[half]) / C;
    m2[half] = quad_sum(s2[half]) / C;
  }
#pragma unroll 1
  for (int jb = 0; jb < C / 8; jb += kLb) {
    float2 gm[kLb], d[kLb][2], v[kLb][2], r[kLb][2];
#pragma unroll
    for (int i = 0; i < kLb; ++i) {
      const int col = 8 * (jb + i) + 2 * L.t;
      gm[i] = *reinterpret_cast<const float2*>(gamma + col);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        d[i][half] = dh[park_idx((jb + i) * 2 + half, L)];
        v[i][half] = val(half, col);
        r[i][half] = res(half, col);
      }
    }
    float se[2 * kLb];
#pragma unroll
    for (int i = 0; i < kLb; ++i) {
      const int col = 8 * (jb + i) + 2 * L.t;
      se[2 * i] = se[2 * i + 1] = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float xh0 = (v[i][half].x - mu[half]) * inv[half];
        const float xh1 = (v[i][half].y - mu[half]) * inv[half];
        float2 o;
        o.x = r[i][half].x +
              inv[half] * (d[i][half].x * gm[i].x - m1[half] - xh0 * m2[half]);
        o.y = r[i][half].y +
              inv[half] * (d[i][half].y * gm[i].y - m1[half] - xh1 * m2[half]);
        const float2 e = out(half, col, o);
        se[2 * i] += e.x;
        se[2 * i + 1] += e.y;
      }
    }
    if (cs_extra) colsum4(cs_extra, 8 * jb + 2 * L.t, se, L);
  }
}

template <int C>
__device__ __forceinline__ void window_backward(const BlockArgs& p, const BwdArgs& q,
                                                const Window& win, long long index,
                                                uint8_t* buf_a, uint8_t* buf_b,
                                                uint8_t* head_fwd, uint8_t* head_bwd,
                                                float* cs, Ring& ring, int bar_id,
                                                const Lane& L) {
  using K = Cfg<C>;
  using B = BwdCfg<C>;
  const size_t row_base = (size_t)index * kTok;   // this window's scratch rows
  const int hidden = p.hidden;
  bf16* qkv_rows = q.qkv + row_base * 3 * C;
  uint32_t* r1_park = q.r1 + row_base * (C / 2);
  float2* dr1_park = q.dr1 + row_base * (C / 2);
  float2* dh1_park = q.dh1 + row_base * (C / 2);
  bf16* g1_rows = q.g1 + row_base * hidden;
  bf16* dz1_rows = q.dz1 + row_base * hidden;

  PHASE_START
  // ================= forward recompute: attention half =================
  const FwdSaves sv = {q.h1 + row_base * C, qkv_rows, q.merged + row_base * C,
                       q.h2 + row_base * C};
  RowStats st2;
  window_attention_half<C>(p, win, buf_a, head_fwd, ring, r1_park, sv, st2, bar_id, L);
  // buf_a holds LN2's output, r1 is parked
  PHASE(0)

  // ---- dz2 = dp2 * dy -> buf_b and scratch; db2 += sum dz2 ----
  {
    scaled_window<C>(q.dy, win, win.dp2, buf_b, q.dz2 + row_base * C, cs + B::kDb2, L);
    fence_proxy_async();
    named_bar_sync(bar_id, 128);   // buf_b is in place
    if (!B::kPersist) {
      colsum_flush(cs + B::kDb2, C, q.db2, L);
      named_bar_sync(bar_id, 128);
    }
  }

  PHASE(1)
  // ================= backward =================
  // ---- MLP per 64 hidden columns: z1 = h2 @ w1_j + b1_j, dg1 = dz2 @ w2_j^T,
  //      g1 = gelu(z1), dz1 = dg1 * gelu'(z1) -> scratch; db1 += sum dz1 ----
  const uint32_t a_addr = smem_u32(buf_a), b_addr = smem_u32(buf_b);
#pragma unroll 1
  for (int j0 = 0; j0 < hidden; j0 += 64) {
    float2 b1v[8];   // loaded before the products, used after them
#pragma unroll
    for (int j = 0; j < 8; ++j)
      b1v[j] = *reinterpret_cast<const float2*>(p.b1 + j0 + 8 * j + 2 * L.t);
    float z[32], dg[32], sd[16];
    PHASE(2)
    mma_smem_n64<C>(z, a_addr, ring);
    mma_smem_n64<C>(dg, b_addr, ring);
    PHASE(8)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j0 + 8 * j + 2 * L.t;
      const float2 bias = b1v[j];
      float sx = 0.f, sy = 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float g0, g1, d0, d1;
        gelu_tanh_both(z[4 * j + 2 * half] + bias.x, g0, d0);
        gelu_tanh_both(z[4 * j + 2 * half + 1] + bias.y, g1, d1);
        d0 *= dg[4 * j + 2 * half];
        d1 *= dg[4 * j + 2 * half + 1];
        const int o = blk_off(L.row0 + 8 * half, col);
        *reinterpret_cast<uint32_t*>(g1_rows + o) = pack_bf16(g0, g1);
        *reinterpret_cast<uint32_t*>(dz1_rows + o) = pack_bf16(d0, d1);
        sx += d0;
        sy += d1;
      }
      sd[2 * j] = sx;
      sd[2 * j + 1] = sy;
    }
#pragma unroll
    for (int j = 0; j < 8; j += 4)
      colsum4(B::kPersist ? cs + B::kDb1 : q.db1, j0 + 8 * j + 2 * L.t,
              *reinterpret_cast<const float(*)[8]>(&sd[2 * j]), L);
  }

  PHASE(2)
  // ---- dh2 = dz1 @ w1^T, in passes of kCw columns; dz1 comes back from the
  //      scratch as the fragments this thread wrote; dh2 -> f32 parking ----
#pragma unroll 1
  for (int pass = 0; pass < K::kPasses; ++pass) {
    float acc[K::kCw / 2];
#pragma unroll
    for (int i = 0; i < K::kCw / 2; ++i) acc[i] = 0.f;
#pragma unroll 1
    for (int j0 = 0; j0 < hidden; j0 += 64) {
      uint32_t a[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        // rows 8 apart are 64 elements apart, columns 8 apart one block (512)
        const bf16* r0 = dz1_rows + blk_off(L.row0, j0 + 16 * kk + 2 * L.t);
        a[kk][0] = *reinterpret_cast<const uint32_t*>(r0);
        a[kk][1] = *reinterpret_cast<const uint32_t*>(r0 + 64);
        a[kk][2] = *reinterpret_cast<const uint32_t*>(r0 + 512);
        a[kk][3] = *reinterpret_cast<const uint32_t*>(r0 + 576);
      }
#pragma unroll
      for (int nb = 0; nb < K::kNb; ++nb)
        mma_regs_n96<4>(*reinterpret_cast<float(*)[48]>(&acc[48 * nb]), a, ring, true);
    }
#pragma unroll
    for (int jc = 0; jc < K::kCw / 8; ++jc) {
      const int col = pass * K::kCw + 8 * jc + 2 * L.t;
#pragma unroll
      for (int half = 0; half < 2; ++half)
        dr1_park[park_idx((col >> 3) * 2 + half, L)] =
            make_float2(acc[4 * jc + 2 * half], acc[4 * jc + 2 * half + 1]);
    }
  }

  PHASE(3)
  // ---- LN2 backward: dr1 = dy + LN2'(dh2) -> f32 parking (over dh2);
  //      datt = dp1 * dr1 -> buf_b and scratch; dln2s, dln2b, dbproj ----
  {
    bf16* datt_rows = q.datt + row_base * C;
    layernorm_backward<C>(
        dr1_park, p.ln2s, st2.mu, st2.inv, cs + B::kDln2s, cs + B::kDln2b,
        cs + B::kDbproj,
        [&](int half, int col) {
          return unpack_bf16(r1_park[park_idx((col >> 3) * 2 + half, L)]);
        },
        [&](int half, int col) {
          return unpack_bf16(*reinterpret_cast<const uint32_t*>(
              q.dy + win.ofs<C>(L.row0 + 8 * half) + col));
        },
        [&](int half, int col, float2 dr1) {
          const int row = L.row0 + 8 * half;
          dr1_park[park_idx((col >> 3) * 2 + half, L)] = dr1;
          const float ax = win.dp1 * dr1.x, ay = win.dp1 * dr1.y;
          const uint32_t r = pack_bf16(ax, ay);
          *reinterpret_cast<uint32_t*>(buf_b + kmaj_off(row, col, 64)) = r;
          *reinterpret_cast<uint32_t*>(datt_rows + blk_off(row, col)) = r;
          return make_float2(ax, ay);   // summed over the rows into dbproj
        },
        L);
    fence_proxy_async();
    named_bar_sync(bar_id, 128);   // buf_b is in place
    if (!B::kPersist) {
      colsum_flush(cs + B::kDln2s, C, q.dln2s, L);
      colsum_flush(cs + B::kDln2b, C, q.dln2b, L);
      colsum_flush(cs + B::kDbproj, C, q.dbproj, L);
      named_bar_sync(bar_id, 128);
    }
  }

  PHASE(4)
  // ---- d(merged) = datt @ wproj^T per 96 columns (three heads), then those
  //      heads' backward ----
  merged_and_heads_backward<C, true>(p, win, b_addr, qkv_rows, head_bwd, q.drel,
                                     cs + B::kDbqkv, ring, bar_id, L);
  if (!B::kPersist) {   // the last head ended on a barrier
    colsum_flush(cs + B::kDbqkv, 3 * C, q.dbqkv, L);
    named_bar_sync(bar_id, 128);
  }

  PHASE(5)
  // ---- dh1 = dqkv @ wqkv^T, in passes of kCw columns over the heads; dqkv
  //      comes back from the scratch as this thread's fragments ----
  dqkv_times_wqkv_t<C>(qkv_rows, ring, L, [&](int col, int half, float2 v) {
    dh1_park[park_idx((col >> 3) * 2 + half, L)] = v;
  });

  PHASE(6)
  // ---- LN1 backward: dx = dr1 + LN1'(dh1); dln1s, dln1b ----
  {
    float mu[2], inv[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const bf16* xr = p.x + win.ofs<C>(L.row0 + 8 * half);
      float s = 0.f;
#pragma unroll 4
      for (int jc = 0; jc < C / 8; ++jc) {
        const float2 v =
            unpack_bf16(*reinterpret_cast<const uint32_t*>(xr + 8 * jc + 2 * L.t));
        s += v.x + v.y;
      }
      mu[half] = quad_sum(s) / C;
      float sq = 0.f;
#pragma unroll 4
      for (int jc = 0; jc < C / 8; ++jc) {
        const float2 v =
            unpack_bf16(*reinterpret_cast<const uint32_t*>(xr + 8 * jc + 2 * L.t));
        sq += (v.x - mu[half]) * (v.x - mu[half]) + (v.y - mu[half]) * (v.y - mu[half]);
      }
      inv[half] = rsqrtf(quad_sum(sq) / C + p.eps);
    }
    layernorm_backward<C>(
        dh1_park, p.ln1s, mu, inv, cs + B::kDln1s, cs + B::kDln1b, nullptr,
        [&](int half, int col) {
          return unpack_bf16(*reinterpret_cast<const uint32_t*>(
              p.x + win.ofs<C>(L.row0 + 8 * half) + col));
        },
        [&](int half, int col) {
          return dr1_park[park_idx((col >> 3) * 2 + half, L)];
        },
        [&](int half, int col, float2 dxv) {
          *reinterpret_cast<uint32_t*>(q.dx + win.ofs<C>(L.row0 + 8 * half) + col) =
              pack_bf16(dxv.x, dxv.y);
          return make_float2(0.f, 0.f);
        },
        L);
    if (!B::kPersist) {
      named_bar_sync(bar_id, 128);
      colsum_flush(cs + B::kDln1s, C, q.dln1s, L);
      colsum_flush(cs + B::kDln1b, C, q.dln1b, L);
      named_bar_sync(bar_id, 128);
    }
  }
  PHASE(7)
}

// ---- ring tiles of the backward, in the order of use ----
//  1. the forward's attention tiles (wqkv by head, wproj by column chunk);
//  2. per 64 hidden columns: kNks tiles of w1[:, chunk], kNks tiles
//     [kKs, 64] of w2[chunk, :]^T;
//  3. per pass, hidden chunk and 96 output columns: [64, 96] of w1^T;
//  4. per 96 columns of d(merged): kNks tiles [kKs, 96] of wproj^T;
//  5. per pass, head, 96 output columns and half: [48, 96] of wqkv^T rows
//     q|k|v of the head.
template <int C>
struct BwdTiles {
  using K = Cfg<C>;
  int t1, t2, t3, t4, t5;
  __host__ __device__ explicit BwdTiles(int hidden) {
    const int chunks = hidden / 64;
    t1 = (K::kHeads + K::kNc) * K::kNks;
    t2 = t1 + chunks * 2 * K::kNks;
    t3 = t2 + K::kPasses * chunks * K::kNb;
    t4 = t3 + K::kNc * K::kNks;
    t5 = t4 + K::kPasses * K::kHeads * K::kNb * 2;
  }
  __host__ __device__ uint32_t bytes(int i) const {
    if (i < t1) return K::kKs * 96 * 2;
    if (i < t2) return K::kKs * 64 * 2;
    if (i < t3) return 64 * 96 * 2;
    if (i < t4) return K::kKs * 96 * 2;
    return 48 * 96 * 2;
  }
  __host__ __device__ long long total_bytes() const {
    return (long long)t1 * K::kKs * 192 + (long long)(t2 - t1) * K::kKs * 128 +
           (long long)(t3 - t2) * 12288 + (long long)(t4 - t3) * K::kKs * 192 +
           (long long)(t5 - t4) * 9216;
  }
};

template <int C>
__global__ void pack_bwd_kernel(uint8_t* dst, const bf16* wqkv, const bf16* wproj,
                                const bf16* w1, const bf16* w2, int hidden) {
  using K = Cfg<C>;
  const BwdTiles<C> T(hidden);
  const int chunks = hidden / 64;
  const long long n1 = (long long)T.t1 * (K::kKs * 12);
  const long long n2 = n1 + (long long)(T.t2 - T.t1) * (K::kKs * 8);
  const long long n3 = n2 + (long long)(T.t3 - T.t2) * 768;
  const long long n4 = n3 + (long long)(T.t4 - T.t3) * (K::kKs * 12);
  const long long n5 = n4 + (long long)(T.t5 - T.t4) * kWqkvTTileBlocks;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n5;
       i += (long long)gridDim.x * blockDim.x) {
    uint8_t* o = dst + i * 16;
    if (i < n1) {
      pack_attention_tiles<C>(dst, wqkv, wproj, i);
    } else if (i < n2) {
      constexpr int kPerTile = K::kKs * 8;   // [kKs, 64]
      const long long m = i - n1;
      const int tile = (int)(m / kPerTile), r = (int)(m % kPerTile);
      const int k8 = r / 64, n = r % 64;
      const int j0 = (tile / (2 * K::kNks)) * 64, which = tile % (2 * K::kNks);
      const int ks = which % K::kNks;
      if (which < K::kNks)
        pack_block(o, [&](int k, int) {
          return w1[(size_t)(ks * K::kKs + k) * hidden + j0 + n]; }, k8, n);
      else
        pack_block(o, [&](int k, int) {
          return w2[(size_t)(j0 + n) * C + ks * K::kKs + k]; }, k8, n);
    } else if (i < n3) {
      const long long m = i - n2;
      const int tile = (int)(m / 768), r = (int)(m % 768);
      const int k8 = r / 96, n = r % 96;
      const int nb = tile % K::kNb, j0 = (tile / K::kNb % chunks) * 64;
      const int pass = tile / (K::kNb * chunks);
      pack_block(o, [&](int k, int) {
        return w1[(size_t)(pass * K::kCw + nb * 96 + n) * hidden + j0 + k]; }, k8, n);
    } else if (i < n4) {
      constexpr int kPerTile = K::kKs * 12;   // [kKs, 96]
      const long long m = i - n3;
      pack_wproj_t_block<C>(o, wproj, (int)(m / kPerTile), (int)(m % kPerTile));
    } else {
      const long long m = i - n4;
      pack_wqkv_t_block<C>(o, wqkv, (int)(m / kWqkvTTileBlocks),
                           (int)(m % kWqkvTTileBlocks));
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kBlockThreads, 1)
swin_block_bwd_window_kernel(const BlockArgs p, const BwdArgs q,
                             const uint8_t* packed, long long nwin) {
  using K = Cfg<C>;
  using B = BwdCfg<C>;
  extern __shared__ uint8_t bwd_smem_raw[];
  uint8_t* smem = bwd_smem_raw + ((128u - (smem_u32(bwd_smem_raw) & 127u)) & 127u);
  const int per_wg = B::per_wg(p.hidden);
  const uint32_t ring_data = smem_u32(smem) + kConsumers * per_wg;
  const uint32_t full = ring_data + B::kStages * K::kStageBytes;
  const uint32_t empty = full + 8 * B::kStages;
  const BwdTiles<C> T(p.hidden);
  const long long steps = (nwin + kConsumers - 1) / kConsumers;

  if (threadIdx.x == 0) ring_init(full, empty, B::kStages);
  PHASE_BEGIN
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      const int mine =
          blockIdx.x < steps ? (int)((steps - blockIdx.x + gridDim.x - 1) / gridDim.x) : 0;
      ring_produce(ring_data, full, empty, B::kStages, K::kStageBytes, packed, mine,
                   T.t5, [&](int i) -> uint32_t { return T.bytes(i); });
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    Ring ring = {ring_data, full, empty, B::kStages, K::kStageBytes, 0, 0u};
    const Lane L = make_lane();
    uint8_t* buf_a = smem + wg * per_wg;
    uint8_t* buf_b = buf_a + K::kBufBytes;
    uint8_t* heads = buf_b + K::kBufBytes;   // only without overlay
    float* cs =
        reinterpret_cast<float*>(heads + (B::kOverlay ? 0 : kHeadBufBytes));
    const int sums = B::sums(p.hidden);
    for (int c = L.tid; c < sums; c += 128) cs[c] = 0.f;
    named_bar_sync(1 + wg, 128);
    for (long long s = blockIdx.x; s < steps; s += gridDim.x) {
      const long long index = s * kConsumers + wg;
      if (index >= nwin) {
        ring_drain(ring, T.t5);
        continue;
      }
      const Window win = make_window(p, index);
      // with overlay: forward k|v^T tiles over buf_b (dz2 comes later), the
      // backward's per-head tiles over buf_a (LN2's output is dead by then)
      window_backward<C>(p, q, win, index, buf_a, buf_b, B::kOverlay ? buf_b : heads,
                         B::kOverlay ? buf_a : heads, cs, ring, 1 + wg, L);
    }
    if (B::kPersist) {
      named_bar_sync(1 + wg, 128);
      colsum_flush(cs + B::kDb2, C, q.db2, L);
      colsum_flush(cs + B::kDln2s, C, q.dln2s, L);
      colsum_flush(cs + B::kDln2b, C, q.dln2b, L);
      colsum_flush(cs + B::kDbproj, C, q.dbproj, L);
      colsum_flush(cs + B::kDbqkv, 3 * C, q.dbqkv, L);
      colsum_flush(cs + B::kDln1s, C, q.dln1s, L);
      colsum_flush(cs + B::kDln1b, C, q.dln1b, L);
      colsum_flush(cs + B::kDb1, p.hidden, q.db1, L);
    }
    PHASE_END
  }
}

template <int C>
cudaError_t launch_bwd(const BlockArgs& p, BwdArgs q, const bf16* wqkv,
                       const bf16* wproj, const bf16* w1, const bf16* w2,
                       bf16* scratch, float* scratch32, float* dwqkv, float* dwproj,
                       float* dw1, float* dw2, cudaStream_t st) {
  const long long n = (long long)p.B * p.H * p.W;
  const int hidden = p.hidden;
  bf16* s = scratch;
  q.h1 = s;
  s += n * C;
  q.qkv = s;
  s += n * 3 * C;
  q.merged = s;
  s += n * C;
  q.datt = s;
  s += n * C;
  q.h2 = s;
  s += n * C;
  q.dz2 = s;
  s += n * C;
  q.g1 = s;
  s += n * hidden;
  q.dz1 = s;
  s += n * hidden;
  q.r1 = reinterpret_cast<uint32_t*>(s);
  s += n * C;
  uint8_t* packed = reinterpret_cast<uint8_t*>(s);
  q.dr1 = reinterpret_cast<float2*>(scratch32);
  q.dh1 = reinterpret_cast<float2*>(scratch32 + n * C);

  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const BwdTiles<C> T(hidden);
  const long long blocks16 = T.total_bytes() / 16;
  pack_bwd_kernel<C><<<(unsigned)((blocks16 + 255) / 256), 256, 0, st>>>(
      packed, wqkv, wproj, w1, w2, hidden);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smem = BwdCfg<C>::smem(hidden);
  err = cudaFuncSetAttribute(swin_block_bwd_window_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long nwin = n / kTok;
  const long long steps = (nwin + kConsumers - 1) / kConsumers;
  const unsigned grid = (unsigned)(steps < sms ? steps : sms);
  swin_block_bwd_window_kernel<C><<<grid, kBlockThreads, smem, st>>>(p, q, packed, nwin);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = launch_atb(q.h1, q.qkv, dwqkv, C, 3 * C, n, sms, st);
  if (err != cudaSuccess) return err;
  err = launch_atb(q.merged, q.datt, dwproj, C, C, n, sms, st);
  if (err != cudaSuccess) return err;
  err = launch_atb(q.h2, q.dz1, dw1, C, hidden, n, sms, st);
  if (err != cudaSuccess) return err;
  return launch_atb(q.g1, q.dz2, dw2, hidden, C, n, sms, st);
}

template <int C>
long long bwd_packed_bytes(int hidden) {
  return BwdTiles<C>(hidden).total_bytes();
}

long long packed_bytes(int C, int hidden) {
  switch (C) {
    case 96: return bwd_packed_bytes<96>(hidden);
    case 192: return bwd_packed_bytes<192>(hidden);
    case 384: return bwd_packed_bytes<384>(hidden);
  }
  return 0;
}

}  // namespace

extern "C" {

#ifdef SWIN_PHASE_CLOCKS
int swin_block_bwd_phase_clocks(long long* out) { return phase_clocks_read(out); }
#endif

// Dynamic shared memory one window block takes at channel width C (0: not
// covered) with an MLP of `hidden` columns.
size_t swin_block_bwd_smem_bytes(int C, int hidden) {
  switch (C) {
    case 96: return BwdCfg<96>::smem(hidden);
    case 192: return BwdCfg<192>::smem(hidden);
    case 384: return BwdCfg<384>::smem(hidden);
  }
  return 0;
}

// Elements of bf16 scratch (the operands of the weight gradients, r1, then
// the packed weights) and of f32 scratch a launch needs.
long long swin_block_bwd_scratch_bf16(int B, int H, int W, int C, int hidden) {
  return (long long)B * H * W * (9LL * C + 2LL * hidden) + packed_bytes(C, hidden) / 2;
}
long long swin_block_bwd_scratch_f32(int B, int H, int W, int C) {
  return 2LL * B * H * W * C;
}

// The split-K pass alone: out[M, N] (f32) += a^T @ b over ntok tokens in
// bf16; M, N multiples of 8, ntok of 64; a and b token-blocked,
// [ntok / 64][M / 8][64][8] and likewise b, as the window kernels write them.
int swin_block_atb_accum(const void* a, const void* b, void* out, int M, int N,
                         long long ntok, void* stream) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_atb(static_cast<const bf16*>(a), static_cast<const bf16*>(b),
                         static_cast<float*>(out), M, N, ntok, sms,
                         static_cast<cudaStream_t>(stream));
}

// Backward of the block on `stream`; returns the CUDA error code of the
// first failed launch (0 on success). x, dy, dx are [B, H, W, C] bf16; the
// 13 gradient outputs are f32, in the order of the parameters, and must be
// zeroed by the caller on the same stream; scratch_bf16 / scratch_f32 hold
// at least swin_block_bwd_scratch_{bf16,f32} elements; shapes as in
// swin_block_fwd.
int swin_block_bwd(const void* x, const void* dy, const void* wqkv,
                   const void* bqkv, const void* wproj, const void* bproj,
                   const void* rel_bias, const void* ln1s, const void* ln1b,
                   const void* ln2s, const void* ln2b, const void* w1,
                   const void* b1, const void* w2, const void* b2,
                   const void* mask, const void* dp, void* dx, void* dwqkv,
                   void* dbqkv, void* dwproj, void* dbproj, void* drel,
                   void* dln1s, void* dln1b, void* dln2s, void* dln2b,
                   void* dw1, void* db1, void* dw2, void* db2,
                   void* scratch_bf16, void* scratch_f32, int B, int H, int W,
                   int C, int heads, int hidden, float eps, void* stream) {
  if (heads * kHd != C || hidden % 64 || H % kWs || W % kWs)
    return (int)cudaErrorInvalidValue;
  BlockArgs p;
  p.x = static_cast<const bf16*>(x);
  p.bqkv = static_cast<const bf16*>(bqkv);
  p.bproj = static_cast<const bf16*>(bproj);
  p.rel_bias = static_cast<const float*>(rel_bias);
  p.mask = static_cast<const float*>(mask);
  p.ln1s = static_cast<const float*>(ln1s);
  p.ln1b = static_cast<const float*>(ln1b);
  p.ln2s = static_cast<const float*>(ln2s);
  p.ln2b = static_cast<const float*>(ln2b);
  p.b1 = static_cast<const float*>(b1);
  p.b2 = static_cast<const float*>(b2);
  p.dp = static_cast<const float*>(dp);
  p.B = B;
  p.H = H;
  p.W = W;
  p.hidden = hidden;
  p.eps = eps;
  p.scale = 1.0f / sqrtf((float)kHd);
  BwdArgs q = {};
  q.dy = static_cast<const bf16*>(dy);
  q.dx = static_cast<bf16*>(dx);
  q.dbqkv = static_cast<float*>(dbqkv);
  q.dbproj = static_cast<float*>(dbproj);
  q.drel = static_cast<float*>(drel);
  q.dln1s = static_cast<float*>(dln1s);
  q.dln1b = static_cast<float*>(dln1b);
  q.dln2s = static_cast<float*>(dln2s);
  q.dln2b = static_cast<float*>(dln2b);
  q.db1 = static_cast<float*>(db1);
  q.db2 = static_cast<float*>(db2);
  const bf16* wq = static_cast<const bf16*>(wqkv);
  const bf16* wp = static_cast<const bf16*>(wproj);
  const bf16* w1p = static_cast<const bf16*>(w1);
  const bf16* w2p = static_cast<const bf16*>(w2);
  bf16* s16 = static_cast<bf16*>(scratch_bf16);
  float* s32 = static_cast<float*>(scratch_f32);
  float* g0 = static_cast<float*>(dwqkv);
  float* g1 = static_cast<float*>(dwproj);
  float* g2 = static_cast<float*>(dw1);
  float* g3 = static_cast<float*>(dw2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 96:
      return (int)launch_bwd<96>(p, q, wq, wp, w1p, w2p, s16, s32, g0, g1, g2, g3, st);
    case 192:
      return (int)launch_bwd<192>(p, q, wq, wp, w1p, w2p, s16, s32, g0, g1, g2, g3, st);
    case 384:
      return (int)launch_bwd<384>(p, q, wq, wp, w1p, w2p, s16, s32, g0, g1, g2, g3, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
