// Fused Swin-transformer block backward for Hopper (sm_90a).
//
// Replaces strajnet_tpu/ops/pallas_swin_block.py::_bwd_kernel (reached
// through _make_block_fn.bwd_call / block_bwd). Given the block's inputs and
// the output cotangent dy it recomputes the forward and emits dx and the 13
// parameter gradients. Nothing but x is saved by the forward.
//
// Two kernels, both written here:
//
// 1. swin_block_bwd_window_kernel: one thread block per 8x8 window. It
//    recomputes the forward of swin_block.cu, runs the backward of every
//    per-token and per-window operation, writes dx, and adds the small
//    gradients (biases, LayerNorm parameters, the rel-pos bias) into their
//    f32 outputs with atomicAdd: one add per column per window, after a
//    reduction over the window's 64 tokens in the block. For each of the
//    four weight gradients, dW = A^T B summed over every token of the batch,
//    it writes the two bf16 operands A and B (LN1 output and dqkv; merged
//    heads and datt; LN2 output and dz1; GELU output and dz2) token by token
//    into scratch in device memory.
// 2. atb_accum_kernel: dW += A[tokens, M]^T B[tokens, N], a split-K product
//    over slices of the token axis. Each block stages 32-token slabs of A and
//    B in shared memory, accumulates a 64x128 tile in WMMA fragments and adds
//    it into the zeroed f32 output with atomicAdd.
//
// A TPU grid is sequential and the TPU kernel sums the parameter gradients
// in scratch that persists from one grid step to the next; here blocks run
// in no order, so the sum over windows is this second pass. The number of
// atomics is M*N times the number of token slices (a few per SM), instead of
// M*N per window.
//
// Rounding points follow the TPU kernel: every product takes bf16 operands
// (dz2, dz1, datt, the per-head d(out), ds, dq/dk/dv are rounded before use)
// and accumulates in f32; dbqkv sums the rounded dqkv; db1, db2, dbproj, the
// LayerNorm gradients and drel sum f32 values; dx is rounded once at the end.
//
// What bounds it on the H100: 3x the forward's matrix products (recompute,
// input gradients, weight gradients), through WMMA with fragments loaded
// from shared memory, L1 and L2; plus 36*C bytes of scratch per token written
// and read once (906 MB at [16,128,128,96]). It is bound by fragment loads
// and scratch traffic, far below the tensor cores' peak.
//
// The shared-memory budget is the forward's (218 KB at C=384): what does not
// fit is parked in device memory that the launch owns: r1 in dx (each block
// owns its window of it) until the final write, q|k|v of all heads in the
// dqkv scratch until each head overwrites its columns with dq|dk|dv, dr1 in
// an f32 scratch. The [64, C] and [64, 4C] bf16 operands of the large
// products are read back from the scratch rows this block wrote (they stay
// in L1/L2).

#include "swin_block_common.cuh"

namespace {

constexpr int kMlpChunk = 64;  // hidden columns per MLP step: warps 0-3 recompute
                               // z1, warps 4-7 compute dg1 for the same columns
constexpr int kStgLd = 2 * kMlpChunk + kPad32;  // staging row, f32 elements

struct BwdParams {
  const bf16* x;
  const bf16* dy;
  const bf16* wqkv;   // [C, 3C]
  const bf16* bqkv;   // [3C]
  const bf16* wproj;  // [C, C]
  const bf16* bproj;  // [C]
  const float* rel_bias;  // [heads, 64, 64]
  const float* mask;      // [nW, 64, 64] or null
  const float* ln1s;
  const float* ln1b;
  const float* ln2s;
  const float* ln2b;
  const bf16* w1;     // [C, hidden]
  const float* b1;    // [hidden]
  const bf16* w2;     // [hidden, C]
  const float* b2;    // [C]
  const float* dp;    // [B, 2]
  bf16* dx;
  // f32 gradients that the window kernel sums with atomics (zeroed before)
  float* dbqkv;
  float* dbproj;
  float* drel;
  float* dln1s;
  float* dln1b;
  float* dln2s;
  float* dln2b;
  float* db1;
  float* db2;
  // scratch, one row per token in window-major order (row = window*64 + t)
  bf16* h1;      // [N, C]   LN1 output
  bf16* qkv;     // [N, 3C]  q|k|v, then dq|dk|dv
  bf16* merged;  // [N, C]   concatenated head outputs
  bf16* datt;    // [N, C]
  bf16* h2;      // [N, C]   LN2 output
  bf16* dz2;     // [N, C]
  bf16* g1;      // [N, hidden]  GELU output
  bf16* dz1;     // [N, hidden]
  float* dr1;    // [N, C]
  int B, H, W, C, heads, hd, hidden;
  float eps, scale;
};

struct BwdLayout {
  int ldh, lda, ldqkv, ldstg, lds, ldp, ldo32;
  size_t off_acc, off_qkv, off_stg, off_p, total;
};

__host__ __device__ inline BwdLayout make_bwd_layout(int C, int hd) {
  BwdLayout L;
  L.ldh = C + kPad16;
  L.lda = (C > 3 * hd ? C : 3 * hd) + kPad32;
  L.ldqkv = 3 * hd + kPad16;
  L.ldstg = 3 * hd + kPad32;
  L.lds = kTok + kPad32;
  L.ldp = kTok + kPad16;
  L.ldo32 = hd + kPad32;
  size_t stg_elems = (size_t)kTok * kStgLd;
  if ((size_t)kTok * L.ldstg > stg_elems) stg_elems = (size_t)kTok * L.ldstg;
  size_t off = round_up((size_t)kTok * L.ldh * sizeof(bf16), 128);
  L.off_acc = off;
  off = round_up(off + (size_t)kTok * L.lda * sizeof(float), 128);
  L.off_qkv = off;
  off = round_up(off + (size_t)kTok * L.ldqkv * sizeof(bf16), 128);
  L.off_stg = off;
  off = round_up(off + stg_elems * sizeof(float), 128);
  L.off_p = off;
  off = round_up(off + (size_t)kTok * L.ldp * sizeof(bf16), 128);
  L.total = off;
  return L;
}

// Sums per-warp partial column sums (lane holds columns lane + 32*i) over the
// block's warps through `red` (at least kWarps*C floats of shared memory) and
// adds the totals into dst[0:C]. Every thread of the block calls it.
__device__ inline void flush_colsums(float* red, const float (&part)[kMaxPerLane],
                                     float* dst, int C) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per_lane = C / 32;
#pragma unroll
  for (int i = 0; i < kMaxPerLane; ++i)
    if (i < per_lane) red[warp * C + lane + 32 * i] = part[i];
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w * C + c];
    atomicAdd(dst + c, s);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
swin_block_bwd_window_kernel(const BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = p.C, hd = p.hd, hidden = p.hidden;
  const BwdLayout L = make_bwd_layout(C, hd);
  bf16* hbuf = reinterpret_cast<bf16*>(smem);
  float* acc = reinterpret_cast<float*>(smem + L.off_acc);
  bf16* qkv = reinterpret_cast<bf16*>(smem + L.off_qkv);
  float* stg = reinterpret_cast<float*>(smem + L.off_stg);
  bf16* pbuf = reinterpret_cast<bf16*>(smem + L.off_p);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwx = p.W / kWs, nwy = p.H / kWs;
  const int b = blockIdx.x / (nwx * nwy);
  const int wi = blockIdx.x % (nwx * nwy);
  const int wy = wi / nwx, wx = wi % nwx;
  const float dp1 = p.dp[2 * b], dp2 = p.dp[2 * b + 1];
  const int per_lane = C / 32;
  const int ctiles = C / 16;
  const int o_nt = hd / 16;
  const int C3 = 3 * C;
  const size_t row0 = (size_t)blockIdx.x * kTok;  // this window's scratch rows

  // token t of this window -> element offset of its channel vector
  auto gofs = [&](int t) -> size_t {
    const int row = wy * kWs + t / kWs, col = wx * kWs + t % kWs;
    return ((size_t)(b * p.H + row) * p.W + col) * (size_t)C;
  };

  // ================= forward recompute =================
  // ---- LN1 (one warp per token) -> hbuf and scratch h1 ----
  for (int t = warp; t < kTok; t += kWarps) {
    const bf16* xr = p.x + gofs(t);
    bf16* h1r = p.h1 + (row0 + t) * C;
    float v[kMaxPerLane];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      if (i < per_lane) {
        v[i] = __bfloat162float(xr[lane + 32 * i]);
        s += v[i];
      }
    }
    const float mu = warp_sum(s) / C;
    float q = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      if (i < per_lane) {
        const float d = v[i] - mu;
        q += d * d;
      }
    }
    const float inv = rsqrtf(warp_sum(q) / C + p.eps);
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      if (i < per_lane) {
        const int c = lane + 32 * i;
        const bf16 hv =
            __float2bfloat16((v[i] - mu) * inv * p.ln1s[c] + p.ln1b[c]);
        hbuf[t * L.ldh + c] = hv;
        h1r[c] = hv;
      }
    }
  }
  __syncthreads();

  // ---- attention forward per head: q|k|v and the head output to scratch ----
  const float* mask = p.mask ? p.mask + (size_t)wi * kTok * kTok : nullptr;
  for (int h = 0; h < p.heads; ++h) {
    for (int tn = warp; tn < 3 * hd / 16; tn += kWarps) {
      const int part = (tn * 16) / hd, colin = (tn * 16) % hd;
      FragC c[4];
      zero_strip(c);
      mma_strip(c, hbuf, L.ldh, p.wqkv + part * C + h * hd + colin, C3, C);
      store_strip(stg + tn * 16, c, L.ldstg);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTok * 3 * hd; idx += kThreads) {
      const int t = idx / (3 * hd), j = idx % (3 * hd);
      const int part = j / hd, jj = j % hd;
      const int col = part * C + h * hd + jj;
      const bf16 v = __float2bfloat16(stg[t * L.ldstg + j] +
                                      __bfloat162float(p.bqkv[col]));
      qkv[t * L.ldqkv + j] = v;
      p.qkv[(row0 + t) * C3 + col] = v;
    }
    __syncthreads();

    // logits = q @ k^T -> stg as [64][lds]
    for (int tile = warp; tile < 16; tile += kWarps) {
      const int tm = tile / 4, tn = tile % 4;
      FragC c;
      wmma::fill_fragment(c, 0.f);
      for (int k0 = 0; k0 < hd; k0 += 16) {
        FragA a;
        FragBt bt;
        wmma::load_matrix_sync(a, qkv + tm * 16 * L.ldqkv + k0, L.ldqkv);
        wmma::load_matrix_sync(bt, qkv + tn * 16 * L.ldqkv + hd + k0, L.ldqkv);
        wmma::mma_sync(c, a, bt, c);
      }
      wmma::store_matrix_sync(stg + tm * 16 * L.lds + tn * 16, c, L.lds,
                              wmma::mem_row_major);
    }
    __syncthreads();

    const float* rb = p.rel_bias + (size_t)h * kTok * kTok;
    for (int t = warp; t < kTok; t += kWarps) {
      float s0 = stg[t * L.lds + lane] * p.scale + rb[t * kTok + lane];
      float s1 = stg[t * L.lds + lane + 32] * p.scale + rb[t * kTok + lane + 32];
      if (mask) {
        s0 += mask[t * kTok + lane];
        s1 += mask[t * kTok + lane + 32];
      }
      const float m = warp_max(fmaxf(s0, s1));
      const float e0 = expf(s0 - m), e1 = expf(s1 - m);
      const float sum = warp_sum(e0 + e1);
      pbuf[t * L.ldp + lane] = __float2bfloat16(e0 / sum);
      pbuf[t * L.ldp + lane + 32] = __float2bfloat16(e1 / sum);
    }
    __syncthreads();

    // head output = P @ v -> stg as [64][ldo32] -> scratch merged (bf16)
    for (int tile = warp; tile < 4 * o_nt; tile += kWarps) {
      const int tm = tile / o_nt, tn = tile % o_nt;
      FragC c;
      wmma::fill_fragment(c, 0.f);
      for (int k0 = 0; k0 < kTok; k0 += 16) {
        FragA a;
        FragB bm;
        wmma::load_matrix_sync(a, pbuf + tm * 16 * L.ldp + k0, L.ldp);
        wmma::load_matrix_sync(bm, qkv + k0 * L.ldqkv + 2 * hd + tn * 16,
                               L.ldqkv);
        wmma::mma_sync(c, a, bm, c);
      }
      wmma::store_matrix_sync(stg + tm * 16 * L.ldo32 + tn * 16, c, L.ldo32,
                              wmma::mem_row_major);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTok * hd; idx += kThreads) {
      const int t = idx / hd, j = idx % hd;
      p.merged[(row0 + t) * C + h * hd + j] =
          __float2bfloat16(stg[t * L.ldo32 + j]);
    }
    __syncthreads();
  }

  // ---- att = merged @ wproj -> acc ----
  for (int tn = warp; tn < ctiles; tn += kWarps) {
    FragC c[4];
    zero_strip(c);
    mma_strip(c, p.merged + row0 * C, C, p.wproj + tn * 16, C, C);
    store_strip(acc + tn * 16, c, L.lda);
  }
  __syncthreads();

  // ---- r1 = x + dp1 * (att + bproj), parked in dx; LN2 -> hbuf, scratch h2;
  //      dz2 = dp2 * dy -> scratch; db2 += sum dz2 ----
  {
    float s_db2[kMaxPerLane];
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) s_db2[i] = 0.f;
    for (int t = warp; t < kTok; t += kWarps) {
      const size_t g = gofs(t);
      const bf16* xr = p.x + g;
      const bf16* dyr = p.dy + g;
      bf16* park = p.dx + g;
      bf16* h2r = p.h2 + (row0 + t) * C;
      bf16* dz2r = p.dz2 + (row0 + t) * C;
      float v[kMaxPerLane];
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        if (i < per_lane) {
          const int c = lane + 32 * i;
          const float att = acc[t * L.lda + c] + __bfloat162float(p.bproj[c]);
          const bf16 r = __float2bfloat16(__bfloat162float(xr[c]) + dp1 * att);
          park[c] = r;
          v[i] = __bfloat162float(r);
          s += v[i];
          const float dz2 = dp2 * __bfloat162float(dyr[c]);
          dz2r[c] = __float2bfloat16(dz2);
          s_db2[i] += dz2;
        }
      }
      const float mu = warp_sum(s) / C;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        if (i < per_lane) {
          const float d = v[i] - mu;
          q += d * d;
        }
      }
      const float inv = rsqrtf(warp_sum(q) / C + p.eps);
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        if (i < per_lane) {
          const int c = lane + 32 * i;
          const bf16 hv =
              __float2bfloat16((v[i] - mu) * inv * p.ln2s[c] + p.ln2b[c]);
          hbuf[t * L.ldh + c] = hv;
          h2r[c] = hv;
        }
      }
    }
    flush_colsums(stg, s_db2, p.db2, C);
  }

  // ================= backward =================
  // ---- MLP, hidden columns in chunks of 64: z1 = h2 @ w1_j + b1_j,
  //      dg1 = dz2 @ w2_j^T, dz1 = dg1 * gelu'(z1); g1 and dz1 -> scratch ----
  for (int j0 = 0; j0 < hidden; j0 += kMlpChunk) {
    {
      FragC c[4];
      zero_strip(c);
      if (warp < 4) {
        mma_strip(c, hbuf, L.ldh, p.w1 + j0 + warp * 16, hidden, C);
        store_strip(stg + warp * 16, c, kStgLd);
      } else {
        const int tn = warp - 4;
        mma_strip_bt(c, p.dz2 + row0 * C, C,
                     p.w2 + (size_t)(j0 + tn * 16) * C, C, C);
        store_strip(stg + kMlpChunk + tn * 16, c, kStgLd);
      }
    }
    __syncthreads();
    {
      const int j = threadIdx.x % kMlpChunk, tq = threadIdx.x / kMlpChunk;
      const float bias = p.b1[j0 + j];
      float part = 0.f;
      for (int t = tq; t < kTok; t += kThreads / kMlpChunk) {
        const float z = stg[t * kStgLd + j] + bias;
        const float dz1 = stg[t * kStgLd + kMlpChunk + j] * gelu_tanh_grad(z);
        const size_t o = (row0 + t) * hidden + j0 + j;
        p.g1[o] = __float2bfloat16(gelu_tanh(z));
        p.dz1[o] = __float2bfloat16(dz1);
        part += dz1;
      }
      acc[threadIdx.x] = part;
    }
    __syncthreads();
    if (threadIdx.x < kMlpChunk) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < kThreads / kMlpChunk; ++q)
        s += acc[q * kMlpChunk + threadIdx.x];
      atomicAdd(p.db1 + j0 + threadIdx.x, s);
    }
    __syncthreads();
  }

  // ---- dh2 = dz1 @ w1^T -> acc ----
  for (int tn = warp; tn < ctiles; tn += kWarps) {
    FragC c[4];
    zero_strip(c);
    mma_strip_bt(c, p.dz1 + row0 * hidden, hidden,
                 p.w1 + (size_t)tn * 16 * hidden, hidden, hidden);
    store_strip(acc + tn * 16, c, L.lda);
  }
  __syncthreads();

  // ---- LN2 backward: dr1 = dy + LN2'(dh2) -> scratch (f32);
  //      datt = dp1 * dr1 -> scratch (bf16) ----
  {
    float s_scale[kMaxPerLane], s_bias[kMaxPerLane], s_bproj[kMaxPerLane];
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i)
      s_scale[i] = s_bias[i] = s_bproj[i] = 0.f;
    for (int t = warp; t < kTok; t += kWarps) {
      const size_t g = gofs(t);
      const bf16* park = p.dx + g;
      const bf16* dyr = p.dy + g;
      float* dr1r = p.dr1 + (row0 + t) * C;
      bf16* dattr = p.datt + (row0 + t) * C;
      float v[kMaxPerLane];
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        if (i < per_lane) {
          v[i] = __bfloat162float(park[lane + 32 * i]);
          s += v[i];
        }
      }
      const float mu = warp_sum(s) / C;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        if (i < per_lane) {
          const float d = v[i] - mu;
          q += d * d;
        }
      }
      const float inv = rsqrtf(warp_sum(q) / C + p.eps);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        if (i < per_lane) {
          const int c = lane + 32 * i;
          const float xhat = (v[i] - mu) * inv;
          const float dh2 = acc[t * L.lda + c];
          const float dhat = dh2 * p.ln2s[c];
          s_scale[i] += dh2 * xhat;
          s_bias[i] += dh2;
          s1 += dhat;
          s2 += dhat * xhat;
          v[i] = xhat;
        }
      }
      const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        if (i < per_lane) {
          const int c = lane + 32 * i;
          const float dhat = acc[t * L.lda + c] * p.ln2s[c];
          const float dr1 = __bfloat162float(dyr[c]) +
                            inv * (dhat - m1 - v[i] * m2);
          dr1r[c] = dr1;
          const float datt = dp1 * dr1;
          dattr[c] = __float2bfloat16(datt);
          s_bproj[i] += datt;
        }
      }
    }
    flush_colsums(stg, s_scale, p.dln2s, C);
    flush_colsums(stg, s_bias, p.dln2b, C);
    flush_colsums(stg, s_bproj, p.dbproj, C);
  }

  // ---- d(merged) = datt @ wproj^T -> hbuf (bf16) ----
  for (int tn = warp; tn < ctiles; tn += kWarps) {
    FragC c[4];
    zero_strip(c);
    mma_strip_bt(c, p.datt + row0 * C, C, p.wproj + (size_t)tn * 16 * C, C, C);
    float* slot = stg + warp * 16;
    store_strip(slot, c, kStgLd);
    __syncwarp();
    for (int idx = lane; idx < kTok * 16; idx += 32) {
      const int t = idx / 16, j = idx % 16;
      hbuf[t * L.ldh + tn * 16 + j] = __float2bfloat16(slot[t * kStgLd + j]);
    }
    __syncwarp();
  }
  __syncthreads();

  // ---- attention backward per head ----
  for (int h = 0; h < p.heads; ++h) {
    // forward q|k|v of this head from the scratch
    for (int idx = threadIdx.x; idx < kTok * 3 * hd; idx += kThreads) {
      const int t = idx / (3 * hd), j = idx % (3 * hd);
      const int part = j / hd, jj = j % hd;
      qkv[t * L.ldqkv + j] = p.qkv[(row0 + t) * C3 + part * C + h * hd + jj];
    }
    __syncthreads();
    // recompute P (bf16) -> pbuf
    for (int tile = warp; tile < 16; tile += kWarps) {
      const int tm = tile / 4, tn = tile % 4;
      FragC c;
      wmma::fill_fragment(c, 0.f);
      for (int k0 = 0; k0 < hd; k0 += 16) {
        FragA a;
        FragBt bt;
        wmma::load_matrix_sync(a, qkv + tm * 16 * L.ldqkv + k0, L.ldqkv);
        wmma::load_matrix_sync(bt, qkv + tn * 16 * L.ldqkv + hd + k0, L.ldqkv);
        wmma::mma_sync(c, a, bt, c);
      }
      wmma::store_matrix_sync(stg + tm * 16 * L.lds + tn * 16, c, L.lds,
                              wmma::mem_row_major);
    }
    __syncthreads();
    const float* rb = p.rel_bias + (size_t)h * kTok * kTok;
    for (int t = warp; t < kTok; t += kWarps) {
      float s0 = stg[t * L.lds + lane] * p.scale + rb[t * kTok + lane];
      float s1 = stg[t * L.lds + lane + 32] * p.scale + rb[t * kTok + lane + 32];
      if (mask) {
        s0 += mask[t * kTok + lane];
        s1 += mask[t * kTok + lane + 32];
      }
      const float m = warp_max(fmaxf(s0, s1));
      const float e0 = expf(s0 - m), e1 = expf(s1 - m);
      const float sum = warp_sum(e0 + e1);
      pbuf[t * L.ldp + lane] = __float2bfloat16(e0 / sum);
      pbuf[t * L.ldp + lane + 32] = __float2bfloat16(e1 / sum);
    }
    __syncthreads();

    // dP = do @ v^T -> stg [64][lds];  dv = P^T @ do -> acc[:, 2hd:3hd]
    const bf16* dout = hbuf + h * hd;  // [64, hd] of d(merged), ld = ldh
    for (int tile = warp; tile < 16; tile += kWarps) {
      const int tm = tile / 4, tn = tile % 4;
      FragC c;
      wmma::fill_fragment(c, 0.f);
      for (int k0 = 0; k0 < hd; k0 += 16) {
        FragA a;
        FragBt bt;
        wmma::load_matrix_sync(a, dout + tm * 16 * L.ldh + k0, L.ldh);
        wmma::load_matrix_sync(bt, qkv + tn * 16 * L.ldqkv + 2 * hd + k0,
                               L.ldqkv);
        wmma::mma_sync(c, a, bt, c);
      }
      wmma::store_matrix_sync(stg + tm * 16 * L.lds + tn * 16, c, L.lds,
                              wmma::mem_row_major);
    }
    for (int tile = warp; tile < 4 * o_nt; tile += kWarps) {
      const int tm = tile / o_nt, tn = tile % o_nt;
      FragC c;
      wmma::fill_fragment(c, 0.f);
      for (int k0 = 0; k0 < kTok; k0 += 16) {
        FragAt a;  // A[m][n] = P[n][m]
        FragB bm;
        wmma::load_matrix_sync(a, pbuf + k0 * L.ldp + tm * 16, L.ldp);
        wmma::load_matrix_sync(bm, dout + k0 * L.ldh + tn * 16, L.ldh);
        wmma::mma_sync(c, a, bm, c);
      }
      wmma::store_matrix_sync(acc + tm * 16 * L.lda + 2 * hd + tn * 16, c,
                              L.lda, wmma::mem_row_major);
    }
    __syncthreads();

    // ds = P * (dP - rowsum(dP * P)); drel += ds; ds (bf16) replaces P
    float* drel = p.drel + (size_t)h * kTok * kTok;
    for (int t = warp; t < kTok; t += kWarps) {
      const float p0 = __bfloat162float(pbuf[t * L.ldp + lane]);
      const float p1 = __bfloat162float(pbuf[t * L.ldp + lane + 32]);
      const float d0 = stg[t * L.lds + lane], d1 = stg[t * L.lds + lane + 32];
      const float dot = warp_sum(d0 * p0 + d1 * p1);
      const float ds0 = p0 * (d0 - dot), ds1 = p1 * (d1 - dot);
      atomicAdd(drel + t * kTok + lane, ds0);
      atomicAdd(drel + t * kTok + lane + 32, ds1);
      pbuf[t * L.ldp + lane] = __float2bfloat16(ds0);
      pbuf[t * L.ldp + lane + 32] = __float2bfloat16(ds1);
    }
    __syncthreads();

    // dq = ds @ k -> acc[:, 0:hd];  dk = ds^T @ q -> acc[:, hd:2hd]
    for (int tile = warp; tile < 8 * o_nt; tile += kWarps) {
      const int which = tile / (4 * o_nt), rest = tile % (4 * o_nt);
      const int tm = rest / o_nt, tn = rest % o_nt;
      FragC c;
      wmma::fill_fragment(c, 0.f);
      if (which == 0) {
        for (int k0 = 0; k0 < kTok; k0 += 16) {
          FragA a;
          FragB bm;
          wmma::load_matrix_sync(a, pbuf + tm * 16 * L.ldp + k0, L.ldp);
          wmma::load_matrix_sync(bm, qkv + k0 * L.ldqkv + hd + tn * 16,
                                 L.ldqkv);
          wmma::mma_sync(c, a, bm, c);
        }
      } else {
        for (int k0 = 0; k0 < kTok; k0 += 16) {
          FragAt a;  // A[m][n] = ds[n][m]
          FragB bm;
          wmma::load_matrix_sync(a, pbuf + k0 * L.ldp + tm * 16, L.ldp);
          wmma::load_matrix_sync(bm, qkv + k0 * L.ldqkv + tn * 16, L.ldqkv);
          wmma::mma_sync(c, a, bm, c);
        }
      }
      wmma::store_matrix_sync(acc + tm * 16 * L.lda + which * hd + tn * 16, c,
                              L.lda, wmma::mem_row_major);
    }
    __syncthreads();

    // dq|dk|dv (bf16) replace this head's q|k|v in the scratch
    for (int idx = threadIdx.x; idx < kTok * 3 * hd; idx += kThreads) {
      const int t = idx / (3 * hd), j = idx % (3 * hd);
      const int part = j / hd, jj = j % hd;
      float v = acc[t * L.lda + j];
      if (part < 2) v *= p.scale;
      p.qkv[(row0 + t) * C3 + part * C + h * hd + jj] = __float2bfloat16(v);
    }
    __syncthreads();
  }

  // ---- dbqkv += column sums of the rounded dqkv; dh1 = dqkv @ wqkv^T -> acc
  for (int c = threadIdx.x; c < C3; c += kThreads) {
    float s = 0.f;
    for (int t = 0; t < kTok; ++t)
      s += __bfloat162float(p.qkv[(row0 + t) * C3 + c]);
    atomicAdd(p.dbqkv + c, s);
  }
  for (int tn = warp; tn < ctiles; tn += kWarps) {
    FragC c[4];
    zero_strip(c);
    mma_strip_bt(c, p.qkv + row0 * C3, C3, p.wqkv + (size_t)tn * 16 * C3, C3,
                 C3);
    store_strip(acc + tn * 16, c, L.lda);
  }
  __syncthreads();

  // ---- LN1 backward; dx = dr1 + LN1'(dh1) ----
  {
    float s_scale[kMaxPerLane], s_bias[kMaxPerLane];
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) s_scale[i] = s_bias[i] = 0.f;
    for (int t = warp; t < kTok; t += kWarps) {
      const size_t g = gofs(t);
      const bf16* xr = p.x + g;
      const float* dr1r = p.dr1 + (row0 + t) * C;
      bf16* dxr = p.dx + g;
      float v[kMaxPerLane];
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        if (i < per_lane) {
          v[i] = __bfloat162float(xr[lane + 32 * i]);
          s += v[i];
        }
      }
      const float mu = warp_sum(s) / C;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        if (i < per_lane) {
          const float d = v[i] - mu;
          q += d * d;
        }
      }
      const float inv = rsqrtf(warp_sum(q) / C + p.eps);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        if (i < per_lane) {
          const int c = lane + 32 * i;
          const float xhat = (v[i] - mu) * inv;
          const float dh1 = acc[t * L.lda + c];
          const float dhat = dh1 * p.ln1s[c];
          s_scale[i] += dh1 * xhat;
          s_bias[i] += dh1;
          s1 += dhat;
          s2 += dhat * xhat;
          v[i] = xhat;
        }
      }
      const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        if (i < per_lane) {
          const int c = lane + 32 * i;
          const float dhat = acc[t * L.lda + c] * p.ln1s[c];
          dxr[c] = __float2bfloat16(dr1r[c] + inv * (dhat - m1 - v[i] * m2));
        }
      }
    }
    flush_colsums(stg, s_scale, p.dln1s, C);
    flush_colsums(stg, s_bias, p.dln1b, C);
  }
}

// ---- dW[M, N] += A[tokens, M]^T @ B[tokens, N] over a slice of the tokens ----
constexpr int kSlab = 32;    // tokens staged per step
constexpr int kTileM = 64;
constexpr int kTileN = 128;  // 8 column tiles: one per warp

__global__ void __launch_bounds__(kThreads)
atb_accum_kernel(const bf16* __restrict__ A, const bf16* __restrict__ Bm,
                 float* __restrict__ out, int M, int N, long long ntok,
                 long long slice) {
  __shared__ __align__(32) bf16 As[kSlab][kTileM + kPad16];
  __shared__ __align__(32) bf16 Bs[kSlab][kTileN + kPad16];
  __shared__ __align__(32) float Cs[kTileM][kTileN + kPad32];

  const int warp = threadIdx.x / 32;
  const int n0 = blockIdx.x * kTileN, m0 = blockIdx.y * kTileM;
  const long long tok_begin = (long long)blockIdx.z * slice;
  long long tok_end = tok_begin + slice;
  if (tok_end > ntok) tok_end = ntok;
  if (tok_begin >= tok_end) return;

  FragC c[4];
  zero_strip(c);
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  for (long long k0 = tok_begin; k0 < tok_end; k0 += kSlab) {
    {
      const int r = threadIdx.x / 8, c8 = (threadIdx.x % 8) * 8;
      const long long tok = k0 + r;
      uint4 v = zero4;
      if (tok < tok_end && m0 + c8 < M)
        v = *reinterpret_cast<const uint4*>(A + tok * M + m0 + c8);
      *reinterpret_cast<uint4*>(&As[r][c8]) = v;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / 16, c8 = (idx % 16) * 8;
      const long long tok = k0 + r;
      uint4 v = zero4;
      if (tok < tok_end && n0 + c8 < N)
        v = *reinterpret_cast<const uint4*>(Bm + tok * N + n0 + c8);
      *reinterpret_cast<uint4*>(&Bs[r][c8]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSlab; kk += 16) {
      FragB bm;
      wmma::load_matrix_sync(bm, &Bs[kk][warp * 16], kTileN + kPad16);
#pragma unroll
      for (int tm = 0; tm < 4; ++tm) {
        FragAt a;  // A^T: element (m, k) at As[k][m]
        wmma::load_matrix_sync(a, &As[kk][tm * 16], kTileM + kPad16);
        wmma::mma_sync(c[tm], a, bm, c[tm]);
      }
    }
    __syncthreads();
  }
  store_strip(&Cs[0][warp * 16], c, kTileN + kPad32);
  __syncthreads();
  for (int idx = threadIdx.x; idx < kTileM * kTileN; idx += kThreads) {
    const int r = idx / kTileN, cc = idx % kTileN;
    if (m0 + r < M && n0 + cc < N)
      atomicAdd(out + (size_t)(m0 + r) * N + n0 + cc, Cs[r][cc]);
  }
}

cudaError_t launch_atb(const bf16* A, const bf16* Bm, float* out, int M, int N,
                       long long ntok, int sms, cudaStream_t stream) {
  const int tiles = ((M + kTileM - 1) / kTileM) * ((N + kTileN - 1) / kTileN);
  // about four blocks per SM over all tiles
  const long long want = (4LL * sms + tiles - 1) / tiles;
  long long slice = (ntok + want - 1) / want;
  slice = (slice + kSlab - 1) / kSlab * kSlab;
  const long long nsplit = (ntok + slice - 1) / slice;
  if (nsplit > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((N + kTileN - 1) / kTileN),
                  (unsigned)((M + kTileM - 1) / kTileM), (unsigned)nsplit);
  atb_accum_kernel<<<grid, kThreads, 0, stream>>>(A, Bm, out, M, N, ntok, slice);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one window block needs at channel width C, head dim hd.
size_t swin_block_bwd_smem_bytes(int C, int hd) {
  return make_bwd_layout(C, hd).total;
}

// Elements of bf16 scratch and of f32 scratch a launch needs.
long long swin_block_bwd_scratch_bf16(int B, int H, int W, int C, int hidden) {
  return (long long)B * H * W * (8LL * C + 2LL * hidden);
}
long long swin_block_bwd_scratch_f32(int B, int H, int W, int C) {
  return (long long)B * H * W * C;
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
  BwdParams p;
  p.x = static_cast<const bf16*>(x);
  p.dy = static_cast<const bf16*>(dy);
  p.wqkv = static_cast<const bf16*>(wqkv);
  p.bqkv = static_cast<const bf16*>(bqkv);
  p.wproj = static_cast<const bf16*>(wproj);
  p.bproj = static_cast<const bf16*>(bproj);
  p.rel_bias = static_cast<const float*>(rel_bias);
  p.mask = static_cast<const float*>(mask);
  p.ln1s = static_cast<const float*>(ln1s);
  p.ln1b = static_cast<const float*>(ln1b);
  p.ln2s = static_cast<const float*>(ln2s);
  p.ln2b = static_cast<const float*>(ln2b);
  p.w1 = static_cast<const bf16*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const bf16*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.dp = static_cast<const float*>(dp);
  p.dx = static_cast<bf16*>(dx);
  p.dbqkv = static_cast<float*>(dbqkv);
  p.dbproj = static_cast<float*>(dbproj);
  p.drel = static_cast<float*>(drel);
  p.dln1s = static_cast<float*>(dln1s);
  p.dln1b = static_cast<float*>(dln1b);
  p.dln2s = static_cast<float*>(dln2s);
  p.dln2b = static_cast<float*>(dln2b);
  p.db1 = static_cast<float*>(db1);
  p.db2 = static_cast<float*>(db2);
  const long long n = (long long)B * H * W;
  bf16* s = static_cast<bf16*>(scratch_bf16);
  p.h1 = s;
  s += n * C;
  p.qkv = s;
  s += n * 3 * C;
  p.merged = s;
  s += n * C;
  p.datt = s;
  s += n * C;
  p.h2 = s;
  s += n * C;
  p.dz2 = s;
  s += n * C;
  p.g1 = s;
  s += n * hidden;
  p.dz1 = s;
  p.dr1 = static_cast<float*>(scratch_f32);
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.heads = heads;
  p.hd = C / heads;
  p.hidden = hidden;
  p.eps = eps;
  p.scale = 1.0f / sqrtf((float)p.hd);

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = make_bwd_layout(C, p.hd).total;
  cudaError_t err = cudaFuncSetAttribute(
      swin_block_bwd_window_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;

  const dim3 grid((unsigned)(B * (H / kWs) * (W / kWs)));
  swin_block_bwd_window_kernel<<<grid, kThreads, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  err = launch_atb(p.h1, p.qkv, static_cast<float*>(dwqkv), C, 3 * C, n,
                   sms, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_atb(p.merged, p.datt, static_cast<float*>(dwproj), C, C, n,
                   sms, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_atb(p.h2, p.dz1, static_cast<float*>(dw1), C, hidden, n,
                   sms, st);
  if (err != cudaSuccess) return (int)err;
  err = launch_atb(p.g1, p.dz2, static_cast<float*>(dw2), hidden, C, n,
                   sms, st);
  return (int)err;
}

}  // extern "C"
