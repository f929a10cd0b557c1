// Fused shifted-window attention for Hopper (sm_90a), forward and backward.
//
// Replaces strajnet_tpu/ops/pallas_window_attention.py::_kernel (reached
// through _make_fused_fn.fwd_call) and ::_bwd_kernel (bwd_call). On input that
// the caller has already normalised and rolled, [B, H, W, C] bf16:
//
//   y = proj(attention(window_partition(x)))
//
// the qkv projection, per head softmax(scale q k^T + rel-pos bias + 0/-100
// SW-MSA mask) v inside each 8x8 window, the head merge and the output
// projection. It is the fused Swin block of swin_block.cu without its two
// LayerNorms, residuals and MLP, and shares that kernel's per-head attention
// (swin_block_common.cuh).
//
// One thread block computes one window (64 tokens), so no cross-window mask
// is needed: the TPU kernel's dense strips, with their -1e9 mask and
// tile-repeated bias, exist to feed a 128x128 matrix unit and do not cross
// over.
//
// Rounding points follow the TPU kernels. Forward: qkv is summed in f32, gets
// its bias in f32 and is rounded to bf16; logits, bias, mask and softmax are
// f32; P is rounded before P v, the merged heads before the projection; the
// projection and its bias are f32, rounded once on the way out. Backward:
// every product takes bf16 operands (dy, d(merged) per head, P, dS, dq|dk|dv)
// and sums in f32; dS uses the f32 softmax; dbqkv sums the rounded dqkv;
// dbproj sums the rounded dy; dbias sums f32 dS.
//
// What bounds them on the H100: 8 C^2 + 256 C FLOPs per token forward (three
// times that backward) against x in and y out once, so operations. The
// products run through WMMA (bf16 x bf16 -> f32) with weight fragments read
// from global memory (L2) once per window; as in the Swin-block kernels,
// fragment loads and not the tensor cores' peak set the speed.
//
// Backward, two kernels: window_attention_bwd_kernel (one block per window)
// recomputes qkv and the softmax, writes dx, and adds dbqkv, dbproj and dbias
// into their zeroed f32 outputs with atomicAdd (one add per column, or per
// bias entry, per window). For the two weight gradients, dwqkv = x^T dqkv and
// dwproj = merged^T dy summed over every token, it writes the bf16 operands
// token by token in window order into scratch, and atb_accum_sm90_kernel
// (swin_block_sm90.cuh; TMA and wgmma) sums A^T B over slices of the token axis. q|k|v of
// all heads are parked in the dqkv scratch until each head overwrites its
// columns with dq|dk|dv.

#include "swin_block_common.cuh"
#include "swin_block_sm90.cuh"

namespace {

constexpr int kSlotLd = kWarps * 16 + kPad32;  // staging row: one 16-column
                                               // slot per warp, f32 elements

struct AttnParams {
  const bf16* x;
  const bf16* dy;     // backward only
  const bf16* wqkv;   // [C, 3C]
  const bf16* bqkv;   // [3C]
  const bf16* wproj;  // [C, C]
  const bf16* bproj;  // [C], forward only
  const float* rel_bias;  // [heads, 64, 64]
  const float* mask;      // [nW, 64, 64] or null
  bf16* out;          // y (forward) or dx (backward)
  // backward: f32 gradients summed with atomics (zeroed before)
  float* dbqkv;
  float* dbproj;
  float* dbias;
  // backward scratch, one row per token in window order (row = window*64 + t)
  bf16* xw;      // [N, C]
  bf16* qkv;     // [N, 3C]  q|k|v, then dq|dk|dv
  bf16* merged;  // [N, C]
  bf16* dyw;     // [N, C]
  int B, H, W, C, heads, hd;
  float scale;
};

struct AttnLayout {
  int ldh, lda, ldqkv, ldstg, lds, ldp, ldo32, ldo;
  size_t off_d, off_acc, off_qkv, off_stg, off_p, off_o, off_p32, total;
};

// Forward: hbuf, acc [64][C], qkv, stg, pbuf, obuf. Backward: hbuf (x, later
// d(merged)), dbuf (dy), acc [64][3hd], qkv, stg (with the warps' slots),
// pbuf, p32.
__host__ __device__ inline AttnLayout make_attn_layout(int C, int hd,
                                                       bool backward) {
  AttnLayout L;
  L.ldh = C + kPad16;
  L.lda = (backward ? 3 * hd : C) + kPad32;
  L.ldqkv = 3 * hd + kPad16;
  L.ldstg = 3 * hd + kPad32;
  L.lds = kTok + kPad32;
  L.ldp = kTok + kPad16;
  L.ldo32 = hd + kPad32;
  L.ldo = hd + kPad16;
  int stg_ld = L.ldstg > L.lds ? L.ldstg : L.lds;
  if (backward && kSlotLd > stg_ld) stg_ld = kSlotLd;
  size_t off = round_up((size_t)kTok * L.ldh * sizeof(bf16), 128);
  L.off_d = off;
  if (backward) off = round_up(off + (size_t)kTok * L.ldh * sizeof(bf16), 128);
  L.off_acc = off;
  off = round_up(off + (size_t)kTok * L.lda * sizeof(float), 128);
  L.off_qkv = off;
  off = round_up(off + (size_t)kTok * L.ldqkv * sizeof(bf16), 128);
  L.off_stg = off;
  off = round_up(off + (size_t)kTok * stg_ld * sizeof(float), 128);
  L.off_p = off;
  off = round_up(off + (size_t)kTok * L.ldp * sizeof(bf16), 128);
  L.off_o = off;
  if (!backward) off = round_up(off + (size_t)kTok * L.ldo * sizeof(bf16), 128);
  L.off_p32 = off;
  if (backward) off = round_up(off + (size_t)kTok * L.lds * sizeof(float), 128);
  L.total = off;
  return L;
}

struct WindowPos {
  int b, wi, wy, wx;
};

__device__ inline WindowPos window_pos(const AttnParams& p) {
  const int nwx = p.W / kWs, nwy = p.H / kWs;
  WindowPos w;
  w.b = blockIdx.x / (nwx * nwy);
  w.wi = blockIdx.x % (nwx * nwy);
  w.wy = w.wi / nwx;
  w.wx = w.wi % nwx;
  return w;
}

// token t of the window -> element offset of its channel vector
__device__ inline size_t token_offset(const AttnParams& p, const WindowPos& w,
                                      int t) {
  const int row = w.wy * kWs + t / kWs, col = w.wx * kWs + t % kWs;
  return ((size_t)(w.b * p.H + row) * p.W + col) * (size_t)p.C;
}

__global__ void __launch_bounds__(kThreads)
window_attention_fwd_kernel(const AttnParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = p.C, hd = p.hd;
  const AttnLayout L = make_attn_layout(C, hd, false);
  bf16* hbuf = reinterpret_cast<bf16*>(smem);
  float* acc = reinterpret_cast<float*>(smem + L.off_acc);
  bf16* qkv = reinterpret_cast<bf16*>(smem + L.off_qkv);
  float* stg = reinterpret_cast<float*>(smem + L.off_stg);
  bf16* pbuf = reinterpret_cast<bf16*>(smem + L.off_p);
  bf16* obuf = reinterpret_cast<bf16*>(smem + L.off_o);
  const WindowPos w = window_pos(p);

  // the window's tokens -> hbuf; zero the projection accumulator
  for (int idx = threadIdx.x; idx < kTok * C; idx += kThreads) {
    const int t = idx / C, c = idx % C;
    hbuf[t * L.ldh + c] = p.x[token_offset(p, w, t) + c];
    acc[t * L.lda + c] = 0.f;
  }
  __syncthreads();

  const AttnBufs S = {hbuf, L.ldh, qkv, L.ldqkv, stg, L.ldstg, L.lds, L.ldo32,
                      pbuf, L.ldp, nullptr};
  const AttnWeights Wt = {
      p.wqkv, p.bqkv, p.rel_bias,
      p.mask ? p.mask + (size_t)w.wi * kTok * kTok : nullptr, C, hd, p.scale};
  for (int h = 0; h < p.heads; ++h) {
    attn_head_qkv(S, Wt, h, nullptr);
    attn_head_softmax(S, Wt, h);
    attn_head_pv(S, hd);
    attn_head_project(S, h, C, hd, obuf, L.ldo, acc, L.lda, p.wproj);
  }

  for (int idx = threadIdx.x; idx < kTok * C; idx += kThreads) {
    const int t = idx / C, c = idx % C;
    p.out[token_offset(p, w, t) + c] = __float2bfloat16(
        acc[t * L.lda + c] + __bfloat162float(p.bproj[c]));
  }
}

__global__ void __launch_bounds__(kThreads)
window_attention_bwd_kernel(const AttnParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = p.C, hd = p.hd, C3 = 3 * p.C;
  const AttnLayout L = make_attn_layout(C, hd, true);
  bf16* hbuf = reinterpret_cast<bf16*>(smem);
  bf16* dbuf = reinterpret_cast<bf16*>(smem + L.off_d);
  float* acc = reinterpret_cast<float*>(smem + L.off_acc);
  bf16* qkv = reinterpret_cast<bf16*>(smem + L.off_qkv);
  float* stg = reinterpret_cast<float*>(smem + L.off_stg);
  bf16* pbuf = reinterpret_cast<bf16*>(smem + L.off_p);
  float* p32 = reinterpret_cast<float*>(smem + L.off_p32);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per_lane = C / 32, ctiles = C / 16;
  const WindowPos w = window_pos(p);
  const size_t row0 = (size_t)blockIdx.x * kTok;  // this window's scratch rows

  // ---- x -> hbuf and scratch; dy -> dbuf and scratch; dbproj += sum dy ----
  {
    float s_dy[kMaxPerLane];
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) s_dy[i] = 0.f;
    for (int t = warp; t < kTok; t += kWarps) {
      const size_t g = token_offset(p, w, t);
#pragma unroll
      for (int i = 0; i < kMaxPerLane; ++i) {
        if (i < per_lane) {
          const int c = lane + 32 * i;
          const bf16 xv = p.x[g + c], dv = p.dy[g + c];
          hbuf[t * L.ldh + c] = xv;
          dbuf[t * L.ldh + c] = dv;
          p.xw[(row0 + t) * C + c] = xv;
          p.dyw[(row0 + t) * C + c] = dv;
          s_dy[i] += __bfloat162float(dv);
        }
      }
    }
    __syncthreads();
    flush_colsums(stg, s_dy, p.dbproj, C);
  }

  // ---- forward recompute per head: q|k|v and the head output to scratch ----
  AttnBufs S = {hbuf, L.ldh, qkv, L.ldqkv, stg, L.ldstg, L.lds, L.ldo32,
                pbuf, L.ldp, nullptr};
  const AttnWeights Wt = {
      p.wqkv, p.bqkv, p.rel_bias,
      p.mask ? p.mask + (size_t)w.wi * kTok * kTok : nullptr, C, hd, p.scale};
  bf16* qkv_rows = p.qkv + row0 * C3;
  for (int h = 0; h < p.heads; ++h) {
    attn_head_qkv(S, Wt, h, qkv_rows);
    attn_head_softmax(S, Wt, h);
    attn_head_pv(S, hd);
    for (int idx = threadIdx.x; idx < kTok * hd; idx += kThreads) {
      const int t = idx / hd, j = idx % hd;
      p.merged[(row0 + t) * C + h * hd + j] =
          __float2bfloat16(stg[t * L.ldo32 + j]);
    }
    __syncthreads();
  }

  // ---- d(merged) = dy @ wproj^T, rounded to bf16 -> hbuf (x is done with) ----
  for (int tn = warp; tn < ctiles; tn += kWarps) {
    FragC c[4];
    zero_strip(c);
    mma_strip_bt(c, dbuf, L.ldh, p.wproj + (size_t)tn * 16 * C, C, C);
    store_strip_bf16(hbuf, L.ldh, tn * 16, c, stg + warp * 16, kSlotLd);
  }
  __syncthreads();

  // ---- attention backward per head, with the f32 softmax kept for dS ----
  S.p32 = p32;
  for (int h = 0; h < p.heads; ++h) {
    attn_head_load_qkv(S, C, hd, h, qkv_rows);
    attn_head_softmax(S, Wt, h);
    attn_head_backward(S, Wt, h, hbuf + h * hd, L.ldh, acc, L.lda, qkv_rows,
                       p.dbias);
  }

  // ---- dbqkv += column sums of the rounded dqkv; dx = dqkv @ wqkv^T ----
  for (int c = threadIdx.x; c < C3; c += kThreads) {
    float s = 0.f;
    for (int t = 0; t < kTok; ++t)
      s += __bfloat162float(qkv_rows[(size_t)t * C3 + c]);
    atomicAdd(p.dbqkv + c, s);
  }
  for (int tn = warp; tn < ctiles; tn += kWarps) {
    FragC c[4];
    zero_strip(c);
    mma_strip_bt(c, qkv_rows, C3, p.wqkv + (size_t)tn * 16 * C3, C3, C3);
    float* slot = stg + warp * 16;
    store_strip(slot, c, kSlotLd);
    __syncwarp();
    for (int idx = lane; idx < kTok * 16; idx += 32) {
      const int t = idx / 16, j = idx % 16;
      p.out[token_offset(p, w, t) + tn * 16 + j] =
          __float2bfloat16(slot[t * kSlotLd + j]);
    }
    __syncwarp();
  }
}

AttnParams make_params(const void* x, const void* dy, const void* wqkv,
                       const void* bqkv, const void* wproj, const void* bproj,
                       const void* rel_bias, const void* mask, void* out, int B,
                       int H, int W, int C, int heads) {
  AttnParams p = {};
  p.x = static_cast<const bf16*>(x);
  p.dy = static_cast<const bf16*>(dy);
  p.wqkv = static_cast<const bf16*>(wqkv);
  p.bqkv = static_cast<const bf16*>(bqkv);
  p.wproj = static_cast<const bf16*>(wproj);
  p.bproj = static_cast<const bf16*>(bproj);
  p.rel_bias = static_cast<const float*>(rel_bias);
  p.mask = static_cast<const float*>(mask);
  p.out = static_cast<bf16*>(out);
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.heads = heads;
  p.hd = C / heads;
  p.scale = 1.0f / sqrtf((float)p.hd);
  return p;
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at channel width C and head dim hd.
size_t window_attention_smem_bytes(int C, int hd, int backward) {
  return make_attn_layout(C, hd, backward != 0).total;
}

// Elements of bf16 scratch a backward launch needs.
long long window_attention_bwd_scratch_bf16(int B, int H, int W, int C) {
  return (long long)B * H * W * 6LL * C;
}

// Launches the forward on `stream` (a cudaStream_t) and returns the CUDA
// error code of the launch (0 on success). x/out [B, H, W, C] bf16 with H and
// W multiples of 8; C a multiple of 32 and at most 384; C / heads a multiple
// of 16. `mask` may be null.
int window_attention_fwd(const void* x, const void* wqkv, const void* bqkv,
                         const void* wproj, const void* bproj,
                         const void* rel_bias, const void* mask, void* out,
                         int B, int H, int W, int C, int heads, void* stream) {
  const AttnParams p = make_params(x, nullptr, wqkv, bqkv, wproj, bproj,
                                   rel_bias, mask, out, B, H, W, C, heads);
  const size_t smem = make_attn_layout(C, p.hd, false).total;
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * (H / kWs) * (W / kWs)));
  window_attention_fwd_kernel<<<grid, kThreads, smem,
                                static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// Backward on `stream`; returns the CUDA error code of the first failed
// launch (0 on success). x, dy, dx are [B, H, W, C] bf16; the five gradient
// outputs are f32 and must be zeroed by the caller on the same stream;
// scratch_bf16 holds at least window_attention_bwd_scratch_bf16 elements.
int window_attention_bwd(const void* x, const void* dy, const void* wqkv,
                         const void* bqkv, const void* wproj,
                         const void* rel_bias, const void* mask, void* dx,
                         void* dwqkv, void* dbqkv, void* dwproj, void* dbproj,
                         void* dbias, void* scratch_bf16, int B, int H, int W,
                         int C, int heads, void* stream) {
  AttnParams p = make_params(x, dy, wqkv, bqkv, wproj, nullptr, rel_bias, mask,
                             dx, B, H, W, C, heads);
  p.dbqkv = static_cast<float*>(dbqkv);
  p.dbproj = static_cast<float*>(dbproj);
  p.dbias = static_cast<float*>(dbias);
  const long long n = (long long)B * H * W;
  bf16* s = static_cast<bf16*>(scratch_bf16);
  p.xw = s;
  s += n * C;
  p.qkv = s;
  s += n * 3 * C;
  p.merged = s;
  s += n * C;
  p.dyw = s;

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = make_attn_layout(C, p.hd, true).total;
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = sm90::sm_count(&sms);
  if (err != cudaSuccess) return (int)err;

  const dim3 grid((unsigned)(B * (H / kWs) * (W / kWs)));
  window_attention_bwd_kernel<<<grid, kThreads, smem, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = sm90::launch_atb<false>(p.xw, p.qkv, static_cast<float*>(dwqkv), C, 3 * C, n, sms,
                   st);
  if (err != cudaSuccess) return (int)err;
  err = sm90::launch_atb<false>(p.merged, p.dyw, static_cast<float*>(dwproj), C, C, n, sms,
                   st);
  return (int)err;
}

}  // extern "C"
