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
// projection. It is the fused Swin block without its two LayerNorms,
// residuals and MLP.
//
// One 64-token window is computed on its own, so no cross-window mask is
// needed: the TPU kernel's dense strips, with their -1e9 mask and
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
// By count both are bound by operations on the H100: 8 C^2 + 256 C FLOPs per
// token forward, 22 C^2 + 768 C backward, against x in and y out once.
//
// The forward (window_attention_fwd_kernel, one block of 8 warps per window)
// still runs on WMMA with weight fragments read from global memory (L2) once
// per window (swin_block_common.cuh): fragment loads, not the tensor cores,
// set its speed.
//
// The backward is the Swin-block backward (swin_block_bwd.cu) without its
// LayerNorms and MLP, on the same device code (swin_block_sm90.cuh,
// swin_block_bwd_sm90.cuh). Three kernels:
//
// 1. pack_attn_bwd_kernel packs wqkv by head, wproj^T and wqkv^T into tiles in
//    the order of use and in the shared-memory operand layout.
// 2. window_attention_bwd_kernel, persistent, two windows per block step: one
//    consumer warpgroup owns one window, a producer warp streams the packed
//    tiles through a ring of shared-memory stages (cp.async.bulk, mbarriers),
//    every product is wgmma with B from that ring. The warpgroup copies the
//    window of x into a K-major operand, recomputes q|k|v, the softmax and
//    the heads' outputs (attention_head of the forward block), loads dy over
//    x, forms d(merged) = dy @ wproj^T per three heads, walks each head back
//    (dP, dS, dq, dk, dv in registers, the transposed products from P^T and
//    dS^T in shared memory) and ends with dx = dqkv @ wqkv^T, rounded once.
//    dbqkv (and dbproj where shared memory has room, C <= 192) are column
//    sums by reduce-scatter kept in shared memory over all windows of a
//    warpgroup and added to device memory once; dbias takes one f32 pair per
//    thread and head. For the two weight gradients it writes x, dqkv, the
//    merged heads and dy into scratch, token-blocked per window.
// 3. atb_accum_sm90_kernel sums dwqkv = x^T dqkv and dwproj = merged^T dy over
//    all tokens (the split-K pass of the Swin-block backward).
//
// Shared memory per block: per warpgroup one [64, C] operand (x, then dy),
// 36 KB of per-head tiles (the forward's k | v^T tiles lie in them first) and
// the column sums; the rest is the ring: 7 stages of 18 KB at C=96, 8 of 12 KB
// at C=192, 4 of 12 KB at C=384 (the Swin-block backward has 5, 3, 2). What
// bounds it as built: as in that kernel, one warpgroup's chain of dependent
// elementwise instructions around small products (the heads' backward and the
// recomputed softmax), not the tensor cores.

#include "swin_block_common.cuh"
#include "swin_block_bwd_sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// Forward (WMMA)
// ---------------------------------------------------------------------------
namespace fwd {

using namespace wmma_attn;

struct AttnParams {
  const bf16* x;
  const bf16* wqkv;   // [C, 3C]
  const bf16* bqkv;   // [3C]
  const bf16* wproj;  // [C, C]
  const bf16* bproj;  // [C]
  const float* rel_bias;  // [heads, 64, 64]
  const float* mask;      // [nW, 64, 64] or null
  bf16* out;
  int B, H, W, C, heads, hd;
  float scale;
};

struct AttnLayout {
  int ldh, lda, ldqkv, ldstg, lds, ldp, ldo32, ldo;
  size_t off_acc, off_qkv, off_stg, off_p, off_o, total;
};

// hbuf, acc [64][C], qkv, stg, pbuf, obuf.
__host__ __device__ inline AttnLayout make_attn_layout(int C, int hd) {
  AttnLayout L;
  L.ldh = C + kPad16;
  L.lda = C + kPad32;
  L.ldqkv = 3 * hd + kPad16;
  L.ldstg = 3 * hd + kPad32;
  L.lds = kTok + kPad32;
  L.ldp = kTok + kPad16;
  L.ldo32 = hd + kPad32;
  L.ldo = hd + kPad16;
  const int stg_ld = L.ldstg > L.lds ? L.ldstg : L.lds;
  size_t off = round_up((size_t)kTok * L.ldh * sizeof(bf16), 128);
  L.off_acc = off;
  off = round_up(off + (size_t)kTok * L.lda * sizeof(float), 128);
  L.off_qkv = off;
  off = round_up(off + (size_t)kTok * L.ldqkv * sizeof(bf16), 128);
  L.off_stg = off;
  off = round_up(off + (size_t)kTok * stg_ld * sizeof(float), 128);
  L.off_p = off;
  off = round_up(off + (size_t)kTok * L.ldp * sizeof(bf16), 128);
  L.off_o = off;
  off = round_up(off + (size_t)kTok * L.ldo * sizeof(bf16), 128);
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
  const AttnLayout L = make_attn_layout(C, hd);
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
                      pbuf, L.ldp};
  const AttnWeights Wt = {
      p.wqkv, p.bqkv, p.rel_bias,
      p.mask ? p.mask + (size_t)w.wi * kTok * kTok : nullptr, C, hd, p.scale};
  for (int h = 0; h < p.heads; ++h) {
    attn_head_qkv(S, Wt, h);
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


}  // namespace fwd

// ---------------------------------------------------------------------------
// Backward (wgmma)
// ---------------------------------------------------------------------------
namespace bwd {

using namespace sm90;

template <int C>
struct AttnBwdCfg {
  using K = Cfg<C>;
  // Column sums in shared memory, f32: dbqkv [3C], kept over all windows of a
  // warpgroup, and dbproj [C] where there is room for it; at C=384 its 1.5 KB
  // would cost the ring a stage, so there every warp adds its sums of dy to
  // device memory.
  static constexpr bool kDbprojShared = C <= 192;
  static constexpr int kSums = (kDbprojShared ? 4 : 3) * C;
  static constexpr int kPerWg = K::kBufBytes + kHeadBufBytes + kSums * 4;
  // the ring takes what is left, up to 8 stages: 7 / 8 / 4 at C = 96 / 192 / 384
  static constexpr int kFit =
      (232448 - 256 - kConsumers * kPerWg) / (K::kStageBytes + 16);
  static constexpr int kStages = kFit < 8 ? kFit : 8;
  static constexpr int kSmem =
      kConsumers * kPerWg + kStages * (K::kStageBytes + 16) + 128;
  static_assert(kStages >= 2, "the ring needs two stages");
};

struct AttnBwdArgs {
  const bf16* dy;
  bf16* dx;
  // f32 gradients summed with atomics (zeroed before the launch)
  float* dbqkv;
  float* dbproj;
  float* dbias;
  // scratch: per window one [64, M] block in the token-blocked layout
  // (blk_off), windows in launch order
  bf16* xw;      // [N, C]
  bf16* qkv;     // [N, 3C]  q|k|v, then dq|dk|dv
  bf16* merged;  // [N, C]   concatenated head outputs
  bf16* dyw;     // [N, C]
};

// ---- ring tiles, in the order of use ----
//  1. per head: kNks tiles [kKs, 96] of wqkv[:, q|k|v columns of the head];
//  2. per 96 columns of d(merged): kNks tiles [kKs, 96] of wproj^T;
//  3. per pass, head, 96 output columns and half: [48, 96] of wqkv^T.
template <int C>
struct AttnBwdTiles {
  using K = Cfg<C>;
  static constexpr int t1 = K::kHeads * K::kNks;
  static constexpr int t2 = t1 + K::kNc * K::kNks;
  static constexpr int t3 = t2 + K::kPasses * K::kHeads * K::kNb * 2;
  static constexpr int kWide = K::kKs * 96 * 2;   // bytes of a [kKs, 96] tile
  __host__ __device__ static constexpr uint32_t bytes(int i) {
    return i < t2 ? kWide : kWqkvTTileBlocks * 16;
  }
  static constexpr long long kTotalBytes =
      (long long)t2 * kWide + (long long)(t3 - t2) * kWqkvTTileBlocks * 16;
};

template <int C>
__global__ void pack_attn_bwd_kernel(uint8_t* dst, const bf16* wqkv,
                                     const bf16* wproj) {
  using T = AttnBwdTiles<C>;
  constexpr int kPerTile = T::kWide / 16;
  constexpr long long n1 = (long long)T::t1 * kPerTile;
  constexpr long long n2 = (long long)T::t2 * kPerTile;
  constexpr long long n3 = T::kTotalBytes / 16;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n3;
       i += (long long)gridDim.x * blockDim.x) {
    uint8_t* o = dst + i * 16;
    if (i < n1) {
      pack_attention_tiles<C>(dst, wqkv, wproj, i);   // its per-head part
    } else if (i < n2) {
      const long long m = i - n1;
      pack_wproj_t_block<C>(o, wproj, (int)(m / kPerTile), (int)(m % kPerTile));
    } else {
      const long long m = i - n2;
      pack_wqkv_t_block<C>(o, wqkv, (int)(m / kWqkvTTileBlocks),
                           (int)(m % kWqkvTTileBlocks));
    }
  }
}

// One window's backward by its warpgroup. `buf` is the [64, C] operand, `hb`
// the per-head tiles, `cs` the column sums.
template <int C>
__device__ __forceinline__ void window_attention_backward(
    const BlockArgs& p, const AttnBwdArgs& q, const Window& win, long long index,
    uint8_t* buf, uint8_t* hb, float* cs, Ring& ring, int bar_id, const Lane& L) {
  using K = Cfg<C>;
  using B = AttnBwdCfg<C>;
  const size_t row_base = (size_t)index * kTok;   // this window's scratch rows
  bf16* qkv_rows = q.qkv + row_base * 3 * C;
  const uint32_t a_addr = smem_u32(buf);

  PHASE_START
  // ---- x -> buf and scratch ----
  copy_window<C>(p.x, win, buf, q.xw + row_base * C, L.tid);
  fence_proxy_async();
  named_bar_sync(bar_id, 128);
  PHASE(0)

  // ---- forward recompute per head: q|k|v and the head's output to scratch;
  //      k | v^T tiles alternate between the first two 8 KB of hb ----
  {
    const float* mask_w = p.mask ? p.mask + (size_t)win.wi * kTok * kTok : nullptr;
    bf16* merged_rows = q.merged + row_base * C;
#pragma unroll 1
    for (int h = 0; h < K::kHeads; ++h) {
      const HeadOut ho = attention_head<C>(
          a_addr, hb + (h & 1) * 8192, h, p.bqkv, p.rel_bias + (size_t)h * kTok * kTok,
          mask_w, p.scale, ring, qkv_rows, merged_rows, bar_id, L);
      ring.stage = ho.stage;
      ring.phase = ho.phase;
    }
  }
  PHASE(1)

  // ---- dy -> buf (every warp's reads of x lie before the last head's
  //      barrier) and scratch; dbproj += sum dy ----
  scaled_window<C>(q.dy, win, 1.0f, buf, q.dyw + row_base * C,
                   B::kDbprojShared ? cs + 3 * C : q.dbproj, L);
  fence_proxy_async();
  named_bar_sync(bar_id, 128);   // buf is in place, the forward's tiles are free
  PHASE(2)

  // ---- d(merged) = dy @ wproj^T per three heads, then their backward ----
  merged_and_heads_backward<C, false>(p, win, a_addr, qkv_rows, hb, q.dbias, cs, ring,
                                      bar_id, L);
  PHASE(3)

  // ---- dx = dqkv @ wqkv^T, rounded once ----
  dqkv_times_wqkv_t<C>(qkv_rows, ring, L, [&](int col, int half, float2 v) {
    *reinterpret_cast<uint32_t*>(q.dx + win.ofs<C>(L.row0 + 8 * half) + col) =
        pack_bf16(v.x, v.y);
  });
  PHASE(4)
}

template <int C>
__global__ void __launch_bounds__(kBlockThreads, 1)
window_attention_bwd_kernel(const BlockArgs p, const AttnBwdArgs q,
                            const uint8_t* packed, long long nwin) {
  using K = Cfg<C>;
  using B = AttnBwdCfg<C>;
  using T = AttnBwdTiles<C>;
  extern __shared__ uint8_t attn_bwd_smem_raw[];
  uint8_t* smem =
      attn_bwd_smem_raw + ((128u - (smem_u32(attn_bwd_smem_raw) & 127u)) & 127u);
  const uint32_t ring_data = smem_u32(smem) + kConsumers * B::kPerWg;
  const uint32_t full = ring_data + B::kStages * K::kStageBytes;
  const uint32_t empty = full + 8 * B::kStages;
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
                   T::t3, [](int i) -> uint32_t { return T::bytes(i); });
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    Ring ring = {ring_data, full, empty, B::kStages, K::kStageBytes, 0, 0u};
    const Lane L = make_lane();
    uint8_t* buf = smem + wg * B::kPerWg;
    uint8_t* hb = buf + K::kBufBytes;
    float* cs = reinterpret_cast<float*>(hb + kHeadBufBytes);
    for (int c = L.tid; c < B::kSums; c += 128) cs[c] = 0.f;
    named_bar_sync(1 + wg, 128);
    for (long long s = blockIdx.x; s < steps; s += gridDim.x) {
      const long long index = s * kConsumers + wg;
      if (index >= nwin) {
        ring_drain(ring, T::t3);
        continue;
      }
      window_attention_backward<C>(p, q, window_at(p.H, p.W, index), index, buf, hb,
                                   cs, ring, 1 + wg, L);
    }
    named_bar_sync(1 + wg, 128);
    colsum_flush(cs, 3 * C, q.dbqkv, L);
    if (B::kDbprojShared) colsum_flush(cs + 3 * C, C, q.dbproj, L);
    PHASE_END
  }
}

template <int C>
cudaError_t launch_attn_bwd(const BlockArgs& p, AttnBwdArgs q, const bf16* wqkv,
                            const bf16* wproj, bf16* scratch, float* dwqkv,
                            float* dwproj, cudaStream_t st) {
  using T = AttnBwdTiles<C>;
  const long long n = (long long)p.B * p.H * p.W;
  bf16* s = scratch;
  q.xw = s;
  s += n * C;
  q.qkv = s;
  s += n * 3 * C;
  q.merged = s;
  s += n * C;
  q.dyw = s;
  s += n * C;
  uint8_t* packed = reinterpret_cast<uint8_t*>(s);

  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  constexpr long long blocks16 = T::kTotalBytes / 16;
  pack_attn_bwd_kernel<C><<<(unsigned)((blocks16 + 255) / 256), 256, 0, st>>>(
      packed, wqkv, wproj);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int smem = AttnBwdCfg<C>::kSmem;
  err = cudaFuncSetAttribute(window_attention_bwd_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long nwin = n / kTok;
  const long long steps = (nwin + kConsumers - 1) / kConsumers;
  const unsigned grid = (unsigned)(steps < sms ? steps : sms);
  window_attention_bwd_kernel<C><<<grid, kBlockThreads, smem, st>>>(p, q, packed, nwin);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = launch_atb(q.xw, q.qkv, dwqkv, C, 3 * C, n, sms, st);
  if (err != cudaSuccess) return err;
  return launch_atb(q.merged, q.dyw, dwproj, C, C, n, sms, st);
}

long long packed_bytes(int C) {
  switch (C) {
    case 96: return AttnBwdTiles<96>::kTotalBytes;
    case 192: return AttnBwdTiles<192>::kTotalBytes;
    case 384: return AttnBwdTiles<384>::kTotalBytes;
  }
  return 0;
}

}  // namespace bwd

}  // namespace

extern "C" {

// Dynamic shared memory one block of the backward window kernel takes at
// channel width C (0: not covered).
size_t window_attention_bwd_smem_bytes(int C) {
  switch (C) {
    case 96: return bwd::AttnBwdCfg<96>::kSmem;
    case 192: return bwd::AttnBwdCfg<192>::kSmem;
    case 384: return bwd::AttnBwdCfg<384>::kSmem;
  }
  return 0;
}

// Elements of bf16 scratch a backward launch needs: the operands of the two
// weight gradients, then the packed weights.
long long window_attention_bwd_scratch_bf16(int B, int H, int W, int C) {
  return (long long)B * H * W * 6LL * C + bwd::packed_bytes(C) / 2;
}

#ifdef SWIN_PHASE_CLOCKS
int window_attention_bwd_phase_clocks(long long* out) {
  return bwd::phase_clocks_read(out);
}
#endif

// Launches the forward on `stream` (a cudaStream_t) and returns the CUDA
// error code of the launch (0 on success). x/out [B, H, W, C] bf16 with H and
// W multiples of 8; C a multiple of 32 and at most 384; C / heads a multiple
// of 16. `mask` may be null.
int window_attention_fwd(const void* x, const void* wqkv, const void* bqkv,
                         const void* wproj, const void* bproj,
                         const void* rel_bias, const void* mask, void* out,
                         int B, int H, int W, int C, int heads, void* stream) {
  fwd::AttnParams p = {};
  p.x = static_cast<const bf16*>(x);
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
  const size_t smem = fwd::make_attn_layout(C, p.hd).total;
  cudaError_t err = cudaFuncSetAttribute(
      fwd::window_attention_fwd_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * (H / fwd::kWs) * (W / fwd::kWs)));
  fwd::window_attention_fwd_kernel<<<grid, fwd::kThreads, smem,
                                     static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// Backward on `stream`; returns the CUDA error code of the first failed
// launch (0 on success). x, dy, dx are [B, H, W, C] bf16 with H and W
// multiples of 8, C one of 96, 192, 384 and C / heads == 32; the five
// gradient outputs are f32 and must be zeroed by the caller on the same
// stream; scratch_bf16 holds at least window_attention_bwd_scratch_bf16
// elements.
int window_attention_bwd(const void* x, const void* dy, const void* wqkv,
                         const void* bqkv, const void* wproj,
                         const void* rel_bias, const void* mask, void* dx,
                         void* dwqkv, void* dbqkv, void* dwproj, void* dbproj,
                         void* dbias, void* scratch_bf16, int B, int H, int W,
                         int C, int heads, void* stream) {
  if (heads * sm90::kHd != C || H % sm90::kWs || W % sm90::kWs)
    return (int)cudaErrorInvalidValue;
  sm90::BlockArgs p = {};
  p.x = static_cast<const bf16*>(x);
  p.bqkv = static_cast<const bf16*>(bqkv);
  p.rel_bias = static_cast<const float*>(rel_bias);
  p.mask = static_cast<const float*>(mask);
  p.B = B;
  p.H = H;
  p.W = W;
  p.scale = 1.0f / sqrtf((float)sm90::kHd);
  bwd::AttnBwdArgs q = {};
  q.dy = static_cast<const bf16*>(dy);
  q.dx = static_cast<bf16*>(dx);
  q.dbqkv = static_cast<float*>(dbqkv);
  q.dbproj = static_cast<float*>(dbproj);
  q.dbias = static_cast<float*>(dbias);
  const bf16* wq = static_cast<const bf16*>(wqkv);
  const bf16* wp = static_cast<const bf16*>(wproj);
  bf16* s16 = static_cast<bf16*>(scratch_bf16);
  float* g0 = static_cast<float*>(dwqkv);
  float* g1 = static_cast<float*>(dwproj);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 96: return (int)bwd::launch_attn_bwd<96>(p, q, wq, wp, s16, g0, g1, st);
    case 192: return (int)bwd::launch_attn_bwd<192>(p, q, wq, wp, s16, g0, g1, st);
    case 384: return (int)bwd::launch_attn_bwd<384>(p, q, wq, wp, s16, g0, g1, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
