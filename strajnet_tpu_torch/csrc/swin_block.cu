// Fused Swin-transformer block forward for Hopper (sm_90a).
//
// Replaces strajnet_tpu/ops/pallas_swin_block.py::_fwd_kernel (reached
// through _make_block_fn.fwd_call / fused_swin_block). On input that the
// caller has already rolled for shifted windows it computes, per 8x8 window
// (64 tokens) of one sample:
//
//   r1  = x + dp1 * proj(W-MSA(LN1(x)))     rel-pos bias + 0/-100 SW-MSA mask
//   out = r1 + dp2 * fc2(gelu_tanh(fc1(LN2(r1))))
//
// Numerics follow the TPU kernel: LayerNorm statistics, softmax and every
// matrix-product accumulator in f32; bf16 operands (the LN outputs, q/k/v,
// the softmax weights, the merged heads, the GELU output); r1 and out are
// rounded to bf16.
//
// What bounds it on the H100: the unfused block streams every LayerNorm,
// residual and MLP intermediate through device memory, so the plain version
// is bound by HBM bytes. Fused, x is read once and out written once, and
// what remains is the matrix products (16 MFLOP per window at C=96, 233 at
// C=384): by count the kernel is bound by operations, and the design is
// about feeding the tensor cores:
//
// - wgmma: 64 rows are one wgmma M tile, so one warpgroup owns one window
//   from LayerNorm to the last residual and meets the other warps of the
//   block at no block-wide barrier; its accumulators stay in registers, and
//   chained products (q k^T -> softmax -> P v -> projection; fc1 -> GELU ->
//   fc2) hand the rounded accumulator on as the next A operand without a
//   trip through shared memory (swin_block_sm90.cuh).
// - staged weights: a small kernel first packs the four weights into tiles
//   in the order of use and in the shared-memory operand layout; a producer
//   warp streams them with cp.async.bulk through a ring of stages guarded by
//   mbarriers, running ahead across phase and window boundaries.
// - several windows per block: two consumer warpgroups (two windows) share
//   every weight tile, which halves the L2 traffic per FLOP; the grid is
//   persistent (one block per SM walking over pairs of windows).
//
// As built it runs at a sixth of the operations bound: at C=96 the issue of
// the elementwise instructions between the products (LayerNorms, softmax,
// GELU: about as many issue slots as the whole window has clocks) sets the
// pace, which is why tanh and exp are the hardware's approximations (their
// error is below the bf16 rounding that follows); at C=384 the products and
// the waits of one warpgroup on its own chain of them.
//
// Shared memory per block: per consumer the A operand [64, C] bf16 (LN1
// output, then r1, then LN2 output: 48 KB at C=384) and 16 KB for two heads'
// k and v^T tiles; the rest, up to eight stages of 12 KB (18 KB at C=96),
// is the ring: 225 KB at C=384. r1 is parked in scratch, in an order in
// which each thread's pairs are contiguous across its warp (each thread
// reads back only what it wrote). At C=384 the fc2 accumulator [64, 384]
// would take 192 registers a thread, so the MLP runs in two passes of 192
// output columns and computes fc1 twice (a third more MLP FLOPs at that
// width).

#include "swin_block_sm90.cuh"

namespace {

using namespace sm90;

// Ring stages: as many as fit beside the consumers' buffers, up to 8. The
// weights in flight (ring bytes per round trip of a stage, some 3 us) bound
// the kernel at C=384, where a window pair streams 4.7 MB of tiles.
template <int C>
__host__ __device__ constexpr int fwd_stages() {
  constexpr int room = 232448 - 256 - kConsumers * (Cfg<C>::kBufBytes + 16384);
  constexpr int fit = room / (Cfg<C>::kStageBytes + 16);
  return fit < 8 ? fit : 8;
}

template <int C>
constexpr int fwd_smem_bytes() {
  return kConsumers * (Cfg<C>::kBufBytes + 16384) +
         fwd_stages<C>() * (Cfg<C>::kStageBytes + 16) + 128;
}

template <int C>
__global__ void __launch_bounds__(kBlockThreads, 1)
swin_block_fwd_kernel(const BlockArgs p, const uint8_t* __restrict__ packed,
                      uint32_t* __restrict__ park, bf16* __restrict__ out,
                      long long nwin) {
  using K = Cfg<C>;
  constexpr int kFwdStages = fwd_stages<C>();
  extern __shared__ uint8_t fwd_smem_raw[];
  uint8_t* smem = fwd_smem_raw + ((128u - (smem_u32(fwd_smem_raw) & 127u)) & 127u);
  constexpr int kPerWg = K::kBufBytes + 16384;
  const uint32_t ring_data = smem_u32(smem) + kConsumers * kPerWg;
  const uint32_t full = ring_data + kFwdStages * K::kStageBytes;
  const uint32_t empty = full + 8 * kFwdStages;

  const int chunks = p.hidden / 64;
  const int attn_tiles = (K::kHeads + K::kNc) * K::kNks;
  const int group = K::kNks + K::kNb;
  const int tiles = attn_tiles + K::kPasses * chunks * group;
  const long long steps = (nwin + kConsumers - 1) / kConsumers;

  if (threadIdx.x == 0) ring_init(full, empty, kFwdStages);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      const int mine =
          blockIdx.x < steps ? (int)((steps - blockIdx.x + gridDim.x - 1) / gridDim.x) : 0;
      ring_produce(ring_data, full, empty, kFwdStages, K::kStageBytes, packed, mine,
                   tiles, [&](int i) -> uint32_t {
                     if (i < attn_tiles) return K::kKs * 96 * 2;
                     return (i - attn_tiles) % group < K::kNks ? K::kKs * 64 * 2
                                                               : 64 * 96 * 2;
                   });
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    Ring ring = {ring_data, full, empty, kFwdStages, K::kStageBytes, 0, 0u};
    const Lane L = make_lane();
    uint8_t* hbuf = smem + wg * kPerWg;
    uint8_t* kv = hbuf + K::kBufBytes;
    const FwdSaves none = {nullptr, nullptr, nullptr, nullptr};
    for (long long s = blockIdx.x; s < steps; s += gridDim.x) {
      const long long index = s * kConsumers + wg;
      if (index >= nwin) {
        ring_drain(ring, tiles);
        continue;
      }
      const Window win = make_window(p, index);
      RowStats stats;
      uint32_t* mine = park + index * (kTok * C / 2);
      window_attention_half<C>(p, win, hbuf, kv, ring, mine, none, stats, 1 + wg, L);
      window_mlp_half<C>(p, win, hbuf, ring, mine, out, L);
    }
  }
}

template <int C>
long long fwd_packed_bytes(int hidden) {
  return fwd_attn_tiles_bytes<C>() +
         (long long)Cfg<C>::kPasses * (hidden / 64) * fwd_mlp_group_bytes<C>();
}

template <int C>
cudaError_t launch_fwd(const BlockArgs& p, const bf16* wqkv, const bf16* wproj,
                       const bf16* w1, const bf16* w2, uint8_t* packed, bf16* out,
                       cudaStream_t st) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return err;
  const long long blocks16 = fwd_packed_bytes<C>(p.hidden) / 16;
  pack_fwd_kernel<C><<<(unsigned)((blocks16 + 255) / 256), 256, 0, st>>>(
      packed, wqkv, wproj, w1, w2, p.hidden);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int smem = fwd_smem_bytes<C>();
  err = cudaFuncSetAttribute(swin_block_fwd_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const long long nwin = (long long)p.B * (p.H / kWs) * (p.W / kWs);
  const long long steps = (nwin + kConsumers - 1) / kConsumers;
  const unsigned grid = (unsigned)(steps < sms ? steps : sms);
  uint32_t* park = reinterpret_cast<uint32_t*>(packed + fwd_packed_bytes<C>(p.hidden));
  swin_block_fwd_kernel<C><<<grid, kBlockThreads, smem, st>>>(p, packed, park, out,
                                                              nwin);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block takes at channel width C (0: not covered).
size_t swin_block_smem_bytes(int C) {
  switch (C) {
    case 96: return fwd_smem_bytes<96>();
    case 192: return fwd_smem_bytes<192>();
    case 384: return fwd_smem_bytes<384>();
  }
  return 0;
}

// Bytes of scratch a launch needs: the packed weights, then r1 (bf16, one
// [64, C] block per window). 0: width not covered.
long long swin_block_fwd_scratch_bytes(int B, int H, int W, int C, int hidden) {
  const long long park = 2LL * B * H * W * C;
  switch (C) {
    case 96: return fwd_packed_bytes<96>(hidden) + park;
    case 192: return fwd_packed_bytes<192>(hidden) + park;
    case 384: return fwd_packed_bytes<384>(hidden) + park;
  }
  return 0;
}

// Launches the block on `stream` (a cudaStream_t) and returns the CUDA error
// code of the first failed launch (0 on success). Arguments in the order of
// fused_swin_block. Shapes: x/out [B, H, W, C] with H and W multiples of 8; C
// one of 96, 192, 384 with C / heads == 32; hidden a multiple of 64. `mask`
// may be null; `dp` is [B, 2]; `scratch` holds swin_block_fwd_scratch_bytes.
int swin_block_fwd(const void* x, const void* wqkv, const void* bqkv,
                   const void* wproj, const void* bproj, const void* rel_bias,
                   const void* ln1s, const void* ln1b, const void* ln2s,
                   const void* ln2b, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* mask,
                   const void* dp, void* out, void* scratch, int B, int H, int W,
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
  const bf16* wq = static_cast<const bf16*>(wqkv);
  const bf16* wp = static_cast<const bf16*>(wproj);
  const bf16* w1p = static_cast<const bf16*>(w1);
  const bf16* w2p = static_cast<const bf16*>(w2);
  uint8_t* pk = static_cast<uint8_t*>(scratch);
  bf16* o = static_cast<bf16*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 96: return (int)launch_fwd<96>(p, wq, wp, w1p, w2p, pk, o, st);
    case 192: return (int)launch_fwd<192>(p, wq, wp, w1p, w2p, pk, o, st);
    case 384: return (int)launch_fwd<384>(p, wq, wp, w1p, w2p, pk, o, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
