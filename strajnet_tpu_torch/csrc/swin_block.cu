// Fused Swin-transformer block forward for Hopper (sm_90a).
//
// Replaces strajnet_tpu/ops/pallas_swin_block.py::_fwd_kernel (reached
// through _make_block_fn.fwd_call / fused_swin_block). One thread block
// computes one 8x8 window (64 tokens) of one sample, on input that the
// caller has already rolled for shifted windows:
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
// residual and MLP intermediate through device memory (stage 0 at batch 16
// is a 50 MB bf16 activation per boundary, 200 MB for the MLP hidden), so
// the plain version is bound by HBM bytes. This kernel reads x once, writes
// out once and keeps every intermediate in shared memory; what remains is
// the matrix products (16 MFLOP per window at C=96, 233 at C=384), which run
// on the tensor cores through WMMA (bf16 x bf16 -> f32, 16x16x16 tiles).
// Weights are read as WMMA fragments straight from global memory, where they
// stay L2-resident (3.5 MB at C=384); each warp computes a 64x16 column
// strip of every weight product, so a weight fragment is read once per
// window. This simple design is bound by its fragment loads, far below the
// tensor cores' peak: TMA, wgmma and software pipelining are later work.
//
// Shared memory per block (C = channels, hd = head dim, all row-padded):
//   hbuf  bf16 [64][C+8]     LN1 output, later LN2 output
//   acc   f32  [64][C+4]     attention-projection sum, later the fc2 sum
//   qkv   bf16 [64][3hd+8]   one head's q | k | v
//   stg   f32                qkv staging / logits / P@V / fc1 chunk
//   pbuf  bf16 [64][136]     softmax weights, later the GELU chunk
//   obuf  bf16 [64][hd+8]    one head's output
// 214 KB at C=384, hd=32. r1 is parked in the output tensor (each block owns
// its window of it) and read back for the final residual.

#include "swin_block_common.cuh"

namespace {

constexpr int kChunk = 128;    // MLP hidden chunk (8 column tiles: one per warp)

struct Params {
  const bf16* x;
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
  bf16* out;
  int B, H, W, C, heads, hd, hidden;
  float eps, scale;
};

struct Layout {
  int ldh, lda, ldqkv, ldstg, lds, ldz, ldp, ldo32, ldo;
  size_t off_acc, off_qkv, off_stg, off_p, off_o, total;
};

__host__ __device__ inline Layout make_layout(int C, int hd) {
  Layout L;
  L.ldh = C + kPad16;
  L.lda = C + kPad32;
  L.ldqkv = 3 * hd + kPad16;
  L.ldstg = 3 * hd + kPad32;
  L.lds = kTok + kPad32;
  L.ldz = kChunk + kPad32;
  L.ldp = kChunk + kPad16;
  L.ldo32 = hd + kPad32;
  L.ldo = hd + kPad16;
  size_t stg_elems = (size_t)kTok * L.ldstg;
  if ((size_t)kTok * L.lds > stg_elems) stg_elems = (size_t)kTok * L.lds;
  if ((size_t)kTok * L.ldo32 > stg_elems) stg_elems = (size_t)kTok * L.ldo32;
  if ((size_t)kTok * L.ldz > stg_elems) stg_elems = (size_t)kTok * L.ldz;
  size_t off = round_up((size_t)kTok * L.ldh * sizeof(bf16), 128);
  L.off_acc = off;
  off = round_up(off + (size_t)kTok * L.lda * sizeof(float), 128);
  L.off_qkv = off;
  off = round_up(off + (size_t)kTok * L.ldqkv * sizeof(bf16), 128);
  L.off_stg = off;
  off = round_up(off + stg_elems * sizeof(float), 128);
  L.off_p = off;
  off = round_up(off + (size_t)kTok * L.ldp * sizeof(bf16), 128);
  L.off_o = off;
  off = round_up(off + (size_t)kTok * L.ldo * sizeof(bf16), 128);
  L.total = off;
  return L;
}

__global__ void __launch_bounds__(kThreads)
swin_block_fwd_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = p.C, hd = p.hd;
  const Layout L = make_layout(C, hd);
  bf16* hbuf = reinterpret_cast<bf16*>(smem);
  float* acc = reinterpret_cast<float*>(smem + L.off_acc);
  bf16* qkv = reinterpret_cast<bf16*>(smem + L.off_qkv);
  float* stg = reinterpret_cast<float*>(smem + L.off_stg);
  bf16* pbuf = reinterpret_cast<bf16*>(smem + L.off_p);
  bf16* obuf = reinterpret_cast<bf16*>(smem + L.off_o);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwx = p.W / kWs, nwy = p.H / kWs;
  const int b = blockIdx.x / (nwx * nwy);
  const int wi = blockIdx.x % (nwx * nwy);
  const int wy = wi / nwx, wx = wi % nwx;
  const float dp1 = p.dp[2 * b], dp2 = p.dp[2 * b + 1];
  const int per_lane = C / 32;
  const int ctiles = C / 16;

  // token t of this window -> element offset of its channel vector
  auto gofs = [&](int t) -> size_t {
    const int row = wy * kWs + t / kWs, col = wx * kWs + t % kWs;
    return ((size_t)(b * p.H + row) * p.W + col) * (size_t)C;
  };

  // ---- LN1 (one warp per token), zero the projection accumulator ----
  for (int t = warp; t < kTok; t += kWarps) {
    const bf16* xr = p.x + gofs(t);
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
        hbuf[t * L.ldh + c] =
            __float2bfloat16((v[i] - mu) * inv * p.ln1s[c] + p.ln1b[c]);
        acc[t * L.lda + c] = 0.f;
      }
    }
  }
  __syncthreads();

  // ---- windowed multi-head attention, one head at a time ----
  const float* mask = p.mask ? p.mask + (size_t)wi * kTok * kTok : nullptr;
  for (int h = 0; h < p.heads; ++h) {
    // q | k | v of head h: [64, C] @ wqkv[:, cols] -> stg (f32)
    for (int tn = warp; tn < 3 * hd / 16; tn += kWarps) {
      const int part = (tn * 16) / hd, colin = (tn * 16) % hd;
      FragC c[4];
      zero_strip(c);
      mma_strip(c, hbuf, L.ldh, p.wqkv + part * C + h * hd + colin, 3 * C, C);
      store_strip(stg + tn * 16, c, L.ldstg);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTok * 3 * hd; idx += kThreads) {
      const int t = idx / (3 * hd), j = idx % (3 * hd);
      const int part = j / hd, jj = j % hd;
      const float v = stg[t * L.ldstg + j] +
                      __bfloat162float(p.bqkv[part * C + h * hd + jj]);
      qkv[t * L.ldqkv + j] = __float2bfloat16(v);
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

    // f32 softmax of scale * logits + rel-pos bias (+ mask), one warp per row
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

    // head output = P @ v -> stg as [64][ldo32] -> obuf (bf16)
    const int o_nt = hd / 16;
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
      obuf[t * L.ldo + j] = __float2bfloat16(stg[t * L.ldo32 + j]);
    }
    __syncthreads();

    // acc += head output @ wproj[h*hd:(h+1)*hd, :]
    for (int tn = warp; tn < ctiles; tn += kWarps) {
      FragC c[4];
      load_strip(c, acc + tn * 16, L.lda);
      mma_strip(c, obuf, L.ldo, p.wproj + (size_t)h * hd * C + tn * 16, C, hd);
      store_strip(acc + tn * 16, c, L.lda);
    }
    __syncthreads();
  }

  // ---- r1 = x + dp1 * (acc + bproj), parked in out; LN2 -> hbuf ----
  for (int t = warp; t < kTok; t += kWarps) {
    const size_t g = gofs(t);
    const bf16* xr = p.x + g;
    bf16* orow = p.out + g;
    float v[kMaxPerLane];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxPerLane; ++i) {
      if (i < per_lane) {
        const int c = lane + 32 * i;
        const float att = acc[t * L.lda + c] + __bfloat162float(p.bproj[c]);
        const bf16 r = __float2bfloat16(__bfloat162float(xr[c]) + dp1 * att);
        orow[c] = r;
        v[i] = __bfloat162float(r);
        s += v[i];
        acc[t * L.lda + c] = 0.f;
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
        hbuf[t * L.ldh + c] =
            __float2bfloat16((v[i] - mu) * inv * p.ln2s[c] + p.ln2b[c]);
      }
    }
  }
  __syncthreads();

  // ---- MLP in hidden chunks of 128: acc += gelu(h2 @ w1_j + b1_j) @ w2_j ----
  for (int j0 = 0; j0 < p.hidden; j0 += kChunk) {
    for (int tn = warp; tn < kChunk / 16; tn += kWarps) {
      FragC c[4];
      zero_strip(c);
      mma_strip(c, hbuf, L.ldh, p.w1 + j0 + tn * 16, p.hidden, C);
      store_strip(stg + tn * 16, c, L.ldz);
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < kTok * kChunk; idx += kThreads) {
      const int t = idx / kChunk, j = idx % kChunk;
      const float z = stg[t * L.ldz + j] + p.b1[j0 + j];
      pbuf[t * L.ldp + j] = __float2bfloat16(gelu_tanh(z));
    }
    __syncthreads();
    for (int tn = warp; tn < ctiles; tn += kWarps) {
      FragC c[4];
      load_strip(c, acc + tn * 16, L.lda);
      mma_strip(c, pbuf, L.ldp, p.w2 + (size_t)j0 * C + tn * 16, C, kChunk);
      store_strip(acc + tn * 16, c, L.lda);
    }
    __syncthreads();
  }

  // ---- out = r1 + dp2 * (acc + b2) ----
  for (int idx = threadIdx.x; idx < kTok * C; idx += kThreads) {
    const int t = idx / C, c = idx % C;
    bf16* o = p.out + gofs(t) + c;
    const float r1 = __bfloat162float(*o);
    *o = __float2bfloat16(r1 + dp2 * (acc[t * L.lda + c] + p.b2[c]));
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs at channel width C and head dim hd.
size_t swin_block_smem_bytes(int C, int hd) { return make_layout(C, hd).total; }

// Launches the block on `stream` (a cudaStream_t) and returns the CUDA error
// code of the launch (0 on success). Arguments in the order of
// fused_swin_block. Shapes: x/out [B, H, W, C] with H and W
// multiples of 8; C a multiple of 32 and at most 384; C / heads a multiple of
// 16; hidden a multiple of 128. `mask` may be null; `dp` is [B, 2].
int swin_block_fwd(const void* x, const void* wqkv, const void* bqkv,
                   const void* wproj, const void* bproj, const void* rel_bias,
                   const void* ln1s, const void* ln1b, const void* ln2s,
                   const void* ln2b, const void* w1, const void* b1,
                   const void* w2, const void* b2, const void* mask,
                   const void* dp, void* out, int B, int H, int W, int C,
                   int heads, int hidden, float eps, void* stream) {
  Params p;
  p.x = static_cast<const bf16*>(x);
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
  p.out = static_cast<bf16*>(out);
  p.B = B;
  p.H = H;
  p.W = W;
  p.C = C;
  p.heads = heads;
  p.hd = C / heads;
  p.hidden = hidden;
  p.eps = eps;
  p.scale = 1.0f / sqrtf((float)p.hd);

  const size_t smem = make_layout(C, p.hd).total;
  cudaError_t err = cudaFuncSetAttribute(
      swin_block_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(B * (H / kWs) * (W / kWs)));
  swin_block_fwd_kernel<<<grid, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
