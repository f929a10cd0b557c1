// Swin-window kernels for every shape and type the TPU kernels take (sm_90a):
// the general route of K1-K4.
//
// Replaces, for the shapes the wgmma kernels of swin_block.cu,
// swin_block_bwd.cu and window_attention.cu are not built for,
//   strajnet_tpu/ops/pallas_swin_block.py::_fwd_kernel (K1) and _bwd_kernel (K2),
//   strajnet_tpu/ops/pallas_window_attention.py::_kernel (K3) and _bwd_kernel (K4).
// Those take any window, head count, head size and MLP width, in f32 or bf16;
// so does this file, up to n = ws * ws <= 256 tokens a window, head_dim <= 64
// and C <= 1024 (the wrapper checks; ops/swin_block.py::kernel_route).
//
// It is a chain of simple SIMT kernels with the intermediates in device
// memory, not a fused kernel:
//
// - gemm_kernel: C = epilogue(alpha * A @ B) over a batch of strided
//   matrices (the batch is a window and a head), f32 accumulators, operands
//   in f32 or bf16, optionally rounded to bf16 as they are loaded. Epilogues:
//   bias; bias and tanh-gelu (keeping the pre-activation); residual
//   `res + dp[sample] * (acc + bias)`; the attention logits
//   `acc * scale + rel_bias + mask`; the gelu gradient. Split over the
//   product's depth into per-split partial sums, which reduce_splits_kernel
//   adds in a fixed order: the weight gradients `sum over tokens a^T b` are
//   deterministic, with no float atomics.
// - ln_rows_kernel / ln_bwd_rows_kernel: LayerNorm and its backward, one warp
//   a row, statistics in f32.
// - softmax_rows_kernel / softmax_bwd_rows_kernel: one warp a row of logits.
// - rows_copy_kernel: the grid order of [B, H, W, C] to the window order
//   (window after window, token after token) and back, with a drop-path
//   multiplier and a rounding.
// - colsum_kernel: sums over tokens (biases, LayerNorm parameters) and over
//   windows (the rel-pos bias), split like the products.
//
// Every token-wise step works in window order, so a head's q, k and v in a
// window are a strided [n, head_dim] block of qkv and the attention is three
// batched products and a softmax. Rounding follows the plain versions
// (ops/swin_block.py::swin_block_reference and swin_block_backward_reference,
// ops/window_attention.py's two references), which is where the JAX kernels
// round: to the element type T after qkv's bias, p before p @ v, the merged
// heads, r1, both LayerNorm outputs and gelu; the backward products take
// operands rounded to `rd` (T for K2, bf16 for K4 whatever T is, as
// pallas_window_attention.py:142) and accumulate in f32.
//
// Bound: operations. A Swin block is 24 C^2 + 4 n C multiply-adds a token
// forward (three times that backward), in f32 on the SIMT units (67 TFLOP/s
// on an H100 SXM) where T is f32. The 16 x 16-thread product tiles of up to
// 64 x 64 outputs reach a fraction of that; the intermediates cost device
// memory traffic a fused kernel would not have. Speed is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kRowWarps = kThreads / 32;
constexpr int kMaxN = 256;   // tokens a window
constexpr long long kTargetBlocks = 264;   // two blocks an SM

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float load(const void* p, long long i, int bf) {
  return bf ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store(void* p, long long i, float v, int bf) {
  if (bf)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float gelu_tanh(float z) {
  const float k = 0.7978845608028654f, c = 0.044715f;
  return 0.5f * z * (1.0f + tanhf(k * (z + c * z * z * z)));
}

__device__ __forceinline__ float gelu_tanh_grad(float z) {
  const float k = 0.7978845608028654f, c = 0.044715f;
  const float t = tanhf(k * (z + c * z * z * z));
  const float du = k * (1.0f + 3.0f * c * z * z);
  return 0.5f * (1.0f + t) + 0.5f * z * (1.0f - t * t) * du;
}

// Window geometry of [B, H, W, C] tokens: row m of the window order (batch,
// window, token within the window) is row grid_row(m) of the grid order.
struct Geom {
  int H, W, ws;
  __device__ long long grid_row(long long m) const {
    const long long hw = (long long)H * W;
    const long long b = m / hw;
    const int r = (int)(m - b * hw);
    const int n = ws * ws, nww = W / ws;
    const int w = r / n, t = r - w * n;
    const int wh = w / nww, ww = w - wh * nww;
    return b * hw + (long long)(wh * ws + t / ws) * W + ww * ws + t % ws;
  }
};

// A strided matrix of a batch: element (i, j) of batch entry z lies at
// p[(z / zdiv) * sw + (z % zdiv) * sh + i * s0 + j * s1].
struct Mat {
  void* p;
  long long s0, s1, sw, sh;
  int bf;    // bf16 storage, else f32
  int rnd;   // round to bf16 on load (an operand) or before the store (a result)
  int map;   // rows are window-order rows stored at their grid rows
};

enum Epi { kStore = 0, kGelu = 1, kResid = 2, kScores = 3, kDGelu = 4 };

struct GemmArgs {
  int M, N, K, Z, zdiv, splits;
  long long kchunk;    // depth of one split
  Mat a, b, c;         // A [M, K], B [K, N], C [M, N]
  float* partial;      // or null: f32 [splits, M, N] sums, no epilogue
  int epi;
  float alpha;
  const void* bias;    // [N] or null
  int bias_bf;
  Mat res;             // kResid: the residual, [M, N] like C
  const float* dp;     // kResid: [B, 2] drop-path multipliers, or null
  int dp_col;
  long long rows_per_sample;
  float* aux;          // kGelu: pre-activation out; kDGelu: in; [M, N] f32
  const float* rel;    // kScores: [zdiv, M, N]
  const float* mask;   // kScores: [n_mask, M, N] or null
  int n_mask;
  Geom g;
};

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads) gemm_kernel(GemmArgs g) {
  constexpr int BK = 16, TM = BM / 16, TN = BN / 16;
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long tiles_m = (g.M + BM - 1) / BM, tiles_n = (g.N + BN - 1) / BN;
  long long blk = blockIdx.x;
  const int bn = (int)(blk % tiles_n);
  blk /= tiles_n;
  const int bm = (int)(blk % tiles_m);
  blk /= tiles_m;
  const int s = (int)(blk % g.splits);
  const int z = (int)(blk / g.splits);
  const int m0 = bm * BM, n0 = bn * BN;
  const long long k_begin = (long long)s * g.kchunk;
  const long long k_end = min((long long)g.K, k_begin + g.kchunk);
  const long long za = (z / g.zdiv) * g.a.sw + (z % g.zdiv) * g.a.sh;
  const long long zb = (z / g.zdiv) * g.b.sw + (z % g.zdiv) * g.b.sh;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (long long k0 = k_begin; k0 < k_end; k0 += BK) {
    for (int e = tid; e < BM * BK; e += kThreads) {
      int mi, ki;   // neighbouring threads on neighbouring addresses
      if (g.a.s1 == 1) {
        mi = e / BK;
        ki = e % BK;
      } else {
        ki = e / BM;
        mi = e % BM;
      }
      const long long m = m0 + mi, k = k0 + ki;
      float v = 0.0f;
      if (m < g.M && k < k_end) {
        v = load(g.a.p, za + m * g.a.s0 + k * g.a.s1, g.a.bf);
        if (g.a.rnd) v = round_bf16(v);
      }
      As[ki][mi] = v;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      int ki, ni;
      if (g.b.s1 == 1) {
        ki = e / BN;
        ni = e % BN;
      } else {
        ni = e / BK;
        ki = e % BK;
      }
      const long long k = k0 + ki, n = n0 + ni;
      float v = 0.0f;
      if (n < g.N && k < k_end) {
        v = load(g.b.p, zb + k * g.b.s0 + n * g.b.s1, g.b.bf);
        if (g.b.rnd) v = round_bf16(v);
      }
      Bs[ki][ni] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  const long long zc = (z / g.zdiv) * g.c.sw + (z % g.zdiv) * g.c.sh;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const long long n = n0 + tx + 16 * j;
      if (n >= g.N) continue;
      float v = acc[i][j];
      if (g.partial) {
        g.partial[((long long)s * g.M + m) * g.N + n] = v;
        continue;
      }
      v *= g.alpha;
      if (g.bias) v += load(g.bias, n, g.bias_bf);
      switch (g.epi) {
        case kGelu:
          if (g.aux) g.aux[m * g.N + n] = v;
          v = gelu_tanh(v);
          break;
        case kDGelu:
          v *= gelu_tanh_grad(g.aux[m * g.N + n]);
          break;
        case kResid: {
          const long long r = g.res.map ? g.g.grid_row(m) : m;
          const float d = g.dp ? g.dp[(m / g.rows_per_sample) * 2 + g.dp_col] : 1.0f;
          v = load(g.res.p, r * g.res.s0 + n * g.res.s1, g.res.bf) + d * v;
          break;
        }
        case kScores: {
          const int w = z / g.zdiv, h = z % g.zdiv;
          v += g.rel[((long long)h * g.M + m) * g.N + n];
          if (g.mask) v += g.mask[((long long)(w % g.n_mask) * g.M + m) * g.N + n];
          break;
        }
        default:
          break;
      }
      if (g.c.rnd) v = round_bf16(v);
      const long long r = g.c.map ? g.g.grid_row(m) : m;
      store(g.c.p, zc + r * g.c.s0 + n * g.c.s1, v, g.c.bf);
    }
  }
}

// out[i] += sum over s of partial[s * len + i], s in order.
__global__ void reduce_splits_kernel(const float* partial, int splits, long long len,
                                     float* out) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= len) return;
  float v = 0.0f;
  for (int s = 0; s < splits; ++s) v += partial[s * len + i];
  out[i] += v;
}

// partial[s * L + l] = sum of a[r * L + l] over the rows r of split s.
__global__ void colsum_kernel(const float* a, long long R, long long L, long long rows,
                              float* partial) {
  const long long col_blocks = (L + kThreads - 1) / kThreads;
  const long long s = blockIdx.x / col_blocks;
  const long long l = (blockIdx.x % col_blocks) * kThreads + threadIdx.x;
  if (l >= L) return;
  const long long r1 = min(R, (s + 1) * rows);
  float v = 0.0f;
  for (long long r = s * rows; r < r1; ++r) v += a[r * L + l];
  partial[s * L + l] = v;
}

// dst[m, :] = rnd(scale * src[row(m), :]), scale the sample's drop-path
// multiplier dp[b, col] where dp is given; one thread an element.
__global__ void rows_copy_kernel(const void* src, int src_bf, int src_map, void* dst,
                                 int dst_bf, int dst_map, int rnd, const float* dp,
                                 int dp_col, Geom g, long long M, int C) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= M * C) return;
  const long long m = e / C;
  const int c = (int)(e - m * C);
  const long long rs = src_map ? g.grid_row(m) : m;
  const long long rd = dst_map ? g.grid_row(m) : m;
  float v = load(src, rs * C + c, src_bf);
  if (dp) v *= dp[(m / ((long long)g.H * g.W)) * 2 + dp_col];
  if (rnd) v = round_bf16(v);
  store(dst, rd * C + c, v, dst_bf);
}

// out[m, :] = LayerNorm(x[row(m), :]) * s + b, rounded to out's type;
// stats[m] = (mean, 1 / std). One warp a row.
__global__ void ln_rows_kernel(const void* x, int x_bf, int x_map, Geom g, long long M,
                               int C, const float* s, const float* b, float eps,
                               void* out, int out_bf, float* stats) {
  const long long m = (long long)blockIdx.x * kRowWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (m >= M) return;
  const long long base = (x_map ? g.grid_row(m) : m) * C;
  float sum = 0.0f;
  for (int c = lane; c < C; c += 32) sum += load(x, base + c, x_bf);
  const float mean = warp_sum(sum) / C;
  float sq = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float d = load(x, base + c, x_bf) - mean;
    sq += d * d;
  }
  const float inv = rsqrtf(warp_sum(sq) / C + eps);
  for (int c = lane; c < C; c += 32) {
    const float xhat = (load(x, base + c, x_bf) - mean) * inv;
    store(out, m * C + c, xhat * s[c] + b[c], out_bf);
  }
  if (lane == 0) {
    stats[2 * m] = mean;
    stats[2 * m + 1] = inv;
  }
}

// The backward of ln_rows_kernel for one row, with d = dL/d(LN output) f32:
//   r = add[m] + inv * (d*s - mean(d*s) - xhat * mean(d*s*xhat))
// out[row(m)] = r (rounded to out's type); prod[m] = d * xhat (for the
// scale's gradient); out2[m] = dp[sample, col] * r where out2 is given.
__global__ void ln_bwd_rows_kernel(const float* d, const void* x, int x_bf, int x_map,
                                   Geom g, long long M, int C, const float* stats,
                                   const float* s, const float* add, float* prod,
                                   void* out, int out_bf, int out_map, float* out2,
                                   const float* dp, int dp_col) {
  const long long m = (long long)blockIdx.x * kRowWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (m >= M) return;
  const long long xb = (x_map ? g.grid_row(m) : m) * C;
  const float mean = stats[2 * m], inv = stats[2 * m + 1];
  float m1 = 0.0f, m2 = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float xhat = (load(x, xb + c, x_bf) - mean) * inv;
    const float dv = d[m * C + c];
    const float dxhat = dv * s[c];
    m1 += dxhat;
    m2 += dxhat * xhat;
    prod[m * C + c] = dv * xhat;
  }
  m1 = warp_sum(m1) / C;
  m2 = warp_sum(m2) / C;
  const long long ob = (out_map ? g.grid_row(m) : m) * C;
  const float scale = out2 ? dp[(m / ((long long)g.H * g.W)) * 2 + dp_col] : 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float xhat = (load(x, xb + c, x_bf) - mean) * inv;
    const float dxhat = d[m * C + c] * s[c];
    const float r = add[m * C + c] + inv * (dxhat - m1 - xhat * m2);
    store(out, ob + c, r, out_bf);
    if (out2) out2[m * C + c] = scale * r;
  }
}

// In place, each row of n logits to its softmax. One warp a row.
__global__ void softmax_rows_kernel(float* s, long long rows, int n) {
  const long long r = (long long)blockIdx.x * kRowWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  float* row = s + r * n;
  float v[kMaxN / 32];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < kMaxN / 32; ++i) {
    const int j = lane + 32 * i;
    v[i] = j < n ? row[j] : -INFINITY;
    mx = fmaxf(mx, v[i]);
  }
  mx = warp_max(mx);
  float sum = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxN / 32; ++i) {
    const int j = lane + 32 * i;
    v[i] = j < n ? expf(v[i] - mx) : 0.0f;
    sum += v[i];
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int i = 0; i < kMaxN / 32; ++i) {
    const int j = lane + 32 * i;
    if (j < n) row[j] = v[i] / sum;
  }
}

// In place, dp (dL/dp, f32) to ds = q * (dp - sum_j dp * q) with q the
// softmax p, or p rounded to bf16 when use_pb (and rnd); one warp a row.
__global__ void softmax_bwd_rows_kernel(const float* p, float* dp, long long rows, int n,
                                        int rnd, int use_pb) {
  const long long r = (long long)blockIdx.x * kRowWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const float* prow = p + r * n;
  float* drow = dp + r * n;
  float q[kMaxN / 32], d[kMaxN / 32];
  float dot = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxN / 32; ++i) {
    const int j = lane + 32 * i;
    q[i] = 0.0f;
    d[i] = 0.0f;
    if (j < n) {
      const float pv = prow[j];
      q[i] = (use_pb && rnd) ? round_bf16(pv) : pv;
      d[i] = drow[j];
      dot += d[i] * q[i];
    }
  }
  dot = warp_sum(dot);
#pragma unroll
  for (int i = 0; i < kMaxN / 32; ++i) {
    const int j = lane + 32 * i;
    if (j < n) drow[j] = q[i] * (d[i] - dot);
  }
}

// ---------------------------------------------------------------- host side

struct Dims {
  int B, H, W, C, heads, ws, hidden, n, hd, nW;
  long long M, BW, Z;
};

Dims make_dims(int B, int H, int W, int C, int heads, int ws, int hidden) {
  Dims d;
  d.B = B;
  d.H = H;
  d.W = W;
  d.C = C;
  d.heads = heads;
  d.ws = ws;
  d.hidden = hidden;
  d.n = ws * ws;
  d.hd = C / heads;
  d.nW = (H / ws) * (W / ws);
  d.M = (long long)B * H * W;
  d.BW = (long long)B * d.nW;
  d.Z = d.BW * heads;
  return d;
}

// Carves one scratch buffer into aligned pieces; with a null base it only
// counts the bytes.
struct Carver {
  char* base;
  size_t used;
  void* take(long long bytes) {
    const size_t off = (used + 255) & ~size_t(255);
    used = off + (size_t)bytes;
    return base ? base + off : nullptr;
  }
};

void* at(const void* p, long long elems, int bf) {
  return static_cast<char*>(const_cast<void*>(p)) + elems * (bf ? 2 : 4);
}

Mat mat(const void* p, long long s0, long long s1, int bf, int rnd = 0, long long sw = 0,
        long long sh = 0, int map = 0) {
  Mat m;
  m.p = const_cast<void*>(p);
  m.s0 = s0;
  m.s1 = s1;
  m.sw = sw;
  m.sh = sh;
  m.bf = bf;
  m.rnd = rnd;
  m.map = map;
  return m;
}

GemmArgs gemm_args(int M, int N, int K, Mat a, Mat b, Mat c, const Dims& d) {
  GemmArgs g = {};
  g.M = M;
  g.N = N;
  g.K = K;
  g.Z = 1;
  g.zdiv = 1;
  g.splits = 1;
  g.kchunk = K;
  g.a = a;
  g.b = b;
  g.c = c;
  g.epi = kStore;
  g.alpha = 1.0f;
  g.rows_per_sample = (long long)d.H * d.W;
  g.g = {d.H, d.W, d.ws};
  return g;
}

int blocks_1d(long long work, long long per_block) {
  return (int)((work + per_block - 1) / per_block);
}

template <int BM, int BN>
cudaError_t launch_gemm_tile(const GemmArgs& g, cudaStream_t st) {
  const long long blocks = (long long)((g.M + BM - 1) / BM) * ((g.N + BN - 1) / BN) *
                           g.Z * g.splits;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  gemm_kernel<BM, BN><<<(unsigned)blocks, kThreads, 0, st>>>(g);
  return cudaGetLastError();
}

cudaError_t launch_gemm(const GemmArgs& g, cudaStream_t st) {
  const int small = g.M < g.N ? g.M : g.N;
  if (small >= 48) return launch_gemm_tile<64, 64>(g, st);
  if (small >= 24) return launch_gemm_tile<32, 32>(g, st);
  return launch_gemm_tile<16, 16>(g, st);
}

cudaError_t reduce_splits(const float* partial, int splits, long long len, float* out,
                          cudaStream_t st) {
  reduce_splits_kernel<<<blocks_1d(len, kThreads), kThreads, 0, st>>>(partial, splits,
                                                                     len, out);
  return cudaGetLastError();
}

// out [K, N] f32 += sum over the R rows of a^T b, a [R, K] and b [R, N]
// row-major (strides lda, ldb), in per-split partial sums added in order.
cudaError_t atb(Mat a, Mat b, int R, int K, int N, float* out, float* partial,
                long long cap, const Dims& d, cudaStream_t st) {
  const long long lda = a.s0, ldb = b.s0;
  a.s0 = 1;     // row k of a^T: column k of a
  a.s1 = lda;
  b.s1 = 1;
  b.s0 = ldb;
  GemmArgs g = gemm_args(K, N, R, a, b, mat(out, N, 1, 0), d);
  const long long tiles = (long long)((K + 63) / 64) * ((N + 63) / 64);
  long long s = (kTargetBlocks + tiles - 1) / tiles;
  s = std::min(s, std::max(1LL, (long long)R / 256));
  s = std::min(s, std::max(1LL, cap / ((long long)K * N)));
  s = std::min(s, 128LL);
  const long long chunk = (((R + s - 1) / s) + 15) / 16 * 16;
  g.splits = (int)((R + chunk - 1) / chunk);
  g.kchunk = chunk;
  g.partial = partial;
  cudaError_t err = launch_gemm(g, st);
  if (err != cudaSuccess) return err;
  return reduce_splits(partial, g.splits, (long long)K * N, out, st);
}

// out [L] f32 += column sums of a [R, L] f32.
cudaError_t colsum(const float* a, long long R, long long L, float* out, float* partial,
                   long long cap, cudaStream_t st) {
  const long long col_blocks = (L + kThreads - 1) / kThreads;
  long long s = (kTargetBlocks + col_blocks - 1) / col_blocks;
  s = std::min(s, std::max(1LL, R / 64));
  s = std::min(s, std::max(1LL, cap / L));
  const long long rows = (R + s - 1) / s;
  s = (R + rows - 1) / rows;
  colsum_kernel<<<(unsigned)(col_blocks * s), kThreads, 0, st>>>(a, R, L, rows, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return reduce_splits(partial, (int)s, L, out, st);
}

cudaError_t rows_copy(const void* src, int src_bf, int src_map, void* dst, int dst_bf,
                      int dst_map, int rnd, const float* dp, int dp_col, const Dims& d,
                      cudaStream_t st) {
  rows_copy_kernel<<<blocks_1d(d.M * d.C, kThreads), kThreads, 0, st>>>(
      src, src_bf, src_map, dst, dst_bf, dst_map, rnd, dp, dp_col, {d.H, d.W, d.ws}, d.M,
      d.C);
  return cudaGetLastError();
}

cudaError_t ln_rows(const void* x, int x_bf, int x_map, const float* s, const float* b,
                    float eps, void* out, int out_bf, float* stats, const Dims& d,
                    cudaStream_t st) {
  ln_rows_kernel<<<blocks_1d(d.M, kRowWarps), kThreads, 0, st>>>(
      x, x_bf, x_map, {d.H, d.W, d.ws}, d.M, d.C, s, b, eps, out, out_bf, stats);
  return cudaGetLastError();
}

cudaError_t ln_bwd_rows(const float* dd, const void* x, int x_bf, int x_map,
                        const float* stats, const float* s, const float* add, float* prod,
                        void* out, int out_bf, int out_map, float* out2, const float* dp,
                        int dp_col, const Dims& d, cudaStream_t st) {
  ln_bwd_rows_kernel<<<blocks_1d(d.M, kRowWarps), kThreads, 0, st>>>(
      dd, x, x_bf, x_map, {d.H, d.W, d.ws}, d.M, d.C, stats, s, add, prod, out, out_bf,
      out_map, out2, dp, dp_col);
  return cudaGetLastError();
}

#define TRY(call)                              \
  do {                                         \
    cudaError_t err_ = (call);                 \
    if (err_ != cudaSuccess) return err_;      \
  } while (0)

// qkv [M, 3C] (T, window order) -> p [Z, n, n] f32 in `probs` and the merged
// heads [M, C] (T): logits, softmax, p @ v.
cudaError_t attention_fwd(const Dims& d, int bf, const void* qkv, const float* rel,
                          const float* mask, float* probs, void* merged,
                          cudaStream_t st) {
  const long long C3 = 3LL * d.C, nn = (long long)d.n * d.n;
  // logits: q [n, hd] @ k^T [hd, n] * scale + rel_bias + mask
  GemmArgs g = gemm_args(
      d.n, d.n, d.hd, mat(qkv, C3, 1, bf, 0, d.n * C3, d.hd),
      mat(at(qkv, d.C, bf), 1, C3, bf, 0, d.n * C3, d.hd),
      mat(probs, d.n, 1, 0, 0, d.heads * nn, nn), d);
  g.Z = (int)d.Z;
  g.zdiv = d.heads;
  g.epi = kScores;
  g.alpha = 1.0f / sqrtf((float)d.hd);
  g.rel = rel;
  g.mask = mask;
  g.n_mask = d.nW;
  TRY(launch_gemm(g, st));
  softmax_rows_kernel<<<blocks_1d(d.Z * d.n, kRowWarps), kThreads, 0, st>>>(
      probs, d.Z * d.n, d.n);
  TRY(cudaGetLastError());
  // p (rounded to T) @ v -> the head's columns of merged
  g = gemm_args(d.n, d.hd, d.n, mat(probs, d.n, 1, 0, bf, d.heads * nn, nn),
                mat(at(qkv, 2LL * d.C, bf), C3, 1, bf, 0, d.n * C3, d.hd),
                mat(merged, d.C, 1, bf, 0, (long long)d.n * d.C, d.hd), d);
  g.Z = (int)d.Z;
  g.zdiv = d.heads;
  return launch_gemm(g, st);
}

// The attention's backward from do [M, C] (f32, rounded to rd): dqkv [M, 3C]
// (f32, rounded to rd) and drel [heads, n, n] += sum over windows of ds.
// probs holds p; dprobs is scratch of its size. use_pb: ds from p rounded
// to rd (K2), else from p (K4).
cudaError_t attention_bwd(const Dims& d, int bf, int rd, int use_pb, const void* qkv,
                          const float* probs, const float* dout, float* dprobs,
                          float* dqkv, float* drel, float* partial, long long cap,
                          cudaStream_t st) {
  const long long C3 = 3LL * d.C, nn = (long long)d.n * d.n;
  const long long wq = d.n * C3, wo = (long long)d.n * d.C, zp = d.heads * nn;
  // dp = do @ v^T
  GemmArgs g = gemm_args(d.n, d.n, d.hd, mat(dout, d.C, 1, 0, 0, wo, d.hd),
                         mat(at(qkv, 2LL * d.C, bf), 1, C3, bf, rd, wq, d.hd),
                         mat(dprobs, d.n, 1, 0, 0, zp, nn), d);
  g.Z = (int)d.Z;
  g.zdiv = d.heads;
  TRY(launch_gemm(g, st));
  // dv = pb^T @ do
  g = gemm_args(d.n, d.hd, d.n, mat(probs, 1, d.n, 0, rd, zp, nn),
                mat(dout, d.C, 1, 0, 0, wo, d.hd),
                mat(dqkv + 2LL * d.C, C3, 1, 0, rd, wq, d.hd), d);
  g.Z = (int)d.Z;
  g.zdiv = d.heads;
  TRY(launch_gemm(g, st));
  softmax_bwd_rows_kernel<<<blocks_1d(d.Z * d.n, kRowWarps), kThreads, 0, st>>>(
      probs, dprobs, d.Z * d.n, d.n, rd, use_pb);
  TRY(cudaGetLastError());
  TRY(colsum(dprobs, d.BW, d.heads * nn, drel, partial, cap, st));
  const float scale = 1.0f / sqrtf((float)d.hd);
  // dq = ds @ k * scale
  g = gemm_args(d.n, d.hd, d.n, mat(dprobs, d.n, 1, 0, rd, zp, nn),
                mat(at(qkv, d.C, bf), C3, 1, bf, rd, wq, d.hd),
                mat(dqkv, C3, 1, 0, rd, wq, d.hd), d);
  g.Z = (int)d.Z;
  g.zdiv = d.heads;
  g.alpha = scale;
  TRY(launch_gemm(g, st));
  // dk = ds^T @ q * scale
  g = gemm_args(d.n, d.hd, d.n, mat(dprobs, 1, d.n, 0, rd, zp, nn),
                mat(qkv, C3, 1, bf, rd, wq, d.hd),
                mat(dqkv + (long long)d.C, C3, 1, 0, rd, wq, d.hd), d);
  g.Z = (int)d.Z;
  g.zdiv = d.heads;
  g.alpha = scale;
  return launch_gemm(g, st);
}

// The intermediates of one launch, carved from its scratch.
struct Buffers {
  void *h1, *qkv, *merged, *r1, *h2, *g1;               // T, [M, *]
  float *stats1, *stats2, *probs, *dprobs, *z1, *dyw, *dz2, *dz1, *dh, *prod, *dr1,
      *datt, *dmerged, *dqkv, *partial;
  long long cap;   // floats of partial
};

enum Kind { kBlockFwd = 0, kBlockBwd = 1, kAttnFwd = 2, kAttnBwd = 3 };

void layout(int kind, const Dims& d, int bf, Carver& cv, Buffers& b) {
  b = Buffers();
  const long long es = bf ? 2 : 4, M = d.M, C = d.C, hid = d.hidden;
  const long long zz = d.Z * d.n * d.n;
  const bool block = kind == kBlockFwd || kind == kBlockBwd;
  const bool bwd = kind == kBlockBwd || kind == kAttnBwd;
  b.h1 = cv.take(M * C * es);   // K3/K4: the input in window order
  b.qkv = cv.take(3 * M * C * es);
  b.probs = static_cast<float*>(cv.take(zz * 4));
  b.merged = cv.take(M * C * es);
  if (block) {
    b.r1 = cv.take(M * C * es);
    b.h2 = cv.take(M * C * es);
    b.g1 = cv.take(M * hid * es);
    b.stats1 = static_cast<float*>(cv.take(2 * M * 4));
    b.stats2 = static_cast<float*>(cv.take(2 * M * 4));
  }
  if (!bwd) return;
  b.dprobs = static_cast<float*>(cv.take(zz * 4));
  b.dyw = static_cast<float*>(cv.take(M * C * 4));
  b.dmerged = static_cast<float*>(cv.take(M * C * 4));
  b.dqkv = static_cast<float*>(cv.take(3 * M * C * 4));
  if (block) {
    b.z1 = static_cast<float*>(cv.take(M * hid * 4));
    b.dz2 = static_cast<float*>(cv.take(M * C * 4));
    b.dz1 = static_cast<float*>(cv.take(M * hid * 4));
    b.dh = static_cast<float*>(cv.take(M * C * 4));
    b.prod = static_cast<float*>(cv.take(M * C * 4));
    b.dr1 = static_cast<float*>(cv.take(M * C * 4));
    b.datt = static_cast<float*>(cv.take(M * C * 4));
  }
  long long most = 3 * C * C;
  if (block && C * hid > most) most = C * hid;
  if ((long long)d.heads * d.n * d.n > most) most = (long long)d.heads * d.n * d.n;
  b.cap = 2 * most > (1LL << 22) ? 2 * most : (1LL << 22);
  b.partial = static_cast<float*>(cv.take(b.cap * 4));
}

// The forward of a whole block, saving what the backward needs (z1 where
// b.z1 is carved); without `out` it stops before the last product.
cudaError_t block_forward(const Dims& d, int bf, const void* x, const void* wqkv,
                          const void* bqkv, const void* wproj, const void* bproj,
                          const float* rel, const float* ln1s, const float* ln1b,
                          const float* ln2s, const float* ln2b, const void* w1,
                          const float* b1, const void* w2, const float* b2,
                          const float* mask, const float* dp, void* out, float eps,
                          const Buffers& b, cudaStream_t st) {
  const int M = (int)d.M, C = d.C, hid = d.hidden;
  TRY(ln_rows(x, bf, 1, ln1s, ln1b, eps, b.h1, bf, b.stats1, d, st));
  GemmArgs g = gemm_args(M, 3 * C, C, mat(b.h1, C, 1, bf), mat(wqkv, 3 * C, 1, bf),
                         mat(b.qkv, 3 * C, 1, bf), d);
  g.bias = bqkv;
  g.bias_bf = bf;
  TRY(launch_gemm(g, st));
  TRY(attention_fwd(d, bf, b.qkv, rel, mask, b.probs, b.merged, st));
  // r1 = x + dp1 * (merged @ wproj + bproj)
  g = gemm_args(M, C, C, mat(b.merged, C, 1, bf), mat(wproj, C, 1, bf),
                mat(b.r1, C, 1, bf), d);
  g.bias = bproj;
  g.bias_bf = bf;
  g.epi = kResid;
  g.res = mat(x, C, 1, bf, 0, 0, 0, 1);
  g.dp = dp;
  g.dp_col = 0;
  TRY(launch_gemm(g, st));
  TRY(ln_rows(b.r1, bf, 0, ln2s, ln2b, eps, b.h2, bf, b.stats2, d, st));
  g = gemm_args(M, hid, C, mat(b.h2, C, 1, bf), mat(w1, hid, 1, bf),
                mat(b.g1, hid, 1, bf), d);
  g.bias = b1;
  g.epi = kGelu;
  g.aux = b.z1;
  TRY(launch_gemm(g, st));
  if (!out) return cudaSuccess;   // the backward's recompute stops here
  // out = r1 + dp2 * (g1 @ w2 + b2), at the grid rows
  g = gemm_args(M, C, hid, mat(b.g1, hid, 1, bf), mat(w2, C, 1, bf),
                mat(out, C, 1, bf, 0, 0, 0, 1), d);
  g.bias = b2;
  g.epi = kResid;
  g.res = mat(b.r1, C, 1, bf);
  g.dp = dp;
  g.dp_col = 1;
  return launch_gemm(g, st);
}

// K3's or K4's forward up to the merged heads: x to window order, qkv, p.
cudaError_t attn_prologue(const Dims& d, int bf, const void* x, const void* wqkv,
                          const void* bqkv, const float* rel, const float* mask,
                          const Buffers& b, cudaStream_t st) {
  const int M = (int)d.M, C = d.C;
  TRY(rows_copy(x, bf, 1, b.h1, bf, 0, 0, nullptr, 0, d, st));
  GemmArgs g = gemm_args(M, 3 * C, C, mat(b.h1, C, 1, bf), mat(wqkv, 3 * C, 1, bf),
                         mat(b.qkv, 3 * C, 1, bf), d);
  g.bias = bqkv;
  g.bias_bf = bf;
  TRY(launch_gemm(g, st));
  return attention_fwd(d, bf, b.qkv, rel, mask, b.probs, b.merged, st);
}

int valid(int B, int H, int W, int C, int heads, int ws, int hidden) {
  if (B < 1 || ws < 1 || heads < 1 || C < 1 || hidden < 1) return 0;
  if (H % ws || W % ws || C % heads || ws * ws > kMaxN) return 0;
  return 1;
}

}  // namespace

extern "C" {

// Bytes of scratch a launch of `kind` (0 block forward, 1 block backward,
// 2 attention forward, 3 attention backward) needs.
long long window_any_scratch_bytes(int kind, int bf, int B, int H, int W, int C,
                                   int heads, int ws, int hidden) {
  if (!valid(B, H, W, C, heads, ws, hidden)) return -1;
  const Dims d = make_dims(B, H, W, C, heads, ws, hidden);
  Carver cv = {nullptr, 0};
  Buffers b;
  layout(kind, d, bf, cv, b);
  return (long long)cv.used;
}

// K1: the whole Swin block, arguments in the order of fused_swin_block. x,
// out [B, H, W, C], wqkv [C, 3C], bqkv [3C], wproj [C, C], bproj [C], w1 [C,
// hidden], w2 [hidden, C] in T (bf16 where bf, else f32); rel [heads, n, n],
// ln*, b1, b2, mask [nW, n, n] (or null) and dp [B, 2] f32. Returns the CUDA
// error of the first failed launch (0 on success).
int swin_any_fwd(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
                 const void* bproj, const void* rel, const void* ln1s, const void* ln1b,
                 const void* ln2s, const void* ln2b, const void* w1, const void* b1,
                 const void* w2, const void* b2, const void* mask, const void* dp,
                 void* out, void* scratch, int bf, int B, int H, int W, int C, int heads,
                 int ws, int hidden, float eps, void* stream) {
  if (!valid(B, H, W, C, heads, ws, hidden)) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(B, H, W, C, heads, ws, hidden);
  Carver cv = {static_cast<char*>(scratch), 0};
  Buffers b;
  layout(kBlockFwd, d, bf, cv, b);
  return (int)block_forward(
      d, bf, x, wqkv, bqkv, wproj, bproj, static_cast<const float*>(rel),
      static_cast<const float*>(ln1s), static_cast<const float*>(ln1b),
      static_cast<const float*>(ln2s), static_cast<const float*>(ln2b), w1,
      static_cast<const float*>(b1), w2, static_cast<const float*>(b2),
      static_cast<const float*>(mask), static_cast<const float*>(dp), out, eps, b,
      static_cast<cudaStream_t>(stream));
}

// K2: dx (T, [B, H, W, C]) and the 13 parameter gradients (f32, zeroed by
// the caller, summed into) of the block from dy (T). The backward products
// take operands rounded to bf16 where rd, else as they are (f32 or bf16).
int swin_any_bwd(const void* x, const void* dy, const void* wqkv, const void* bqkv,
                 const void* wproj, const void* bproj, const void* rel, const void* ln1s,
                 const void* ln1b, const void* ln2s, const void* ln2b, const void* w1,
                 const void* b1, const void* w2, const void* b2, const void* mask,
                 const void* dp, void* dx, float* dwqkv, float* dbqkv, float* dwproj,
                 float* dbproj, float* drel, float* dln1s, float* dln1b, float* dln2s,
                 float* dln2b, float* dw1, float* db1, float* dw2, float* db2,
                 void* scratch, int bf, int rd, int B, int H, int W, int C, int heads,
                 int ws, int hidden, float eps, void* stream) {
  if (!valid(B, H, W, C, heads, ws, hidden)) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(B, H, W, C, heads, ws, hidden);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Carver cv = {static_cast<char*>(scratch), 0};
  Buffers b;
  layout(kBlockBwd, d, bf, cv, b);
  const float* fdp = static_cast<const float*>(dp);
  const float* fln1s = static_cast<const float*>(ln1s);
  const float* fln2s = static_cast<const float*>(ln2s);
  TRY(block_forward(d, bf, x, wqkv, bqkv, wproj, bproj, static_cast<const float*>(rel),
                    fln1s, static_cast<const float*>(ln1b), fln2s,
                    static_cast<const float*>(ln2b), w1, static_cast<const float*>(b1),
                    w2, static_cast<const float*>(b2), static_cast<const float*>(mask),
                    fdp, nullptr, eps, b, st));
  const int M = (int)d.M, hid = d.hidden;
  const long long cap = b.cap;
  // out = r1 + dp2 * (g1 @ w2 + b2)
  TRY(rows_copy(dy, bf, 1, b.dyw, 0, 0, 0, nullptr, 0, d, st));
  TRY(rows_copy(dy, bf, 1, b.dz2, 0, 0, 0, fdp, 1, d, st));
  TRY(atb(mat(b.g1, hid, 1, bf, rd), mat(b.dz2, C, 1, 0, rd), M, hid, C, dw2, b.partial,
          cap, d, st));
  TRY(colsum(b.dz2, M, C, db2, b.partial, cap, st));
  GemmArgs g = gemm_args(M, hid, C, mat(b.dz2, C, 1, 0, rd), mat(w2, 1, C, bf, rd),
                         mat(b.dz1, hid, 1, 0), d);
  g.epi = kDGelu;
  g.aux = b.z1;
  TRY(launch_gemm(g, st));
  TRY(colsum(b.dz1, M, hid, db1, b.partial, cap, st));
  TRY(atb(mat(b.h2, C, 1, bf, rd), mat(b.dz1, hid, 1, 0, rd), M, C, hid, dw1, b.partial,
          cap, d, st));
  g = gemm_args(M, C, hid, mat(b.dz1, hid, 1, 0, rd), mat(w1, 1, hid, bf, rd),
                mat(b.dh, C, 1, 0), d);
  TRY(launch_gemm(g, st));
  // dr1 = dy + LN2's backward; datt = dp1 * dr1
  TRY(ln_bwd_rows(b.dh, b.r1, bf, 0, b.stats2, fln2s, b.dyw, b.prod, b.dr1, 0, 0, b.datt,
                  fdp, 0, d, st));
  TRY(colsum(b.prod, M, C, dln2s, b.partial, cap, st));
  TRY(colsum(b.dh, M, C, dln2b, b.partial, cap, st));
  // r1 = x + dp1 * (merged @ wproj + bproj)
  TRY(colsum(b.datt, M, C, dbproj, b.partial, cap, st));
  TRY(atb(mat(b.merged, C, 1, bf, rd), mat(b.datt, C, 1, 0, rd), M, C, C, dwproj,
          b.partial, cap, d, st));
  g = gemm_args(M, C, C, mat(b.datt, C, 1, 0, rd), mat(wproj, 1, C, bf, rd),
                mat(b.dmerged, C, 1, 0, rd), d);
  TRY(launch_gemm(g, st));
  TRY(attention_bwd(d, bf, rd, 1, b.qkv, b.probs, b.dmerged, b.dprobs, b.dqkv, drel,
                    b.partial, cap, st));
  // qkv = LN1(x) @ wqkv + bqkv
  TRY(atb(mat(b.h1, C, 1, bf, rd), mat(b.dqkv, 3 * C, 1, 0), M, C, 3 * C, dwqkv,
          b.partial, cap, d, st));
  TRY(colsum(b.dqkv, M, 3 * C, dbqkv, b.partial, cap, st));
  g = gemm_args(M, C, 3 * C, mat(b.dqkv, 3 * C, 1, 0), mat(wqkv, 1, 3 * C, bf, rd),
                mat(b.dh, C, 1, 0), d);
  TRY(launch_gemm(g, st));
  TRY(ln_bwd_rows(b.dh, x, bf, 1, b.stats1, fln1s, b.dr1, b.prod, dx, bf, 1, nullptr,
                  nullptr, 0, d, st));
  TRY(colsum(b.prod, M, C, dln1s, b.partial, cap, st));
  return (int)colsum(b.dh, M, C, dln1b, b.partial, cap, st);
}

// K3: proj(attention(windows of x)), arguments in the order of
// fused_window_attention; x, out [B, H, W, C] and the weights in T, rel and
// mask f32.
int attn_any_fwd(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
                 const void* bproj, const void* rel, const void* mask, void* out,
                 void* scratch, int bf, int B, int H, int W, int C, int heads, int ws,
                 void* stream) {
  if (!valid(B, H, W, C, heads, ws, 1)) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(B, H, W, C, heads, ws, 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Carver cv = {static_cast<char*>(scratch), 0};
  Buffers b;
  layout(kAttnFwd, d, bf, cv, b);
  TRY(attn_prologue(d, bf, x, wqkv, bqkv, static_cast<const float*>(rel),
                    static_cast<const float*>(mask), b, st));
  GemmArgs g = gemm_args((int)d.M, C, C, mat(b.merged, C, 1, bf), mat(wproj, C, 1, bf),
                         mat(out, C, 1, bf, 0, 0, 0, 1), d);
  g.bias = bproj;
  g.bias_bf = bf;
  return (int)launch_gemm(g, st);
}

// K4: dx (T) and the five parameter gradients (f32, zeroed by the caller)
// of K3 from dy (T); operands of the backward products rounded to bf16 where
// rd.
int attn_any_bwd(const void* x, const void* dy, const void* wqkv, const void* bqkv,
                 const void* wproj, const void* rel, const void* mask, void* dx,
                 float* dwqkv, float* dbqkv, float* dwproj, float* dbproj, float* drel,
                 void* scratch, int bf, int rd, int B, int H, int W, int C, int heads,
                 int ws, void* stream) {
  if (!valid(B, H, W, C, heads, ws, 1)) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(B, H, W, C, heads, ws, 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Carver cv = {static_cast<char*>(scratch), 0};
  Buffers b;
  layout(kAttnBwd, d, bf, cv, b);
  const int M = (int)d.M;
  const long long cap = b.cap;
  TRY(attn_prologue(d, bf, x, wqkv, bqkv, static_cast<const float*>(rel),
                    static_cast<const float*>(mask), b, st));
  TRY(rows_copy(dy, bf, 1, b.dyw, 0, 0, rd, nullptr, 0, d, st));
  TRY(colsum(b.dyw, M, C, dbproj, b.partial, cap, st));
  TRY(atb(mat(b.merged, C, 1, bf, rd), mat(b.dyw, C, 1, 0), M, C, C, dwproj, b.partial,
          cap, d, st));
  GemmArgs g = gemm_args(M, C, C, mat(b.dyw, C, 1, 0), mat(wproj, 1, C, bf, rd),
                         mat(b.dmerged, C, 1, 0, rd), d);
  TRY(launch_gemm(g, st));
  TRY(attention_bwd(d, bf, rd, 0, b.qkv, b.probs, b.dmerged, b.dprobs, b.dqkv, drel,
                    b.partial, cap, st));
  TRY(atb(mat(b.h1, C, 1, bf, rd), mat(b.dqkv, 3 * C, 1, 0), M, C, 3 * C, dwqkv,
          b.partial, cap, d, st));
  TRY(colsum(b.dqkv, M, 3 * C, dbqkv, b.partial, cap, st));
  g = gemm_args(M, C, 3 * C, mat(b.dqkv, 3 * C, 1, 0), mat(wqkv, 1, 3 * C, bf, rd),
                mat(dx, C, 1, bf, 0, 0, 0, 1), d);
  return (int)launch_gemm(g, st);
}

}  // extern "C"
