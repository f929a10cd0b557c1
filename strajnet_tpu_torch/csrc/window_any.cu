// Swin-window kernels for every shape and type the TPU kernels take (sm_90a):
// the general route of K1-K4, on the tensor cores.
//
// Replaces, for the shapes the wgmma kernels of swin_block.cu,
// swin_block_bwd.cu and window_attention.cu are not built for,
//   strajnet_tpu/ops/pallas_swin_block.py::_fwd_kernel (K1) and _bwd_kernel (K2),
//   strajnet_tpu/ops/pallas_window_attention.py::_kernel (K3) and _bwd_kernel (K4).
// Those take any window, head count, head size and MLP width, in f32 or bf16;
// so does this file, up to n = ws * ws <= 256 tokens a window, head_dim <= 64,
// C <= 1024 and an MLP width of 4096 (the wrapper checks;
// ops/swin_block.py::kernel_route).
//
// Bound: operations. A Swin block is 24 C^2 + 4 n C multiply-adds a token
// forward (three times that backward): 989 TFLOP/s in bf16 and, in f32, the
// rate of three TF32 passes (495 / 3 = 165 TFLOP/s). At narrow widths the
// intermediates between the launches (x, qkv, merged, r1, g1, out: ~22 M C
// elements) set a traffic floor above the roofline bound, and at small
// depths (K = C = 128) each product tile's prologue and epilogue weigh as
// much as its main loop.
//
// The kernels, every product on the tensor cores:
//
// - gemm_kernel (mma.sync): C = epilogue(A @ B) over the tokens (the
//   backward's products, and the forward's in bf16), 64 x 64 block tiles, four warps of 32 x 32, the operands staged by cp.async
//   (16-byte copies where the rows allow, element copies else, zero-filled
//   edges) into a ring of three shared-memory stages; bf16 fragments by
//   ldmatrix, f32 ones split into TF32 halves as they are read. A LayerNorm
//   prologue (the block computes its rows' mean and 1/std, two threads a
//   row, under the first stages' loads; each stage of A is normalised and
//   rounded to T in shared memory once it lands, by the threads that copied
//   it; the statistics and, for the backward, the normalised rows are
//   saved) or a drop-path row scale on A; epilogues bias, bias + tanh-gelu
//   (keeping the pre-activation), the gelu gradient (with the column sums
//   of its result), `res + dp[sample] * (acc + bias)`; the window-order <->
//   grid-order row map (Geom::grid_row) on any operand. The backward's
//   products (RB in f32) read f32 operands rounded to bf16.
// - gemm_sm90_kernel (wgmma, bf16) and gemm_tf32x3_kernel (wgmma, f32 as
//   three TF32 passes, each landed stage split once into TF32 halves in
//   shared memory): the plain products C = A @ B + bias of K3 and of K4's
//   recomputed qkv, 128-row block tiles of two consumer warpgroups fed by a
//   cp.async ring (see the kernels); qkv stored in window order, the
//   projection at the grid rows.
// - fwd_product_kernel (wgmma, f32 as three TF32 passes): the four products
//   of K1's forward and of K2's recompute in f32 (LN1 -> qkv, the
//   projection + residual, LN2 -> fc1 + gelu, fc2 + residual), 128 x 128
//   tiles of two consumer warpgroups fed by a producer warp's tensor-map
//   copies into an mbarrier ring, A's LayerNorm and TF32 split in registers
//   while the last stage's products run (see the kernel).
// - atb_kernel: the weight gradients, sum over tokens of a^T b, up to four
//   in one launch, split over the tokens into per-split f32 partials; a row
//   of ones under a^T gives the column sums of b (a bias gradient).
// - attn_fwd_kernel: a block per (window, head, 16-64 queries): k and v of
//   the window whole in shared memory, a warp per strip of 16 queries and
//   part of the keys (attn_plan: strips a block are traded for parts of the
//   keys while the grid is under two waves), logits and p in registers
//   (passes for the row max, the row sum and p @ v; with several parts
//   their statistics and p @ v combined in part order through shared
//   memory), p rounded to T in a per-warp staging tile. p never reaches
//   device memory; the row max and sum do (8 bytes a row) for the backward.
//   k and v are held whole, not streamed: 174 KB of shared memory at n =
//   256, hd = 64 in f32. It reads qkv in window order (K1, K2, SwinV2's
//   unfused attention stage) or gathers each window's rows from grid order
//   (K3, K4).
// - attn_bwd_kernel (K2 and K4): a block per (head, group of windows), a
//   warp per 16 keys, k and v of the window whole in shared memory, the
//   16-query tiles of q and dO streamed through a double buffer: p and dp
//   computed once per window and head, dk and dv in registers, dq summed
//   over the key strips through shared memory in a fixed order. Its
//   products take bf16 operands; templated on the softmax dS takes (f32 p
//   for K4, p rounded to bf16 for K2). The rel-pos gradient sums the
//   group's windows in a partial private to the block, the bias gradient of
//   qkv the stores of dq, dk and dv.
// - ln_bwd_kernel (the LayerNorm backward of a block of rows, with the
//   column sums of the LayerNorm parameters' and biases' gradients) and
//   reduce_kernel (every per-split partial added in a fixed order, one
//   launch).
// - SwinV2's block (swinv2_any_fwd, swinv2_any_bwd) on the same products
//   (none with a prologue), around kernels of its own. Its attention stage
//   (q and k normalised per head, q times its logit scale exp(min(tau, ln
//   100)), then the window attention at scale 1) is one launch in bf16 at
//   head size 32, swinv2_attn_kernel (wgmma, a block per window and head,
//   the normalisation in shared memory); at other head sizes and in f32 it
//   is two, qk_norm_kernel (a thread a row and head) and attn_fwd_kernel
//   (v2_attn_fused chooses from the type and head size). Further:
//   qk_norm_bwd_kernel (with dtau's partials), postnorm_kernel (x + dp
//   LN(y), the post-norm residuals) and its backward, add_rows_kernel (dx's
//   last sum). 7 launches a forward and 17 a backward fused, 8 and 18 not;
//   the Swin-v1 kernels' code is as it was.
//
// Why mma.sync for the backward's products: their operands pass through a
// per-element step between shared memory and the tensor cores that is done
// per fragment (the rounding to bf16 of the backward's f32 operands, the
// row scale), A's rows may be gathered by a row map, and the attention's
// tiles are 16 rows of one warp; register fragments serve all of these.
// The plain products run on wgmma: bf16 as stored, f32 split into its TF32
// halves once a stage in shared memory, where wgmma reads them; so do the
// forward's in f32, with A's LayerNorm and split in registers, which wgmma
// reads A from.
//
// f32 runs as 3xTF32 (mma_sync.cuh), each stage of a sum (the product
// loop's 16-deep stage, an attention strip's k step) summed from zero and
// added to the f32 total to nearest (the tensor cores round their sums
// toward zero). K2 and K4 round every backward product's operands to bf16
// whatever T is (as the JAX kernels do): in f32 these run as bf16 m16n8k16
// products, their f32 operands rounded as the fragments are read, and the
// deep ones (dz1's input, dmerged, dx, the weight gradients) add each
// stage's product to the f32 sum to nearest; only the recomputed forward
// (LayerNorm, qkv, q k^T, p v, the MLP) runs in f32.
//
// Launches: K1 5 (qkv, attention, proj, fc1, fc2), K2 13, K3 3 (qkv, the
// attention, proj), K4 7, SwinV2's block 7 and 17 (8 and 18 where its
// attention stage is not fused; window_any_launches counts them). Rounding
// follows the plain versions (ops/swin_block.py::swin_block_reference and
// swin_block_backward_reference, ops/window_attention.py's two references):
// to T after qkv's bias, p before p @ v, the merged heads, r1, both
// LayerNorm outputs and gelu; the backward products take operands rounded
// to bf16 and accumulate in f32; dqkv is rounded to bf16 before its column
// sums (dbqkv), db1, db2, dbproj sum f32 values. No float atomics: two runs
// are bit-identical.

#include <cuda.h>
#include <dlfcn.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "mma_sync.cuh"
#include "sm90_ptx.cuh"

namespace {

using namespace msync;

constexpr int kMaxN = 256;         // tokens a window
constexpr int kMaxHeadDim = 64;
constexpr int kMaxC = 1024;
constexpr int kMaxHidden = 4096;
constexpr int kThreads = 128;      // products and attention: four warps
constexpr int kRowThreads = 256;   // LayerNorm backward
constexpr int kRowsPerBlock = 32;   // the LayerNorm backward's rows a block, at most
constexpr int kChunk = 64;         // keys (or queries) a step of the attention
constexpr long long kTargetBlocks = 528;   // four blocks an SM

long long g_launches = 0;       // kernels launched by this library
long long g_fwd_launches = 0;   // of them, fwd_product_kernel's
long long g_v2_attn_launches = 0;   // of them, swinv2_attn_kernel's

// ------------------------------------------------------------ elements

__device__ __forceinline__ float load(const void* p, long long i, int bf) {
  return bf ? __bfloat162float(static_cast<const bf16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store(void* p, long long i, float v, int bf) {
  if (bf)
    static_cast<bf16*>(p)[i] = __float2bfloat16(v);
  else
    static_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum over the eight lanes of a column of an mma accumulator (same lane % 4)
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 16);
  return v;
}

// the max over the four lanes of a row of an mma accumulator
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// the sum of eight partial sums, as a tree
__device__ __forceinline__ float sum8(const float (&v)[8]) {
  return ((v[0] + v[1]) + (v[2] + v[3])) + ((v[4] + v[5]) + (v[6] + v[7]));
}

// the sum over the four lanes of a row of an mma accumulator
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
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
// Row indices fit 32 bits (the wrapper checks B * H * W < 2^31).
struct Geom {
  int H, W, ws;
  __device__ int grid_row(long long m64) const {
    const int m = (int)m64, hw = H * W;
    const int b = m / hw, r = m - b * hw;
    const int n = ws * ws, nww = W / ws;
    const int w = r / n, t = r - w * n;
    const int wh = w / nww, ww = w - wh * nww;
    const int ty = t / ws;
    return b * hw + (wh * ws + ty) * W + ww * ws + (t - ty * ws);
  }
  // the window-order row of grid row g (grid_row's inverse)
  __device__ int window_row(long long g64) const {
    const int g = (int)g64, hw = H * W;
    const int b = g / hw, r = g - b * hw;
    const int y = r / W, x = r - y * W;
    const int wh = y / ws, ww = x / ws;
    return b * hw + (wh * (W / ws) + ww) * (ws * ws) + (y - wh * ws) * ws + (x - ww * ws);
  }
};

// ------------------------------------------------------------ staging

// A matrix in device memory: element (i, j) at p[row(i) * ld + j], row(i) =
// grid_row(i) where map, else i. vec: p and ld allow 16-byte copies.
struct Src {
  const void* p;
  long long ld;
  int map, vec;
};

// Copies rows [r0, r0 + rows) x columns [c0, c0 + cols) of s into dst (row
// stride dld elements; cols a multiple of 16 bytes), zeros outside rows <
// r_end and columns < c_end, except a 1 in column ones_col (-1: none) of
// every valid row. Stored row of row r0 + r: rowidx[r] where given, else as
// s says. Threads tid of nthreads share the work; what goes by cp.async is
// complete after cp_async_wait.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, int dld, int rows, int cols, const Src& s,
                                           long long r0, long long c0, long long r_end,
                                           long long c_end, long long ones_col,
                                           const Geom& geo, int tid, int nthreads,
                                           const int* rowidx = nullptr) {
  constexpr int CE = 16 / sizeof(T);
  const int cpr = cols / CE;
  const T* src = static_cast<const T*>(s.p);
  for (int i = tid; i < rows * cpr; i += nthreads) {
    const int r = i / cpr, c = (i - r * cpr) * CE;
    T* d = dst + r * dld + c;
    const long long gr = r0 + r, gc = c0 + c;
    if (gr < r_end) {
      const long long row = rowidx ? rowidx[r] : s.map ? geo.grid_row(gr) : gr;
      const T* p = src + row * s.ld + gc;
      if (s.vec && gc + CE <= c_end) {
        cp_async16(d, p);
        continue;
      }
#pragma unroll
      for (int e = 0; e < CE; ++e) {
        const long long col = gc + e;
        d[e] = col < c_end ? p[e] : from_f<T>(col == ones_col ? 1.0f : 0.0f);
      }
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// ------------------------------------------------------------ token products

// The mean and 1 / std of a row of K elements (null: 0 and 0), summed by two
// neighbouring lanes (half 0 and 1), each over half of the row: 16-byte
// loads where the row allows (vec), all in flight at once.
template <typename T>
__device__ __forceinline__ void row_stats(const T* row, int K, int half, int vec, float eps,
                                          float& mean, float& inv) {
  constexpr int CE = 16 / (int)sizeof(T);
  const bool v16 = vec && K % (2 * CE) == 0;
  const int hk = K / 2;
  auto row_sum = [&](float mu, bool sq) {
    float acc_ = 0.0f;
    if (!row) return 0.0f;
    if (v16) {
      const uint4* p = reinterpret_cast<const uint4*>(row + half * hk);
#pragma unroll 8
      for (int i = 0; i < hk / CE; ++i) {
        const uint4 u = p[i];
        const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int j = 0; j < CE; ++j) {
          const float v = to_f(e[j]) - mu;
          acc_ += sq ? v * v : v;
        }
      }
    } else {
#pragma unroll 8
      for (int k = half; k < K; k += 2) {
        const float v = to_f(row[k]) - mu;
        acc_ += sq ? v * v : v;
      }
    }
    return acc_;
  };
  float s1 = row_sum(0.0f, false);
  s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
  mean = s1 / K;
  float s2 = row_sum(mean, true);
  s2 += __shfl_xor_sync(0xffffffffu, s2, 1);
  inv = row ? rsqrtf(s2 / K + eps) : 0.0f;
}


template <typename T>
struct Tile {
  static constexpr int kBM = 64, kBN = 64;
  static constexpr int kBK = 64 / (int)sizeof(T);   // 64 bytes of depth a stage
  static constexpr int kCE = 16 / (int)sizeof(T);   // elements a 16-byte chunk
  static constexpr int kLdK = kBK + kCE;            // rows along the depth
  static constexpr int kLdM = 64 + 8;               // rows along M or N
  static constexpr int kStage =
      kBM * kLdK > kBK * kLdM ? kBM * kLdK : kBK * kLdM;    // elements an operand
  static constexpr int kStages = 3;
  static constexpr int kSmemBytes = 2 * kStages * kStage * (int)sizeof(T);   // the ring
};

// acc (a 32 x 32 warp tile of the 64 x 64 block tile at (m0, n0)) = A @ B
// over depth [k_begin, k_end). A is [M, K] (AT: stored as [K, M], the
// tokens along K), B is [K, N] (BT: stored as [N, K]). Stored rows and
// columns beyond m_end / n_end / k_end read as 0; column ones_col of a
// stored [K, M] A as 1. arows: the stored rows of A's 64 rows (not AT), or
// null. With XA, xs(chunk, row in tile, k) transforms a 16-byte chunk of A
// in shared memory once it has landed, before any warp reads it; each
// thread transforms the chunks it copied itself. pre() runs (and ends with
// a barrier) once the first stages are in flight. bf16 sums in the tensor
// cores' accumulator; f32 runs as 3xTF32, each stage (two m16n8k8 steps)
// summed from zero and added to acc to nearest; with RB (f32 only) both
// operands are rounded to bf16 as the fragments are read and each stage's
// m16n8k16 product is summed from zero and added to acc to nearest (the
// tensor cores round their sums toward zero, and these sums run over every
// token or over 3C).
template <typename T, bool AT, bool BT, bool XA, bool RB, typename F, typename P>
__device__ __forceinline__ void mainloop(float (&acc)[2][4][4], T* smem, const Src& a,
                                         const Src& b, const Geom& geo, const int* arows,
                                         long long m0, long long m_end, long long ones_col,
                                         long long n0, long long n_end, long long k_begin,
                                         long long k_end, F&& xs, P&& pre) {
  using TL = Tile<T>;
  constexpr bool kF32 = sizeof(T) == 4;
  static_assert(kF32 || !RB, "bf16 operands need no rounding");
  constexpr int CE = TL::kCE;
  constexpr int kARows = AT ? TL::kBK : TL::kBM, kACols = AT ? TL::kBM : TL::kBK;
  constexpr int kBRows = BT ? TL::kBN : TL::kBK, kBCols = BT ? TL::kBK : TL::kBN;
  constexpr int kLdA = AT ? TL::kLdM : TL::kLdK, kLdB = BT ? TL::kLdK : TL::kLdM;
  T* sa = smem;
  T* sb = smem + TL::kStages * TL::kStage;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
  const int ktiles = (int)((k_end - k_begin + TL::kBK - 1) / TL::kBK);
  auto issue = [&](int kt) {
    const int slot = kt % TL::kStages;
    const long long k0 = k_begin + (long long)kt * TL::kBK;
    T* da = sa + slot * TL::kStage;
    T* db = sb + slot * TL::kStage;
    if (AT)
      stage_tile<T>(da, kLdA, kARows, kACols, a, k0, m0, k_end, m_end, ones_col, geo, tid,
                    kThreads);
    else
      stage_tile<T>(da, kLdA, kARows, kACols, a, m0, k0, m_end, k_end, -1, geo, tid, kThreads,
                    arows);
    if (BT)
      stage_tile<T>(db, kLdB, kBRows, kBCols, b, n0, k0, n_end, k_end, -1, geo, tid,
                    kThreads);
    else
      stage_tile<T>(db, kLdB, kBRows, kBCols, b, k0, n0, k_end, n_end, -1, geo, tid,
                    kThreads);
  };
  for (int s = 0; s < TL::kStages - 1; ++s) {
    if (s < ktiles) issue(s);
    cp_async_commit();
  }
  pre();   // work that needs no stage (the LayerNorm statistics), under the loads
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<TL::kStages - 2>();
    const int slot = kt % TL::kStages;
    T* ta = sa + slot * TL::kStage;
    T* tb = sb + slot * TL::kStage;
    const long long k0 = k_begin + (long long)kt * TL::kBK;
    if constexpr (XA) {
      for (int i = tid; i < kARows * (kACols / CE); i += kThreads) {
        const int r = i / (kACols / CE), c = (i - r * (kACols / CE)) * CE;
        xs(ta + r * kLdA + c, r, k0 + c);
      }
    }
    __syncthreads();
    if (kt + TL::kStages - 1 < ktiles) issue(kt + TL::kStages - 1);
    cp_async_commit();
    const View<T, !AT> va = {ta, kLdA};
    const View<T, BT> vb = {tb, kLdB};
    if constexpr (RB) {
      // f32 stored, bf16 products: one m16n8k16 step a stage (kBK = 16)
      static_assert(TL::kBK == Tc<bf16>::kK, "one bf16 step a stage");
      Tc<bf16>::A fa[2];
      Tc<bf16>::B fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i) Bf16Of::load_a(fa[i], va, wm * 32 + i * 16, 0, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) Bf16Of::load_b(fb[j], vb, 0, wn * 32 + j * 8, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          Tc<bf16>::mma(t, fa[i], fb[j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += t[e];
        }
    } else if constexpr (!kF32) {
      // bf16: fragments by ldmatrix. Lane i addresses row i % 8 of matrix
      // i / 8; A's four matrices are (rows 0-7, 8-15) x (k 0-7, 8-15), k
      // slowest; B's (k 0-7, 8-15) x (columns 0-7, 8-15), k fastest: two n8
      // tiles' b0, b1 an instruction.
      const int li = lane & 7, mi = lane >> 3;
#pragma unroll
      for (int kk = 0; kk < TL::kBK; kk += 16) {
        typename Tc<T>::A fa[2];
        uint32_t fb[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int m = wm * 32 + i * 16 + (mi & 1) * 8, k = kk + (mi >> 1) * 8;
          if (AT)   // stored [k][m]: lane li addresses k row li
            ldsm_x4<true>(fa[i].r, ta + (k + li) * kLdA + m);
          else
            ldsm_x4<false>(fa[i].r, ta + (m + li) * kLdA + k);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = wn * 32 + j * 16 + (mi >> 1) * 8, k = kk + (mi & 1) * 8;
          if (BT)
            ldsm_x4<false>(fb[j], tb + (n + li) * kLdB + k);
          else
            ldsm_x4<true>(fb[j], tb + (k + li) * kLdB + n);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const typename Tc<T>::B b = {{fb[j >> 1][(j & 1) * 2], fb[j >> 1][(j & 1) * 2 + 1]}};
            Tc<T>::mma(acc[i][j], fa[i], b);
          }
      }
    } else {
      // f32: the stage's two m16n8k8 steps summed from zero, then added to
      // acc to nearest
      float tacc[2][4][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) tacc[i][j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < TL::kBK; kk += Tc<T>::kK) {
        typename Tc<T>::A fa[2];
        typename Tc<T>::B fb[4];
#pragma unroll
        for (int i = 0; i < 2; ++i) Tc<T>::load_a(fa[i], va, wm * 32 + i * 16, kk, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j) Tc<T>::load_b(fb[j], vb, kk, wn * 32 + j * 8, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) Tc<T>::mma(tacc[i][j], fa[i], fb[j]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += tacc[i][j][e];
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// A result: element (i, j) stored at p[row(i) * ld + j] (row as in Src; the
// wgmma products also take map == kToWindow: row(i) = window_row(i)), in
// bf16 where bf, else f32.
constexpr int kToWindow = 2;
struct Out {
  void* p;
  long long ld;
  int bf, map;
};

enum Epi { kStore = 0, kGelu = 1, kDGelu = 2, kResid = 3 };
enum Xf { kNone = 0, kLayerNorm = 1, kRowScale = 2 };

struct GemmArgs {
  int M, N, K;
  Src a, b;
  int xf;                     // transform of A (XF kernels)
  const float* ln_s;          // kLayerNorm: scale and shift [K]
  const float* ln_b;
  float eps;
  float* stats;               // kLayerNorm: (mean, 1/std) of each row, or null
  void* side;                 // the transformed A [M, K] in T, or null
  const float* dp;            // drop-path multipliers [B, 2]: kRowScale, kResid
  int dp_col;
  int epi;
  Out c;
  const void* bias;           // [N] or null
  int bias_bf;
  Src res;                    // kResid: the residual [M, N], in T
  float* aux;                 // kGelu: the pre-activation out; kDGelu: in; f32 [M, N]
  float* colsum;              // kDGelu: column sums of the result, [tiles_m, N], or null
  Geom g;
};

template <typename T, bool BT, bool XF, bool RB>
__global__ void __launch_bounds__(kThreads) gemm_kernel(GemmArgs g) {
  using TL = Tile<T>;
  constexpr int CE = TL::kCE;
  static_assert(kThreads == 2 * TL::kBM, "the LayerNorm prologue takes two threads a row");
  __shared__ __align__(16) unsigned char smem[TL::kSmemBytes];
  __shared__ int grid_rows[TL::kBM];   // the grid row of each window-order row
  __shared__ float row_dp[TL::kBM], row_a[TL::kBM], row_b[TL::kBM];
  // LayerNorm: its scale and shift, zero beyond K
  __shared__ __align__(16) float col_s[XF ? kMaxC + 64 : 4], col_b[XF ? kMaxC + 64 : 4];
  const int tiles_n = (g.N + TL::kBN - 1) / TL::kBN;
  const int bn = blockIdx.x % tiles_n, bm = blockIdx.x / tiles_n;
  const long long m0 = (long long)bm * TL::kBM, n0 = (long long)bn * TL::kBN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int hw = g.g.H * g.g.W;
  for (int r = tid; r < TL::kBM; r += kThreads) {
    const long long m = m0 + r;
    grid_rows[r] = m < g.M ? g.g.grid_row(m) : 0;
    row_dp[r] = (g.dp && m < g.M) ? g.dp[((int)m / hw) * 2 + g.dp_col] : 1.0f;
  }
  __syncthreads();
  // the rows' LayerNorm statistics or drop-path scales
  auto pre = [&] {
    if constexpr (XF) {
      if (g.xf == kLayerNorm) {
        for (int i = tid; i < g.K + TL::kBK; i += kThreads) {
          col_s[i] = i < g.K ? g.ln_s[i] : 0.0f;
          col_b[i] = i < g.K ? g.ln_b[i] : 0.0f;
        }
        const int r = tid >> 1, half = tid & 1;
        const long long m = m0 + r;
        const T* row = m < g.M ? static_cast<const T*>(g.a.p) +
                                     (g.a.map ? (long long)grid_rows[r] : m) * g.a.ld
                               : nullptr;
        float mean, inv;
        row_stats<T>(row, g.K, half, g.a.vec, g.eps, mean, inv);
        if (half == 0) {
          row_a[r] = row ? mean : 0.0f;
          row_b[r] = inv;
          if (g.stats && bn == 0 && row) {
            g.stats[2 * m] = mean;
            g.stats[2 * m + 1] = inv;
          }
        }
      } else {
        for (int r = tid; r < TL::kBM; r += kThreads) {
          row_a[r] = 0.0f;
          row_b[r] = m0 + r < g.M ? row_dp[r] : 0.0f;
        }
      }
      __syncthreads();
    }
  };
  T* const side = (XF && g.side && bn == 0) ? static_cast<T*>(g.side) : nullptr;
  const bool side_vec = g.K % CE == 0 && (uintptr_t)g.side % 16 == 0;
  // LayerNorm (v - mean) / std * s + b or the row scale, rounded to T, of
  // a chunk of A in place; the chunk to the side output too
  auto xs = [&](T* d, int r, long long k) {
    if constexpr (XF) {
      const bool ln = g.xf == kLayerNorm;
      const float ra = row_a[r], rb = row_b[r];
#pragma unroll
      for (int e = 0; e < CE; ++e) {
        float v = (to_f(d[e]) - ra) * rb;
        if (ln) v = v * col_s[k + e] + col_b[k + e];
        d[e] = from_f<T>(v);
      }
      const long long m = m0 + r;
      if (side && m < g.M && k < g.K) {
        T* o = side + m * g.K + k;
        if (side_vec && k + CE <= g.K) {
          *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(d);
        } else {
          for (int e = 0; e < CE && k + e < g.K; ++e) o[e] = d[e];
        }
      }
    }
  };
  float acc[2][4][4];
  mainloop<T, false, BT, XF, RB>(acc, reinterpret_cast<T*>(smem), g.a, g.b, g.g,
                                 g.a.map ? grid_rows : nullptr, m0, g.M, -1, n0, g.N, 0, g.K,
                                 xs, pre);

  const int gq = lane >> 2, tq = lane & 3;
  const bool pairs = g.c.ld % 2 == 0 && (uintptr_t)g.c.p % 8 == 0;
  float cs[4][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}, {0.0f, 0.0f}};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int rl = wm * 32 + i * 16 + gq + e2 * 8;
      const long long m = m0 + rl;
      if (m >= g.M) continue;
      const long long orow = (g.c.map ? (long long)grid_rows[rl] : m) * g.c.ld;
      const long long rrow = (g.res.map ? (long long)grid_rows[rl] : m) * g.res.ld;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long n = n0 + wn * 32 + j * 8 + 2 * tq;
        if (n >= g.N) continue;
        const int cnt = n + 1 < g.N ? 2 : 1;
        float v[2];
#pragma unroll
        for (int e1 = 0; e1 < 2; ++e1) {
          if (e1 >= cnt) break;
          float x = acc[i][j][e2 * 2 + e1];
          if (g.bias) x += load(g.bias, n + e1, g.bias_bf);
          if (g.epi == kGelu) {
            if (g.aux) g.aux[m * g.N + n + e1] = x;
            x = gelu_tanh(x);
          } else if (g.epi == kDGelu) {
            x *= gelu_tanh_grad(g.aux[m * g.N + n + e1]);
            cs[j][e1] += x;
          } else if (g.epi == kResid) {
            x = load(g.res.p, rrow + n + e1, sizeof(T) == 2) + row_dp[rl] * x;
          }
          v[e1] = x;
        }
        if (cnt == 2 && pairs) {
          if (g.c.bf)
            *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(g.c.p) + orow + n) =
                __floats2bfloat162_rn(v[0], v[1]);
          else
            *reinterpret_cast<float2*>(static_cast<float*>(g.c.p) + orow + n) =
                make_float2(v[0], v[1]);
        } else {
          for (int e1 = 0; e1 < cnt; ++e1) store(g.c.p, orow + n + e1, v[e1], g.c.bf);
        }
      }
    }
  if (g.colsum) {   // per block: the column sums over its 64 rows, warps in order
    float* red = reinterpret_cast<float*>(smem);   // [2][kBN]
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = column_sum(cs[j][h]);
        if (lane < 4) red[wm * TL::kBN + wn * 32 + j * 8 + 2 * lane + h] = v;
      }
    __syncthreads();
    for (int c = tid; c < TL::kBN; c += kThreads) {
      const long long n = n0 + c;
      if (n < g.N) g.colsum[(long long)bm * g.N + n] = red[c] + red[TL::kBN + c];
    }
  }
}

// The weight gradients: out_p = sum over the tokens of a_p^T b_p, per split
// of the tokens, for up to four problems at once.
struct AtbProblem {
  Src a, b;          // a [R, Ka], b [R, N], tokens along the rows
  int Ka, N, ones;   // ones: row Ka of the result sums b's columns
  float* partial;    // [splits, Ka + ones, N]
  int tiles_n, blocks;
};

constexpr int kMaxProblems = 4;

struct AtbArgs {
  AtbProblem p[kMaxProblems];
  int count, splits;
  long long R, chunk;
  Geom g;
};

template <typename T, bool RB>
__global__ void __launch_bounds__(kThreads) atb_kernel(AtbArgs g) {
  using TL = Tile<T>;
  __shared__ __align__(16) unsigned char smem[TL::kSmemBytes];
  int blk = blockIdx.x, pi = 0;
  while (pi < g.count - 1 && blk >= g.p[pi].blocks) {
    blk -= g.p[pi].blocks;
    ++pi;
  }
  const AtbProblem p = g.p[pi];
  const int tiles = p.blocks / g.splits;
  const int s = blk / tiles, t = blk - s * tiles;
  const int bn = t % p.tiles_n, bm = t / p.tiles_n;
  const long long m0 = (long long)bm * TL::kBM, n0 = (long long)bn * TL::kBN;
  const long long k_begin = (long long)s * g.chunk;
  const long long k_end = k_begin + g.chunk < g.R ? k_begin + g.chunk : g.R;
  const int Ma = p.Ka + p.ones;
  float acc[2][4][4];
  mainloop<T, true, false, false, RB>(acc, reinterpret_cast<T*>(smem), p.a, p.b, g.g, nullptr,
                                      m0, p.Ka, p.ones ? p.Ka : -1, n0, p.N, k_begin, k_end,
                                      [](T*, int, long long) {}, [] {});
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1, gq = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long m = m0 + wm * 32 + i * 16 + gq + (e >> 1) * 8;
        const long long n = n0 + wn * 32 + j * 8 + 2 * tq + (e & 1);
        if (m < Ma && n < p.N) p.partial[((long long)s * Ma + m) * p.N + n] = acc[i][j][e];
      }
}

// ------------------------------------------------------------ Hopper products

// The plain products C = A @ B + bias of K3 and of K4's recomputed qkv (A
// [M, K], B [K, N], C [M, N] row-major, any M, N, K and row stride; qkv
// stored at its window-order rows, the projection at the grid rows), on
// wgmma. Bound by bytes at the route's widths in bf16 (K = C, N = C or 3C:
// 16 to 3C operations a byte) and near the balance point in f32 (three TF32
// passes), so the design moves each byte once and keeps the loads in
// flight: a block of two consumer warpgroups (256 threads) owns a 128-row
// tile of C, 64 rows each warpgroup; all its threads stage 64-byte-deep
// slices of A and B by cp.async (16-byte copies where the rows allow,
// element copies with zero fill past M, N and K else) into a ring of
// kProdStages stages, the next stages in flight under this one's products.
// The stage layout is wgmma's 8 x 8 core matrices without swizzle, each
// column of core matrices padded by 16 bytes so that the eight 16-byte
// copies of a quarter-warp land on distinct banks. The epilogue adds the
// bias, rounds to T, writes the tile to shared memory and stores whole rows
// in 16-byte pieces at the rows c.map says. No atomics: two runs are
// bit-identical.
//
// gemm_sm90_kernel (bf16): m64nBNk16 (BN 64 or 128) with A K-major (a row's
// eight depths in 16 bytes) and B MN-major (eight columns of one depth in
// 16 bytes: B is read as stored, not transposed), 64-deep stages.
// gemm_tf32x3_kernel (f32): m64n64k8 with both operands K-major, as TF32
// requires; 32-deep stages of A (K-major) and B (as stored) are split once
// they land, in shared memory, into TF32 halves hi = tf32(a), lo = tf32(a -
// hi) (A's hi in place, B's halves transposed to [n][k]), and each
// warpgroup sums lo_a hi_b + hi_a lo_b + hi_a hi_b over the stage's four k
// steps from zero and adds the stage to its f32 total to nearest (the
// tensor cores round their sums toward zero): gemm_kernel's 3xTF32 with a
// 32-deep stage, the split done once a stage for the block rather than per
// warp and fragment.
constexpr int kProdThreads = 256, kProdBM = 128, kProdStages = 3;

// The 16 bytes at d: elements [0, 16 / sizeof(T)) of p where i + e < end,
// zero beyond
template <typename T>
__device__ __forceinline__ void copy16_zero(uint8_t* d, const T* p, long long i,
                                            long long end, int vec) {
  constexpr int CE = 16 / (int)sizeof(T);
  if (vec && i + CE <= end) {
    cp_async16(d, p);
    return;
  }
  alignas(16) T e[CE];
#pragma unroll
  for (int j = 0; j < CE; ++j) e[j] = i + j < end ? p[j] : from_f<T>(0.0f);
  *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(e);
}

// 128 rows x 8 pieces of 16 bytes of A (rows m0.., elements k0..) into the
// K-major core-matrix layout at st: piece (r, kc) at kc * ld + r * 16
template <typename T>
__device__ __forceinline__ void stage_a(uint8_t* st, int ld, const GemmArgs& g, long long m0,
                                        long long k0) {
  constexpr int CE = 16 / (int)sizeof(T);
  const T* A = static_cast<const T*>(g.a.p);
  for (int i = threadIdx.x; i < kProdBM * 8; i += kProdThreads) {
    const int r = i >> 3, kc = i & 7;   // a row's eight pieces by neighbouring threads
    const long long m = m0 + r, k = k0 + kc * CE;
    uint8_t* d = st + kc * ld + r * 16;
    if (m < g.M)
      copy16_zero<T>(d, A + m * g.a.ld + k, k, g.K, g.a.vec);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The end of a product tile: acc (each warpgroup's 64 x BN accumulator of
// wgmma) + bias, rounded to T, written to shared memory and stored as whole
// rows in 16-byte pieces at the rows c.map says (the tile's own, the grid
// rows or the window-order rows). The caller has synchronised; smem may
// take the tile.
template <typename T, int BN>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2], const GemmArgs& g,
                                           long long m0, long long n0, uint8_t* smem,
                                           long long* orow) {
  constexpr int CE = 16 / (int)sizeof(T), LDC = BN + CE;   // a row of the tile, padded
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  if (tid < kProdBM) {
    const long long m = m0 + tid;
    orow[tid] = m >= g.M               ? 0
                : g.c.map == kToWindow ? (long long)g.g.window_row(m)
                : g.c.map              ? (long long)g.g.grid_row(m)
                                       : m;
  }
  T* ct = reinterpret_cast<T*>(smem);
  const int r0 = wg * 64 + warp * 16 + (lane >> 2), t4 = lane & 3;
  const int bias_bf = sizeof(T) == 2;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = j * 8 + 2 * t4;
    const long long n = n0 + c;
    const float b0 = g.bias && n < g.N ? load(g.bias, n, bias_bf) : 0.0f;
    const float b1 = g.bias && n + 1 < g.N ? load(g.bias, n + 1, bias_bf) : 0.0f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      T* d = ct + (r0 + 8 * h) * LDC + c;
      d[0] = from_f<T>(acc[4 * j + 2 * h] + b0);
      d[1] = from_f<T>(acc[4 * j + 2 * h + 1] + b1);
    }
  }
  __syncthreads();
  const bool vec = g.c.ld % CE == 0 && (uintptr_t)g.c.p % 16 == 0;
  for (int i = tid; i < kProdBM * (BN / CE); i += kProdThreads) {
    const int r = i / (BN / CE), c = (i - r * (BN / CE)) * CE;
    const long long m = m0 + r, n = n0 + c;
    if (m >= g.M || n >= g.N) continue;
    T* o = static_cast<T*>(g.c.p) + orow[r] * g.c.ld + n;
    const T* v = ct + r * LDC + c;
    if (vec && n + CE <= g.N) {
      *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(v);
    } else {
      for (int e = 0; e < CE && n + e < g.N; ++e) o[e] = v[e];
    }
  }
}

template <int BN>
struct WgTile {   // gemm_sm90_kernel's shared memory
  static constexpr int kBK = 64;                    // bf16 depths a stage
  static constexpr int kLdA = kProdBM * 16 + 16;    // bytes between A's columns of core matrices
  static constexpr int kLdB = kBK * 16 + 16;        // bytes between B's columns of core matrices
  static constexpr int kA = 8 * kLdA;               // A's bytes a stage
  static constexpr int kStage = kA + (BN / 8) * kLdB;
  static constexpr int kSmem = kProdStages * kStage;   // also holds the C tile
  static_assert(kSmem >= kProdBM * (BN + 8) * 2, "the C tile fits in the ring");
};

template <int BN>
__global__ void __launch_bounds__(kProdThreads, BN == 128 ? 2 : 3) gemm_sm90_kernel(GemmArgs g) {
  using TL = WgTile<BN>;
  constexpr int S = kProdStages;
  extern __shared__ __align__(128) uint8_t wg_smem[];
  __shared__ long long orow[kProdBM];   // the row each row of the tile is stored at
  const int tiles_n = (g.N + BN - 1) / BN;
  const long long m0 = (long long)(blockIdx.x / tiles_n) * kProdBM;
  const long long n0 = (long long)(blockIdx.x % tiles_n) * BN;
  const int tid = threadIdx.x, wg = tid >> 7;
  const bf16* B = static_cast<const bf16*>(g.b.p);
  const int ktiles = (g.K + TL::kBK - 1) / TL::kBK;
  auto issue = [&](int kt) {
    uint8_t* st = wg_smem + (kt % S) * TL::kStage;
    const long long k0 = (long long)kt * TL::kBK;
    stage_a<bf16>(st, TL::kLdA, g, m0, k0);
    for (int i = tid; i < TL::kBK * (BN / 8); i += kProdThreads) {
      const int kr = i / (BN / 8), nc = i - kr * (BN / 8);
      const long long k = k0 + kr, n = n0 + nc * 8;
      uint8_t* d = st + TL::kA + nc * TL::kLdB + kr * 16;
      if (k < g.K)
        copy16_zero<bf16>(d, B + k * g.b.ld + n, n, g.N, g.b.vec);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  };
  for (int s = 0; s < S - 1; ++s) {
    if (s < ktiles) issue(s);
    cp_async_commit();
  }
  float acc[BN / 2];
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<S - 2>();
    sm90::fence_proxy_async();   // this thread's copies, visible to wgmma
    __syncthreads();             // every thread's; the slot read last step is free
    if (kt + S - 1 < ktiles) issue(kt + S - 1);
    cp_async_commit();
    const uint32_t sa = sm90::smem_u32(wg_smem + (kt % S) * TL::kStage) + wg * 64 * 16;
    const uint32_t sb = sm90::smem_u32(wg_smem + (kt % S) * TL::kStage + TL::kA);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TL::kBK / 16; ++kk) {
      if (kk > 0 && (long long)kt * TL::kBK + kk * 16 >= g.K) break;   // zeros past K
      const uint64_t da = sm90::make_desc(sa + kk * 2 * TL::kLdA, TL::kLdA, 128);
      const uint64_t db = sm90::make_desc(sb + kk * 256, 128, TL::kLdB);
      if constexpr (BN == 128)
        sm90::wgmma_ss_n128<0, 1>(acc, da, db, (kt | kk) != 0);
      else
        sm90::wgmma_ss_n64<0, 1>(acc, da, db, (kt | kk) != 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait0();
  }
  cp_async_wait<0>();
  __syncthreads();   // both warpgroups' products done: the ring takes the C tile
  store_tile<bf16, BN>(acc, g, m0, n0, wg_smem, orow);
}

struct Tf32Tile {   // gemm_tf32x3_kernel's shared memory
  static constexpr int kBN = 64, kBK = 32;        // f32 depths a stage
  static constexpr int kLdA = kProdBM * 16 + 16;  // bytes between A's columns of core matrices
  static constexpr int kLdB = kBN * 16 + 16;      // the same for B's halves ([n][k])
  static constexpr int kLdR = kBN + 4;            // floats a row of a staged B ([k][n])
  static constexpr int kA = 8 * kLdA;             // A's bytes a stage
  static constexpr int kStage = kA + kBK * kLdR * 4;
  static constexpr int kHalfB = 8 * kLdB;
  static constexpr int kSmem = kProdStages * kStage + kA + 2 * kHalfB;   // + A's lo, B's halves
  static_assert(kProdStages * kStage >= kProdBM * (kBN + 4) * 4, "the C tile fits in the ring");
};

__global__ void __launch_bounds__(kProdThreads, 2) gemm_tf32x3_kernel(GemmArgs g) {
  using TL = Tf32Tile;
  constexpr int BN = TL::kBN, BK = TL::kBK, S = kProdStages;
  extern __shared__ __align__(128) uint8_t wg_smem[];
  __shared__ long long orow[kProdBM];
  uint8_t* alo = wg_smem + S * TL::kStage;
  uint8_t* bhi = alo + TL::kA;
  uint8_t* blo = bhi + TL::kHalfB;
  const int tiles_n = (g.N + BN - 1) / BN;
  const long long m0 = (long long)(blockIdx.x / tiles_n) * kProdBM;
  const long long n0 = (long long)(blockIdx.x % tiles_n) * BN;
  const int tid = threadIdx.x, wg = tid >> 7;
  const float* B = static_cast<const float*>(g.b.p);
  const int ktiles = (g.K + BK - 1) / BK;
  auto issue = [&](int kt) {
    uint8_t* st = wg_smem + (kt % S) * TL::kStage;
    const long long k0 = (long long)kt * BK;
    stage_a<float>(st, TL::kLdA, g, m0, k0);
    for (int i = tid; i < BK * (BN / 4); i += kProdThreads) {
      const int kr = i / (BN / 4), nc = i - kr * (BN / 4);
      const long long k = k0 + kr, n = n0 + nc * 4;
      uint8_t* d = st + TL::kA + (kr * TL::kLdR + nc * 4) * 4;
      if (k < g.K)
        copy16_zero<float>(d, B + k * g.b.ld + n, n, g.N, g.b.vec);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  };
  for (int s = 0; s < S - 1; ++s) {
    if (s < ktiles) issue(s);
    cp_async_commit();
  }
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();   // the stage has landed; last step's products are done
    if (kt + S - 1 < ktiles) issue(kt + S - 1);
    cp_async_commit();
    uint8_t* st = wg_smem + (kt % S) * TL::kStage;
    // the stage's TF32 halves: A's hi in place and its lo beside, B's both
    // transposed to [n][k]
    for (int i = tid; i < kProdBM * 8; i += kProdThreads) {
      const int off = (i & 7) * TL::kLdA + (i >> 3) * 16;
      const float4 v = *reinterpret_cast<const float4*>(st + off);
      uint4 hi, lo;
      Tc<float>::split(v.x, hi.x, lo.x);
      Tc<float>::split(v.y, hi.y, lo.y);
      Tc<float>::split(v.z, hi.z, lo.z);
      Tc<float>::split(v.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(st + off) = hi;
      *reinterpret_cast<uint4*>(alo + off) = lo;
    }
    const float* braw = reinterpret_cast<const float*>(st + TL::kA);
    for (int i = tid; i < BN * (BK / 4); i += kProdThreads) {
      const int n = i % BN, kc = i / BN;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) Tc<float>::split(braw[(kc * 4 + e) * TL::kLdR + n], hi[e], lo[e]);
      const int off = kc * TL::kLdB + n * 16;
      *reinterpret_cast<uint4*>(bhi + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(blo + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    sm90::fence_proxy_async();   // the halves, visible to wgmma
    __syncthreads();
    const uint32_t sa = sm90::smem_u32(st) + wg * 64 * 16, sl = sm90::smem_u32(alo) + wg * 64 * 16;
    const uint32_t sh = sm90::smem_u32(bhi), sq = sm90::smem_u32(blo);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      if (kk > 0 && (long long)kt * BK + kk * 8 >= g.K) break;   // zeros past K
      const uint64_t a_hi = sm90::make_desc(sa + kk * 2 * TL::kLdA, TL::kLdA, 128);
      const uint64_t a_lo = sm90::make_desc(sl + kk * 2 * TL::kLdA, TL::kLdA, 128);
      const uint64_t b_hi = sm90::make_desc(sh + kk * 2 * TL::kLdB, TL::kLdB, 128);
      const uint64_t b_lo = sm90::make_desc(sq + kk * 2 * TL::kLdB, TL::kLdB, 128);
      sm90::wgmma_tf32_n64(part, a_lo, b_hi, kk != 0);
      sm90::wgmma_tf32_n64(part, a_hi, b_lo, 1);
      sm90::wgmma_tf32_n64(part, a_hi, b_hi, 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait0();
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
  }
  cp_async_wait<0>();
  __syncthreads();   // both warpgroups' products done: the ring takes the C tile
  store_tile<float, BN>(acc, g, m0, n0, wg_smem, orow);
}

// The four products of a block's forward in f32 (block_forward: LN1(x) @
// wqkv + bqkv, x + dp1 (merged @ wproj + bproj), gelu(LN2(r1) @ w1 + b1),
// r1 + dp2 (g1 @ w2 + b2)), on wgmma as three TF32 passes. Bound by
// operations at K = C >= 192 (3xTF32's 165 TFLOP/s) and by bytes at C 96,
// where fc1 writes g1 and z1 (1.9 KB a row) for 74 KFLOP a row. So the
// design keeps the tensor cores and the loads busy at once: a block owns a
// 128 x 128 tile of C (columns past N read as zero: a wider tile
// normalises A's rows fewer times), two consumer warpgroups of 64 rows
// each and a producer warp, of a warpgroup that gives its registers to the
// consumers (setmaxnreg).
// - Loads: a ring of kFwdStages stages, 16 depths of A's 128 rows and of
//   B's 128 columns, by one tensor-map copy (TMA) each, zero past the edges,
//   counted on the stage's mbarrier (element cp.async where a row stride is
//   no multiple of 16 bytes). qkv runs over x's rows in grid order, each
//   row stored at its window-order row (the attention's layout), so no
//   operand needs a row map.
// - A: its TF32 halves never go through shared memory. Each consumer
//   thread reads its wgmma fragment of a landed stage (two 16-byte reads:
//   the stage's depths are permuted so that a thread's four depths of its
//   two 8-deep steps are adjacent; B takes the same order), applies the
//   LayerNorm in f32 with the row's mean and 1 / std (computed by the
//   consumers while the first stages land) and the column's scale and
//   shift, writes it to the side output (h1, h2) in the tiles of the first
//   column, and splits it into hi = tf32(a), lo = tf32(a - hi) in
//   registers, for wgmma with A from registers.
// - B: each stage split once by the consumers into its halves, transposed
//   to wgmma's K-major layout, in one of two buffers.
// - Products: those of stage k (lo_a hi_b + hi_a lo_b + hi_a hi_b over its
//   two 8-deep steps, summed from zero and added to the f32 total to
//   nearest, as gemm_kernel's 3xTF32) run while the consumers take stage
//   k + 1.
// - Epilogue: acc + bias into shared memory, then whole rows stored in
//   16-byte pieces: gelu keeping the pre-activation (z1), or the residual
//   res + dp[sample] * v (each loaded before any is used), at the rows
//   c.map says.
// No atomics: two runs are bit-identical.
constexpr int kFwdConsumers = 256;                  // two warpgroups
constexpr int kFwdThreads = kFwdConsumers + 128;    // and the producer's
// Registers per thread once the warpgroups rebalance (setmaxnreg): the
// consumers hold acc, the stage's sums and two stages of A's fragments
constexpr int kFwdConsumerRegs = 232, kFwdProducerRegs = 40;
static_assert(kFwdConsumers * kFwdConsumerRegs + 128 * kFwdProducerRegs <= 65536,
              "the registers of an SM");
constexpr int kFwdBM = 128, kFwdBN = 128, kFwdBK = 16, kFwdStages = 6;
constexpr int kFwdBar = 1;                          // the consumers' named barrier
constexpr int kStatPieces = 24;   // 16-byte pieces of a row a thread holds for its statistics

struct FwdTile {   // fwd_product_kernel's dynamic shared memory, then LN's columns
  static constexpr int kRawA = kFwdBM * kFwdBK * 4;         // A's stage as it lands, [128][16]
  static constexpr int kRaw = kRawA + kFwdBK * kFwdBN * 4;  // and B's, [16][128]
  static constexpr int kLdB = kFwdBN * 16;   // bytes between B's columns of core matrices
  static constexpr int kHalfB = kFwdBK / 4 * kLdB;          // one TF32 half of B's stage
  static constexpr int kSmem = kFwdStages * kRaw + 2 * 2 * kHalfB;
  static_assert(kSmem >= kFwdBM * (kFwdBN + 4) * 4, "the C tile fits");
  static_assert(kFwdBN * (kFwdBK / 4) % kFwdConsumers == 0, "a thread, whole pieces of B");
};

// The tensor maps of A [M, K] (boxes of 128 rows x 16 depths) and B [K, N]
// (16 x 128), and whether each is used (else its stages go by cp.async)
struct FwdMaps {
  CUtensorMap a, b;
  int ta, tb;
};

__global__ void __launch_bounds__(kFwdThreads, 1)
    fwd_product_kernel(const GemmArgs g, const __grid_constant__ FwdMaps maps) {
  using TL = FwdTile;
  constexpr int S = kFwdStages, BN = kFwdBN, BK = kFwdBK;
  extern __shared__ __align__(128) uint8_t fwd_smem[];
  __shared__ __align__(8) uint64_t bars[2 * S];   // each stage's full, then empty
  __shared__ int orow[kFwdBM], rrow[kFwdBM];      // the rows C and the residual take
  __shared__ float row_a[kFwdBM], row_b[kFwdBM], row_dp[kFwdBM];
  const int ktiles = (g.K + BK - 1) / BK;
  float* col_s = reinterpret_cast<float*>(fwd_smem + TL::kSmem);   // LN's, zero past K
  float* col_b = col_s + ktiles * BK;
  const int tiles_n = (g.N + BN - 1) / BN, bn = blockIdx.x % tiles_n;
  const long long m0 = (long long)(blockIdx.x / tiles_n) * kFwdBM, n0 = (long long)bn * BN;
  const int tid = threadIdx.x;
  const uint32_t full0 = sm90::smem_u32(bars), empty0 = full0 + 8 * S;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      sm90::mbar_init(full0 + 8 * s, 32);   // each producer lane, once a stage
      sm90::mbar_init(empty0 + 8 * s, 1);   // the consumers, once they have read it
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  // the warp, uniform to the compiler (a branch on threadIdx would put the
  // consumers' wgmma on a divergent path, which ptxas serialises)
  const int warp_id = __shfl_sync(0xffffffffu, tid / 32, 0);
  if (warp_id >= kFwdConsumers / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kFwdProducerRegs));
    if (warp_id > kFwdConsumers / 32) return;
    // the producer warp: lane 0 the tensor-map copies; every lane element
    // copies of an operand without a map, then its arrival once they landed
    const int lane = tid & 31;
    const char* A = static_cast<const char*>(g.a.p);
    const char* B = static_cast<const char*>(g.b.p);
    const int nb = (int)min((long long)BN, g.N - n0);   // B's columns in this tile
    const uint32_t bytes = (maps.ta ? TL::kRawA : 0) + (maps.tb ? TL::kRaw - TL::kRawA : 0);
    for (int kt = 0; kt < ktiles; ++kt) {
      const int s = kt % S;
      if (kt >= S) sm90::mbar_wait(empty0 + 8 * s, (kt / S - 1) & 1);
      uint8_t* ra = fwd_smem + s * TL::kRaw;
      uint8_t* rb = ra + TL::kRawA;
      const uint32_t full = full0 + 8 * s;
      const int k0 = kt * BK, kb = min(BK, g.K - k0);   // depths in this stage
      if (lane == 0 && bytes) {
        sm90::mbar_expect_tx_only(full, bytes);
        if (maps.ta) sm90::tma_load_2d(sm90::smem_u32(ra), &maps.a, k0, (int)m0, full);
        if (maps.tb) sm90::tma_load_2d(sm90::smem_u32(rb), &maps.b, (int)n0, k0, full);
      }
      if (!maps.ta) {
        for (int i = lane; i < kFwdBM * kb; i += 32) {
          const int r = i / kb, c = i - r * kb;
          if (m0 + r < g.M)
            cp_async4(ra + (r * BK + c) * 4, A + ((m0 + r) * g.a.ld + k0 + c) * 4);
        }
      }
      if (!maps.tb) {
        for (int i = lane; i < kb * nb; i += 32) {
          const int kr = i / nb, c = i - kr * nb;
          cp_async4(rb + (kr * BN + c) * 4, B + ((k0 + kr) * g.b.ld + n0 + c) * 4);
        }
      }
      sm90::cp_async_mbar_arrive(full);
    }
    return;
  }
  // the consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kFwdConsumerRegs));
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int hw = g.g.H * g.g.W;
  const bool ln = g.xf == kLayerNorm;
  if (tid < kFwdBM) {
    const long long m = m0 + tid;
    const bool in = m < g.M;
    orow[tid] = !in                    ? 0
                : g.c.map == kToWindow ? g.g.window_row(m)
                : g.c.map              ? g.g.grid_row(m)
                                       : (int)m;
    rrow[tid] = !in ? 0 : g.res.map ? g.g.grid_row(m) : (int)m;
    row_dp[tid] = (g.dp && in) ? g.dp[((int)m / hw) * 2 + g.dp_col] : 1.0f;
  }
  if (ln) {
    for (int i = tid; i < ktiles * BK; i += kFwdConsumers) {
      col_s[i] = i < g.K ? g.ln_s[i] : 0.0f;
      col_b[i] = i < g.K ? g.ln_b[i] : 0.0f;
    }
    // the rows' statistics while the first stages land: tpr threads a row,
    // each holding every tpr-th 16 bytes of it (at most kStatPieces), so
    // that both sums read the row once; rows in rounds of 256 / tpr
    int tpr = 2;
    while (g.K > 4 * kStatPieces * tpr) tpr *= 2;
    if (g.a.vec && g.K % (4 * tpr) == 0) {
      const int per = g.K / (4 * tpr), j = tid % tpr;
      for (int r = tid / tpr; r < kFwdBM; r += kFwdConsumers / tpr) {
        const long long m = m0 + r;
        const float4* row = reinterpret_cast<const float4*>(static_cast<const float*>(g.a.p) +
                                                            m * g.a.ld);
        float4 v[kStatPieces];
#pragma unroll
        for (int i = 0; i < kStatPieces; ++i)
          v[i] = i < per && m < g.M ? row[j + i * tpr] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
        for (int i = 0; i < kStatPieces; ++i) s1 += (v[i].x + v[i].y) + (v[i].z + v[i].w);
        for (int o = 1; o < tpr; o <<= 1) s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        const float mean = s1 / g.K;
#pragma unroll
        for (int i = 0; i < kStatPieces; ++i) {
          if (i >= per) break;
          const float a = v[i].x - mean, b = v[i].y - mean, c = v[i].z - mean, d = v[i].w - mean;
          s2 += (a * a + b * b) + (c * c + d * d);
        }
        for (int o = 1; o < tpr; o <<= 1) s2 += __shfl_xor_sync(0xffffffffu, s2, o);
        if (j == 0) {
          row_a[r] = m < g.M ? mean : 0.0f;
          row_b[r] = m < g.M ? rsqrtf(s2 / g.K + g.eps) : 0.0f;
        }
      }
    } else {   // rows that allow no 16-byte reads: two threads a row, twice
      const int r = tid >> 1, half = tid & 1;
      const long long m = m0 + r;
      const float* row = m < g.M ? static_cast<const float*>(g.a.p) + m * g.a.ld : nullptr;
      float mean, inv;
      row_stats<float>(row, g.K, half, g.a.vec, g.eps, mean, inv);
      if (half == 0) {
        row_a[r] = row ? mean : 0.0f;
        row_b[r] = inv;
      }
    }
  }
  sm90::named_bar_sync(kFwdBar, kFwdConsumers);
  // the side outputs at the rows C takes where it is stored in window order
  const bool to_window = g.c.map == kToWindow;
  if (ln && g.stats && bn == 0 && tid < kFwdBM && m0 + tid < g.M) {
    const long long m = to_window ? orow[tid] : m0 + tid;
    g.stats[2 * m] = row_a[tid];
    g.stats[2 * m + 1] = row_b[tid];
  }
  // this thread's rows of A: R0 and R0 + 8 of the tile
  const int gq = lane >> 2, t4 = lane & 3;
  const int R0 = wg * 64 + warp * 16 + gq;
  const bool in0 = m0 + R0 < g.M, in1 = m0 + R0 + 8 < g.M;
  const float mean0 = ln ? row_a[R0] : 0.0f, inv0 = ln ? row_b[R0] : 1.0f;
  const float mean1 = ln ? row_a[R0 + 8] : 0.0f, inv1 = ln ? row_b[R0 + 8] : 1.0f;
  float* const side = (ln && g.side && bn == 0) ? static_cast<float*>(g.side) : nullptr;
  const long long side0 = in0 ? (to_window ? orow[R0] : m0 + R0) * g.K : -1;
  const long long side1 = in1 ? (to_window ? orow[R0 + 8] : m0 + R0 + 8) * g.K : -1;
  const bool side_vec = g.K % 4 == 0 && (uintptr_t)g.side % 16 == 0;
  // A's fragments of stage kt for the two 8-deep steps: the thread's depths
  // 4 t4 .. 4 t4 + 3 of the stage are step 0's t4 and t4 + 4, then step 1's
  // (stage depth 4 e + 2 step + j / 4 is element j of a step), of rows R0
  // and R0 + 8; LayerNorm, zero past M and K, the side output, TF32 halves
  auto take_a = [&](int kt, uint32_t (&hi)[2][4], uint32_t (&lo)[2][4]) {
    const float* ra = reinterpret_cast<const float*>(fwd_smem + (kt % S) * TL::kRaw);
    const int k = kt * BK + 4 * t4;
    float4 x = *reinterpret_cast<const float4*>(ra + R0 * BK + 4 * t4);
    float4 y = *reinterpret_cast<const float4*>(ra + (R0 + 8) * BK + 4 * t4);
    float* xe = &x.x;
    float* ye = &y.x;
    float4 cs = make_float4(1.0f, 1.0f, 1.0f, 1.0f), cb = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (ln) {
      cs = *reinterpret_cast<const float4*>(col_s + k);
      cb = *reinterpret_cast<const float4*>(col_b + k);
    }
    const float* se = &cs.x;
    const float* be = &cb.x;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool kin = k + e < g.K;
      if (ln) {
        const float tx = (xe[e] - mean0) * inv0, ty = (ye[e] - mean1) * inv1;
        xe[e] = tx * se[e] + be[e];
        ye[e] = ty * se[e] + be[e];
      }
      xe[e] = kin && in0 ? xe[e] : 0.0f;
      ye[e] = kin && in1 ? ye[e] : 0.0f;
    }
    if (side && k < g.K) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long o = h ? side1 : side0;
        if (o < 0) continue;
        const float4 v = h ? y : x;
        if (side_vec) {
          *reinterpret_cast<float4*>(side + o + k) = v;
        } else {
          const float* ve = &v.x;
          for (int e = 0; e < 4 && k + e < g.K; ++e) side[o + k + e] = ve[e];
        }
      }
    }
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      Tc<float>::split(xe[2 * st], hi[st][0], lo[st][0]);
      Tc<float>::split(ye[2 * st], hi[st][1], lo[st][1]);
      Tc<float>::split(xe[2 * st + 1], hi[st][2], lo[st][2]);
      Tc<float>::split(ye[2 * st + 1], hi[st][3], lo[st][3]);
    }
  };
  // B's stage kt into halves buffer kt % 2: piece (n, kc) of a half holds
  // depths kc, kc + 4, kc + 8, kc + 12 of column n (the permuted order),
  // zero past N and K
  auto take_b = [&](int kt) {
    const float* rb = reinterpret_cast<const float*>(fwd_smem + (kt % S) * TL::kRaw + TL::kRawA);
    uint8_t* hb = fwd_smem + S * TL::kRaw + (kt & 1) * 2 * TL::kHalfB;
    const int k0 = kt * BK;
#pragma unroll
    for (int it = 0; it < BN * (BK / 4) / kFwdConsumers; ++it) {
      const int i = tid + it * kFwdConsumers, n = i % BN, kc = i / BN;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = kc + 4 * e;
        Tc<float>::split(k0 + d < g.K && n0 + n < g.N ? rb[d * BN + n] : 0.0f, hi[e], lo[e]);
      }
      const int off = kc * TL::kLdB + n * 16;
      *reinterpret_cast<uint4*>(hb + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(hb + TL::kHalfB + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  };
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  uint32_t ahi[2][4], alo[2][4], nhi[2][4], nlo[2][4];
  sm90::mbar_wait(full0, 0);
  take_a(0, ahi, alo);
  take_b(0);
  for (int kt = 0; kt < ktiles; ++kt) {
    sm90::fence_proxy_async();   // this thread's halves of B, visible to wgmma
    sm90::named_bar_sync(kFwdBar, kFwdConsumers);   // everyone's; the last products done
    const uint32_t bh = sm90::smem_u32(fwd_smem + S * TL::kRaw + (kt & 1) * 2 * TL::kHalfB);
    const uint32_t bl = bh + TL::kHalfB;
    sm90::wgmma_fence();
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const uint64_t b_hi = sm90::make_desc(bh + st * 2 * TL::kLdB, TL::kLdB, 128);
      const uint64_t b_lo = sm90::make_desc(bl + st * 2 * TL::kLdB, TL::kLdB, 128);
      sm90::wgmma_tf32_rs_n128(part, alo[st], b_hi, st != 0);
      sm90::wgmma_tf32_rs_n128(part, ahi[st], b_lo, 1);
      sm90::wgmma_tf32_rs_n128(part, ahi[st], b_hi, 1);
    }
    sm90::wgmma_commit();
    if (tid == 0) sm90::mbar_arrive(empty0 + 8 * (kt % S));   // the raw stage is free
    if (kt + 1 < ktiles) {   // the next stage, under this one's products
      sm90::mbar_wait(full0 + 8 * ((kt + 1) % S), ((kt + 1) / S) & 1);
      take_a(kt + 1, nhi, nlo);
      take_b(kt + 1);
    }
    sm90::wgmma_wait0();
    // read only after the wait: the products' sums, and A's fragments kept
    // until they are done with
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        asm volatile("" : "+r"(ahi[st][e]), "+r"(alo[st][e])::"memory");
        ahi[st][e] = nhi[st][e];
        alo[st][e] = nlo[st][e];
      }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      asm volatile("" : "+f"(part[i])::"memory");
      acc[i] += part[i];
    }
  }
  // the epilogue: acc + bias into the tile in shared memory (the ring and
  // the halves are free once both warpgroups' products are done), then rows
  // in 16-byte pieces
  sm90::named_bar_sync(kFwdBar, kFwdConsumers);
  constexpr int LDC = BN + 4;
  float* ct = reinterpret_cast<float*>(fwd_smem);
  const float* bias = static_cast<const float*>(g.bias);
  {
    const int r0 = wg * 64 + warp * 16 + gq;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = j * 8 + 2 * t4;
      const long long n = n0 + c;
      const float b0 = bias && n < g.N ? bias[n] : 0.0f;
      const float b1 = bias && n + 1 < g.N ? bias[n + 1] : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(ct + (r0 + 8 * h) * LDC + c) =
            make_float2(acc[4 * j + 2 * h] + b0, acc[4 * j + 2 * h + 1] + b1);
    }
  }
  sm90::named_bar_sync(kFwdBar, kFwdConsumers);
  const bool resid = g.epi == kResid, gelu = g.epi == kGelu;
  const float* res = static_cast<const float*>(g.res.p);
  float* out = static_cast<float*>(g.c.p);
  const bool vec = g.N % 4 == 0 && g.c.ld % 4 == 0 && (uintptr_t)g.c.p % 16 == 0 &&
                   (!resid || (g.res.ld % 4 == 0 && (uintptr_t)g.res.p % 16 == 0)) &&
                   (uintptr_t)g.aux % 16 == 0;
  // a thread's pieces: i = tid + it * 256 (each of its residuals loaded
  // before any is used)
  constexpr int kPieces = kFwdBM * (BN / 4) / kFwdConsumers;
  float4 rv[kPieces];
  if (resid && vec) {
#pragma unroll
    for (int it = 0; it < kPieces; ++it) {
      const int i = tid + it * kFwdConsumers, r = i / (BN / 4), c = (i % (BN / 4)) * 4;
      if (m0 + r < g.M && n0 + c < g.N)
        rv[it] = *reinterpret_cast<const float4*>(res + (long long)rrow[r] * g.res.ld + n0 + c);
    }
  }
#pragma unroll
  for (int it = 0; it < kPieces; ++it) {
    const int i = tid + it * kFwdConsumers, r = i / (BN / 4), c = (i % (BN / 4)) * 4;
    const long long m = m0 + r, n = n0 + c;
    if (m >= g.M || n >= g.N) continue;
    float4 v = *reinterpret_cast<const float4*>(ct + r * LDC + c);
    float* e = &v.x;
    const long long o = (long long)orow[r] * g.c.ld + n;
    if (vec) {
      if (gelu) {
        if (g.aux) *reinterpret_cast<float4*>(g.aux + m * g.N + n) = v;
#pragma unroll
        for (int j = 0; j < 4; ++j) e[j] = gelu_tanh(e[j]);
      } else if (resid) {
        const float4 x = rv[it];
        const float d = row_dp[r];
        v = make_float4(x.x + d * v.x, x.y + d * v.y, x.z + d * v.z, x.w + d * v.w);
      }
      *reinterpret_cast<float4*>(out + o) = v;
    } else {
      const long long q = (long long)rrow[r] * g.res.ld + n;
      for (int j = 0; j < 4 && n + j < g.N; ++j) {
        float x = e[j];
        if (gelu) {
          if (g.aux) g.aux[m * g.N + n + j] = x;
          x = gelu_tanh(x);
        } else if (resid) {
          x = res[q + j] + row_dp[r] * x;
        }
        out[o + j] = x;
      }
    }
  }
}

// ------------------------------------------------------------ attention

struct AttnArgs {
  const void* qkv;      // T [M, 3C], window order
  const float* rel;     // [heads, n, n]
  const float* mask;    // [n_mask, n, n] or null
  int n_mask;
  const void* dout;     // backward: dL/d(merged heads) [M, C], in the products' type
  void* out;            // forward: the merged heads T [M, C]; backward: dqkv T [M, 3C]
  float* stats;         // [BW * heads, n, 2]: row max and sum of the softmax
  float* drel;          // backward: [groups, heads, n, n], sums over a group's windows
  float* dbias;         // backward: [groups, 3C], column sums of dqkv
  long long BW;
  int groups;           // backward: window w is in group w % groups
  int sgroups;          // forward: blocks a window and head
  int n, np, hd, hdp, heads, C;
  float scale;
  int vec;
};

template <typename T>
struct Att {
  static constexpr int kPad = 16 / (int)sizeof(T);
  static __host__ __device__ int ldh(int hdp) { return hdp + kPad; }
  static __host__ __device__ int ldp() { return kChunk + kPad; }
};

// s (16 x ncols, ncols <= 64 a multiple of 8) += A [16, kdim] @ B [kdim,
// ncols]; a over (row, k), b over (col, k).
template <typename T, bool JA, bool JB>
__device__ __forceinline__ void mma_strip(float (&s)[8][4], int kdim, int ncols, int lane,
                                          const View<T, JA>& a, const View<T, JB>& b) {
  for (int k0 = 0; k0 < kdim; k0 += Tc<T>::kK) {
    typename Tc<T>::A fa;
    Tc<T>::load_a(fa, a, 0, k0, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j * 8 < ncols) {
        typename Tc<T>::B fb;
        Tc<T>::load_b(fb, b, k0, j * 8, lane);
        Tc<T>::step(s[j], fa, fb);
      }
    }
  }
}

__device__ __forceinline__ void zero_strip(float (&s)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
}

// The rel-pos bias of a head and the mask of a window, [n, n] each (mask
// null without a shift)
struct Bias {
  const float *rel, *mask;
  int n;
  __device__ Bias(const AttnArgs& a, long long w, int h)
      : rel(a.rel + (long long)h * a.n * a.n),
        mask(a.mask ? a.mask + (long long)(w % a.n_mask) * a.n * a.n : nullptr),
        n(a.n) {}
  // the logit of query qi and key kj from acc = q . k
  __device__ __forceinline__ float logit(float acc, float scale, int qi, int kj) const {
    const float v = acc * scale + rel[qi * n + kj];
    return mask ? v + mask[qi * n + kj] : v;
  }
};

// One block per (window, head, qtiles strips of 16 queries): k and v of the
// window whole in shared memory, a warp per strip and part of the keys
// (kparts parts of kpart keys; attn_plan picks both from the widths). A
// warp holds its strip's logits over its keys in registers. With one part
// (kSplit false) it takes the row max and sum alone; with several the
// parts' maxima and then their sums of exp(logit - max) are combined
// through shared memory in part order, so that every warp rounds p =
// exp(logit - max) / sum to T with the row's own statistics, as the plain
// version does, and the parts' p @ v are added in part order by the
// strip's first warp. No atomics.
// Blocks an SM the registers allow: eight for windows of 64 tokens (64
// registers a thread), three in bf16 over 64 (170), two in f32 (256); split,
// four for parts of 64 keys (128), two over.
// The forward attention's split of a window and head (attn_plan): qtiles
// strips of 16 queries a block, kparts parts of kpart keys (a multiple of
// 16) a strip
struct AttnSplit {
  int qtiles, kparts, kpart;
};

template <typename T, int kChunks, bool kSplit>
__global__ void __launch_bounds__(kThreads, kSplit ? (kChunks == 1 ? 4 : 2)
                                  : kChunks == 1 ? 8 : sizeof(T) == 2 ? 3 : 2)
    attn_fwd_kernel(AttnArgs a, AttnSplit sp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int LDH = Att<T>::ldh(a.hdp), LDP = Att<T>::ldp();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gq = lane >> 2, tq = lane & 3;
  const int nthreads = kSplit ? (int)blockDim.x : kThreads, nwarps = nthreads >> 5;
  const int wq = kSplit ? warp / sp.kparts : warp, wk = kSplit ? warp - wq * sp.kparts : 0;
  const long long z = blockIdx.x / a.sgroups, w = z / a.heads;
  const int h = (int)(z - w * a.heads), sg = blockIdx.x % a.sgroups;
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Vs = Ks + a.np * LDH;
  T* Qw = Vs + a.np * LDH + warp * 16 * (LDH + LDP);
  T* Pw = Qw + 16 * LDH;
  const Geom none = {1, 1, 1};
  const Src src = {a.qkv, 3LL * a.C, 0, a.vec};
  const long long row0 = w * a.n, rend = row0 + a.n;
  const Bias bias(a, w, h);
  const long long cq = (long long)h * a.hd, ck = a.C + cq, cv = 2LL * a.C + cq;
  const int q0 = (sg * (kSplit ? sp.qtiles : kThreads / 32) + wq) * 16;
  const int kb = kSplit ? wk * sp.kpart : 0, ke = kSplit ? min(a.np, kb + sp.kpart) : a.np;
  const int nch = (ke - kb + kChunk - 1) / kChunk;
  // k and v whole and this warp's queries, in flight together
  stage_tile<T>(Ks, LDH, a.np, a.hdp, src, row0, ck, rend, ck + a.hd, -1, none, tid, nthreads);
  stage_tile<T>(Vs, LDH, a.np, a.hdp, src, row0, cv, rend, cv + a.hd, -1, none, tid, nthreads);
  if (q0 < a.np)
    stage_tile<T>(Qw, LDH, 16, a.hdp, src, row0 + q0, cq, rend, cq + a.hd, -1, none, lane, 32);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (!kSplit && q0 >= a.np) return;
  // split: every warp takes part in the barriers below, those with no
  // queries or keys on zeros
  const bool on = !kSplit || (q0 < a.np && kb < ke);
  const View<T, true> vq = {Qw, LDH}, vp = {Pw, LDP};
  float mx[2] = {-INFINITY, -INFINITY}, sm[2] = {0.0f, 0.0f};
  // the logits of the strip over this warp's keys, all chunks (kChunks at
  // most) in registers: -inf beyond the window's keys
  float s[kChunks][8][4];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (c >= nch || !on) break;
    const int j0 = kb + c * kChunk, ncols = min(kChunk, ke - j0);
    zero_strip(s[c]);
    mma_strip<T>(s[c], a.hdp, ncols, lane, vq, View<T, true>{Ks + j0 * LDH, LDH});
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + gq + (e >> 1) * 8, kj = j0 + j * 8 + 2 * tq + (e & 1);
        s[c][j][e] = (j * 8 >= ncols || kj >= a.n) ? -INFINITY
                     : qi >= a.n                   ? 0.0f
                                                   : bias.logit(s[c][j][e], a.scale, qi, kj);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float cm = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) cm = fmaxf(cm, fmaxf(s[c][j][2 * r], s[c][j][2 * r + 1]));
      mx[r] = fmaxf(mx[r], quad_max(cm));
    }
  }
  // split: the parts' row maxima and sums [nwarps][16], and p @ v
  // [nwarps][16][hdp]; the strip's first warp
  float* rmax = reinterpret_cast<float*>(Vs + a.np * LDH + nwarps * 16 * (LDH + LDP));
  float* rsum = rmax + nwarps * 16;
  float* ro = rsum + nwarps * 16;
  const int first = wq * sp.kparts;
  if constexpr (kSplit) {   // the row max over the parts, in part order
    if (tq == 0) {
      rmax[warp * 16 + gq] = mx[0];
      rmax[warp * 16 + gq + 8] = mx[1];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float m = -INFINITY;
      for (int p = 0; p < sp.kparts; ++p) m = fmaxf(m, rmax[(first + p) * 16 + gq + 8 * r]);
      mx[r] = m;
    }
  }
  // the row sums of exp(logit - max), eight partial sums a row
  float part[2][8];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 8; ++j) part[r][j] = 0.0f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (c >= nch || !on) break;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) part[r][j] += expf(s[c][j][2 * r + e] - mx[r]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) sm[r] = quad_sum(sum8(part[r]));
  if constexpr (kSplit) {   // the row sum over the parts, in part order
    if (tq == 0) {
      rsum[warp * 16 + gq] = sm[0];
      rsum[warp * 16 + gq + 8] = sm[1];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float t = 0.0f;
      for (int p = 0; p < sp.kparts; ++p) t += rsum[(first + p) * 16 + gq + 8 * r];
      sm[r] = t;
    }
  }
  float o[8][4];
  zero_strip(o);
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (c >= nch || !on) break;
    const int j0 = kb + c * kChunk, ncols = min(kChunk, ke - j0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rl = gq + (e >> 1) * 8, cl = j * 8 + 2 * tq + (e & 1);
        if (j * 8 < ncols) {
          const float p = q0 + rl < a.n ? expf(s[c][j][e] - mx[e >> 1]) / sm[e >> 1] : 0.0f;
          Pw[rl * LDP + cl] = from_f<T>(p);
        }
      }
    __syncwarp();
    mma_strip<T>(o, ncols, a.hdp, lane, vp, View<T, false>{Vs + j0 * LDH, LDH});
    __syncwarp();
  }
  if constexpr (kSplit) {   // p @ v over the parts, in part order
    if (wk > 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = gq + (e >> 1) * 8, d = j * 8 + 2 * tq + (e & 1);
          if (d < a.hdp) ro[(warp * 16 + rl) * a.hdp + d] = o[j][e];
        }
    }
    __syncthreads();
    if (wk > 0 || !on) return;
    for (int p = 1; p < sp.kparts; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rl = gq + (e >> 1) * 8, d = j * 8 + 2 * tq + (e & 1);
          if (d < a.hdp) o[j][e] += ro[((first + p) * 16 + rl) * a.hdp + d];
        }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qi = q0 + gq + (e >> 1) * 8, d = j * 8 + 2 * tq + (e & 1);
      if (qi < a.n && d < a.hd)
        static_cast<T*>(a.out)[(row0 + qi) * a.C + cq + d] = from_f<T>(o[j][e]);
    }
  if (a.stats && tq == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + gq + r * 8;
      if (qi < a.n) {
        a.stats[(z * a.n + qi) * 2] = mx[r];
        a.stats[(z * a.n + qi) * 2 + 1] = sm[r];
      }
    }
  }
}

// ------------------------------------------------------------ the attention backward

constexpr int kBwdMaxThreads = 32 * kMaxN / 16;   // a warp per 16 keys
constexpr long long kMaxSmem = 232448;            // a block's shared memory on sm_90

// Rows [r0, r0 + rows) x columns [c0, c0 + cols) (cols even) of the f32
// matrix s (row stride ld), rounded to bf16, into dst (row stride dld):
// zeros outside rows < r_end and columns < c_end.
__device__ __forceinline__ void stage_bf16_of(bf16* dst, int dld, int rows, int cols,
                                              const float* s, long long ld, long long r0,
                                              long long c0, long long r_end, long long c_end,
                                              int tid, int nthreads) {
  const int half = cols / 2;
  for (int i = tid; i < rows * half; i += nthreads) {
    const int r = i / half, c = (i - r * half) * 2;
    const long long gr = r0 + r, gc = c0 + c;
    float v0 = 0.0f, v1 = 0.0f;
    if (gr < r_end) {
      const float* p = s + gr * ld + gc;
      if (gc < c_end) v0 = p[0];
      if (gc + 1 < c_end) v1 = p[1];
    }
    *reinterpret_cast<uint32_t*>(dst + r * dld + c) = pack_bf16(v0, v1);
  }
}

// bf16 B fragments of two n8 tiles (columns n0, n0 + 8) of the 16 rows of a
// [k][n] tile in shared memory (row stride ld; k16 x n16): b0, b1 of the
// first tile in r[0], r[1], of the second in r[2], r[3]. bf16 by ldmatrix;
// f32 elements are rounded to bf16 as they are read.
template <typename S>
__device__ __forceinline__ void b_kn(uint32_t (&r)[4], const S* base, int ld, int n0, int lane) {
  if constexpr (sizeof(S) == 2) {
    const int li = lane & 7, mi = lane >> 3;
    ldsm_x4<true>(r, base + ((mi & 1) * 8 + li) * ld + n0 + (mi >> 1) * 8);
  } else {
    const View<float, false> v = {base, ld};
    Tc<bf16>::B b;
    Bf16Of::load_b(b, v, 0, n0, lane);
    r[0] = b.r[0];
    r[1] = b.r[1];
    Bf16Of::load_b(b, v, 0, n0 + 8, lane);
    r[2] = b.r[0];
    r[3] = b.r[1];
  }
}

// The A fragment (m16 x k16, bf16) of an accumulator pair s[0], s[1] (two
// n8 tiles of the same 16 rows), each element rounded to bf16
__device__ __forceinline__ void a_of(Tc<bf16>::A& f, const float (&s)[2][4]) {
  f.r[0] = pack_bf16(s[0][0], s[0][1]);
  f.r[1] = pack_bf16(s[0][2], s[0][3]);
  f.r[2] = pack_bf16(s[1][0], s[1][1]);
  f.r[3] = pack_bf16(s[1][2], s[1][3]);
}

// The attention backward of K2 and K4: dq, dk, dv of each window and head
// from one computation of p and dp. Every backward product takes operands
// rounded to bf16 whatever T is (P), as both JAX kernels round them, and
// runs as bf16 m16n8k16. dS takes the f32 p in K4 (as
// pallas_window_attention.py) and p rounded to bf16 in K2 (as
// pallas_swin_block.py). One block per (head, group of windows), a warp per
// strip of 16 keys. The block holds the window's k (T: the logits, 3xTF32
// in f32, as the forward computes them) and v (P) whole, the softmax's row
// statistics, and streams the 16-query tiles of q (T) and dO (P) through a
// double buffer, the next tile in flight under this one. Per tile each warp
// computes its keys' logits, p, dp and their row sums over its keys; the
// warps' sums are added in warp order (D); then ds = p (dp - D), dv +=
// rd(p)^T dO and dk += rd(ds)^T rd(q) from registers, and rd(ds) goes to a
// shared [16, np] tile, from which the warps compute the tile's dq over all
// keys, 16 columns each (warp w columns 16 w, 16 (w + nw), ...). dk and dv
// stay in registers until the window is done. The rel-pos gradient sums
// the group's windows in a partial private to the block, the bias gradient
// of qkv the stores of dq, dk and dv. No float atomics.
template <typename T, bool kK2>
__global__ void __launch_bounds__(kBwdMaxThreads) attn_bwd_kernel(AttnArgs a) {
  using P = bf16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nw = blockDim.x >> 5;
  const int LDQ = Att<T>::ldh(a.hdp), LDV = Att<P>::ldh(a.hdp), LDS = a.np + Att<P>::kPad;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, gq = lane >> 2, tq = lane & 3;
  const int li = lane & 7, mi = lane >> 3;
  const int h = blockIdx.x % a.heads, gi = blockIdx.x / a.heads;
  T* Ks = reinterpret_cast<T*>(smem_raw);
  T* Qb = Ks + a.np * LDQ;                       // [2][16][LDQ]: query tiles of q
  P* Vs = reinterpret_cast<P*>(Qb + 2 * 16 * LDQ);
  P* Ob = Vs + a.np * LDV;                       // [2][16][LDV]: query tiles of dO
  P* Sd = Ob + 2 * 16 * LDV;                     // rd(ds) of a query tile, [16][LDS]
  float* red = reinterpret_cast<float*>(Sd);     // at a window's end: [2][nw][hdp]
  float* redD = reinterpret_cast<float*>(Sd + 16 * LDS);   // [nw][16]
  float* mxs = redD + 16 * nw;
  float* sms = mxs + a.np;
  float* csq = sms + a.np;           // column sums of dq, dk and dv, over the windows
  float* csk = csq + a.hdp;
  float* csv = csk + a.hdp;
  const Geom none = {1, 1, 1};
  const long long C3 = 3LL * a.C;
  const long long cq = (long long)h * a.hd, ck = a.C + cq, cv = 2LL * a.C + cq;
  const Src src = {a.qkv, C3, 0, a.vec};
  const Src dsrc = {a.dout, a.C, 0, (a.hd * (int)sizeof(P)) % 16 == 0};
  const long long nn = (long long)a.n * a.n;
  float* part = a.drel + ((long long)gi * a.heads + h) * nn;
  const int k0r = warp * 16;
  for (int d = tid; d < a.hdp; d += blockDim.x) csq[d] = csk[d] = csv[d] = 0.0f;
  for (long long w = gi; w < a.BW; w += a.groups) {
    const bool first = w == gi;
    const long long z = w * a.heads + h, row0 = w * a.n, rend = row0 + a.n;
    const Bias bias(a, w, h);
    // query tile q0's q and dO into buffer (q0 / 16) % 2
    auto stage_queries = [&](int q0) {
      const int b = (q0 / 16) & 1;
      stage_tile<T>(Qb + b * 16 * LDQ, LDQ, 16, a.hdp, src, row0 + q0, cq, rend, cq + a.hd, -1,
                    none, tid, blockDim.x);
      stage_tile<P>(Ob + b * 16 * LDV, LDV, 16, a.hdp, dsrc, row0 + q0, cq, rend, cq + a.hd, -1,
                    none, tid, blockDim.x);
    };
    __syncthreads();
    stage_tile<T>(Ks, LDQ, a.np, a.hdp, src, row0, ck, rend, ck + a.hd, -1, none, tid,
                  blockDim.x);
    if constexpr (sizeof(P) == sizeof(T))
      stage_tile<P>(Vs, LDV, a.np, a.hdp, src, row0, cv, rend, cv + a.hd, -1, none, tid,
                    blockDim.x);
    else
      stage_bf16_of(Vs, LDV, a.np, a.hdp, static_cast<const float*>(a.qkv), C3, row0, cv, rend,
                    cv + a.hd, tid, blockDim.x);
    stage_queries(0);
    for (int i = tid; i < a.np; i += blockDim.x) {
      const bool ok = i < a.n;
      mxs[i] = ok ? a.stats[(z * a.n + i) * 2] : 0.0f;
      sms[i] = ok ? a.stats[(z * a.n + i) * 2 + 1] : 1.0f;
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    float dk[8][4], dv[8][4];
    zero_strip(dk);
    zero_strip(dv);
    for (int q0 = 0; q0 < a.np; q0 += 16) {
      // the next tile's q and dO in flight under this one (its buffer was
      // last read before the previous tile's second barrier)
      if (q0 + 16 < a.np) stage_queries(q0 + 16);
      cp_async_commit();
      const T* Qt = Qb + ((q0 / 16) & 1) * 16 * LDQ;
      const P* Ot = Ob + ((q0 / 16) & 1) * 16 * LDV;
      // s^T and dp^T: this warp's 16 keys x the tile's 16 queries
      float s[2][4], dpt[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dpt[j][e] = 0.0f;
      {
        const View<T, true> vk = {Ks + k0r * LDQ, LDQ}, vq = {Qt, LDQ};
        for (int k0 = 0; k0 < a.hdp; k0 += Tc<T>::kK) {
          typename Tc<T>::A fa;
          Tc<T>::load_a(fa, vk, 0, k0, lane);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            typename Tc<T>::B fb;
            Tc<T>::load_b(fb, vq, k0, j * 8, lane);
            Tc<T>::step(s[j], fa, fb);
          }
        }
        const View<P, true> vv = {Vs + k0r * LDV, LDV}, vo = {Ot, LDV};
        for (int k0 = 0; k0 < a.hdp; k0 += Tc<P>::kK) {
          typename Tc<P>::A fa;
          Tc<P>::load_a(fa, vv, 0, k0, lane);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            typename Tc<P>::B fb;
            Tc<P>::load_b(fb, vo, k0, j * 8, lane);
            Tc<P>::step(dpt[j], fa, fb);
          }
        }
      }
      // p (0 beyond the window; K2: rounded to T), and the sums over this
      // warp's keys of p dp
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0r + gq + (e >> 1) * 8, qi = q0 + j * 8 + 2 * tq + (e & 1);
          const float p = (kj < a.n && qi < a.n)
                              ? expf(bias.logit(s[j][e], a.scale, qi, kj) - mxs[qi]) / sms[qi]
                              : 0.0f;
          s[j][e] = kK2 ? rnd_t<P>(p) : p;
        }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float v = column_sum(s[j][c] * dpt[j][c] + s[j][2 + c] * dpt[j][2 + c]);
          if (gq == 0) redD[warp * 16 + j * 8 + 2 * tq + c] = v;
        }
      __syncthreads();
      float D[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float t = 0.0f;
          for (int v = 0; v < nw; ++v) t += redD[v * 16 + j * 8 + 2 * tq + c];
          D[j][c] = t;
        }
      // ds; the rel-pos partial (all loads before any store)
      float ds[2][4], prev[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0r + gq + (e >> 1) * 8, qi = q0 + j * 8 + 2 * tq + (e & 1);
          ds[j][e] = s[j][e] * (dpt[j][e] - D[j][e & 1]);
          prev[j][e] = (!first && kj < a.n && qi < a.n) ? part[(long long)qi * a.n + kj] : 0.0f;
        }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = gq + (e >> 1) * 8, ql = j * 8 + 2 * tq + (e & 1);
          const int kj = k0r + kl, qi = q0 + ql;
          if (kj < a.n && qi < a.n) part[(long long)qi * a.n + kj] = prev[j][e] + ds[j][e];
          Sd[ql * LDS + kj] = from_f<P>(ds[j][e]);
        }
      // dv += rd(p)^T dO, dk += rd(ds)^T rd(q)
      {
        Tc<bf16>::A pa, sa;
        a_of(pa, s);
        a_of(sa, ds);
#pragma unroll
        for (int n0 = 0; n0 < 64; n0 += 16) {
          if (n0 >= a.hdp) break;
          uint32_t fb[4];
          b_kn<bf16>(fb, Ot, LDV, n0, lane);
          Tc<bf16>::mma(dv[n0 / 8], pa, Tc<bf16>::B{{fb[0], fb[1]}});
          Tc<bf16>::mma(dv[n0 / 8 + 1], pa, Tc<bf16>::B{{fb[2], fb[3]}});
          b_kn<T>(fb, Qt, LDQ, n0, lane);
          Tc<bf16>::mma(dk[n0 / 8], sa, Tc<bf16>::B{{fb[0], fb[1]}});
          Tc<bf16>::mma(dk[n0 / 8 + 1], sa, Tc<bf16>::B{{fb[2], fb[3]}});
        }
      }
      cp_async_wait<0>();
      __syncthreads();
      // dq of the tile = rd(ds) rd(k) * scale, rounded to P; its column
      // sums (each column's by one warp, tile after tile)
      for (int n0 = warp * 16; n0 < a.hdp; n0 += nw * 16) {
        float dq[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) dq[j][e] = 0.0f;
        for (int k0 = 0; k0 < a.np; k0 += 16) {
          Tc<bf16>::A fa;
          ldsm_x4<false>(fa.r, Sd + ((mi & 1) * 8 + li) * LDS + k0 + (mi >> 1) * 8);
          uint32_t fb[4];
          b_kn<T>(fb, Ks + k0 * LDQ, LDQ, n0, lane);
          Tc<bf16>::mma(dq[0], fa, Tc<bf16>::B{{fb[0], fb[1]}});
          Tc<bf16>::mma(dq[1], fa, Tc<bf16>::B{{fb[2], fb[3]}});
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int d = n0 + j * 8 + 2 * tq + c;
            float sq = 0.0f;
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const int qi = q0 + gq + hr * 8;
              if (qi < a.n && d < a.hd) {
                const float v = rnd_t<P>(dq[j][hr * 2 + c] * a.scale);
                static_cast<T*>(a.out)[(row0 + qi) * C3 + cq + d] = from_f<T>(v);
                sq += v;
              }
            }
            sq = column_sum(sq);
            if (gq == 0) csq[d] += sq;
          }
      }
    }
    // dk and dv of this warp's keys, rounded to P; their column sums over
    // the warps, in warp order
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (j * 8 >= a.hdp) break;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float sk = 0.0f, sv = 0.0f;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int kj = k0r + gq + hr * 8, d = j * 8 + 2 * tq + c;
          if (kj < a.n && d < a.hd) {
            const float vk = rnd_t<P>(dk[j][hr * 2 + c] * a.scale);
            const float vv = rnd_t<P>(dv[j][hr * 2 + c]);
            T* o = static_cast<T*>(a.out) + (row0 + kj) * C3;
            o[ck + d] = from_f<T>(vk);
            o[cv + d] = from_f<T>(vv);
            sk += vk;
            sv += vv;
          }
        }
        sk = column_sum(sk);
        sv = column_sum(sv);
        if (gq == 0) {
          red[warp * a.hdp + j * 8 + 2 * tq + c] = sk;
          red[(nw + warp) * a.hdp + j * 8 + 2 * tq + c] = sv;
        }
      }
    }
    __syncthreads();
    for (int d = tid; d < a.hdp; d += blockDim.x) {
      float tk = 0.0f, tv = 0.0f;
      for (int v = 0; v < nw; ++v) {
        tk += red[v * a.hdp + d];
        tv += red[(nw + v) * a.hdp + d];
      }
      csk[d] += tk;
      csv[d] += tv;
    }
  }
  __syncthreads();
  float* out = a.dbias + (long long)gi * C3;
  for (int d = tid; d < a.hd; d += blockDim.x) {
    out[cq + d] = csq[d];
    out[ck + d] = csk[d];
    out[cv + d] = csv[d];
  }
}

// ------------------------------------------------------------ rows

// The LayerNorm backward of `rows` rows a block, with d = dL/d(LN output):
//   r = add[row(m)] + inv * (d*s - mean(d*s) - xhat * mean(d*s*xhat))
// out[row(m)] = r; out2[m] = dp[sample, 0] * r (rounded to T) where out2 is
// given. Per block, the column sums of
// d * xhat and d (the LayerNorm parameters' gradients) and, where given, of
// dp[sample, 0] * r and dp[sample, 1] * add (biases').
struct LnBwdArgs {
  const float* d;           // f32 [M, C]
  const void* x;            // the LayerNorm's input, T [M, C]
  int x_map;
  const float* stats;       // (mean, 1/std) of each row
  const float* s;           // the LayerNorm's scale
  const void* add;          // [M, C], bf16 where add_bf else f32
  int add_bf, add_map;
  Out out;
  void* out2;               // T [M, C] or null
  const float* dp;          // [B, 2]
  float *ps, *pb, *p_res, *p_add;   // [blocks, C] partial sums (the last two may be null)
  long long M;
  int C, rows;                      // rows a block, at most kRowsPerBlock
  Geom g;
};

template <typename T>
__global__ void __launch_bounds__(kRowThreads) ln_bwd_kernel(LnBwdArgs a) {
  __shared__ float m1s[kRowsPerBlock], m2s[kRowsPerBlock], means[kRowsPerBlock],
      invs[kRowsPerBlock], dp0[kRowsPerBlock], dp1[kRowsPerBlock];
  __shared__ long long xrow[kRowsPerBlock], arow[kRowsPerBlock], orow[kRowsPerBlock];
  const long long r0 = (long long)blockIdx.x * a.rows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, C = a.C;
  const T* x = static_cast<const T*>(a.x);
  const long long hw = (long long)a.g.H * a.g.W;
  for (int r = warp; r < a.rows; r += kRowThreads / 32) {
    const long long m = r0 + r;
    float mean = 0.0f, inv = 0.0f, s1 = 0.0f, s2 = 0.0f;
    long long gr = 0;
    if (m < a.M) {
      gr = a.g.grid_row(m);
      mean = a.stats[2 * m];
      inv = a.stats[2 * m + 1];
      const T* xr = x + (a.x_map ? gr : m) * C;
      const float* dr = a.d + m * C;
      for (int c = lane; c < C; c += 32) {
        const float xhat = (to_f(xr[c]) - mean) * inv;
        const float dx = dr[c] * a.s[c];
        s1 += dx;
        s2 += dx * xhat;
      }
      s1 = warp_sum(s1) / C;
      s2 = warp_sum(s2) / C;
    }
    if (lane == 0) {
      m1s[r] = s1;
      m2s[r] = s2;
      means[r] = mean;
      invs[r] = inv;
      xrow[r] = a.x_map ? gr : m;
      arow[r] = a.add_map ? gr : m;
      orow[r] = a.out.map ? gr : m;
      dp0[r] = m < a.M ? a.dp[(m / hw) * 2] : 0.0f;
      dp1[r] = m < a.M ? a.dp[(m / hw) * 2 + 1] : 0.0f;
    }
  }
  __syncthreads();
  for (int c = tid; c < C; c += kRowThreads) {
    float ss = 0.0f, sb = 0.0f, sr = 0.0f, sa = 0.0f;
    const float sc = a.s[c];
    for (int r = 0; r < a.rows; ++r) {
      const long long m = r0 + r;
      if (m >= a.M) break;
      const float xhat = (to_f(x[xrow[r] * C + c]) - means[r]) * invs[r];
      const float dv = a.d[m * C + c];
      const float ad = load(a.add, arow[r] * C + c, a.add_bf);
      const float res = ad + invs[r] * (dv * sc - m1s[r] - xhat * m2s[r]);
      store(a.out.p, orow[r] * C + c, res, a.out.bf);
      if (a.out2) {
        const float v = dp0[r] * res;
        sr += v;
        static_cast<T*>(a.out2)[m * C + c] = from_f<T>(v);
      }
      sa += dp1[r] * ad;
      ss += dv * xhat;
      sb += dv;
    }
    const long long o = (long long)blockIdx.x * C + c;
    a.ps[o] = ss;
    a.pb[o] = sb;
    if (a.p_res) a.p_res[o] = sr;
    if (a.p_add) a.p_add[o] = sa;
  }
}

// dst[i] += sum over s < count of src[s * stride + i], s in order; one
// launch for every entry.
struct ReduceEntry {
  const float* src;
  long long stride, len;
  float* dst;
  int count, ways;   // ways: threads an entry's element, each summing every ways-th split
};

constexpr int kMaxEntries = 16;

struct ReduceArgs {
  ReduceEntry e[kMaxEntries];
  int blocks[kMaxEntries];
  int count;
};

// A block: 256 / ways elements of one ReduceEntry, `ways` threads each
// summing every ways-th split in order, then the ways' sums in order.
constexpr int kReduceThreads = 256, kReduceMaxWays = 8;

__global__ void __launch_bounds__(kReduceThreads) reduce_kernel(ReduceArgs a) {
  __shared__ float red[kReduceThreads];
  int blk = blockIdx.x, i = 0;
  while (i < a.count - 1 && blk >= a.blocks[i]) {
    blk -= a.blocks[i];
    ++i;
  }
  const ReduceEntry e = a.e[i];
  const int cols = kReduceThreads / e.ways;
  const int c = threadIdx.x % cols, way = threadIdx.x / cols;
  const long long j = (long long)blk * cols + c;
  float v = 0.0f;
  if (j < e.len) {
#pragma unroll 4
    for (int s = way; s < e.count; s += e.ways) v += e.src[s * e.stride + j];
  }
  red[threadIdx.x] = v;
  __syncthreads();
  if (way == 0 && j < e.len) {
    float t = 0.0f;
    for (int w = 0; w < e.ways; ++w) t += red[w * cols + c];
    e.dst[j] += t;
  }
}

// ------------------------------------------------------------ SwinV2

// SwinV2's block (swinv2_any_fwd, swinv2_any_bwd) runs on the products and
// the fused attention above, with kernels of its own around them: the
// scaled cosine attention takes q and k normalised per head beforehand (q
// times its head's logit scale; the attention then runs with scale 1), and
// the post-norms LN(proj) and LN(fc2) run as passes of their own after the
// products, since a product's tile holds part of a row. A warp a row or a
// thread a (row, head); no atomics.

constexpr float kLogScaleMax = 4.605170185988092f;   // ln 100, the logit scale's clamp
constexpr float kNormEps = 1e-12f;                     // F.normalize's

__device__ __forceinline__ float logit_scale(const float* tau, int h) {
  return expf(fminf(tau[h], kLogScaleMax));
}

// q <- normalize(q) * exp(min(tau_h, ln 100)), k <- normalize(k) in qkv (T
// [M, 3C], window order), a thread a (row, head); q and k as they were into
// raw (T [M, 2C]) where given, for the backward
struct QkNormArgs {
  void* qkv;
  void* raw;
  const float* tau;   // [heads]
  long long M;
  int C, heads, hd;
};

template <typename T>
__global__ void __launch_bounds__(kRowThreads) qk_norm_kernel(QkNormArgs a) {
  const long long p = (long long)blockIdx.x * kRowThreads + threadIdx.x;
  if (p >= a.M * a.heads) return;
  const long long m = p / a.heads;
  const int h = (int)(p - m * a.heads);
  const float s = logit_scale(a.tau, h);
  for (int part = 0; part < 2; ++part) {
    T* v = static_cast<T*>(a.qkv) + m * 3 * a.C + part * a.C + h * a.hd;
    float ss = 0.0f;
    for (int e = 0; e < a.hd; ++e) {
      const float x = to_f(v[e]);
      ss += x * x;
    }
    const float den = fmaxf(sqrtf(ss), kNormEps), g = part == 0 ? s : 1.0f;
    if (a.raw) {
      T* r = static_cast<T*>(a.raw) + m * 2 * a.C + part * a.C + h * a.hd;
      for (int e = 0; e < a.hd; ++e) r[e] = v[e];
    }
    for (int e = 0; e < a.hd; ++e) v[e] = from_f<T>(to_f(v[e]) / den * g);
  }
}

// The backward of qk_norm_kernel: dq', dk' (in dqkv, T [M, 3C]) to dq, dk in
// place, through the normalisation of raw's q and k; per block, each head's
// part of dtau = s * sum(dq' . q^) (zero where tau > ln 100, as the clamp's
// gradient), the block's (row, head) pairs of the head in order
struct QkNormBwdArgs {
  const void* raw;    // T [M, 2C]
  void* dqkv;
  const float* tau;
  float* ptau;        // [blocks, heads]
  long long M;
  int C, heads, hd;
};

template <typename T>
__global__ void __launch_bounds__(kRowThreads) qk_norm_bwd_kernel(QkNormBwdArgs a) {
  __shared__ float dots[kRowThreads];
  const long long p0 = (long long)blockIdx.x * kRowThreads, p = p0 + threadIdx.x;
  float dtau = 0.0f;
  if (p < a.M * a.heads) {
    const long long m = p / a.heads;
    const int h = (int)(p - m * a.heads);
    const float s = logit_scale(a.tau, h);
    for (int part = 0; part < 2; ++part) {
      const T* x = static_cast<const T*>(a.raw) + m * 2 * a.C + part * a.C + h * a.hd;
      T* d = static_cast<T*>(a.dqkv) + m * 3 * a.C + part * a.C + h * a.hd;
      const float g = part == 0 ? s : 1.0f;
      float ss = 0.0f;
      for (int e = 0; e < a.hd; ++e) {
        const float v = to_f(x[e]);
        ss += v * v;
      }
      const float nrm = sqrtf(ss), den = fmaxf(nrm, kNormEps);
      // dot = x^ . (dL/dx^), dL/dx^ = g * d
      float dot = 0.0f;
      for (int e = 0; e < a.hd; ++e) dot += to_f(x[e]) / den * (g * to_f(d[e]));
      if (part == 0 && a.tau[h] <= kLogScaleMax) dtau = dot;
      for (int e = 0; e < a.hd; ++e) {
        const float xh = to_f(x[e]) / den, dxh = g * to_f(d[e]);
        d[e] = from_f<T>(nrm > kNormEps ? (dxh - xh * dot) / den : dxh / den);
      }
    }
  }
  dots[threadIdx.x] = dtau;
  __syncthreads();
  if (threadIdx.x < a.heads) {
    const int h = threadIdx.x;
    float t = 0.0f;
    for (int i = (int)((h - p0 % a.heads + a.heads) % a.heads); i < kRowThreads; i += a.heads)
      t += dots[i];
    a.ptau[(long long)blockIdx.x * a.heads + h] = t;
  }
}

// SwinV2's attention stage in bf16 at head size 32, one launch: the
// normalisation of q and k (qk_norm_kernel's arithmetic, bit for bit), the
// logits, the softmax and p @ v of attn_fwd_kernel's cosine form, fused.
// Replaces no TPU kernel (the JAX package has no SwinV2 block); it takes
// the place of the pair qk_norm_kernel -> attn_fwd_kernel on the route's
// main type. A block per (window, head), one warpgroup, two blocks an SM
// (255 registers a thread, 113 KB of shared memory):
// - q, k and v of the head (at most 256 rows of 32) land by cp.async in
//   shared memory as wgmma's 8 x 8 core matrices: the 16 bytes of chunk c of
//   row r at c * kV2Chunk + r * 16, rows past the window zero. q and k are
//   K-major operands in that layout, and v is the MN-major B of p @ v as it
//   stands, so nothing is transposed.
// - A thread a row normalises q and k in place, summing the squares in the
//   order e = 0 .. 31 as qk_norm_kernel does; with `save` it also stores q
//   and k as they were (raw) and as normalised (back into qkv), which the
//   backward reads, and the softmax's row statistics.
// - The warpgroup walks the window's 64-query tiles (in an order rotated by
//   the window): S = q' k'^T on wgmma (A and B from shared memory, two
//   m64n128 halves of the keys, 128 f32 registers a thread); the bias and
//   the mask of each warp's 16 rows stream in through a ring of its own
//   (below) and are added as Bias::logit adds them; the row max, exp once a
//   logit (expf) and the row sums in attn_fwd_kernel's order (eight partial
//   sums over 64-key chunks, then the tree and the quad), so the statistics
//   are the two launches' bit for bit; p = e times the row's 1 / sum,
//   rounded to bf16 into the A fragments of p @ v (wgmma, A from
//   registers); merged rounded to bf16. (A division a logit, as
//   attn_fwd_kernel's p = e / sum, took 40 % of a first version's time on
//   an H100; p moves by at most an f32 rounding before its bf16 one.)
// Bound: the bias and mask reads from L2 (f32; 8 bytes a logit in a shifted
// window, 4 in an unshifted one), then q, k, v from device memory; the
// products are 4 n hd flops a query, far below the card's rate. No atomics:
// each (window, head) slice has one owner block.
constexpr int kV2Hd = 32;                  // the head size it is built for
constexpr int kV2Threads = 128;            // one warpgroup
constexpr int kV2Chunk = kMaxN * 16;       // bytes of one 8-column chunk of 256 rows
constexpr int kV2Part = 4 * kV2Chunk;      // q, k or v of the head

struct V2AttnArgs {
  bf16* qkv;           // [M, 3C], window order
  bf16* raw;           // save: q and k as they were, [M, 2C]; else null
  float* stats;        // save: [Z, n, 2] row max and sum; else null
  bf16* out;           // the merged heads [M, C]
  const float* tau;    // [heads]
  const float* rel;    // [heads, n, n]
  const float* mask;   // [n_mask, n, n] or null
  int n_mask, n, heads, C;
};

// The bias and mask stream through shared memory: each warp stages the 16
// rows of its accumulator, chunk by chunk of 32 keys, through a ring of its
// own (kV2Stages chunks in flight, each stage's mbarrier counting the
// warp's 32 lanes and the bytes; [stage][rel, mask][16 rows][32 keys] f32),
// so that no barrier of the block paces the loads. Tensor-map copies (TMA)
// where n % 4 == 0, else element cp.async (16-byte cp.async by every lane
// made the kernel 28 % slower than TMA on an H100). The 16-byte unit u of
// row r sits at u ^ (r % 8) (TMA's 128-byte swizzle): a warp's reads of its
// accumulator's pairs take two wavefronts.
constexpr int kV2Keys = 32;                                 // keys a chunk
constexpr int kV2Stages = 4;
constexpr int kV2BiasRow = kV2Keys * 4;                     // 128 bytes
constexpr int kV2BiasMat = 16 * kV2BiasRow;                 // 2 KB
constexpr int kV2BiasStage = 2 * kV2BiasMat;                // rel and mask
constexpr int kV2WarpRing = kV2Stages * kV2BiasStage;       // 16 KB
constexpr int kV2Smem = 4 * kV2WarpRing + 3 * kV2Part + 4 * kV2Stages * 8;   // two blocks an SM

// Rows r0 .. r0 + 15 x keys 32 c .. 32 c + 31 of rel (and mask) into a
// stage of the warp's ring by element cp.async (rows of n % 4 != 0 floats,
// which no tensor map takes), the window's rows and keys only: none past
// them, which the logits never read.
__device__ __forceinline__ void v2_stage_bias(uint8_t* st, const float* rel, const float* mask,
                                              int n, int r0, int c, int lane) {
  const int units = (mask ? 2 : 1) * 16 * 8, k0 = c * kV2Keys;
  for (int i = lane; i < units; i += 32) {
    const int m = i >> 7, r = (i >> 3) & 15, u = i & 7;
    const int qi = r0 + r, kj = k0 + u * 4;
    if (qi >= n || kj >= n) continue;
    const float* src = (m ? mask : rel) + (long long)qi * n + kj;
    uint8_t* d = st + m * kV2BiasMat + r * kV2BiasRow + ((u ^ (r & 7)) << 4);
    for (int e = 0; e < 4 && kj + e < n; ++e) cp_async4(d + 4 * e, src + e);
  }
}

// The tensor maps of rel ([heads * n, n]) and mask ([nW * n, n]) in boxes
// of 16 rows x 32 keys, swizzled by 128 bytes (unit u of row r at u ^ (r %
// 8), as v2_stage_bias lays them), where n % 4 == 0 (tma); else the stages
// go by cp.async. Past the tensors' edges the boxes read zeros.
struct V2Maps {
  CUtensorMap rel, mask;
  int tma;
};

// kFull: windows of 256 tokens, n a constant (its bounds checks compiled
// away: 26 % of the time at SwinV2-B's widths on an H100)
template <bool kFull>
__global__ void __launch_bounds__(kV2Threads, 2)
    swinv2_attn_kernel(V2AttnArgs a, const __grid_constant__ V2Maps maps) {
  // [the warps' rings][q, k, v][the rings' mbarriers]
  extern __shared__ __align__(1024) uint8_t v2_smem[];
  const int tid = threadIdx.x, lane = tid & 31, t = lane & 3, warp = tid >> 5;
  const int row0 = warp * 16 + (lane >> 2);   // first row of a tile's accumulator
  const long long z = blockIdx.x, w = z / a.heads;
  const int h = (int)(z - w * a.heads), n = kFull ? kMaxN : a.n, wi = (int)(w % a.n_mask);
  const long long ld = 3LL * a.C, m0 = w * n;
  const float* rel = a.rel + (long long)h * n * n;
  const float* mask = a.mask ? a.mask + (long long)wi * n * n : nullptr;
  uint8_t* ring = v2_smem + warp * kV2WarpRing;
  uint8_t* qkv_s = v2_smem + 4 * kV2WarpRing;
  const uint32_t bar0 = sm90::smem_u32(qkv_s + 3 * kV2Part) + warp * kV2Stages * 8;
  if (lane == 0) {
    for (int s = 0; s < kV2Stages; ++s) sm90::mbar_init(bar0 + 8 * s, 32);
    sm90::fence_barrier_init();
  }
  __syncwarp();
  // the warp's bias chunks in order (tile, chunk), nch chunks a tile; the
  // tiles in an order rotated by the window, so that the blocks in flight
  // read different rows of the bias
  const int nch = (n + kV2Keys - 1) / kV2Keys, ntiles = (n + 63) / 64, nq = ntiles * nch;
  const int rot = (int)(w % ntiles);
  auto tile_row = [&](int i) { return (i + rot) % ntiles * 64; };
  auto issue = [&](int q) {
    if (q >= nq) return;
    const int s = q % kV2Stages, r0 = tile_row(q / nch) + warp * 16, c = q % nch;
    uint8_t* st = ring + s * kV2BiasStage;
    const uint32_t bar = bar0 + 8 * s;
    if (maps.tma) {
      if (lane == 0) {
        sm90::fence_proxy_async();
        sm90::mbar_expect_tx_only(bar, mask ? 2 * kV2BiasMat : kV2BiasMat);
        sm90::tma_load_2d(sm90::smem_u32(st), &maps.rel, c * kV2Keys, h * n + r0, bar);
        if (mask)
          sm90::tma_load_2d(sm90::smem_u32(st + kV2BiasMat), &maps.mask, c * kV2Keys,
                            wi * n + r0, bar);
      }
      sm90::mbar_arrive(bar);
    } else {
      v2_stage_bias(st, rel, mask, n, r0, c, lane);
      sm90::cp_async_mbar_arrive(bar);
    }
  };
  // q, k, v: [part][chunk][row] 16-byte units, zeros past the window
  for (int i = tid; i < 3 * 4 * kMaxN; i += kV2Threads) {
    const int part = i / (4 * kMaxN), r = (i >> 2) & (kMaxN - 1), c = i & 3;
    uint8_t* d = qkv_s + part * kV2Part + c * kV2Chunk + r * 16;
    if (r < n)
      cp_async16(d, a.qkv + (m0 + r) * ld + part * a.C + h * kV2Hd + c * 8);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
  }
  cp_async_commit();
#pragma unroll
  for (int q = 0; q < kV2Stages; ++q) issue(q);
  cp_async_wait<0>();
  __syncthreads();
  // q <- q / max(|q|, eps) * exp(min(tau_h, ln 100)), k <- k / max(|k|, eps)
  const float scale = logit_scale(a.tau, h);
  for (int i = tid; i < 2 * kMaxN; i += kV2Threads) {
    const int part = i / kMaxN, r = i & (kMaxN - 1);
    if (r >= n) continue;
    uint8_t* row = qkv_s + part * kV2Part + r * 16;
    uint4 u[4], o[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) u[c] = *reinterpret_cast<const uint4*>(row + c * kV2Chunk);
    const bf16* x = reinterpret_cast<const bf16*>(u);
    bf16* y = reinterpret_cast<bf16*>(o);
    float ss = 0.0f;
#pragma unroll
    for (int e = 0; e < kV2Hd; ++e) {
      const float v = to_f(x[e]);
      ss += v * v;
    }
    const float den = fmaxf(sqrtf(ss), kNormEps), g = part == 0 ? scale : 1.0f;
#pragma unroll
    for (int e = 0; e < kV2Hd; ++e) y[e] = from_f<bf16>(to_f(x[e]) / den * g);
#pragma unroll
    for (int c = 0; c < 4; ++c) *reinterpret_cast<uint4*>(row + c * kV2Chunk) = o[c];
    if (a.raw) {
      const long long col = part * a.C + h * kV2Hd;
      uint4* dq = reinterpret_cast<uint4*>(a.qkv + (m0 + r) * ld + col);
      uint4* dr = reinterpret_cast<uint4*>(a.raw + (m0 + r) * 2LL * a.C + col);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dr[c] = u[c];
        dq[c] = o[c];
      }
    }
  }
  sm90::fence_proxy_async();   // q', k' in place, visible to wgmma
  __syncthreads();
  const uint32_t sq = sm90::smem_u32(qkv_s), sk = sq + kV2Part, sv = sk + kV2Part;
  const bool two = n > 128;   // keys in both halves
  int q = 0;                  // the next bias chunk to consume
  for (int it = 0; it < ntiles; ++it) {
    const int q0 = tile_row(it);
    float s[2][64];   // keys 0-127 and 128-255 of rows row0, row0 + 8
    sm90::wgmma_fence();
#pragma unroll
    for (int hk = 0; hk < 2; ++hk) {
      if (hk == 1 && !two) break;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
        sm90::wgmma_ss_n128<0, 0>(
            s[hk], sm90::make_desc(sq + q0 * 16 + kk * 2 * kV2Chunk, kV2Chunk, 128),
            sm90::make_desc(sk + hk * 128 * 16 + kk * 2 * kV2Chunk, kV2Chunk, 128), kk);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait0();
    // the logits, chunk by chunk as the warp's bias lands: -inf past the
    // window's keys, 0 on rows past its queries; acc * 1 + rel (+ mask) as
    // Bias::logit adds them
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int c = 0; c < kMaxN / kV2Keys; ++c) {
      if (c < nch) sm90::mbar_wait(bar0 + 8 * (q % kV2Stages), (q / kV2Stages) & 1);
      const uint8_t* st = ring + (q % kV2Stages) * kV2BiasStage;
#pragma unroll
      for (int jj = 0; jj < kV2Keys / 8; ++jj)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = (lane >> 2) + 8 * hf, qi = q0 + row0 + 8 * hf;
          const int kj = c * kV2Keys + jj * 8 + 2 * t;
          float* v = &s[c >> 2][4 * ((c & 3) * 4 + jj) + 2 * hf];
          if (kj >= n) {
            v[0] = v[1] = -INFINITY;
          } else if (qi >= n) {
            v[0] = 0.0f;
            v[1] = kj + 1 < n ? 0.0f : -INFINITY;
          } else {
            const int off = r * kV2BiasRow + (((2 * jj + (t >> 1)) ^ (r & 7)) << 4) + (t & 1) * 8;
            const float2 b = *reinterpret_cast<const float2*>(st + off);
            float v0 = v[0] * 1.0f + b.x, v1 = v[1] * 1.0f + b.y;
            if (mask) {
              const float2 m = *reinterpret_cast<const float2*>(st + kV2BiasMat + off);
              v0 += m.x;
              v1 += m.y;
            }
            v[0] = v0;
            v[1] = kj + 1 < n ? v1 : -INFINITY;
          }
          mx[hf] = fmaxf(mx[hf], fmaxf(v[0], v[1]));
        }
      if (c < nch) {
        __syncwarp();   // every lane has read the stage
        issue(q + kV2Stages);
        ++q;
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) mx[hf] = quad_max(mx[hf]);
    // e = exp(s - max) in place, once a logit; the row sums in
    // attn_fwd_kernel's order (eight partial sums over 64-key chunks)
    float part[2][8];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int j = 0; j < 8; ++j) part[hf][j] = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c >= 2 && !two) break;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& v = s[c >> 1][4 * ((c & 1) * 8 + j) + 2 * hf + e];
            v = expf(v - mx[hf]);
            part[hf][j] += v;
          }
    }
    float sum[2], inv[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      sum[hf] = quad_sum(sum8(part[hf]));
      inv[hf] = 1.0f / sum[hf];
    }
    // p = e / sum (as e times the row's 1 / sum) in bf16, the A operand of
    // p @ v, 16 keys a step
    float o[16];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      if (kk >= 8 && !two) break;
      const float* e0 = &s[kk >> 3][8 * (kk & 7)];
      const uint32_t fa[4] = {pack_bf16(e0[0] * inv[0], e0[1] * inv[0]),
                              pack_bf16(e0[2] * inv[1], e0[3] * inv[1]),
                              pack_bf16(e0[4] * inv[0], e0[5] * inv[0]),
                              pack_bf16(e0[6] * inv[1], e0[7] * inv[1])};
      sm90::wgmma_rs_n32<1>(o, fa, sm90::make_desc(sv + kk * 256, 128, kV2Chunk), kk);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait0();
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int qi = q0 + row0 + 8 * hf;
      if (qi >= n) continue;
      uint32_t* dst = reinterpret_cast<uint32_t*>(a.out + (m0 + qi) * a.C + h * kV2Hd + 2 * t);
#pragma unroll
      for (int j = 0; j < 4; ++j) dst[4 * j] = pack_bf16(o[4 * j + 2 * hf], o[4 * j + 2 * hf + 1]);
      if (a.stats && t == 0) {
        a.stats[(z * n + qi) * 2] = mx[hf];
        a.stats[(z * n + qi) * 2 + 1] = sum[hf];
      }
    }
  }
}

// A post-norm residual: out[row(m)] = res[row(m)] + dp[sample, dp_col] *
// (LN(y[m]) * s + b), y in T (window order), statistics in f32; a warp a row
struct PostNormArgs {
  const void* y;
  const float *s, *b;
  Src res;            // T
  Out out;
  const float* dp;    // [B, 2]
  int dp_col;
  long long M;
  int C;
  float eps;
  Geom g;
};

template <typename T>
__global__ void __launch_bounds__(kRowThreads) postnorm_kernel(PostNormArgs a) {
  const long long m = (long long)blockIdx.x * (kRowThreads / 32) + (threadIdx.x >> 5);
  if (m >= a.M) return;
  const int lane = threadIdx.x & 31, C = a.C;
  const T* y = static_cast<const T*>(a.y) + m * C;
  float s1 = 0.0f;
  for (int c = lane; c < C; c += 32) s1 += to_f(y[c]);
  const float mean = warp_sum(s1) / C;
  float s2 = 0.0f;
  for (int c = lane; c < C; c += 32) {
    const float v = to_f(y[c]) - mean;
    s2 += v * v;
  }
  const float inv = rsqrtf(warp_sum(s2) / C + a.eps);
  const long long hw = (long long)a.g.H * a.g.W, gr = a.g.grid_row(m);
  const float d = a.dp[(m / hw) * 2 + a.dp_col];
  const T* res = static_cast<const T*>(a.res.p) + (a.res.map ? gr : m) * a.res.ld;
  const long long o = (a.out.map ? gr : m) * a.out.ld;
  for (int c = lane; c < C; c += 32) {
    const float v = (to_f(y[c]) - mean) * inv * a.s[c] + a.b[c];
    store(a.out.p, o + c, to_f(res[c]) + d * v, a.out.bf);
  }
}

// The backward of postnorm_kernel, `rows` rows a block: with g = dL/dout =
// g1[row(m)] + g2[m] and u = dp[sample, dp_col] * g,
//   dy[m] = inv * (u*s - mean(u*s) - yhat * mean(u*s*yhat))   (T)
// and g into gout (f32) where given; per block, the column sums of u * yhat
// and u (the LayerNorm's scale and shift) and of dy (the bias of the
// product before it), rows in order
struct PostNormBwdArgs {
  const void* y;      // T [M, C], window order
  const float* s;
  const void* g1;     // T [M, C]
  int g1_map;
  const float* g2;    // f32 [M, C] or null
  void* dy;           // T [M, C]
  float* gout;        // f32 [M, C] or null
  const float* dp;
  int dp_col;
  float *ps, *pb, *py;   // [blocks, C]
  long long M;
  int C, rows;
  float eps;
  Geom g;
};

template <typename T>
__global__ void __launch_bounds__(kRowThreads) postnorm_bwd_kernel(PostNormBwdArgs a) {
  __shared__ float m1s[kRowsPerBlock], m2s[kRowsPerBlock], means[kRowsPerBlock],
      invs[kRowsPerBlock], dps[kRowsPerBlock];
  __shared__ long long grows[kRowsPerBlock];
  const long long r0 = (long long)blockIdx.x * a.rows;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, C = a.C;
  const T* y = static_cast<const T*>(a.y);
  const T* g1 = static_cast<const T*>(a.g1);
  const long long hw = (long long)a.g.H * a.g.W;
  for (int r = warp; r < a.rows; r += kRowThreads / 32) {
    const long long m = r0 + r;
    float mean = 0.0f, inv = 0.0f, m1 = 0.0f, m2 = 0.0f, d = 0.0f;
    long long gr = 0;
    if (m < a.M) {
      gr = a.g1_map ? a.g.grid_row(m) : m;
      d = a.dp[(m / hw) * 2 + a.dp_col];
      const T* yr = y + m * C;
      float s1 = 0.0f;
      for (int c = lane; c < C; c += 32) s1 += to_f(yr[c]);
      mean = warp_sum(s1) / C;
      float s2 = 0.0f;
      for (int c = lane; c < C; c += 32) {
        const float v = to_f(yr[c]) - mean;
        s2 += v * v;
      }
      inv = rsqrtf(warp_sum(s2) / C + a.eps);
      for (int c = lane; c < C; c += 32) {
        const float yhat = (to_f(yr[c]) - mean) * inv;
        const float g = to_f(g1[gr * C + c]) + (a.g2 ? a.g2[m * C + c] : 0.0f);
        const float us = d * g * a.s[c];
        m1 += us;
        m2 += us * yhat;
      }
      m1 = warp_sum(m1) / C;
      m2 = warp_sum(m2) / C;
    }
    if (lane == 0) {
      m1s[r] = m1;
      m2s[r] = m2;
      means[r] = mean;
      invs[r] = inv;
      dps[r] = d;
      grows[r] = gr;
    }
  }
  __syncthreads();
  for (int c = tid; c < C; c += kRowThreads) {
    float ss = 0.0f, sb = 0.0f, sy = 0.0f;
    const float sc = a.s[c];
    for (int r = 0; r < a.rows; ++r) {
      const long long m = r0 + r;
      if (m >= a.M) break;
      const float yhat = (to_f(y[m * C + c]) - means[r]) * invs[r];
      const float g = to_f(g1[grows[r] * C + c]) + (a.g2 ? a.g2[m * C + c] : 0.0f);
      const float u = dps[r] * g;
      const float dv = invs[r] * (u * sc - m1s[r] - yhat * m2s[r]);
      static_cast<T*>(a.dy)[m * C + c] = from_f<T>(dv);
      if (a.gout) a.gout[m * C + c] = g;
      ss += u * yhat;
      sb += u;
      sy += dv;
    }
    const long long o = (long long)blockIdx.x * C + c;
    a.ps[o] = ss;
    a.pb[o] = sb;
    a.py[o] = sy;
  }
}

// out[grid_row(m)] = x[m] + y[m]: f32 [M, C] in window order, summed in
// f32 and rounded to T once (the block backward's dx)
template <typename T>
__global__ void __launch_bounds__(kRowThreads) add_rows_kernel(const float* x, const float* y,
                                                               T* out, long long M, int C,
                                                               Geom g) {
  const long long i = (long long)blockIdx.x * kRowThreads + threadIdx.x;
  if (i >= M * C) return;
  const long long m = i / C;
  out[(long long)g.grid_row(m) * C + (i - m * C)] = from_f<T>(x[i] + y[i]);
}

// ------------------------------------------------------------ host side

struct Dims {
  int B, H, W, C, heads, ws, hidden, n, hd, nW, np, hdp;
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
  d.np = (d.n + 15) / 16 * 16;
  d.hdp = (d.hd + 15) / 16 * 16;
  d.M = (long long)B * H * W;
  d.BW = (long long)B * d.nW;
  d.Z = d.BW * heads;
  return d;
}

Geom geom(const Dims& d) { return {d.H, d.W, d.ws}; }

int valid(int B, int H, int W, int C, int heads, int ws, int hidden) {
  if (B < 1 || ws < 1 || heads < 1 || C < 1 || hidden < 1) return 0;
  if (H % ws || W % ws || C % heads || ws * ws > kMaxN) return 0;
  if (C / heads > kMaxHeadDim || C > kMaxC || hidden > kMaxHidden) return 0;
  if ((long long)B * H * W * std::max(3 * C, hidden) >= (1LL << 31)) return 0;
  return 1;
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
  float* f32(long long n) { return static_cast<float*>(take(n * 4)); }
};

enum Kind {
  kBlockFwd = 0,
  kBlockBwd = 1,
  kAttnFwd = 2,
  kAttnBwd = 3,
  kBlockFwdV2 = 4,   // SwinV2's block
  kBlockBwdV2 = 5
};

// The forward attention's grid: a block holds qt strips of 16 queries, each
// by kp parts of the keys (a warp each, qt kp <= 4). Strips a block are
// halved (and the keys split in their place) while the grid has fewer than
// kAttnBlocks blocks; a part keeps 16 keys or more, and a window of 16
// tokens or fewer keeps one part and four strips a block (one of them
// used). A pure function of the widths, held against
// ops/window_attention.py::attention_plan.
constexpr long long kAttnBlocks = 264;   // two waves of 132 SMs
struct AttnPlan {
  int qt, kp;
};

AttnPlan attn_plan(const Dims& d) {
  const int tiles = d.np / 16;
  int qt = 4;
  while (qt > 1 && d.Z * ((tiles + qt - 1) / qt) < kAttnBlocks) qt /= 2;
  const int kp = std::min(4 / qt, tiles);
  return kp == 1 ? AttnPlan{4, 1} : AttnPlan{qt, kp};
}

// groups of windows a head in the attention backward (a block each, a
// warp per 16 keys): about 16 warps an SM in all
int bwd_groups(const Dims& d) {
  const long long per = (long long)d.heads * (d.np / 16);
  const long long g = std::max(1LL, (16 * 132 + per - 1) / per);
  return (int)std::min(d.BW, g);
}

// rows a block of the LayerNorm backward: 8 to 32, about four blocks an SM
int ln_rows(const Dims& d) {
  return (int)std::min<long long>(kRowsPerBlock, std::max<long long>(8, d.M / kTargetBlocks));
}

int row_blocks(const Dims& d) { return (int)((d.M + ln_rows(d) - 1) / ln_rows(d)); }

int tiles(long long n) { return (int)((n + 63) / 64); }

// The weight gradients of a backward (Ka, N, ones of each) and the split of
// the tokens: splits, chunk and the partials' floats.
struct AtbPlan {
  int count, Ka[kMaxProblems], N[kMaxProblems], ones[kMaxProblems];
  int splits;
  long long chunk, floats;
};

AtbPlan atb_plan(int kind, const Dims& d) {
  AtbPlan p = {};
  const int C = d.C, hid = d.hidden;
  auto add = [&](int ka, int n, int ones) {
    p.Ka[p.count] = ka;
    p.N[p.count] = n;
    p.ones[p.count] = ones;
    ++p.count;
  };
  if (kind == kBlockBwd) {
    add(hid, C, 0);      // dw2 = g1^T dz2
    add(C, hid, 0);      // dw1 = h2^T dz1
    add(C, C, 0);        // dwproj = merged^T datt
    add(C, 3 * C, 0);    // dwqkv = h1^T dqkv
  } else if (kind == kBlockBwdV2) {
    add(hid, C, 0);      // dw2 = g1^T dy2
    add(C, hid, 0);      // dw1 = r1^T dz1
    add(C, C, 0);        // dwproj = merged^T dy1
    add(C, 3 * C, 1);    // dwqkv = x^T dqkv, and dbqkv
  } else {
    add(C, C, 1);        // dwproj = merged^T dy, and dbproj
    add(C, 3 * C, 0);    // dwqkv = x^T dqkv
  }
  long long t = 0, per_split = 0;
  for (int i = 0; i < p.count; ++i) {
    t += (long long)tiles(p.Ka[i] + p.ones[i]) * tiles(p.N[i]);
    per_split += (long long)(p.Ka[i] + p.ones[i]) * p.N[i];
  }
  long long s = (kTargetBlocks + t - 1) / t;
  s = std::min(s, std::max(1LL, d.M / 256));
  s = std::min(s, 128LL);
  const long long chunk = ((d.M + s - 1) / s + 31) / 32 * 32;
  p.chunk = chunk;
  p.splits = (int)((d.M + chunk - 1) / chunk);
  p.floats = p.splits * per_split;
  return p;
}

// The intermediates of one launch, carved from its scratch.
struct Buffers {
  void *qkv, *merged, *r1, *g1, *h1, *h2, *dz2, *dz1, *datt, *dmerged, *dqkv;   // T
  float *stats1, *stats2, *astats, *z1, *dh, *dr1;
  float *p_atb, *p_db1, *p_ln2, *p_ln1, *p_drel, *p_dbqkv;
  void *qkraw, *y1, *y2, *dy1, *dy2;   // SwinV2's (T)
  float* p_tau;
};

void layout_v2(int kind, const Dims& d, int bf, Carver& cv, Buffers& b);

void layout(int kind, const Dims& d, int bf, Carver& cv, Buffers& b) {
  if (kind == kBlockFwdV2 || kind == kBlockBwdV2) return layout_v2(kind, d, bf, cv, b);
  b = Buffers();
  const long long es = bf ? 2 : 4, M = d.M, C = d.C, hid = d.hidden;
  const bool block = kind == kBlockFwd || kind == kBlockBwd;
  const bool bwd = kind == kBlockBwd || kind == kAttnBwd;
  b.qkv = cv.take(3 * M * C * es);
  b.merged = cv.take(M * C * es);
  if (block) {
    b.r1 = cv.take(M * C * es);
    b.g1 = cv.take(M * hid * es);
  }
  if (!bwd) return;
  const int G = bwd_groups(d);
  b.astats = cv.f32(2 * d.Z * d.n);
  b.dmerged = cv.take(M * C * es);   // in the backward products' type (K4: bf16)
  b.dqkv = cv.take(3 * M * C * es);
  b.p_atb = cv.f32(atb_plan(kind, d).floats);
  b.p_drel = cv.f32((long long)G * d.heads * d.n * d.n);
  b.p_dbqkv = cv.f32((long long)G * 3 * C);
  if (kind != kBlockBwd) return;
  const long long nrb = row_blocks(d);
  b.h1 = cv.take(M * C * es);
  b.h2 = cv.take(M * C * es);
  b.dz2 = cv.take(M * C * es);
  b.dz1 = cv.take(M * hid * es);
  b.datt = cv.take(M * C * es);
  b.stats1 = cv.f32(2 * M);
  b.stats2 = cv.f32(2 * M);
  b.z1 = cv.f32(M * hid);
  b.dh = cv.f32(M * C);
  b.dr1 = cv.f32(M * C);
  b.p_db1 = cv.f32((long long)tiles(M) * hid);
  b.p_ln2 = cv.f32(4 * nrb * C);
  b.p_ln1 = cv.f32(2 * nrb * C);
}

#define TRY(call)                         \
  do {                                    \
    cudaError_t err_ = (call);            \
    if (err_ != cudaSuccess) return err_; \
  } while (0)

int vec_ok(const void* p, long long ld, int es) {
  return ((uintptr_t)p % 16 == 0) && ((ld * es) % 16 == 0);
}

template <typename T>
Src src_of(const void* p, long long ld, int map = 0) {
  return {p, ld, map, vec_ok(p, ld, (int)sizeof(T))};
}

GemmArgs gemm_args(const Dims& d, int M, int N, int K) {
  GemmArgs g = {};
  g.M = M;
  g.N = N;
  g.K = K;
  g.eps = 1e-5f;
  g.g = geom(d);
  return g;
}

// The backward's products (BT) take operands rounded to bf16: in f32 the RB
// kernel. The forward's products round nothing.
template <typename T, bool BT, bool XF>
cudaError_t launch_gemm(const GemmArgs& g, cudaStream_t st) {
  const long long blocks = (long long)tiles(g.M) * tiles(g.N);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  gemm_kernel<T, BT, XF, sizeof(T) == 4 && BT><<<(unsigned)blocks, kThreads, 0, st>>>(g);
  ++g_launches;
  return cudaGetLastError();
}

// A product kernel over 128-row tiles of C, bn columns each
template <typename K>
cudaError_t launch_product(K kernel, int smem, int bn, const GemmArgs& g, cudaStream_t st) {
  const long long blocks =
      (long long)((g.M + kProdBM - 1) / kProdBM) * ((g.N + bn - 1) / bn);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  kernel<<<(unsigned)blocks, kProdThreads, smem, st>>>(g);
  ++g_launches;
  return cudaGetLastError();
}

// A plain product C = A @ B + bias (no transform or row map of A): bf16 on
// gemm_sm90_kernel (BN 64 for N up to 64, else 128), f32 on
// gemm_tf32x3_kernel
template <typename T>
cudaError_t launch_plain_product(const GemmArgs& g, cudaStream_t st) {
  if (g.xf || g.epi != kStore || g.a.map) return cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 4)
    return launch_product(gemm_tf32x3_kernel, Tf32Tile::kSmem, Tf32Tile::kBN, g, st);
  else if (g.N <= 64)
    return launch_product(gemm_sm90_kernel<64>, WgTile<64>::kSmem, 64, g, st);
  else
    return launch_product(gemm_sm90_kernel<128>, WgTile<128>::kSmem, 128, g, st);
}

// fwd_product_kernel's dynamic shared memory: the ring and B's halves, and
// with a LayerNorm its scale and shift (K rounded up to a stage)
int fwd_smem_bytes(long long K, int ln) {
  return FwdTile::kSmem + (ln ? 2 * (int)((K + kFwdBK - 1) / kFwdBK) * kFwdBK * 4 : 0);
}

// libcuda's cuTensorMapEncodeTiled (the CUDA runtime has loaded libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A tensor map of the f32 matrix s (rows x cols) in boxes of box_rows x
// box_cols, zero past its edges: 1 when encoded; 0 where its rows allow no
// tensor-map copy (a row stride or address that is no multiple of 16 bytes:
// its stages go by element copies); -1 where they allow one but libcuda has
// no encoder or refuses the map, which the launch reports rather than fall
// back to element copies a stage cannot be fed by.
int f32_map(CUtensorMap* m, const Src& s, long long rows, long long cols, int box_rows,
            int box_cols) {
  if (!s.vec) return 0;
  const EncodeTiled enc = encode_tiled();
  if (!enc) return -1;
  const cuuint64_t dim[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)s.ld * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return enc(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(s.p), dim, stride, box,
             step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 1
             : -1;
}

// A forward product in f32 on fwd_product_kernel. A is read in its own row
// order (no map).
cudaError_t launch_fwd(const GemmArgs& g, cudaStream_t st) {
  if (g.a.map || g.xf == kRowScale || g.epi == kDGelu || g.colsum || g.c.bf)
    return cudaErrorInvalidValue;
  const int smem = fwd_smem_bytes(g.K, g.xf == kLayerNorm);
  const long long blocks =
      (long long)((g.M + kFwdBM - 1) / kFwdBM) * ((g.N + kFwdBN - 1) / kFwdBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  FwdMaps maps;
  maps.ta = f32_map(&maps.a, g.a, g.M, g.K, kFwdBM, kFwdBK);
  maps.tb = f32_map(&maps.b, g.b, g.K, g.N, kFwdBK, kFwdBN);
  if (maps.ta < 0 || maps.tb < 0) return cudaErrorNotSupported;
  TRY(cudaFuncSetAttribute(fwd_product_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem));
  fwd_product_kernel<<<(unsigned)blocks, kFwdThreads, smem, st>>>(g, maps);
  ++g_launches;
  ++g_fwd_launches;
  return cudaGetLastError();
}

// The weight gradients, on operands rounded to bf16 (in f32 the RB kernel)
template <typename T>
cudaError_t launch_atb(const Dims& d, int kind, const Src* a, const Src* b, float* partial,
                       cudaStream_t st, AtbPlan* plan_out) {
  const AtbPlan plan = atb_plan(kind, d);
  AtbArgs g = {};
  g.count = plan.count;
  g.splits = plan.splits;
  g.R = d.M;
  g.chunk = plan.chunk;
  g.g = geom(d);
  long long blocks = 0;
  float* at = partial;
  for (int i = 0; i < plan.count; ++i) {
    AtbProblem& p = g.p[i];
    p.a = a[i];
    p.b = b[i];
    p.Ka = plan.Ka[i];
    p.N = plan.N[i];
    p.ones = plan.ones[i];
    p.partial = at;
    p.tiles_n = tiles(p.N);
    p.blocks = tiles(p.Ka + p.ones) * p.tiles_n * plan.splits;
    blocks += p.blocks;
    at += (long long)plan.splits * (p.Ka + p.ones) * p.N;
  }
  *plan_out = plan;
  atb_kernel<T, sizeof(T) == 4><<<(unsigned)blocks, kThreads, 0, st>>>(g);
  ++g_launches;
  return cudaGetLastError();
}

cudaError_t launch_reduce(ReduceArgs& r, cudaStream_t st) {
  long long blocks = 0;
  for (int i = 0; i < r.count; ++i) {
    const int cols = kReduceThreads / r.e[i].ways;
    r.blocks[i] = (int)((r.e[i].len + cols - 1) / cols);
    blocks += r.blocks[i];
  }
  reduce_kernel<<<(unsigned)blocks, kReduceThreads, 0, st>>>(r);
  ++g_launches;
  return cudaGetLastError();
}

void add_entry(ReduceArgs& r, const float* src, long long stride, int count, long long len,
               float* dst) {
  ReduceEntry& e = r.e[r.count++];
  e.src = src;
  e.stride = stride;
  e.count = count;
  e.len = len;
  e.dst = dst;
  // one thread an element for a few splits, up to eight for many
  e.ways = 1;
  while (e.ways < kReduceMaxWays && count >= 16 * e.ways) e.ways *= 2;
}

// The entries of the weight gradients' partials (plan order), their bias
// rows where `ones`.
void add_atb_entries(ReduceArgs& r, const AtbPlan& plan, const float* partial, float* const* dw,
                     float* const* db) {
  const float* at = partial;
  for (int i = 0; i < plan.count; ++i) {
    const long long rows = plan.Ka[i] + plan.ones[i], len = (long long)plan.Ka[i] * plan.N[i];
    add_entry(r, at, rows * plan.N[i], plan.splits, len, dw[i]);
    if (plan.ones[i]) add_entry(r, at + len, rows * plan.N[i], plan.splits, plan.N[i], db[i]);
    at += plan.splits * rows * plan.N[i];
  }
}

// attn_fwd_kernel<T>: k and v whole, and per warp its queries and p tile;
// with parts of the keys, their row statistics and p @ v in f32
template <typename T>
size_t attn_smem(const Dims& d, const AttnPlan& p) {
  const size_t ldh = Att<T>::ldh(d.hdp), ldp = Att<T>::ldp(), nw = (size_t)p.qt * p.kp;
  return (2 * (size_t)d.np * ldh + nw * 16 * (ldh + ldp)) * sizeof(T) +
         (p.kp > 1 ? nw * 16 * (2 + (size_t)d.hdp) * 4 : 0);
}

// attn_bwd_kernel<T, kK2>: k whole and two query tiles of q in T; v whole,
// two query tiles of dO and the ds tile in bf16; the warps' row sums, the
// row statistics and the column sums in f32 (at most 132,096 bytes: np
// 256, hdp 64 in f32)
template <typename T>
size_t bwd_smem(const Dims& d) {
  using P = bf16;
  const size_t ldq = Att<T>::ldh(d.hdp), ldv = Att<P>::ldh(d.hdp);
  const size_t lds = d.np + Att<P>::kPad, nw = d.np / 16;
  return ((size_t)d.np + 32) * ldq * sizeof(T) +
         (((size_t)d.np + 32) * ldv + 16 * lds) * sizeof(P) +
         (16 * nw + 2 * (size_t)d.np + 3 * (size_t)d.hdp) * 4;
}

// cosine: SwinV2's attention, q and k normalised beforehand and q scaled
// per head (qk_norm_kernel), so the logits take no scale here
template <typename T>
AttnArgs attn_args(const Dims& d, const void* qkv, const float* rel, const float* mask,
                   bool cosine = false) {
  AttnArgs a = {};
  a.qkv = qkv;
  a.rel = rel;
  a.mask = mask;
  a.n_mask = d.nW;
  a.BW = d.BW;
  a.groups = bwd_groups(d);
  a.n = d.n;
  a.np = d.np;
  a.hd = d.hd;
  a.hdp = d.hdp;
  a.heads = d.heads;
  a.C = d.C;
  a.scale = cosine ? 1.0f : 1.0f / sqrtf((float)d.hd);
  a.vec = (d.hd * (int)sizeof(T)) % 16 == 0;
  return a;
}

// merged = attention(qkv); the softmax's row statistics into stats where given
template <typename T>
cudaError_t attention_fwd(const Dims& d, const void* qkv, const float* rel, const float* mask,
                          void* merged, float* stats, cudaStream_t st, bool cosine = false) {
  AttnArgs a = attn_args<T>(d, qkv, rel, mask, cosine);
  const AttnPlan p = attn_plan(d);
  const AttnSplit sp = {p.qt, p.kp, (d.np / 16 + p.kp - 1) / p.kp * 16};
  a.out = merged;
  a.stats = stats;
  a.sgroups = (d.np / 16 + p.qt - 1) / p.qt;
  const size_t smem = attn_smem<T>(d, p);
  // one chunk: the logits of a part of at most 64 keys in registers
  auto kernel = p.kp == 1 ? (sp.kpart <= kChunk ? attn_fwd_kernel<T, 1, false>
                                                : attn_fwd_kernel<T, kMaxN / kChunk, false>)
                          : (sp.kpart <= kChunk ? attn_fwd_kernel<T, 1, true>
                                                : attn_fwd_kernel<T, kMaxN / kChunk, true>);
  if (smem > 48 * 1024)
    TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  kernel<<<(unsigned)(d.Z * a.sgroups), 32 * p.qt * p.kp, smem, st>>>(a, sp);
  ++g_launches;
  return cudaGetLastError();
}

// dqkv from dout, with the rel-pos and qkv-bias partials, in one launch:
// K2 (kK2) with its products' operands rounded to T, K4 to bf16
template <typename T, bool kK2>
cudaError_t attention_bwd(const Dims& d, const void* qkv, const float* rel, const float* mask,
                          const Buffers& b, cudaStream_t st, bool cosine = false) {
  AttnArgs a = attn_args<T>(d, qkv, rel, mask, cosine);
  a.dout = b.dmerged;
  a.out = b.dqkv;
  a.stats = b.astats;
  a.drel = b.p_drel;
  a.dbias = b.p_dbqkv;
  const size_t smem = bwd_smem<T>(d);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = attn_bwd_kernel<T, kK2>;
  if (smem > 48 * 1024)
    TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  kernel<<<(unsigned)((long long)a.groups * d.heads), 32 * (d.np / 16), smem, st>>>(a);
  ++g_launches;
  return cudaGetLastError();
}

struct BlockParams {
  const void *x, *wqkv, *bqkv, *wproj, *bproj, *w1, *w2;
  const float *rel, *ln1s, *ln1b, *ln2s, *ln2b, *b1, *b2, *mask, *dp;
  float eps;
};

// The four products of a block's forward
enum FwdProduct { kQkv = 0, kProj = 1, kFc1 = 2, kFc2 = 3 };

// The arguments of product `which` of a block's forward; `save` keeps what
// the backward needs (the LayerNorm statistics and outputs, z1)
template <typename T>
GemmArgs fwd_args(const Dims& d, int which, const BlockParams& w, bool save, void* out,
                  const Buffers& b) {
  const int M = (int)d.M, C = d.C, hid = d.hidden, bf = sizeof(T) == 2;
  GemmArgs g;
  if (which == kQkv) {   // qkv = LN1(x) @ wqkv + bqkv
    // in f32 over x's rows in grid order, each stored at its window-order
    // row (with its statistics and LN1(x)); in bf16 over the window-order
    // rows, read at their grid rows
    const bool f32 = sizeof(T) == 4;
    g = gemm_args(d, M, 3 * C, C);
    g.a = src_of<T>(w.x, C, f32 ? 0 : 1);
    g.b = src_of<T>(w.wqkv, 3 * C);
    g.xf = kLayerNorm;
    g.ln_s = w.ln1s;
    g.ln_b = w.ln1b;
    g.eps = w.eps;
    g.stats = save ? b.stats1 : nullptr;
    g.side = save ? b.h1 : nullptr;
    g.c = {b.qkv, 3LL * C, bf, f32 ? kToWindow : 0};
    g.bias = w.bqkv;
    g.bias_bf = bf;
  } else if (which == kProj) {   // r1 = x + dp1 * (merged @ wproj + bproj)
    g = gemm_args(d, M, C, C);
    g.a = src_of<T>(b.merged, C);
    g.b = src_of<T>(w.wproj, C);
    g.epi = kResid;
    g.res = src_of<T>(w.x, C, 1);
    g.dp = w.dp;
    g.dp_col = 0;
    g.c = {b.r1, C, bf, 0};
    g.bias = w.bproj;
    g.bias_bf = bf;
  } else if (which == kFc1) {   // g1 = gelu(LN2(r1) @ w1 + b1)
    g = gemm_args(d, M, hid, C);
    g.a = src_of<T>(b.r1, C);
    g.b = src_of<T>(w.w1, hid);
    g.xf = kLayerNorm;
    g.ln_s = w.ln2s;
    g.ln_b = w.ln2b;
    g.eps = w.eps;
    g.stats = save ? b.stats2 : nullptr;
    g.side = save ? b.h2 : nullptr;
    g.epi = kGelu;
    g.aux = save ? b.z1 : nullptr;
    g.c = {b.g1, hid, bf, 0};
    g.bias = w.b1;
  } else {   // out = r1 + dp2 * (g1 @ w2 + b2), at the grid rows
    g = gemm_args(d, M, C, hid);
    g.a = src_of<T>(b.g1, hid);
    g.b = src_of<T>(w.w2, C);
    g.epi = kResid;
    g.res = src_of<T>(b.r1, C);
    g.dp = w.dp;
    g.dp_col = 1;
    g.c = {out, C, bf, 1};
    g.bias = w.b2;
  }
  return g;
}

// Product `which` of a block's forward: f32 on fwd_product_kernel, bf16 on
// gemm_kernel
template <typename T>
cudaError_t fwd_product(const Dims& d, int which, const BlockParams& w, bool save, void* out,
                        const Buffers& b, cudaStream_t st) {
  const GemmArgs g = fwd_args<T>(d, which, w, save, out, b);
  if constexpr (sizeof(T) == 4)
    return launch_fwd(g, st);
  else if (which == kQkv || which == kFc1)
    return launch_gemm<T, false, true>(g, st);
  else
    return launch_gemm<T, false, false>(g, st);
}

// The forward of a whole block; `save` keeps what the backward needs (the
// LayerNorm statistics and outputs, the softmax's statistics, z1), and
// without `out` it stops before the last product.
template <typename T>
cudaError_t block_forward(const Dims& d, const BlockParams& w, bool save, void* out,
                          const Buffers& b, cudaStream_t st) {
  TRY(fwd_product<T>(d, kQkv, w, save, out, b, st));
  TRY(attention_fwd<T>(d, b.qkv, w.rel, w.mask, b.merged, save ? b.astats : nullptr, st));
  TRY(fwd_product<T>(d, kProj, w, save, out, b, st));
  TRY(fwd_product<T>(d, kFc1, w, save, out, b, st));
  if (!out) return cudaSuccess;
  return fwd_product<T>(d, kFc2, w, save, out, b, st);
}

struct BlockGrads {
  float *dwqkv, *dbqkv, *dwproj, *dbproj, *drel, *dln1s, *dln1b, *dln2s, *dln2b, *dw1, *db1,
      *dw2, *db2;
};

template <typename T>
cudaError_t block_backward(const Dims& d, const BlockParams& w, const void* dy, void* dx,
                           const BlockGrads& gr, const Buffers& b, cudaStream_t st) {
  const int M = (int)d.M, C = d.C, hid = d.hidden, bf = sizeof(T) == 2;
  const int nrb = row_blocks(d);
  const Geom geo = geom(d);
  TRY(block_forward<T>(d, w, true, nullptr, b, st));
  // out = r1 + dp2 * (g1 @ w2 + b2): dz1 = (rd(dp2 * dy) @ rd(w2)^T) *
  // gelu'(z1); dz2 = dp2 * dy unrounded to the side (db2 sums it so, dw2
  // rounds it as it reads it)
  GemmArgs g = gemm_args(d, M, hid, C);
  g.a = src_of<T>(dy, C, 1);
  g.b = src_of<T>(w.w2, C);
  g.xf = kRowScale;
  g.dp = w.dp;
  g.dp_col = 1;
  g.side = b.dz2;
  g.epi = kDGelu;
  g.aux = b.z1;
  g.colsum = b.p_db1;
  g.c = {b.dz1, hid, bf, 0};
  TRY((launch_gemm<T, true, true>(g, st)));
  // dh2 = rd(dz1) @ rd(w1)^T
  g = gemm_args(d, M, C, hid);
  g.a = src_of<T>(b.dz1, hid);
  g.b = src_of<T>(w.w1, hid);
  g.c = {b.dh, C, 0, 0};
  TRY((launch_gemm<T, true, false>(g, st)));
  // dr1 = dy + LN2's backward; datt = dp1 * dr1
  LnBwdArgs l = {};
  l.d = b.dh;
  l.x = b.r1;
  l.x_map = 0;
  l.stats = b.stats2;
  l.s = w.ln2s;
  l.add = dy;
  l.add_bf = bf;
  l.add_map = 1;
  l.out = {b.dr1, C, 0, 0};
  l.out2 = b.datt;
  l.dp = w.dp;
  l.ps = b.p_ln2;
  l.pb = b.p_ln2 + (long long)nrb * C;
  l.p_res = b.p_ln2 + 2LL * nrb * C;
  l.p_add = b.p_ln2 + 3LL * nrb * C;
  l.M = d.M;
  l.C = C;
  l.rows = ln_rows(d);
  l.g = geo;
  ln_bwd_kernel<T><<<nrb, kRowThreads, 0, st>>>(l);
  ++g_launches;
  TRY(cudaGetLastError());
  // dmerged = rd(datt) @ rd(wproj)^T, stored in bf16
  g = gemm_args(d, M, C, C);
  g.a = src_of<T>(b.datt, C);
  g.b = src_of<T>(w.wproj, C);
  g.c = {b.dmerged, C, 1, 0};
  TRY((launch_gemm<T, true, false>(g, st)));
  TRY((attention_bwd<T, true>(d, b.qkv, w.rel, w.mask, b, st)));
  // dh1 = dqkv @ rd(wqkv)^T (dqkv is rounded to bf16); dx = dr1 + LN1's
  // backward
  g = gemm_args(d, M, C, 3 * C);
  g.a = src_of<T>(b.dqkv, 3 * C);
  g.b = src_of<T>(w.wqkv, 3 * C);
  g.c = {b.dh, C, 0, 0};
  TRY((launch_gemm<T, true, false>(g, st)));
  l = LnBwdArgs();
  l.d = b.dh;
  l.x = w.x;
  l.x_map = 1;
  l.stats = b.stats1;
  l.s = w.ln1s;
  l.add = b.dr1;
  l.add_bf = 0;
  l.add_map = 0;
  l.out = {dx, C, bf, 1};
  l.dp = w.dp;
  l.ps = b.p_ln1;
  l.pb = b.p_ln1 + (long long)nrb * C;
  l.M = d.M;
  l.C = C;
  l.rows = ln_rows(d);
  l.g = geo;
  ln_bwd_kernel<T><<<nrb, kRowThreads, 0, st>>>(l);
  ++g_launches;
  TRY(cudaGetLastError());
  // the weight gradients, rd(a)^T rd(b)
  const Src a[4] = {src_of<T>(b.g1, hid), src_of<T>(b.h2, C), src_of<T>(b.merged, C),
                    src_of<T>(b.h1, C)};
  const Src bb[4] = {src_of<T>(b.dz2, C), src_of<T>(b.dz1, hid), src_of<T>(b.datt, C),
                     src_of<T>(b.dqkv, 3 * C)};
  AtbPlan plan;
  TRY(launch_atb<T>(d, kBlockBwd, a, bb, b.p_atb, st, &plan));
  ReduceArgs r = {};
  float* const dw[4] = {gr.dw2, gr.dw1, gr.dwproj, gr.dwqkv};
  add_atb_entries(r, plan, b.p_atb, dw, dw);
  add_entry(r, b.p_db1, hid, tiles(M), hid, gr.db1);
  const long long nc = (long long)nrb * C;
  add_entry(r, b.p_ln2, C, nrb, C, gr.dln2s);
  add_entry(r, b.p_ln2 + nc, C, nrb, C, gr.dln2b);
  add_entry(r, b.p_ln2 + 2 * nc, C, nrb, C, gr.dbproj);
  add_entry(r, b.p_ln2 + 3 * nc, C, nrb, C, gr.db2);
  add_entry(r, b.p_ln1, C, nrb, C, gr.dln1s);
  add_entry(r, b.p_ln1 + nc, C, nrb, C, gr.dln1b);
  const long long hnn = (long long)d.heads * d.n * d.n;
  add_entry(r, b.p_drel, hnn, bwd_groups(d), hnn, gr.drel);
  add_entry(r, b.p_dbqkv, 3LL * C, bwd_groups(d), 3LL * C, gr.dbqkv);
  return launch_reduce(r, st);
}

// K3's or K4's qkv = x @ wqkv + bqkv in window order: x read in grid
// order, each row stored at its window-order row
template <typename T>
cudaError_t attn_qkv(const Dims& d, const void* x, const void* wqkv, const void* bqkv,
                     const Buffers& b, cudaStream_t st) {
  GemmArgs g = gemm_args(d, (int)d.M, 3 * d.C, d.C);
  g.a = src_of<T>(x, d.C);
  g.b = src_of<T>(wqkv, 3 * d.C);
  g.c = {b.qkv, 3LL * d.C, sizeof(T) == 2, kToWindow};
  g.bias = bqkv;
  g.bias_bf = sizeof(T) == 2;
  return launch_plain_product<T>(g, st);
}

// K3 (3 launches): qkv, the attention, the projection stored at the grid rows
template <typename T>
cudaError_t attn_forward(const Dims& d, const void* x, const void* wqkv, const void* bqkv,
                         const void* wproj, const void* bproj, const float* rel,
                         const float* mask, void* out, const Buffers& b, cudaStream_t st) {
  TRY(attn_qkv<T>(d, x, wqkv, bqkv, b, st));
  TRY(attention_fwd<T>(d, b.qkv, rel, mask, b.merged, nullptr, st));
  GemmArgs g = gemm_args(d, (int)d.M, d.C, d.C);
  g.a = src_of<T>(b.merged, d.C);
  g.b = src_of<T>(wproj, d.C);
  g.c = {out, d.C, sizeof(T) == 2, 1};
  g.bias = bproj;
  g.bias_bf = sizeof(T) == 2;
  return launch_plain_product<T>(g, st);
}

// K4 (7 launches): the forward recomputed in T (qkv, the softmax's
// statistics and the merged heads, f32 as 3xTF32), then every backward
// product on operands rounded to bf16, as the JAX kernel rounds them
// whatever the input type: in f32 by the RB products, which round f32
// operands as their fragments are read.
template <typename T>
cudaError_t attn_backward(const Dims& d, const void* x, const void* dy, const void* wqkv,
                          const void* bqkv, const void* wproj, const float* rel,
                          const float* mask, void* dx, float* dwqkv, float* dbqkv,
                          float* dwproj, float* dbproj, float* drel, const Buffers& b,
                          cudaStream_t st) {
  const int M = (int)d.M, C = d.C, bf = sizeof(T) == 2;
  TRY(attn_qkv<T>(d, x, wqkv, bqkv, b, st));
  TRY(attention_fwd<T>(d, b.qkv, rel, mask, b.merged, b.astats, st));
  // dmerged = rd(dy) @ rd(wproj)^T, stored in bf16
  GemmArgs g = gemm_args(d, M, C, C);
  g.a = src_of<T>(dy, C, 1);
  g.b = src_of<T>(wproj, C);
  g.c = {b.dmerged, C, 1, 0};
  TRY((launch_gemm<T, true, false>(g, st)));
  TRY((attention_bwd<T, false>(d, b.qkv, rel, mask, b, st)));
  // dx = dqkv @ rd(wqkv)^T, at the grid rows
  g = gemm_args(d, M, C, 3 * C);
  g.a = src_of<T>(b.dqkv, 3 * C);
  g.b = src_of<T>(wqkv, 3 * C);
  g.c = {dx, C, bf, 1};
  TRY((launch_gemm<T, true, false>(g, st)));
  // dwproj = rd(merged)^T rd(dy) (and dbproj), dwqkv = rd(x)^T dqkv
  const Src a[2] = {src_of<T>(b.merged, C), src_of<T>(x, C, 1)};
  const Src bb[2] = {src_of<T>(dy, C, 1), src_of<T>(b.dqkv, 3 * C)};
  AtbPlan plan;
  TRY(launch_atb<T>(d, kAttnBwd, a, bb, b.p_atb, st, &plan));
  ReduceArgs r = {};
  float* const dw[2] = {dwproj, dwqkv};
  float* const db[2] = {dbproj, nullptr};
  add_atb_entries(r, plan, b.p_atb, dw, db);
  const long long hnn = (long long)d.heads * d.n * d.n;
  add_entry(r, b.p_drel, hnn, bwd_groups(d), hnn, drel);
  add_entry(r, b.p_dbqkv, 3LL * C, bwd_groups(d), 3LL * C, dbqkv);
  return launch_reduce(r, st);
}

// ------------------------------------------------------------ SwinV2, host side

// (row, head) pairs a block of the normalisation and its backward
long long qk_blocks(const Dims& d) { return (d.M * d.heads + kRowThreads - 1) / kRowThreads; }

// The intermediates of SwinV2's block forward (y1 and y2 share a buffer)
// and backward
void layout_v2(int kind, const Dims& d, int bf, Carver& cv, Buffers& b) {
  b = Buffers();
  const long long es = bf ? 2 : 4, M = d.M, C = d.C, hid = d.hidden;
  b.qkv = cv.take(3 * M * C * es);
  b.merged = cv.take(M * C * es);
  b.y1 = cv.take(M * C * es);
  b.r1 = cv.take(M * C * es);
  b.g1 = cv.take(M * hid * es);
  if (kind == kBlockFwdV2) {
    b.y2 = b.y1;
    return;
  }
  const long long nrb = row_blocks(d);
  const int G = bwd_groups(d);
  b.y2 = cv.take(M * C * es);
  b.qkraw = cv.take(2 * M * C * es);
  b.astats = cv.f32(2 * d.Z * d.n);
  b.z1 = cv.f32(M * hid);
  b.dy2 = cv.take(M * C * es);
  b.dz1 = cv.take(M * hid * es);
  b.dh = cv.f32(M * C);
  b.dr1 = cv.f32(M * C);
  b.dy1 = cv.take(M * C * es);
  b.dmerged = cv.take(M * C * es);   // bf16
  b.dqkv = cv.take(3 * M * C * es);
  b.p_atb = cv.f32(atb_plan(kBlockBwdV2, d).floats);
  b.p_drel = cv.f32((long long)G * d.heads * d.n * d.n);
  // the shared attention backward writes its column sums of dq, dk, dv
  // here; SwinV2's are taken before the normalisation's backward, so not
  // the bias's gradient (the atb pass sums that), and go unread. Kept so
  // that the Swin-v1 attention kernel needs no branch to skip them
  b.p_dbqkv = cv.f32((long long)G * 3 * C);
  b.p_db1 = cv.f32((long long)tiles(M) * hid);
  b.p_ln2 = cv.f32(3 * nrb * C);
  b.p_ln1 = cv.f32(3 * nrb * C);
  b.p_tau = cv.f32(qk_blocks(d) * d.heads);
}

// Product `which` of SwinV2's block forward, none with a prologue: qkv =
// x @ wqkv + bqkv (stored in window order), y1 = merged @ wproj + bproj,
// g1 = gelu(r1 @ w1 + b1) (z1 kept where `save`), y2 = g1 @ w2 + b2; f32 on
// fwd_product_kernel, bf16 on gemm_kernel
template <typename T>
cudaError_t fwd_product_v2(const Dims& d, int which, const BlockParams& w, bool save,
                           const Buffers& b, cudaStream_t st) {
  const int M = (int)d.M, C = d.C, hid = d.hidden, bf = sizeof(T) == 2;
  const bool f32 = sizeof(T) == 4;
  GemmArgs g;
  if (which == kQkv) {   // f32: x's grid rows stored at window rows; bf16: read at them
    g = gemm_args(d, M, 3 * C, C);
    g.a = src_of<T>(w.x, C, f32 ? 0 : 1);
    g.b = src_of<T>(w.wqkv, 3 * C);
    g.c = {b.qkv, 3LL * C, bf, f32 ? kToWindow : 0};
    g.bias = w.bqkv;
    g.bias_bf = bf;
  } else if (which == kProj) {
    g = gemm_args(d, M, C, C);
    g.a = src_of<T>(b.merged, C);
    g.b = src_of<T>(w.wproj, C);
    g.c = {b.y1, C, bf, 0};
    g.bias = w.bproj;
    g.bias_bf = bf;
  } else if (which == kFc1) {
    g = gemm_args(d, M, hid, C);
    g.a = src_of<T>(b.r1, C);
    g.b = src_of<T>(w.w1, hid);
    g.epi = kGelu;
    g.aux = save ? b.z1 : nullptr;
    g.c = {b.g1, hid, bf, 0};
    g.bias = w.b1;
  } else {
    g = gemm_args(d, M, C, hid);
    g.a = src_of<T>(b.g1, hid);
    g.b = src_of<T>(w.w2, C);
    g.c = {b.y2, C, bf, 0};
    g.bias = w.b2;
  }
  if constexpr (sizeof(T) == 4)
    return launch_fwd(g, st);
  else
    return launch_gemm<T, false, false>(g, st);
}

// Whether SwinV2's attention stage runs fused (swinv2_attn_kernel): in bf16
// at head size 32, the widths it is built for; else qk_norm_kernel, then
// attn_fwd_kernel. A function of the type and widths alone.
bool v2_attn_fused(int bf, int hd) { return bf && hd == kV2Hd; }

// SwinV2's attention stage: merged = attention(normalised q, k; v) from qkv
// (window order); with raw and stats (the backward's recompute) q and k as
// they were into raw, q' and k' into qkv and the softmax's statistics into
// stats. `fused` runs swinv2_attn_kernel (bf16, v2_attn_fused widths only),
// else the two launches.
template <typename T>
cudaError_t v2_attention(const Dims& d, const float* tau, const float* rel, const float* mask,
                         void* qkv, void* raw, float* stats, void* merged, bool fused,
                         cudaStream_t st) {
  if (!fused) {
    const QkNormArgs q = {qkv, raw, tau, d.M, d.C, d.heads, d.hd};
    qk_norm_kernel<T><<<(unsigned)qk_blocks(d), kRowThreads, 0, st>>>(q);
    ++g_launches;
    TRY(cudaGetLastError());
    return attention_fwd<T>(d, qkv, rel, mask, merged, stats, st, true);
  }
  if (sizeof(T) != 2 || !v2_attn_fused(1, d.hd)) return cudaErrorInvalidValue;
  V2AttnArgs a = {};
  a.qkv = static_cast<bf16*>(qkv);
  a.raw = static_cast<bf16*>(raw);
  a.stats = stats;
  a.out = static_cast<bf16*>(merged);
  a.tau = tau;
  a.rel = rel;
  a.mask = mask;
  a.n_mask = d.nW;
  a.n = d.n;
  a.heads = d.heads;
  a.C = d.C;
  V2Maps maps = {};
  maps.tma = d.n % 4 == 0;
  if (maps.tma) {
    const EncodeTiled enc = encode_tiled();
    if (!enc) return cudaErrorNotSupported;
    const cuuint32_t box[2] = {(cuuint32_t)kV2Keys, 16}, step[2] = {1, 1};
    const cuuint64_t stride[1] = {(cuuint64_t)d.n * 4};
    const float* src[2] = {rel, mask};
    const long long rows[2] = {(long long)d.heads * d.n, (long long)d.nW * d.n};
    CUtensorMap* dst[2] = {&maps.rel, &maps.mask};
    for (int i = 0; i < 2; ++i) {
      if (!src[i]) continue;
      const cuuint64_t dim[2] = {(cuuint64_t)d.n, (cuuint64_t)rows[i]};
      if (enc(dst[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(src[i]), dim,
              stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
              CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return cudaErrorNotSupported;
    }
  }
  auto kernel = d.n == kMaxN ? swinv2_attn_kernel<true> : swinv2_attn_kernel<false>;
  TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kV2Smem));
  TRY(cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, 100));
  kernel<<<(unsigned)d.Z, kV2Threads, kV2Smem, st>>>(a, maps);
  ++g_launches;
  ++g_v2_attn_launches;
  return cudaGetLastError();
}

// out[row] = res[row] + dp[sample, col] * LN(y)
template <typename T>
cudaError_t postnorm(const Dims& d, const void* y, const float* s, const float* sh, Src res,
                     Out out, const BlockParams& w, int col, cudaStream_t st) {
  PostNormArgs a = {};
  a.y = y;
  a.s = s;
  a.b = sh;
  a.res = res;
  a.out = out;
  a.dp = w.dp;
  a.dp_col = col;
  a.M = d.M;
  a.C = d.C;
  a.eps = w.eps;
  a.g = geom(d);
  const long long rows = kRowThreads / 32;
  postnorm_kernel<T><<<(unsigned)((d.M + rows - 1) / rows), kRowThreads, 0, st>>>(a);
  ++g_launches;
  return cudaGetLastError();
}

template <typename T>
cudaError_t postnorm_bwd(const Dims& d, const void* y, const float* s, const void* g1,
                         const float* g2, void* dy, float* gout, const BlockParams& w, int col,
                         float* partial, cudaStream_t st) {
  const long long nrb = row_blocks(d), nc = nrb * d.C;
  PostNormBwdArgs a = {};
  a.y = y;
  a.s = s;
  a.g1 = g1;
  a.g1_map = 1;
  a.g2 = g2;
  a.dy = dy;
  a.gout = gout;
  a.dp = w.dp;
  a.dp_col = col;
  a.ps = partial;
  a.pb = partial + nc;
  a.py = partial + 2 * nc;
  a.M = d.M;
  a.C = d.C;
  a.rows = ln_rows(d);
  a.eps = w.eps;
  a.g = geom(d);
  postnorm_bwd_kernel<T><<<(unsigned)nrb, kRowThreads, 0, st>>>(a);
  ++g_launches;
  return cudaGetLastError();
}

// SwinV2's block forward (7 launches, 8 where the attention stage is not
// fused: v2_attn_fused): qkv, the attention stage (the normalisation of q
// and k, the attention), the projection, LN1's residual, fc1, fc2, LN2's
// residual; `save` keeps what the backward needs (q and k as they were and
// normalised, the softmax's statistics, z1), and without `out` it stops
// before the last pass.
template <typename T>
cudaError_t block_forward_v2(const Dims& d, const BlockParams& w, const float* tau, bool save,
                             void* out, const Buffers& b, cudaStream_t st) {
  const int C = d.C, bf = sizeof(T) == 2;
  TRY(fwd_product_v2<T>(d, kQkv, w, save, b, st));
  TRY(v2_attention<T>(d, tau, w.rel, w.mask, b.qkv, save ? b.qkraw : nullptr,
                      save ? b.astats : nullptr, b.merged, v2_attn_fused(bf, d.hd), st));
  TRY(fwd_product_v2<T>(d, kProj, w, save, b, st));
  // r1 = x + dp1 * LN1(y1), x read at the grid rows
  TRY(postnorm<T>(d, b.y1, w.ln1s, w.ln1b, src_of<T>(w.x, C, 1), Out{b.r1, C, bf, 0}, w, 0,
                  st));
  TRY(fwd_product_v2<T>(d, kFc1, w, save, b, st));
  TRY(fwd_product_v2<T>(d, kFc2, w, save, b, st));
  if (!out) return cudaSuccess;
  // out = r1 + dp2 * LN2(y2), at the grid rows
  return postnorm<T>(d, b.y2, w.ln2s, w.ln2b, src_of<T>(b.r1, C), Out{out, C, bf, 1}, w, 1,
                     st);
}

// SwinV2's block backward (17 launches, 18 where the attention stage is not
// fused): the forward recomputed (6 or 7), then
// every product on operands rounded to bf16 as the Swin-v1 backward's
template <typename T>
cudaError_t block_backward_v2(const Dims& d, const BlockParams& w, const float* tau,
                              const void* dy, void* dx, const BlockGrads& gr, float* dtau,
                              const Buffers& b, cudaStream_t st) {
  const int M = (int)d.M, C = d.C, hid = d.hidden, bf = sizeof(T) == 2;
  const long long nrb = row_blocks(d), nc = nrb * C;
  TRY(block_forward_v2<T>(d, w, tau, true, nullptr, b, st));
  // out = r1 + dp2 * LN2(y2): dy2 = LN2's backward of dp2 * dy
  TRY(postnorm_bwd<T>(d, b.y2, w.ln2s, dy, nullptr, b.dy2, nullptr, w, 1, b.p_ln2, st));
  // y2 = g1 @ w2 + b2: dz1 = (rd(dy2) @ rd(w2)^T) * gelu'(z1), with db1's partials
  GemmArgs g = gemm_args(d, M, hid, C);
  g.a = src_of<T>(b.dy2, C);
  g.b = src_of<T>(w.w2, C);
  g.epi = kDGelu;
  g.aux = b.z1;
  g.colsum = b.p_db1;
  g.c = {b.dz1, hid, bf, 0};
  TRY((launch_gemm<T, true, false>(g, st)));
  // dh = rd(dz1) @ rd(w1)^T
  g = gemm_args(d, M, C, hid);
  g.a = src_of<T>(b.dz1, hid);
  g.b = src_of<T>(w.w1, hid);
  g.c = {b.dh, C, 0, 0};
  TRY((launch_gemm<T, true, false>(g, st)));
  // r1 = x + dp1 * LN1(y1): dr1 = dy + dh, dy1 = LN1's backward of dp1 * dr1
  TRY(postnorm_bwd<T>(d, b.y1, w.ln1s, dy, b.dh, b.dy1, b.dr1, w, 0, b.p_ln1, st));
  // dmerged = rd(dy1) @ rd(wproj)^T, stored in bf16
  g = gemm_args(d, M, C, C);
  g.a = src_of<T>(b.dy1, C);
  g.b = src_of<T>(w.wproj, C);
  g.c = {b.dmerged, C, 1, 0};
  TRY((launch_gemm<T, true, false>(g, st)));
  TRY((attention_bwd<T, true>(d, b.qkv, w.rel, w.mask, b, st, true)));
  // dq, dk through the normalisation; dtau's partials
  const QkNormBwdArgs q = {b.qkraw, b.dqkv, tau, b.p_tau, d.M, C, d.heads, d.hd};
  qk_norm_bwd_kernel<T><<<(unsigned)qk_blocks(d), kRowThreads, 0, st>>>(q);
  ++g_launches;
  TRY(cudaGetLastError());
  // dx = dr1 + dqkv @ rd(wqkv)^T, at the grid rows
  g = gemm_args(d, M, C, 3 * C);
  g.a = src_of<T>(b.dqkv, 3 * C);
  g.b = src_of<T>(w.wqkv, 3 * C);
  g.c = {b.dh, C, 0, 0};
  TRY((launch_gemm<T, true, false>(g, st)));
  const long long n = d.M * C;
  add_rows_kernel<T><<<(unsigned)((n + kRowThreads - 1) / kRowThreads), kRowThreads, 0, st>>>(
      b.dr1, b.dh, static_cast<T*>(dx), d.M, C, geom(d));
  ++g_launches;
  TRY(cudaGetLastError());
  // the weight gradients, rd(a)^T rd(b), and dbqkv
  const Src a[4] = {src_of<T>(b.g1, hid), src_of<T>(b.r1, C), src_of<T>(b.merged, C),
                    src_of<T>(w.x, C, 1)};
  const Src bb[4] = {src_of<T>(b.dy2, C), src_of<T>(b.dz1, hid), src_of<T>(b.dy1, C),
                     src_of<T>(b.dqkv, 3 * C)};
  AtbPlan plan;
  TRY(launch_atb<T>(d, kBlockBwdV2, a, bb, b.p_atb, st, &plan));
  ReduceArgs r = {};
  float* const dw[4] = {gr.dw2, gr.dw1, gr.dwproj, gr.dwqkv};
  float* const db[4] = {nullptr, nullptr, nullptr, gr.dbqkv};
  add_atb_entries(r, plan, b.p_atb, dw, db);
  add_entry(r, b.p_db1, hid, tiles(M), hid, gr.db1);
  add_entry(r, b.p_ln2, C, (int)nrb, C, gr.dln2s);
  add_entry(r, b.p_ln2 + nc, C, (int)nrb, C, gr.dln2b);
  add_entry(r, b.p_ln2 + 2 * nc, C, (int)nrb, C, gr.db2);
  add_entry(r, b.p_ln1, C, (int)nrb, C, gr.dln1s);
  add_entry(r, b.p_ln1 + nc, C, (int)nrb, C, gr.dln1b);
  add_entry(r, b.p_ln1 + 2 * nc, C, (int)nrb, C, gr.dbproj);
  const long long hnn = (long long)d.heads * d.n * d.n;
  add_entry(r, b.p_drel, hnn, bwd_groups(d), hnn, gr.drel);
  add_entry(r, b.p_tau, d.heads, (int)qk_blocks(d), d.heads, dtau);
  return launch_reduce(r, st);
}

}  // namespace

extern "C" {

// Kernels this library has launched since it was loaded (K1 5 a call, K2 13,
// K3 3, K4 7, SwinV2's block 7 and 17, or 8 and 18 unfused).
long long window_any_launches(void) { return g_launches; }

// Of them, fwd_product_kernel's: every product of a block's forward in f32
// (4 a K1 call, 3 in a K2 call's recompute).
long long window_any_fwd_launches(void) { return g_fwd_launches; }

// Of them, swinv2_attn_kernel's: SwinV2's fused attention stage, one a block
// forward and one a backward (its recompute) in bf16 at head size 32.
long long window_any_v2_attn_launches(void) { return g_v2_attn_launches; }

// For the tests: SwinV2's attention stage alone, as swinv2_any_fwd (raw and
// stats null) or its backward's recompute (both given) runs it, on qkv (T
// [B * H * W, 3C], window order; q and k are normalised in place where raw
// is given or the two launches run), tau [heads], rel [heads, n, n], mask
// [nW, n, n] (or null), into merged (T [B * H * W, C]), raw (T [.., 2C])
// and stats ([B * nW * heads, n, 2]). `fused` 1 launches
// swinv2_attn_kernel (bf16 at head size 32 only), 0 the two launches.
// Returns the CUDA error of the first failed launch.
int swinv2_any_attn(void* qkv, const void* tau, const void* rel, const void* mask,
                    void* merged, void* raw, float* stats, int fused, int bf, int B, int H,
                    int W, int C, int heads, int ws, void* stream) {
  if (!valid(B, H, W, C, heads, ws, 1) || (raw == nullptr) != (stats == nullptr))
    return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(B, H, W, C, heads, ws, 1);
  const float* t = static_cast<const float*>(tau);
  const float* r = static_cast<const float*>(rel);
  const float* m = static_cast<const float*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf ? v2_attention<bf16>(d, t, r, m, qkv, raw, stats, merged, fused != 0, st)
                  : v2_attention<float>(d, t, r, m, qkv, raw, stats, merged, fused != 0, st));
}

// The forward attention's grid at these widths (attn_plan): the strips of 16
// queries a block into out[0], the parts of the keys into out[1]. Returns 0,
// or -1 for widths the route does not take.
int window_any_attn_plan(int B, int H, int W, int C, int heads, int ws, int* out) {
  if (!valid(B, H, W, C, heads, ws, 1)) return -1;
  const AttnPlan p = attn_plan(make_dims(B, H, W, C, heads, ws, 1));
  out[0] = p.qt;
  out[1] = p.kp;
  return 0;
}

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
  const BlockParams w = {x, wqkv, bqkv, wproj, bproj, w1, w2,
                         static_cast<const float*>(rel), static_cast<const float*>(ln1s),
                         static_cast<const float*>(ln1b), static_cast<const float*>(ln2s),
                         static_cast<const float*>(ln2b), static_cast<const float*>(b1),
                         static_cast<const float*>(b2), static_cast<const float*>(mask),
                         static_cast<const float*>(dp), eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf ? block_forward<bf16>(d, w, false, out, b, st)
                  : block_forward<float>(d, w, false, out, b, st));
}

// K2: dx (T, [B, H, W, C]) and the 13 parameter gradients (f32, zeroed by
// the caller, summed into) of the block from dy (T). The backward products
// take operands rounded to bf16 whatever T is (`rd` must be 1, as the JAX
// kernel rounds them).
int swin_any_bwd(const void* x, const void* dy, const void* wqkv, const void* bqkv,
                 const void* wproj, const void* bproj, const void* rel, const void* ln1s,
                 const void* ln1b, const void* ln2s, const void* ln2b, const void* w1,
                 const void* b1, const void* w2, const void* b2, const void* mask,
                 const void* dp, void* dx, float* dwqkv, float* dbqkv, float* dwproj,
                 float* dbproj, float* drel, float* dln1s, float* dln1b, float* dln2s,
                 float* dln2b, float* dw1, float* db1, float* dw2, float* db2,
                 void* scratch, int bf, int rd, int B, int H, int W, int C, int heads,
                 int ws, int hidden, float eps, void* stream) {
  if (!valid(B, H, W, C, heads, ws, hidden) || rd != 1) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(B, H, W, C, heads, ws, hidden);
  Carver cv = {static_cast<char*>(scratch), 0};
  Buffers b;
  layout(kBlockBwd, d, bf, cv, b);
  const BlockParams w = {x, wqkv, bqkv, wproj, bproj, w1, w2,
                         static_cast<const float*>(rel), static_cast<const float*>(ln1s),
                         static_cast<const float*>(ln1b), static_cast<const float*>(ln2s),
                         static_cast<const float*>(ln2b), static_cast<const float*>(b1),
                         static_cast<const float*>(b2), static_cast<const float*>(mask),
                         static_cast<const float*>(dp), eps};
  const BlockGrads gr = {dwqkv, dbqkv, dwproj, dbproj, drel, dln1s, dln1b,
                         dln2s, dln2b, dw1,   db1,    dw2,    db2};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf ? block_backward<bf16>(d, w, dy, dx, gr, b, st)
                  : block_backward<float>(d, w, dy, dx, gr, b, st));
}

// SwinV2's block: arguments as swin_any_fwd's, with tau [heads] (f32, the
// logit scales before their clamp and exp) after rel, bqkv = (q_bias, 0,
// v_bias) and ln* the post-norms'.
int swinv2_any_fwd(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
                   const void* bproj, const void* rel, const void* tau, const void* ln1s,
                   const void* ln1b, const void* ln2s, const void* ln2b, const void* w1,
                   const void* b1, const void* w2, const void* b2, const void* mask,
                   const void* dp, void* out, void* scratch, int bf, int B, int H, int W, int C,
                   int heads, int ws, int hidden, float eps, void* stream) {
  if (!valid(B, H, W, C, heads, ws, hidden)) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(B, H, W, C, heads, ws, hidden);
  Carver cv = {static_cast<char*>(scratch), 0};
  Buffers b;
  layout(kBlockFwdV2, d, bf, cv, b);
  const BlockParams w = {x, wqkv, bqkv, wproj, bproj, w1, w2,
                         static_cast<const float*>(rel), static_cast<const float*>(ln1s),
                         static_cast<const float*>(ln1b), static_cast<const float*>(ln2s),
                         static_cast<const float*>(ln2b), static_cast<const float*>(b1),
                         static_cast<const float*>(b2), static_cast<const float*>(mask),
                         static_cast<const float*>(dp), eps};
  const float* t = static_cast<const float*>(tau);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf ? block_forward_v2<bf16>(d, w, t, false, out, b, st)
                  : block_forward_v2<float>(d, w, t, false, out, b, st));
}

// SwinV2's block backward: dx (T) and the 14 parameter gradients (f32,
// zeroed by the caller, summed into) from dy (T), the 13 of swin_any_bwd's
// (dbqkv's k third unused) with dtau [heads] after drel. The backward
// products take operands rounded to bf16 whatever T is.
int swinv2_any_bwd(const void* x, const void* dy, const void* wqkv, const void* bqkv,
                   const void* wproj, const void* bproj, const void* rel, const void* tau,
                   const void* ln1s, const void* ln1b, const void* ln2s, const void* ln2b,
                   const void* w1, const void* b1, const void* w2, const void* b2,
                   const void* mask, const void* dp, void* dx, float* dwqkv, float* dbqkv,
                   float* dwproj, float* dbproj, float* drel, float* dtau, float* dln1s,
                   float* dln1b, float* dln2s, float* dln2b, float* dw1, float* db1,
                   float* dw2, float* db2, void* scratch, int bf, int B, int H, int W, int C,
                   int heads, int ws, int hidden, float eps, void* stream) {
  if (!valid(B, H, W, C, heads, ws, hidden)) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(B, H, W, C, heads, ws, hidden);
  Carver cv = {static_cast<char*>(scratch), 0};
  Buffers b;
  layout(kBlockBwdV2, d, bf, cv, b);
  const BlockParams w = {x, wqkv, bqkv, wproj, bproj, w1, w2,
                         static_cast<const float*>(rel), static_cast<const float*>(ln1s),
                         static_cast<const float*>(ln1b), static_cast<const float*>(ln2s),
                         static_cast<const float*>(ln2b), static_cast<const float*>(b1),
                         static_cast<const float*>(b2), static_cast<const float*>(mask),
                         static_cast<const float*>(dp), eps};
  const BlockGrads gr = {dwqkv, dbqkv, dwproj, dbproj, drel, dln1s, dln1b,
                         dln2s, dln2b, dw1,   db1,    dw2,    db2};
  const float* t = static_cast<const float*>(tau);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf ? block_backward_v2<bf16>(d, w, t, dy, dx, gr, dtau, b, st)
                  : block_backward_v2<float>(d, w, t, dy, dx, gr, dtau, b, st));
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
  Carver cv = {static_cast<char*>(scratch), 0};
  Buffers b;
  layout(kAttnFwd, d, bf, cv, b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* frel = static_cast<const float*>(rel);
  const float* fmask = static_cast<const float*>(mask);
  return (int)(bf ? attn_forward<bf16>(d, x, wqkv, bqkv, wproj, bproj, frel, fmask, out, b, st)
                  : attn_forward<float>(d, x, wqkv, bqkv, wproj, bproj, frel, fmask, out, b,
                                        st));
}

// K4: dx (T) and the five parameter gradients (f32, zeroed by the caller)
// of K3 from dy (T); operands of the backward products rounded to bf16 (`rd`
// must be 1, as the JAX kernel rounds them whatever the input type).
int attn_any_bwd(const void* x, const void* dy, const void* wqkv, const void* bqkv,
                 const void* wproj, const void* rel, const void* mask, void* dx,
                 float* dwqkv, float* dbqkv, float* dwproj, float* dbproj, float* drel,
                 void* scratch, int bf, int rd, int B, int H, int W, int C, int heads,
                 int ws, void* stream) {
  if (!valid(B, H, W, C, heads, ws, 1) || rd != 1) return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(B, H, W, C, heads, ws, 1);
  Carver cv = {static_cast<char*>(scratch), 0};
  Buffers b;
  layout(kAttnBwd, d, bf, cv, b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* frel = static_cast<const float*>(rel);
  const float* fmask = static_cast<const float*>(mask);
  return (int)(bf ? attn_backward<bf16>(d, x, dy, wqkv, bqkv, wproj, frel, fmask, dx, dwqkv,
                                        dbqkv, dwproj, dbproj, drel, b, st)
                  : attn_backward<float>(d, x, dy, wqkv, bqkv, wproj, frel, fmask, dx, dwqkv,
                                         dbqkv, dwproj, dbproj, drel, b, st));
}

// For the tests: product `which` (0 qkv, 1 the projection, 2 fc1, 3 fc2)
// of a block's forward in f32 alone, as swin_any_fwd launches it, so that
// its side outputs can be held against a reference: a its input A [B, H, W,
// K] (qkv: x in grid order, read at the grid rows; else in window order),
// res the residual (1: x, 3: r1), w [K, N], bias [N], ln_s and ln_b [K] (0,
// 2), dp [B, 2] (1, 3), out [M, N] (3: in grid order); where stats is given
// (0, 2) also stats [M, 2], side [M, K] and (2) aux [M, N], as the
// backward's recompute keeps them. K and N follow from C and hidden. Every
// weight and bias of the block's parameters points at w and bias (the one
// product reads only its own), and every buffer at the operand or output
// the product takes. Returns the CUDA error of the launch.
int window_any_fwd_product(int which, const void* a, const void* res, const void* w,
                           const void* bias, const void* ln_s, const void* ln_b,
                           const void* dp, void* out, float* stats, void* side, float* aux,
                           int B, int H, int W, int C, int ws, int hidden, float eps,
                           void* stream) {
  if (which < kQkv || which > kFc2 || !valid(B, H, W, C, C, ws, hidden))
    return (int)cudaErrorInvalidValue;
  const Dims d = make_dims(B, H, W, C, C, ws, hidden);
  BlockParams p = {};
  Buffers b = {};
  const float* fs = static_cast<const float*>(ln_s);
  const float* fb = static_cast<const float*>(ln_b);
  p.eps = eps;
  p.dp = static_cast<const float*>(dp);
  // the operands where block_forward finds them
  p.x = which == kQkv ? a : res;
  b.merged = const_cast<void*>(a);
  b.r1 = const_cast<void*>(which == kFc1 ? a : res);
  b.g1 = which == kFc1 ? out : const_cast<void*>(a);
  b.qkv = out;
  p.wqkv = p.wproj = p.w1 = p.w2 = w;
  p.bqkv = p.bproj = bias;
  p.b1 = p.b2 = static_cast<const float*>(bias);
  p.ln1s = p.ln2s = fs;
  p.ln1b = p.ln2b = fb;
  b.stats1 = b.stats2 = stats;
  b.h1 = b.h2 = side;
  b.z1 = aux;
  if (which == kProj) b.r1 = out;
  return (int)fwd_product<float>(d, which, p, stats != nullptr, out, b,
                                 static_cast<cudaStream_t>(stream));
}

}  // extern "C"
