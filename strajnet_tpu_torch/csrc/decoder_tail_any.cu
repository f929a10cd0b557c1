// The decoder tail for every geometry and type the TPU kernel takes (sm_90a):
// the general route of K7,
//
//   out = conv3x3(elu(conv3x3(upsample2x(x), w_up) + b_up), w_out) + b_out
//
// with SAME padding on both convolutions (the elu'd intermediate counts as 0
// outside the 2H x 2W image), x [N, H, W, Cin] and out [N, 2H, 2W, 2] in T
// (f32 or bf16), the weights HWIO in f32: w_up [3, 3, Cin, Cmid], w_out
// [3, 3, Cmid, 2].
//
// Replaces strajnet_tpu/ops/pallas_decoder_tail.py::_tail_kernel for the
// geometries decoder_tail.cu (Cin 96, Cmid 48, bf16) is not built for. The
// TPU kernel's gate (pallas_decoder_tail.py::supports) takes two output
// channels, Cin and Cmid multiples of 8 and square images whose side is a
// multiple of 8 (and of 16 above 16), in f32 or bf16; this kernel takes any
// Cin, Cmid >= 1 and any N, H, W, and masks the ragged edges itself.
//
// Phase form, as the TPU kernel and decoder_tail.cu compute it: both
// convolutions run on the (H + 1) x (W + 1) offset grid. Entry (r, c) of
// channel block p = 2a + b stands for upsampled pixel (2(r - a) + a,
// 2(c - b) + b), and
//
//   y[r, c, :] = sum over taps (u, v) of xpad[r + u, c + v, :] @ Kf[u, v]
//   e = elu(y + b_up) (0 where the entry stands for a pixel outside the image)
//   o[i, j, :] = sum over taps (u, v) of e[i + u, j + v, :] @ Ky[u, v]
//
// with xpad the input padded by one pixel, Kf [2, 2, Cin, 4 Cmid] the
// phase-folded kernel (4/9 of the multiply-adds of a 3x3 on the upsampled
// image) and Ky [2, 2, 4 Cmid, 8] the re-bucketed output kernel, whose 8
// lanes are the 2 x 2 output pixels x 2 channels of one entry
// (ops/decoder_tail.py::fold_kernel_2x and build_ky write them out).
//
// Two launches a call:
// - fold_tail_weights_kernel folds both kernels in f32, rounds them to T
//   once and writes them in the products' operand layout, per chunk of 16
//   intermediate channels: Kf as [chunk][tap][4 x 16 columns, phase-major]
//   [Cin padded to a stage] (the depth contiguous, as ldmatrix reads B), Ky
//   as [chunk][tap][4 x 16][8], zeros for the channels beyond Cin and Cmid.
//   So any Cin and Cmid are taken with no masked inner loop.
// - decoder_tail_any_kernel: an implicit GEMM on mma.sync (bf16 m16n8k16;
//   f32 as 3xTF32 through the fragments of mma_sync.cuh, each k step
//   summed from zero and added to the accumulators to nearest). A block
//   owns a tile of 16 x 8 offset-grid entries (15 x 7 output entries and their
//   one-entry halo, which the neighbours recompute: 128 / 105 = 1.22x the
//   up-convolution's work), eight warps of 16 entries each. Per chunk of 16
//   intermediate channels it runs the main product [128, 4 Cin] x [4 Cin,
//   64] over the input channels in stages of 64 bytes of depth: the
//   stage's 17 x 9 input pixels (zero-filled outside the image) and its
//   slice of Kf are copied by cp.async into one of two buffers while the
//   warps work on the other; a tap (u, v) is a shift of the rows the
//   fragments read (ldmatrix takes a row address per lane; in f32 it reads
//   the TF32 fragments' 32-bit elements, which are then split). The
//   accumulators then take the bias, elu, the border mask and the rounding
//   to T (as the plain version rounds the intermediate) into shared
//   memory, [entry][64], from which the output product [128, 4 x 64] x [4
//   x 64, 8] adds the chunk's share to accumulators kept in registers
//   across the chunks; rows 15 and column 7 of its result belong to the
//   neighbouring tiles and are dropped. The output goes out interleaved,
//   [N, 2H, 2W, 2], with b_out added in f32 and rounded once.
//
// Bound: operations, 4 Cin 4 Cmid multiply-adds an offset-grid entry for
// the main product and 4 x 4 Cmid x 8 for the output one, on the tensor
// cores (bf16 989 TFLOP/s; f32 three TF32 passes, 165). No atomics: two runs
// are bit-identical.

#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "mma_sync.cuh"

namespace {

using namespace msync;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTH = 16, kTW = 8;              // offset-grid entries a tile
constexpr int kEnt = kTH * kTW;               // 128: 16 a warp
constexpr int kOutH = kTH - 1, kOutW = kTW - 1;   // output entries a tile owns
constexpr int kXH = kTH + 1, kXW = kTW + 1;   // input pixels a tile reads
constexpr int kPix = kXH * kXW;
constexpr int kCM = 16;                       // intermediate channels a chunk
constexpr int kNC = 4 * kCM;                  // columns of the main product
constexpr int kLanes = 8;                     // columns of the output product
constexpr int kEntPad = kEnt + 16;            // entries the shifted reads reach

// Shared-memory layout of T: rows padded so that the fragments' reads fall
// in distinct banks.
template <typename T>
struct Lay {
  static constexpr int kCE = 16 / (int)sizeof(T);   // elements a 16-byte chunk
  static constexpr int kKc = 64 / (int)sizeof(T);   // input channels a stage
  static constexpr int kLdX = kKc + kCE;
  static constexpr int kLdB = kKc + kCE;
  static constexpr int kLdE = kNC + kCE;
  static constexpr int kLdY = sizeof(T) == 2 ? 24 : 8;
  static constexpr int kXElems = kPix * kLdX;
  static constexpr int kBElems = 4 * kNC * kLdB;
  static constexpr int kStage = kXElems + kBElems;
  static constexpr size_t kSmem =
      (size_t)(2 * kStage + kEntPad * kLdE + 4 * kNC * kLdY) * sizeof(T);
};

struct TailArgs {
  const void* x;       // [N, H, W, Cin] T
  const void* kf;      // [chunks][4][kNC][cinp] T
  const void* ky;      // [chunks][4][kNC][8] T
  const float* b_up;   // [Cmid]
  const float* b_out;  // [2]
  void* out;           // [N, 2H, 2W, 2] T
  int N, H, W, Cin, Cmid, cinp, chunks, tiles_y, tiles_x, vec;
};

// Folds w_up [3, 3, Cin, Cmid] into Kf and re-buckets w_out [3, 3, Cmid, 2]
// into Ky in f32, rounded to T once, in the main kernel's operand layout.
template <typename T>
__global__ void fold_tail_weights_kernel(const float* __restrict__ w_up,
                                         const float* __restrict__ w_out, T* __restrict__ kf,
                                         T* __restrict__ ky, int Cin, int Cmid, int cinp,
                                         int chunks) {
  // rows of the 3x3 kernel that fold into low-resolution tap u of output
  // phase a: phase 0 reads input row i-1 (row 0) and i (rows 1, 2), phase 1
  // reads i (rows 0, 1) and i+1 (row 2)
  auto first = [](int a, int u) { return u == 0 ? 0 : (a == 0 ? 1 : 2); };
  auto last = [](int a, int u) { return u == 0 ? (a == 0 ? 0 : 1) : 2; };
  const long long nkf = (long long)chunks * 4 * cinp * kNC;
  const long long nky = (long long)chunks * 4 * kNC * kLanes;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < nkf + nky;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < nkf) {
      // Kf[chunk][tap (u, v)][16 (2 a + b) + m][ci]
      const int ci = (int)(i % cinp), col = (int)(i / cinp % kNC);
      const int tap = (int)(i / ((long long)kNC * cinp) % 4), cm = (int)(i / (4LL * kNC * cinp));
      const int p = col / kCM, co = cm * kCM + col % kCM;
      const int a = p >> 1, b = p & 1, u = tap >> 1, v = tap & 1;
      float s = 0.0f;
      if (ci < Cin && co < Cmid)
        for (int dy = first(a, u); dy <= last(a, u); ++dy)
          for (int dx = first(b, v); dx <= last(b, v); ++dx)
            s += w_up[((long long)(dy * 3 + dx) * Cin + ci) * Cmid + co];
      kf[i] = from_f<T>(s);
    } else {
      // Ky[chunk][tap (u, v)][16 (2 a2 + b2) + m][2 (2 a + b) + o]: tap kr of
      // output phase a reads upsampled row 2 i + a + kr - 1 = 2 (i + u - a2) + a2
      const long long j = i - nkf;
      const int lane = (int)(j % kLanes), ch = (int)(j / kLanes % kNC);
      const int tap = (int)(j / (kLanes * kNC) % 4), cm = (int)(j / (4 * kLanes * kNC));
      const int q = lane >> 1, o = lane & 1, a = q >> 1, b = q & 1;
      const int p2 = ch / kCM, mc = cm * kCM + ch % kCM, a2 = p2 >> 1, b2 = p2 & 1;
      const int u = tap >> 1, v = tap & 1;
      const int kr = 2 * u - a2 - a + 1, kc = 2 * v - b2 - b + 1;
      const bool hit = kr >= 0 && kr <= 2 && kc >= 0 && kc <= 2 && mc < Cmid;
      ky[j] = from_f<T>(hit ? w_out[((long long)(kr * 3 + kc) * Cmid + mc) * 2 + o] : 0.0f);
    }
  }
}

// The rows of a warp's 16 entries at tap (u, v): entry i of the warp reads
// input pixel (row + u, column + v) of the tile's 17 x 9 pixels
__device__ __forceinline__ int tap_pixel(int entry, int u, int v) {
  return ((entry >> 3) + u) * kXW + (entry & 7) + v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2) decoder_tail_any_kernel(TailArgs g) {
  using L = Lay<T>;
  constexpr int CE = L::kCE, Kc = L::kKc;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);               // 2 x (X, Kf)
  T* Es = ring + 2 * L::kStage;                           // [kEntPad][kLdE]
  T* Ys = Es + kEntPad * L::kLdE;                         // [4][kNC][kLdY]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3, li = lane & 7, mi = lane >> 3;
  const int tx = blockIdx.x % g.tiles_x, ty = (blockIdx.x / g.tiles_x) % g.tiles_y;
  const long long n = blockIdx.x / ((long long)g.tiles_x * g.tiles_y);
  const int R0 = ty * kOutH, C0 = tx * kOutW;    // the tile's first entry
  const int e0 = warp * 16;                      // this warp's entries
  const T* xi = static_cast<const T*>(g.x) + n * g.H * g.W * g.Cin;
  const T* kf = static_cast<const T*>(g.kf);
  const T* ky = static_cast<const T*>(g.ky);
  const int nkc = g.cinp / Kc, nst = g.chunks * nkc;
  for (int i = tid; i < (kEntPad - kEnt) * L::kLdE; i += kThreads)
    Es[kEnt * L::kLdE + i] = from_f<T>(0.0f);

  // stage st: input channels [kc Kc, (kc + 1) Kc) of the tile's pixels and
  // the matching rows of the four taps of Kf, chunk cm
  auto issue = [&](int st) {
    const int cm = st / nkc, kc = st - cm * nkc, ci0 = kc * Kc;
    T* xs = ring + (st & 1) * L::kStage;
    T* bs = xs + L::kXElems;
    for (int i = tid; i < kPix * (Kc / CE); i += kThreads) {
      const int p = i / (Kc / CE), c = (i - p * (Kc / CE)) * CE;
      const int y = R0 - 1 + p / kXW, xx = C0 - 1 + p % kXW;
      T* d = xs + p * L::kLdX + c;
      const int ci = ci0 + c;
      if (y >= 0 && y < g.H && xx >= 0 && xx < g.W && ci < g.Cin) {
        const T* s = xi + ((long long)y * g.W + xx) * g.Cin + ci;
        if (g.vec && ci + CE <= g.Cin) {
          cp_async16(d, s);
        } else {
#pragma unroll
          for (int e = 0; e < CE; ++e) d[e] = ci + e < g.Cin ? s[e] : from_f<T>(0.0f);
        }
      } else {
        *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
      }
    }
    for (int i = tid; i < 4 * kNC * (Kc / CE); i += kThreads) {
      const int r = i / (Kc / CE), c = (i - r * (Kc / CE)) * CE;   // r = tap * kNC + col
      cp_async16(bs + r * L::kLdB + c,
                 kf + ((long long)cm * 4 * kNC + r) * g.cinp + ci0 + c);
    }
  };

  float acc1[8][4], acc2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  issue(0);
  cp_async_commit();
  for (int st = 0; st < nst; ++st) {
    const int cm = st / nkc, kc = st - cm * nkc;
    if (kc == 0) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc1[j][e] = 0.0f;
    }
    cp_async_wait<0>();
    __syncthreads();   // stage st has landed; every warp is done with st - 1
    if (st + 1 < nst) issue(st + 1);
    cp_async_commit();
    const T* xs = ring + (st & 1) * L::kStage;
    const T* bs = xs + L::kXElems;
    // the main product: acc1 += X[tap shift] @ Kf[tap] over the stage.
    // Fragments by ldmatrix, lane li addressing row li of matrix mi: A's
    // (entries 0-7, 8-15) x (k low, high half), k slowest; B's (k low, high
    // half) x (columns 0-7, 8-15) from Kf's [column][k] rows. In f32 a
    // matrix row is 4 elements, each thread's register one TF32 element.
    const int ea = e0 + (mi & 1) * 8 + li;
    constexpr int kHalf = sizeof(T) == 2 ? 8 : 4;   // elements of a matrix row
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      const int u = tap >> 1, v = tap & 1;
      const T* xa = xs + tap_pixel(ea, u, v) * L::kLdX + (mi >> 1) * kHalf;
      const T* bt = bs + (tap * kNC + (mi >> 1) * 8 + li) * L::kLdB + (mi & 1) * kHalf;
#pragma unroll
      for (int kk = 0; kk < Kc; kk += Tc<T>::kK) {
        uint32_t ra[4];
        ldsm_x4<false>(ra, xa + kk);
        typename Tc<T>::A fa;
        if constexpr (sizeof(T) == 2) {
#pragma unroll
          for (int q = 0; q < 4; ++q) fa.r[q] = ra[q];
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q) Tc<T>::split(__uint_as_float(ra[q]), fa.hi[q], fa.lo[q]);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t rb[4];
          ldsm_x4<false>(rb, bt + jj * 16 * L::kLdB + kk);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            typename Tc<T>::B fb;
            if constexpr (sizeof(T) == 2) {
              fb.r[0] = rb[2 * h];
              fb.r[1] = rb[2 * h + 1];
            } else {
              Tc<T>::split(__uint_as_float(rb[2 * h]), fb.hi[0], fb.lo[0]);
              Tc<T>::split(__uint_as_float(rb[2 * h + 1]), fb.hi[1], fb.lo[1]);
            }
            Tc<T>::step(acc1[2 * jj + h], fa, fb);
          }
        }
      }
    }
    if (kc != nkc - 1) continue;
    // the chunk's intermediate: bias, elu, the border mask, rounded to T
    for (int i = tid; i < 4 * kNC * kLanes; i += kThreads) {
      const int r = i / kLanes, c = i - r * kLanes;
      Ys[r * L::kLdY + c] = ky[(long long)cm * 4 * kNC * kLanes + i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int el = e0 + gq + (e >> 1) * 8, col = j * 8 + 2 * tq + (e & 1);
        const int r = R0 + (el >> 3), c = C0 + (el & 7);
        const int p = col / kCM, ch = cm * kCM + col % kCM, a2 = p >> 1, b2 = p & 1;
        const bool inside = r <= g.H && c <= g.W && ch < g.Cmid && !(r == 0 && a2) &&
                            !(r == g.H && !a2) && !(c == 0 && b2) && !(c == g.W && !b2);
        float y = 0.0f;
        if (inside) {
          y = acc1[j][e] + g.b_up[ch];
          y = y > 0.0f ? y : expm1f(y);
        }
        Es[el * L::kLdE + col] = from_f<T>(y);
      }
    __syncthreads();
    // the output product: acc2 += E[tap shift] @ Ky[tap]
#pragma unroll
    for (int tap = 0; tap < 4; ++tap) {
      const int sh = (tap >> 1) * kTW + (tap & 1);
      const T* yt = Ys + tap * kNC * L::kLdY;
      if constexpr (sizeof(T) == 2) {
#pragma unroll
        for (int kk = 0; kk < kNC; kk += 32) {
          uint32_t fb[4];
          ldsm_x4<true>(fb, yt + (kk + mi * 8 + li) * L::kLdY);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            Tc<bf16>::A fa;
            ldsm_x4<false>(fa.r, Es + (e0 + sh + (mi & 1) * 8 + li) * L::kLdE + kk + h * 16 +
                                     (mi >> 1) * 8);
            Tc<bf16>::mma(acc2, fa, Tc<bf16>::B{{fb[2 * h], fb[2 * h + 1]}});
          }
        }
      } else {
        const View<T, true> va = {Es + (e0 + sh) * L::kLdE, L::kLdE};
        const View<T, false> vb = {yt, L::kLdY};
#pragma unroll
        for (int kk = 0; kk < kNC; kk += 8) {
          typename Tc<T>::A fa;
          typename Tc<T>::B fb;
          Tc<T>::load_a(fa, va, 0, kk, lane);
          Tc<T>::load_b(fb, vb, kk, 0, lane);
          Tc<T>::step(acc2, fa, fb);
        }
      }
    }
  }
  cp_async_wait<0>();
  // out[n, 2i + a, 2j + b, o] = acc2[entry (i, j)][2 (2a + b) + o] + b_out[o]
  const int a = tq >> 1, b = tq & 1;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int el = e0 + gq + hr * 8, er = el >> 3, ec = el & 7;
    const int i = R0 + er, j = C0 + ec;
    if (er >= kOutH || ec >= kOutW || i >= g.H || j >= g.W) continue;
    const float v0 = acc2[2 * hr] + g.b_out[0], v1 = acc2[2 * hr + 1] + g.b_out[1];
    const long long o = ((n * 2 * g.H + 2 * i + a) * 2 * g.W + 2 * j + b) * 2;
    if constexpr (sizeof(T) == 2)
      *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(g.out) + o) =
          __floats2bfloat162_rn(v0, v1);
    else
      *reinterpret_cast<float2*>(static_cast<float*>(g.out) + o) = make_float2(v0, v1);
  }
}

long long round_up(long long v, long long m) { return (v + m - 1) / m * m; }

struct Plan {
  int cinp, chunks;
  long long kf_elems, ky_elems, ky_offset;   // ky_offset in bytes, 256-aligned
};

Plan plan(int bf, int Cin, int Cmid) {
  Plan p;
  p.cinp = (int)round_up(Cin, bf ? Lay<bf16>::kKc : Lay<float>::kKc);
  p.chunks = (Cmid + kCM - 1) / kCM;
  p.kf_elems = (long long)p.chunks * 4 * p.cinp * kNC;
  p.ky_elems = (long long)p.chunks * 4 * kNC * kLanes;
  p.ky_offset = round_up(p.kf_elems * (bf ? 2 : 4), 256);
  return p;
}

template <typename T>
cudaError_t launch(const void* x, const float* w_up, const float* b_up, const float* w_out,
                   const float* b_out, void* out, void* scratch, int N, int H, int W, int Cin,
                   int Cmid, cudaStream_t st) {
  const Plan p = plan(sizeof(T) == 2, Cin, Cmid);
  T* kf = static_cast<T*>(scratch);
  T* ky = reinterpret_cast<T*>(static_cast<char*>(scratch) + p.ky_offset);
  const long long elems = p.kf_elems + p.ky_elems;
  const int fold_blocks = (int)std::min<long long>((elems + 255) / 256, 1024);
  fold_tail_weights_kernel<T><<<fold_blocks, 256, 0, st>>>(w_up, w_out, kf, ky, Cin, Cmid,
                                                           p.cinp, p.chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  TailArgs g;
  g.x = x;
  g.kf = kf;
  g.ky = ky;
  g.b_up = b_up;
  g.b_out = b_out;
  g.out = out;
  g.N = N;
  g.H = H;
  g.W = W;
  g.Cin = Cin;
  g.Cmid = Cmid;
  g.cinp = p.cinp;
  g.chunks = p.chunks;
  g.tiles_y = (H + kOutH - 1) / kOutH;
  g.tiles_x = (W + kOutW - 1) / kOutW;
  g.vec = (Cin * (int)sizeof(T)) % 16 == 0 && (uintptr_t)x % 16 == 0;
  const long long blocks = (long long)N * g.tiles_y * g.tiles_x;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = Lay<T>::kSmem;
  err = cudaFuncSetAttribute(decoder_tail_any_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  decoder_tail_any_kernel<T><<<(unsigned)blocks, kThreads, smem, st>>>(g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of scratch a call needs: the folded, padded weights.
long long decoder_tail_any_scratch_bytes(int bf, int Cin, int Cmid) {
  if (Cin < 1 || Cmid < 1) return -1;
  const Plan p = plan(bf, Cin, Cmid);
  return p.ky_offset + p.ky_elems * (bf ? 2 : 4);
}

// Launches the tail on `stream` (a cudaStream_t): the weight fold, then the
// tail; returns the CUDA error of the first failed launch (0 on success).
// x [N, H, W, Cin] and out [N, 2H, 2W, 2] in bf16 where bf, else f32; w_up
// [3, 3, Cin, Cmid], b_up [Cmid], w_out [3, 3, Cmid, 2] and b_out [2] f32;
// scratch of decoder_tail_any_scratch_bytes(bf, Cin, Cmid) bytes, 256-byte
// aligned.
int decoder_tail_any_fwd(const void* x, const void* w_up, const void* b_up,
                         const void* w_out, const void* b_out, void* out, void* scratch,
                         int bf, int N, int H, int W, int Cin, int Cmid, void* stream) {
  if (N < 1 || H < 1 || W < 1 || Cin < 1 || Cmid < 1) return (int)cudaErrorInvalidValue;
  const float *wu = static_cast<const float*>(w_up), *bu = static_cast<const float*>(b_up);
  const float *wo = static_cast<const float*>(w_out), *bo = static_cast<const float*>(b_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(bf ? launch<bf16>(x, wu, bu, wo, bo, out, scratch, N, H, W, Cin, Cmid, st)
                  : launch<float>(x, wu, bu, wo, bo, out, scratch, N, H, W, Cin, Cmid, st));
}

}  // extern "C"
