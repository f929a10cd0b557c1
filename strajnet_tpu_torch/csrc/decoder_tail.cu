// Fused decoder tail for Hopper (sm_90a):
//
//   out = conv3x3(elu(conv3x3(upsample2x(x), w_up) + b_up), w_out)
//
// with SAME padding on both convolutions; x [N, H, W, Cin] bf16, out
// [N, 2H, 2W, 2] bf16; the caller adds b_out.
//
// Replaces strajnet_tpu/ops/pallas_decoder_tail.py::_tail_kernel (reached
// through _tail_call / decoder_tail). What it keeps of that kernel is the
// point of it: the elu'd [N, 2H, 2W, Cmid] intermediate (805 MB in bf16 at
// the flagship tail, N=128, H=W=128, Cmid=48) never goes to device memory.
// Its layout does not cross over: the [H+2, W+16] flattened padding, the
// packed [Cin, 16 Cmid] and [4 Cmid, 72] matrices with slice-adds and the
// 8-lane phase-layout output serve the TPU's sublane alignment. This kernel
// writes [N, 2H, 2W, 2] directly.
//
// The up-convolution runs in phase form. Upsampled pixel (2i+a, 2j+b) reads
// the 2x2 input taps at rows i+a-1, i+a and columns j+b-1, j+b with the
// phase-folded kernel (the caller folds w_up: 4/9 of the multiply-adds of a
// 3x3 on the upsampled image). On the "offset grid" (H+1) x (W+1), entry
// (r, c) of channel block p = 2a+b stands for upsampled pixel
// (2(r-a)+a, 2(c-b)+b), and all four phases share one form:
//
//   y[r, c, :] = sum over taps (u, v) of xpad[r+u, c+v, :] @ Kf[u, v]
//
// with xpad the input padded by one pixel and Kf [2, 2, Cin, 4 Cmid].
//
// One thread block takes an 8 x 16 tile of the offset grid: 128 rows of a
// [128, 4 Cin] x [4 Cin, 4 Cmid] product, exactly eight 16-row WMMA tiles,
// each of them 16 consecutive pixels of one input row, so an A fragment is a
// plain strided load from the input tile in shared memory. That tile of the
// intermediate covers the 14 x 30 upsampled pixels of a 7 x 15 input tile
// with their one-pixel halo, so neighbouring blocks recompute the halo:
// 128 / 105 = 1.22x the up-convolution's work. The block then adds b_up,
// applies elu in f32, zeroes the entries that stand for pixels outside the
// image (the output conv's zero padding: the intermediate there is 0, not
// elu(b_up)), rounds to bf16 into shared memory, and runs the 3x3 output conv
// to two channels as plain f32 FMAs, one upsampled pixel per thread.
//
// Shared memory (Cin=96, Cmid=48): input tile with halo 9 x 17 x 112 bf16 =
// 34 KB, intermediate 128 x 200 bf16 = 51 KB, staging, w_out and bias 14 KB:
// 100 KB, two blocks per SM. The folded up-conv kernel (147 KB) does not fit
// beside them; its WMMA fragments are read from global memory, where L2 holds
// it. What bounds the kernel on the H100 is operations (324 GFLOP against
// 0.44 GB per flagship launch); this design is limited by its fragment loads
// from shared memory and L2, far below the tensor cores' peak. With 80
// registers two blocks share an SM, and that occupancy is what hides the L2
// latency of the weight fragments: a variant with three strips per warp and
// prefetched fragments needed 169 registers, one block per SM, and was slower.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTH = 8, kTW = 16;             // offset-grid tile
constexpr int kXH = kTH + 1, kXW = kTW + 1;  // input tile with halo
constexpr int kIn = kTH - 1, kJn = kTW - 1;  // input pixels a block owns
constexpr int kOutH = 2 * kIn, kOutW = 2 * kJn;
constexpr int kSlotLd = 20;                  // f32 staging row of one 16x16 tile

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

struct TailParams {
  const bf16* x;     // [N, H, W, Cin]
  const bf16* kf;    // [2, 2, Cin, 4*Cmid] phase-folded up-conv kernel
  const float* bup;  // [Cmid]
  const bf16* wo;    // [3, 3, Cmid, 2]
  bf16* out;         // [N, 2H, 2W, 2]
  int N, H, W, Cin, Cmid;
};

struct TailLayout {
  int ldx, lde;
  size_t off_e, off_slot, off_wo, off_bias, total;
};

__host__ __device__ inline size_t round_up(size_t v, size_t a) {
  return (v + a - 1) / a * a;
}

__host__ __device__ inline TailLayout make_layout(int Cin, int Cmid) {
  TailLayout L;
  L.ldx = Cin + 16;       // a multiple of 16: every pixel row 32-byte aligned
  L.lde = 4 * Cmid + 8;
  size_t off = round_up((size_t)kXH * kXW * L.ldx * sizeof(bf16), 128);
  L.off_e = off;
  off = round_up(off + (size_t)kTH * kTW * L.lde * sizeof(bf16), 128);
  L.off_slot = off;
  off = round_up(off + (size_t)kWarps * 16 * kSlotLd * sizeof(float), 128);
  L.off_wo = off;
  off = round_up(off + (size_t)9 * Cmid * 2 * sizeof(float), 128);
  L.off_bias = off;
  off = round_up(off + (size_t)4 * Cmid * sizeof(float), 128);
  L.total = off;
  return L;
}

__global__ void __launch_bounds__(kThreads)
decoder_tail_kernel(const TailParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Cin = p.Cin, Cmid = p.Cmid, H = p.H, W = p.W;
  const TailLayout L = make_layout(Cin, Cmid);
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* es = reinterpret_cast<bf16*>(smem + L.off_e);
  float* slots = reinterpret_cast<float*>(smem + L.off_slot);
  float* wos = reinterpret_cast<float*>(smem + L.off_wo);
  float* bias = reinterpret_cast<float*>(smem + L.off_bias);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n = blockIdx.z;
  const int i0 = blockIdx.y * kIn, j0 = blockIdx.x * kJn;
  const int ldb = 4 * Cmid;

  // ---- input tile with halo (zero outside the image), w_out, bias ----
  {
    const int vec = Cin / 8;  // 16-byte vectors per pixel
    const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
    for (int idx = threadIdx.x; idx < kXH * kXW * vec; idx += kThreads) {
      const int px = idx / vec, k = idx % vec;
      const int gi = i0 - 1 + px / kXW, gj = j0 - 1 + px % kXW;
      uint4 v = zero4;
      if (gi >= 0 && gi < H && gj >= 0 && gj < W)
        v = *reinterpret_cast<const uint4*>(
            p.x + (((size_t)n * H + gi) * W + gj) * Cin + k * 8);
      *reinterpret_cast<uint4*>(xs + px * L.ldx + k * 8) = v;
    }
    for (int idx = threadIdx.x; idx < 9 * Cmid * 2; idx += kThreads)
      wos[idx] = __bfloat162float(p.wo[idx]);
    for (int idx = threadIdx.x; idx < 4 * Cmid; idx += kThreads)
      bias[idx] = p.bup[idx % Cmid];
  }
  __syncthreads();

  float* slot = slots + warp * 16 * kSlotLd;
  const int items = (kTH / 4) * (ldb / 16);
  for (int item = warp; item < items; item += kWarps) {
    const int mh = item % (kTH / 4), ns = item / (kTH / 4);
    FragC c[4];
#pragma unroll
    for (int tm = 0; tm < 4; ++tm) wmma::fill_fragment(c[tm], 0.f);
    for (int tap = 0; tap < 4; ++tap) {
      const int u = tap >> 1, v = tap & 1;
      const bf16* B = p.kf + (size_t)tap * Cin * ldb + ns * 16;
      for (int k0 = 0; k0 < Cin; k0 += 16) {
        FragB bm;
        wmma::load_matrix_sync(bm, B + (size_t)k0 * ldb, ldb);
#pragma unroll
        for (int tm = 0; tm < 4; ++tm) {
          FragA a;
          wmma::load_matrix_sync(
              a, xs + ((mh * 4 + tm + u) * kXW + v) * L.ldx + k0, L.ldx);
          wmma::mma_sync(c[tm], a, bm, c[tm]);
        }
      }
    }
#pragma unroll
    for (int tm = 0; tm < 4; ++tm) {
      const int r = mh * 4 + tm, gr = i0 + r;
      wmma::store_matrix_sync(slot, c[tm], kSlotLd, wmma::mem_row_major);
      __syncwarp();
      for (int idx = lane; idx < 256; idx += 32) {
        const int cc = idx / 16, jj = idx % 16;
        const int col = ns * 16 + jj, gc = j0 + cc;
        const int blk = col / Cmid, a2 = blk >> 1, b2 = blk & 1;
        const bool inside = gr <= H && gc <= W &&
                            !(a2 == 1 && gr == 0) && !(a2 == 0 && gr == H) &&
                            !(b2 == 1 && gc == 0) && !(b2 == 0 && gc == W);
        const float y = slot[cc * kSlotLd + jj] + bias[col];
        const float e = y > 0.f ? y : expf(fminf(y, 0.f)) - 1.f;
        es[(r * kTW + cc) * L.lde + col] = __float2bfloat16(inside ? e : 0.f);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // ---- 3x3 output conv to two channels, one upsampled pixel per thread.
  //      Upsampled row R sits at offset row (R+1)>>1, phase R&1. ----
  for (int px = threadIdx.x; px < kOutH * kOutW; px += kThreads) {
    const int R = 2 * i0 + px / kOutW, Cc = 2 * j0 + px % kOutW;
    if (R >= 2 * H || Cc >= 2 * W) continue;
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
    for (int kr = 0; kr < 3; ++kr) {
      const int Rp = R + kr - 1;
      const int lr = ((Rp + 1) >> 1) - i0, a2 = Rp & 1;
#pragma unroll
      for (int kc = 0; kc < 3; ++kc) {
        const int Cp = Cc + kc - 1;
        const int lc = ((Cp + 1) >> 1) - j0, b2 = Cp & 1;
        const __nv_bfloat162* e2 = reinterpret_cast<const __nv_bfloat162*>(
            es + (lr * kTW + lc) * L.lde + (2 * a2 + b2) * Cmid);
        const float4* w4 =
            reinterpret_cast<const float4*>(wos + (kr * 3 + kc) * Cmid * 2);
        for (int m = 0; m < Cmid / 2; ++m) {
          const float2 e = __bfloat1622float2(e2[m]);
          const float4 w = w4[m];  // w[2m][0], w[2m][1], w[2m+1][0], w[2m+1][1]
          acc0 += e.x * w.x + e.y * w.z;
          acc1 += e.x * w.y + e.y * w.w;
        }
      }
    }
    __nv_bfloat162 o;
    o.x = __float2bfloat16(acc0);
    o.y = __float2bfloat16(acc1);
    *reinterpret_cast<__nv_bfloat162*>(
        p.out + (((size_t)n * 2 * H + R) * 2 * W + Cc) * 2) = o;
  }
}

}  // namespace

extern "C" {

// Launches the tail on `stream` (a cudaStream_t) and returns the CUDA error
// code of the launch (0 on success). x [N, H, W, Cin] bf16; kf the
// phase-folded up-conv kernel [2, 2, Cin, 4*Cmid] bf16; bup [Cmid] f32; wo
// [3, 3, Cmid, 2] bf16; out [N, 2H, 2W, 2] bf16. Cin a multiple of 16, Cmid
// a multiple of 4. Widths whose tiles outgrow a block's shared memory come
// back as cudaErrorInvalidValue.
int decoder_tail_fwd(const void* x, const void* kf, const void* bup,
                     const void* wo, void* out, int N, int H, int W, int Cin,
                     int Cmid, void* stream) {
  if (Cin % 16 || Cmid % 4 || N > 65535) return (int)cudaErrorInvalidValue;
  TailParams p;
  p.x = static_cast<const bf16*>(x);
  p.kf = static_cast<const bf16*>(kf);
  p.bup = static_cast<const float*>(bup);
  p.wo = static_cast<const bf16*>(wo);
  p.out = static_cast<bf16*>(out);
  p.N = N;
  p.H = H;
  p.W = W;
  p.Cin = Cin;
  p.Cmid = Cmid;
  const size_t smem = make_layout(Cin, Cmid).total;
  cudaError_t err = cudaFuncSetAttribute(
      decoder_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the next launch's check must not see it
    return (int)err;
  }
  const dim3 grid((unsigned)((W + kJn - 1) / kJn), (unsigned)((H + kIn - 1) / kIn),
                  (unsigned)N);
  decoder_tail_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
