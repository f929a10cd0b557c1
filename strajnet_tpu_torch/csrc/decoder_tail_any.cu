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
// Cin, Cmid, H and W, and masks the ragged edges itself.
//
// A direct SIMT convolution. A block owns 16 x 16 output pixels of one image
// and keeps what the TPU kernel keeps out of device memory, the elu'd
// intermediate: per chunk of 16 of its channels it computes the 18 x 18
// intermediate pixels its outputs read (the halo is recomputed by the
// neighbours, 1.27x the up-convolution's work) into shared memory, from the
// 10 x 10 input pixels they read, 16 input channels at a time; then it adds
// the chunk's share of the output convolution to its two accumulators per
// pixel. Sums in f32; the intermediate is rounded to T (as the plain version
// rounds it), the output once.
//
// Bound: operations, 9 Cin Cmid multiply-adds per upsampled pixel for the
// up-convolution and 18 Cmid for the output one, on the SIMT units.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;               // output pixels a side
constexpr int kE = kTile + 2;           // intermediate pixels a side
constexpr int kX = kTile / 2 + 2;       // input pixels a side
constexpr int kCM = 16;                 // intermediate channels a chunk
constexpr int kCI = 16;                 // input channels a chunk
constexpr int kEntries = kE * kE * kCM;
constexpr int kPerThread = (kEntries + kThreads - 1) / kThreads;

__device__ __forceinline__ float load(const void* p, long long i, int bf) {
  return bf ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
            : static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float round_to(float v, int bf) {
  return bf ? __bfloat162float(__float2bfloat16(v)) : v;
}

__global__ void __launch_bounds__(kThreads)
    decoder_tail_any_kernel(const void* x, const float* w_up, const float* b_up,
                            const float* w_out, const float* b_out, void* out, int bf,
                            int H, int W, int Cin, int Cmid) {
  __shared__ float xs[kX * kX * kCI];
  __shared__ float wus[9 * kCI * kCM];
  __shared__ float es[kEntries];
  __shared__ float wos[9 * kCM * 2];
  const int H2 = 2 * H, W2 = 2 * W;
  const int tiles_x = (W2 + kTile - 1) / kTile, tiles_y = (H2 + kTile - 1) / kTile;
  const int tid = threadIdx.x;
  const int tx0 = (blockIdx.x % tiles_x) * kTile;
  const int ty0 = ((blockIdx.x / tiles_x) % tiles_y) * kTile;
  const long long img = blockIdx.x / (tiles_x * tiles_y);
  const int lo_y = ty0 / 2 - 1, lo_x = tx0 / 2 - 1;   // input pixel (0, 0) of xs
  const int oy = tid / kTile, ox = tid % kTile;         // this thread's output pixel
  const void* xi = static_cast<const char*>(x) + img * H * W * Cin * (bf ? 2 : 4);
  float acc0 = 0.0f, acc1 = 0.0f;

  for (int cm0 = 0; cm0 < Cmid; cm0 += kCM) {
    float ea[kPerThread];
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) ea[r] = 0.0f;
    for (int ci0 = 0; ci0 < Cin; ci0 += kCI) {
      for (int e = tid; e < kX * kX * kCI; e += kThreads) {
        const int ci = e % kCI, p = e / kCI;
        const int iy = lo_y + p / kX, ix = lo_x + p % kX;
        float v = 0.0f;
        if (iy >= 0 && iy < H && ix >= 0 && ix < W && ci0 + ci < Cin)
          v = load(xi, ((long long)iy * W + ix) * Cin + ci0 + ci, bf);
        xs[e] = v;
      }
      for (int e = tid; e < 9 * kCI * kCM; e += kThreads) {
        const int c = e % kCM, ci = (e / kCM) % kCI, tap = e / (kCM * kCI);
        wus[e] = (ci0 + ci < Cin && cm0 + c < Cmid)
                     ? w_up[((long long)tap * Cin + ci0 + ci) * Cmid + cm0 + c]
                     : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kPerThread; ++r) {
        const int e = tid + kThreads * r;
        if (e >= kEntries) continue;
        const int c = e % kCM, p = e / kCM;
        const int ey = ty0 - 1 + p / kE, ex = tx0 - 1 + p % kE;   // upsampled pixel
        float v = ea[r];
        for (int dy = 0; dy < 3; ++dy) {
          const int uy = ey + dy - 1;
          if (uy < 0 || uy >= H2) continue;
          for (int dx = 0; dx < 3; ++dx) {
            const int ux = ex + dx - 1;
            if (ux < 0 || ux >= W2) continue;
            const float* xp = xs + ((uy / 2 - lo_y) * kX + (ux / 2 - lo_x)) * kCI;
            const float* wp = wus + (dy * 3 + dx) * kCI * kCM + c;
#pragma unroll
            for (int ci = 0; ci < kCI; ++ci) v = fmaf(xp[ci], wp[ci * kCM], v);
          }
        }
        ea[r] = v;
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const int e = tid + kThreads * r;
      if (e >= kEntries) continue;
      const int c = e % kCM, p = e / kCM;
      const int ey = ty0 - 1 + p / kE, ex = tx0 - 1 + p % kE;
      float v = 0.0f;
      if (ey >= 0 && ey < H2 && ex >= 0 && ex < W2 && cm0 + c < Cmid) {
        v = ea[r] + b_up[cm0 + c];
        v = round_to(v > 0.0f ? v : expm1f(v), bf);
      }
      es[e] = v;
    }
    for (int e = tid; e < 9 * kCM * 2; e += kThreads) {
      const int o = e % 2, c = (e / 2) % kCM, tap = e / (2 * kCM);
      wos[e] = cm0 + c < Cmid ? w_out[((long long)tap * Cmid + cm0 + c) * 2 + o] : 0.0f;
    }
    __syncthreads();
    for (int ky = 0; ky < 3; ++ky)
      for (int kx = 0; kx < 3; ++kx) {
        const float* ep = es + ((oy + ky) * kE + ox + kx) * kCM;
        const float* wp = wos + (ky * 3 + kx) * kCM * 2;
#pragma unroll
        for (int c = 0; c < kCM; ++c) {
          acc0 = fmaf(ep[c], wp[2 * c], acc0);
          acc1 = fmaf(ep[c], wp[2 * c + 1], acc1);
        }
      }
    __syncthreads();
  }
  const int gy = ty0 + oy, gx = tx0 + ox;
  if (gy >= H2 || gx >= W2) return;
  const long long o = ((img * H2 + gy) * W2 + gx) * 2;
  const float v0 = acc0 + b_out[0], v1 = acc1 + b_out[1];
  if (bf) {
    static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16(v0);
    static_cast<__nv_bfloat16*>(out)[o + 1] = __float2bfloat16(v1);
  } else {
    static_cast<float*>(out)[o] = v0;
    static_cast<float*>(out)[o + 1] = v1;
  }
}

}  // namespace

extern "C" {

// Launches the tail on `stream` (a cudaStream_t) and returns the CUDA error
// of the launch (0 on success). x [N, H, W, Cin] and out [N, 2H, 2W, 2] in
// bf16 where bf, else f32; w_up [3, 3, Cin, Cmid], b_up [Cmid], w_out
// [3, 3, Cmid, 2] and b_out [2] f32.
int decoder_tail_any_fwd(const void* x, const void* w_up, const void* b_up,
                         const void* w_out, const void* b_out, void* out, int bf, int N,
                         int H, int W, int Cin, int Cmid, void* stream) {
  if (N < 1 || H < 1 || W < 1 || Cin < 1 || Cmid < 1) return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)N * ((2 * H + kTile - 1) / kTile) * ((2 * W + kTile - 1) / kTile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  decoder_tail_any_kernel<<<(unsigned)blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const float*>(w_up), static_cast<const float*>(b_up),
      static_cast<const float*>(w_out), static_cast<const float*>(b_out), out, bf, H, W,
      Cin, Cmid);
  return (int)cudaGetLastError();
}

}  // extern "C"
