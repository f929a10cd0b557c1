// Four-corner gather of a zero-padded image, and its scatter, for Hopper.
//
// Replaces strajnet_tpu/ops/pallas_warp_gather.py::_fwd_kernel (reached
// through _fwd_call) and ::_bwd_kernel (reached through _bwd_call). For every
// query n of image slice s, with integer floor indices (x0, y0):
//
//   forward:   c_ab[s, n] = img[s, y0 + a, x0 + b]          a, b in {0, 1}
//   backward:  dimg[s, y0 + a, x0 + b] += g_ab[s, n]
//
// The bilinear blend of the four corners stays outside, in PyTorch, so that
// the gradient with respect to the query coordinates is plain autograd.
//
// The TPU kernel turns the gather into one-hot matrix products because a TPU
// has no per-lane gather; a GPU thread loads its four corners directly, so
// the result is exact for any f32 image. One thread per query. Both kernels
// are bound by bytes: each query reads two indices and moves four floats; the
// image slice of a query's neighbourhood stays in L2. The scatter uses f32
// atomicAdd, so the order of its sums varies from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(kThreads)
warp_gather_fwd_kernel(const float* __restrict__ img,
                       const float* __restrict__ x0f,
                       const float* __restrict__ y0f, float* __restrict__ c00,
                       float* __restrict__ c01, float* __restrict__ c10,
                       float* __restrict__ c11, long long total, long long n,
                       int hp, int wp) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long s = i / n;
  // the wrapper's clip keeps indices inside; the clamp keeps a bad caller
  // from reading outside the image
  const int x0 = clampi((int)x0f[i], 0, wp - 2);
  const int y0 = clampi((int)y0f[i], 0, hp - 2);
  const float* p = img + ((size_t)s * hp + y0) * wp + x0;
  c00[i] = __ldg(p);
  c01[i] = __ldg(p + 1);
  c10[i] = __ldg(p + wp);
  c11[i] = __ldg(p + wp + 1);
}

__global__ void __launch_bounds__(kThreads)
warp_gather_bwd_kernel(const float* __restrict__ x0f,
                       const float* __restrict__ y0f,
                       const float* __restrict__ g00,
                       const float* __restrict__ g01,
                       const float* __restrict__ g10,
                       const float* __restrict__ g11, float* __restrict__ dimg,
                       long long total, long long n, int hp, int wp) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const long long s = i / n;
  const int x0 = clampi((int)x0f[i], 0, wp - 2);
  const int y0 = clampi((int)y0f[i], 0, hp - 2);
  float* p = dimg + ((size_t)s * hp + y0) * wp + x0;
  atomicAdd(p, g00[i]);
  atomicAdd(p + 1, g01[i]);
  atomicAdd(p + wp, g10[i]);
  atomicAdd(p + wp + 1, g11[i]);
}

}  // namespace

extern "C" {

// img [S, hp, wp] f32; x0f, y0f and the four outputs [S, n] f32. Launches on
// `stream` and returns the CUDA error code of the launch (0 on success).
int warp_gather_fwd(const void* img, const void* x0f, const void* y0f,
                    void* c00, void* c01, void* c10, void* c11, int S,
                    long long n, int hp, int wp, void* stream) {
  const long long total = (long long)S * n;
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  warp_gather_fwd_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const float*>(x0f),
      static_cast<const float*>(y0f), static_cast<float*>(c00),
      static_cast<float*>(c01), static_cast<float*>(c10),
      static_cast<float*>(c11), total, n, hp, wp);
  return (int)cudaGetLastError();
}

// dimg [S, hp, wp] f32, zeroed by the caller on the same stream.
int warp_gather_bwd(const void* x0f, const void* y0f, const void* g00,
                    const void* g01, const void* g10, const void* g11,
                    void* dimg, int S, long long n, int hp, int wp,
                    void* stream) {
  const long long total = (long long)S * n;
  if (total == 0) return 0;
  const unsigned blocks = (unsigned)((total + kThreads - 1) / kThreads);
  warp_gather_bwd_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0f), static_cast<const float*>(y0f),
      static_cast<const float*>(g00), static_cast<const float*>(g01),
      static_cast<const float*>(g10), static_cast<const float*>(g11),
      static_cast<float*>(dimg), total, n, hp, wp);
  return (int)cudaGetLastError();
}

}  // extern "C"
