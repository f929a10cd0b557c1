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
// the result is exact for any f32 image. Both kernels are bound by bytes:
// each query reads two indices and moves four floats.
//
// Forward: one thread per query; the image slice of a query's neighbourhood
// stays in L2.
//
// Backward: scattered f32 atomics to device memory would be paced by the L2
// atomic units (four per query), and need the image zeroed first. Instead a
// block owns a band of `rows` rows of one slice's gradient, held in shared
// memory (a 258 x 258 slice is 266 KB, more than one SM has, hence bands). It
// reads all of its slice's floor rows, coalesced, and reads x0 and the four
// cotangents only of the queries that have a corner row in its band; it adds
// those corners into shared memory and then writes the band once, which also
// writes every zero: no memset. The bands of one slice are neighbours in the
// grid, so they read their slice at about the same time and the second read
// comes from L2. Each thread takes kUnroll queries a blockDim apart per
// step, so that a warp covers consecutive queries: where neighbouring
// queries share corners (a smooth flow) the lanes of one atomic instruction
// hit distinct words in distinct banks. The loads run a step ahead of the
// atomics (the rows two steps ahead, the corners of the queries in the band
// one step ahead), so a thread's two dependent loads and its atomics
// overlap; 1024 threads, the most a block takes, keep the most loads in
// flight on an SM that one such block fills. Float atomics on shared memory
// are compare-and-swap loops on this card, so their bank conflicts and
// retries on scattered targets cost more than plain stores would. The sums
// are f32 in an order that varies from run to run.

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

constexpr int kBwdThreads = 1024;
constexpr int kUnroll = 2;
// Shared memory one block may take on the H100.
constexpr int kMaxSmem = 232448;

// One step's queries of a thread: kUnroll queries kBwdThreads apart.
struct Batch {
  int y[kUnroll];      // row y0 from the band's first row (-2: past the end)
  bool top[kUnroll];   // row y0 in the band
  bool bot[kUnroll];   // row y0 + 1 in the band
  float x[kUnroll];
  float g[4][kUnroll];
};

__device__ __forceinline__ void load_rows(float (&yf)[kUnroll], const float* y0f,
                                          long long q0, long long n) {
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long q = q0 + (long long)k * kBwdThreads;
    yf[k] = q < n ? __ldg(y0f + q) : 0.f;
  }
}

__device__ __forceinline__ void band_rows(Batch& b, const float (&yf)[kUnroll],
                                          long long q0, long long n, int hp, int r0,
                                          int nr) {
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long q = q0 + (long long)k * kBwdThreads;
    b.y[k] = q < n ? clampi((int)yf[k], 0, hp - 2) - r0 : -2;
    b.top[k] = b.y[k] >= 0 && b.y[k] < nr;
    b.bot[k] = b.y[k] + 1 >= 0 && b.y[k] + 1 < nr;
  }
}

// x0 and the four cotangents of the batch's queries that reach the band.
__device__ __forceinline__ void load_corners(Batch& b, const float* x0f,
                                             const float* const (&gs)[4], long long q0) {
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long q = q0 + (long long)k * kBwdThreads;
    b.x[k] = (b.top[k] || b.bot[k]) ? __ldg(x0f + q) : 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      b.g[c][k] = (c < 2 ? b.top[k] : b.bot[k]) ? __ldg(gs[c] + q) : 0.f;
  }
}

__device__ __forceinline__ void scatter(float* band, const Batch& b, int wp) {
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    float* p = band + b.y[k] * wp + clampi((int)b.x[k], 0, wp - 2);
    if (b.top[k]) {
      atomicAdd(p, b.g[0][k]);
      atomicAdd(p + 1, b.g[1][k]);
    }
    if (b.bot[k]) {
      atomicAdd(p + wp, b.g[2][k]);
      atomicAdd(p + wp + 1, b.g[3][k]);
    }
  }
}

__global__ void __launch_bounds__(kBwdThreads)
warp_gather_bwd_kernel(const float* __restrict__ x0f,
                       const float* __restrict__ y0f,
                       const float* __restrict__ g00,
                       const float* __restrict__ g01,
                       const float* __restrict__ g10,
                       const float* __restrict__ g11, float* __restrict__ dimg,
                       long long n, int hp, int wp, int rows, int bands) {
  extern __shared__ float band[];
  const int s = blockIdx.x / bands;
  const int r0 = (blockIdx.x % bands) * rows;
  const int nr = (r0 + rows < hp ? r0 + rows : hp) - r0;
  const int cells = nr * wp;
  for (int i = threadIdx.x; i < cells; i += kBwdThreads) band[i] = 0.f;
  __syncthreads();

  const size_t base = (size_t)s * n;
  const float* ys = y0f + base;
  const float* xs = x0f + base;
  const float* const gs[4] = {g00 + base, g01 + base, g10 + base, g11 + base};
  const long long step = (long long)kUnroll * kBwdThreads;
  long long q0 = threadIdx.x;
  float yf[kUnroll];
  Batch cur;
  load_rows(yf, ys, q0, n);
  band_rows(cur, yf, q0, n, hp, r0, nr);
  load_corners(cur, xs, gs, q0);
  load_rows(yf, ys, q0 + step, n);
  for (; q0 < n; q0 += step) {
    Batch next;
    band_rows(next, yf, q0 + step, n, hp, r0, nr);
    load_corners(next, xs, gs, q0 + step);
    load_rows(yf, ys, q0 + 2 * step, n);
    scatter(band, cur, wp);
    cur = next;
  }
  __syncthreads();
  float* out = dimg + ((size_t)s * hp + r0) * wp;
  for (int i = threadIdx.x; i < cells; i += kBwdThreads) out[i] = band[i];
}

// Dynamic shared memory of one block of the backward at band height `rows`
// and padded width `wp` (0: more than a block may take).
int bwd_smem_bytes(int rows, int wp) {
  const long long bytes = 4LL * rows * wp;
  return bytes <= kMaxSmem ? (int)bytes : 0;
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

// dimg [S, hp, wp] f32, written whole (no zeroing needed); the bands are
// `rows` rows high (1 <= rows; rows * wp floats must fit a block's shared
// memory).
int warp_gather_bwd(const void* x0f, const void* y0f, const void* g00,
                    const void* g01, const void* g10, const void* g11,
                    void* dimg, int S, long long n, int hp, int wp, int rows,
                    void* stream) {
  if (S <= 0) return 0;
  const int smem = bwd_smem_bytes(rows, wp);
  if (hp < 2 || wp < 2 || rows < 1 || smem == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      warp_gather_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int bands = (hp + rows - 1) / rows;
  warp_gather_bwd_kernel<<<(unsigned)((long long)S * bands), kBwdThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0f), static_cast<const float*>(y0f),
      static_cast<const float*>(g00), static_cast<const float*>(g01),
      static_cast<const float*>(g10), static_cast<const float*>(g11),
      static_cast<float*>(dimg), n, hp, wp, rows, bands);
  return (int)cudaGetLastError();
}

}  // extern "C"
