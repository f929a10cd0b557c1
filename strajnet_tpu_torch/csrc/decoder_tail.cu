// Fused decoder tail for Hopper (sm_90a):
//
//   out = conv3x3(elu(conv3x3(upsample2x(x), w_up) + b_up), w_out)
//
// with SAME padding on both convolutions and b_out added; x [N, H, W, 96]
// bf16, 48 intermediate channels, out [N, 2H, 2W, 2] bf16.
//
// Replaces strajnet_tpu/ops/pallas_decoder_tail.py::_tail_kernel (reached
// through _tail_call / decoder_tail). What it keeps of that kernel is the
// point of it: the elu'd [N, 2H, 2W, 48] intermediate (805 MB in bf16 at the
// flagship tail, N=128, H=W=128) never goes to device memory. Its layout does
// not cross over: the [H+2, W+16] flattened padding and the slice-adds of its
// packed matrices serve the TPU's sublane alignment.
//
// Both convolutions run in phase form on the "offset grid" (H+1) x (W+1).
// Upsampled pixel (2i+a, 2j+b) reads the 2x2 input taps at rows i+a-1, i+a
// and columns j+b-1, j+b with the phase-folded kernel (4/9 of the
// multiply-adds of a 3x3 on the upsampled image). Entry (r, c) of channel
// block p = 2a+b stands for upsampled pixel (2(r-a)+a, 2(c-b)+b), and all
// four phases share one form:
//
//   y[r, c, :] = sum over taps (u, v) of xpad[r+u, c+v, :] @ Kf[u, v]
//
// with xpad the input padded by one pixel and Kf [2, 2, 96, 192]. The 3x3
// output conv over the upsampled image is, on the same grid, a 2x2 VALID
// conv with the re-bucketed kernel Ky [2, 2, 192, 8], whose 8 lanes are the
// 2x2 output pixels x 2 channels of one entry:
//
//   o[i, j, :] = sum over taps (u, v) of e[i+u, j+v, :] @ Ky[u, v]
//
// pack_tail_weights_kernel folds both kernels in f32, rounds them once and
// writes them in the operand layout of the products below, per launch.
//
// One persistent block per SM walks over tiles of 16 x 8 entries (15 x 7 input
// pixels, 30 x 14 output pixels: neighbouring tiles recompute the one-entry
// halo, 128 / 105 = 1.22x the up-convolution's work). Two consumer
// warpgroups own 8 x 8 entries each; a third warpgroup feeds them:
//
// - Main product [64, 384] x [384, 192] per warpgroup, wgmma m64n96k16 with
//   two accumulators of 96 columns. The input tile with its halo lies in
//   shared memory channel-blocked, [channel / 8][17 x 9 pixels][8]: an 8-row
//   group of the A operand is then eight pixels of one input row, 128
//   contiguous bytes, the groups one pixel row (144 bytes) apart, and a tap
//   (u, v) is an offset of (9 u + v) * 16 bytes on the descriptor's start
//   address: no copy per tap, no fragment loads. Three loader warps bring the
//   next tile in with 16-byte cp.async (zero-filled outside the image) while
//   the consumers work on this one (two buffers, mbarriers).
// - Weights. The folded kernel is 147 KB: beside the input tiles and the
//   intermediate it does not fit in shared memory, so one producer thread
//   streams it per tile through a ring of eight 12 KB stages (32 rows of Kf
//   each) with cp.async.bulk, as the Swin-block kernels stream theirs; the
//   consumers keep one wgmma group in flight and release a stage when the
//   group that read it has retired. 3.2 GB of L2 reads per flagship launch.
// - Epilogue in registers: bias, elu, the border mask (an entry that stands
//   for a pixel outside the image is 0, not elu(b_up): the output conv's zero
//   padding) and the rounding happen on the accumulator fragments, which go
//   straight into the intermediate's operand layout, [channel / 8][entry][8].
// - Output conv on the tensor cores: wgmma m64n8k16 over K = 4 x 192, A the
//   intermediate with a tap's shift (8 u + v entries) as a start-address
//   offset, B = Ky resident in shared memory (12 KB). Row 15 and column 7 of
//   the result belong to the neighbouring tiles and are dropped.
//
// Shared memory: 2 x 29 KB input, 54 KB intermediate, 12 KB Ky, 96 KB ring:
// 221 KB. What bounds the kernel on the H100 is operations by count (324
// GFLOP against 0.44 GB per flagship launch). As built, a tile takes some 12 K
// clocks of which the main product has 40 % (4.7 K, close to the tensor
// cores' 4.4 K for its FLOPs: the ring keeps up), the epilogue 37 % and the
// output conv 16 % (tools/swin_block_bwd_phases.py): both warpgroups leave
// the tensor cores idle while they run their 96 exp and 48 stores a thread
// and the 48 dependent wgmma of eight columns. Tiles of their own per
// warpgroup, out of step with each other, would hide one behind the other.

#include "swin_block_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kCin = 96, kCmid = 48;
constexpr int kN = 4 * kCmid;                 // columns of the main product
constexpr int kTH = 16, kTW = 8;              // offset-grid tile
constexpr int kXH = kTH + 1, kXW = kTW + 1;   // input tile with halo
constexpr int kPix = kXH * kXW;
constexpr int kIn = kTH - 1, kJn = kTW - 1;   // input pixels a tile owns
constexpr int kKb = kCin / 8;                 // 16-byte channel blocks per pixel
constexpr int kInBytes = (kKb * kPix * 16 + 127) / 128 * 128;
// entries of the intermediate, with the tail that the shifted reads of the
// dropped outputs reach
constexpr int kEnt = kTH * kTW + 16;
constexpr int kEBytes = (kN / 8) * kEnt * 16;
constexpr int kKyBytes = 4 * kN * 8 * 2;
constexpr int kStageRows = 32;                // rows of Kf per ring stage
constexpr int kStageBytes = kStageRows * kN * 2;
constexpr int kTileStages = 4 * kCin / kStageRows;
constexpr int kStages = 8;
constexpr int kLoaders = 96;                  // threads of the three loader warps
constexpr int kSmem = 2 * kInBytes + kEBytes + kKyBytes + kN * 4 +
                      kStages * kStageBytes + (2 * kStages + 4) * 8 + 128;
static_assert(kSmem <= 232448, "shared memory of one block");
static_assert(kCin % kStageRows == 0, "a stage lies within one tap");

struct TailParams {
  const bf16* x;          // [N, H, W, 96]
  const uint8_t* kf;      // Kf as [384 / 8][192][8] bf16: the ring's stages
  const float* bup;       // [48]
  const uint8_t* ky;      // Ky as [768 / 8][8][8] bf16
  const float* bout;      // [2]
  bf16* out;              // [N, 2H, 2W, 2]
  int N, H, W, tiles_x, tiles_y;
  long long tiles;
};

struct Tile {
  int n, i0, j0;   // sample, first input row and column the tile owns
};

__device__ __forceinline__ Tile tile_at(const TailParams& p, long long index) {
  Tile t;
  t.j0 = (int)(index % p.tiles_x) * kJn;
  t.i0 = (int)(index / p.tiles_x % p.tiles_y) * kIn;
  t.n = (int)(index / ((long long)p.tiles_x * p.tiles_y));
  return t;
}

// Folds w_up [3, 3, 96, 48] into Kf and re-buckets w_out [3, 3, 48, 2] into
// Ky (both f32 in, bf16 out), 16 bytes of the packed layouts per thread.
__global__ void pack_tail_weights_kernel(const float* __restrict__ w_up,
                                         const float* __restrict__ w_out,
                                         uint8_t* __restrict__ kf,
                                         uint8_t* __restrict__ ky) {
  constexpr int kKfBlocks = 4 * kCin / 8 * kN, kKyBlocks = 4 * kN / 8 * 8;
  // rows of the 3x3 kernel that fold into low-resolution tap u of output
  // phase a: phase 0 reads input row i-1 (row 0) and i (rows 1, 2), phase 1
  // reads i (rows 0, 1) and i+1 (row 2)
  auto first = [](int a, int u) { return u == 0 ? 0 : (a == 0 ? 1 : 2); };
  auto last = [](int a, int u) { return u == 0 ? (a == 0 ? 0 : 1) : 2; };
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < kKfBlocks + kKyBlocks;
       i += gridDim.x * blockDim.x) {
    if (i < kKfBlocks) {
      // Kf[tap (u, v)][ci][48 (2 a + b) + co]
      const int n = i % kN, p = n / kCmid, co = n % kCmid, a = p >> 1, b = p & 1;
      pack_block(kf + (size_t)i * 16, [&](int k, int) {
        const int tap = k / kCin, ci = k % kCin, u = tap >> 1, v = tap & 1;
        float s = 0.f;
        for (int dy = first(a, u); dy <= last(a, u); ++dy)
          for (int dx = first(b, v); dx <= last(b, v); ++dx)
            s += w_up[((dy * 3 + dx) * kCin + ci) * kCmid + co];
        return __float2bfloat16(s);
      }, i / kN, n);
    } else {
      // Ky[tap (u, v)][48 (2 a2 + b2) + m][2 (2 a + b) + o]: tap kr of output
      // phase a reads upsampled row 2 i + a + kr - 1 = 2 (i + u - a2) + a2
      const int j = i - kKfBlocks, n = j % 8, q = n >> 1, a = q >> 1, b = q & 1;
      pack_block(ky + (size_t)j * 16, [&](int k, int) {
        const int tap = k / kN, ch = k % kN, u = tap >> 1, v = tap & 1;
        const int p2 = ch / kCmid, m = ch % kCmid, a2 = p2 >> 1, b2 = p2 & 1;
        const int kr = 2 * u - a2 - a + 1, kc = 2 * v - b2 - b + 1;
        const bool hit = kr >= 0 && kr <= 2 && kc >= 0 && kc <= 2;
        return __float2bfloat16(
            hit ? w_out[((kr * 3 + kc) * kCmid + m) * 2 + (n & 1)] : 0.f);
      }, j / 8, n);
    }
  }
}

// e^x by the hardware's 2^x (relative error about 2^-22, denormals flushed).
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// 16 bytes global -> shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__global__ void __launch_bounds__(kBlockThreads, 1)
decoder_tail_kernel(const TailParams p) {
  extern __shared__ uint8_t tail_smem_raw[];
  uint8_t* smem = tail_smem_raw + ((128u - (smem_u32(tail_smem_raw) & 127u)) & 127u);
  uint8_t* es = smem + 2 * kInBytes;
  uint8_t* kys = es + kEBytes;
  float* bias = reinterpret_cast<float*>(kys + kKyBytes);
  const uint32_t xs_addr = smem_u32(smem);
  const uint32_t ring_data = smem_u32(bias) + kN * 4;
  const uint32_t full = ring_data + kStages * kStageBytes;
  const uint32_t empty = full + 8 * kStages;
  const uint32_t in_full = empty + 8 * kStages;   // [2], then in_empty [2]
  const uint32_t in_empty = in_full + 16;

  PHASE_BEGIN
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(in_full + 8 * b, kLoaders);
      mbar_init(in_empty + 8 * b, 4 * kConsumers);
    }
    ring_init(full, empty, kStages);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int t = threadIdx.x - kConsumers * 128;
    if (t == 0) {
      const int mine = blockIdx.x < p.tiles
                           ? (int)((p.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x)
                           : 0;
      ring_produce(ring_data, full, empty, kStages, kStageBytes, p.kf, mine,
                   kTileStages, [](int) -> uint32_t { return kStageBytes; });
    } else if (t >= 32) {
      // the input tile of every step, channel-blocked, one step ahead
      const int lt = t - 32, kb = lt % kKb;
      int buf = 0;
      uint32_t phase = 0;
      for (long long index = blockIdx.x; index < p.tiles; index += gridDim.x) {
        const Tile tl = tile_at(p, index);
        mbar_wait(in_empty + 8 * buf, phase ^ 1);
        const uint32_t dst = xs_addr + buf * kInBytes + kb * kPix * 16;
        for (int pix = lt / kKb; pix < kPix; pix += kLoaders / kKb) {
          const int gi = tl.i0 - 1 + pix / kXW, gj = tl.j0 - 1 + pix % kXW;
          const bool ok = gi >= 0 && gi < p.H && gj >= 0 && gj < p.W;
          const bf16* src =
              ok ? p.x + (((size_t)tl.n * p.H + gi) * p.W + gj) * kCin + kb * 8 : p.x;
          cp_async16(dst + pix * 16, src, ok);
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        fence_proxy_async();
        mbar_arrive(in_full + 8 * buf);
        buf ^= 1;
        if (buf == 0) phase ^= 1;
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    Ring ring = {ring_data, full, empty, kStages, kStageBytes, 0, 0u};
    const Lane L = make_lane();
    for (int i = threadIdx.x; i < kKyBytes / 16; i += kConsumers * 128)
      reinterpret_cast<uint4*>(kys)[i] = reinterpret_cast<const uint4*>(p.ky)[i];
    for (int i = threadIdx.x; i < kN; i += kConsumers * 128) bias[i] = p.bup[i % kCmid];
    fence_proxy_async();
    named_bar_sync(1, kConsumers * 128);

    const uint32_t e_addr = smem_u32(es) + 64 * wg * 16;   // this warpgroup's entries
    int buf = 0;
    uint32_t in_phase = 0;
    for (long long index = blockIdx.x; index < p.tiles; index += gridDim.x) {
      const Tile tl = tile_at(p, index);

      PHASE_START
      // ---- main product: y = sum over taps of x[r+u, c+v, :] @ Kf[u, v] ----
      mbar_wait(in_full + 8 * buf, in_phase);
      PHASE(0)
      const uint32_t x_addr = xs_addr + buf * kInBytes + 8 * wg * kXW * 16;
      float acc[2][48];
      int prev = 0;
#pragma unroll 1
      for (int s = 0; s < kTileStages; ++s) {
        const uint32_t st = ring.wait();
        const int tap = s / (kCin / kStageRows), u = tap >> 1, v = tap & 1;
        const int kb0 = s % (kCin / kStageRows) * (kStageRows / 8);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kStageRows / 16; ++kk) {
          const uint64_t da =
              make_desc(x_addr + ((kb0 + 2 * kk) * kPix + u * kXW + v) * 16, kPix * 16,
                        kXW * 16);
#pragma unroll
          for (int hb = 0; hb < 2; ++hb)
            wgmma_ss_n96<0, 0>(acc[hb], da,
                               make_desc(st + kk * 2 * kN * 16 + hb * 96 * 16, kN * 16,
                                         128),
                               (s | kk) != 0);
        }
        wgmma_commit();
        // one group stays in flight: the stage before this one is read
        if (s > 0) {
          wgmma_wait1();
          if (threadIdx.x % 32 == 0) mbar_arrive(empty + 8 * prev);
        }
        prev = ring.stage;
        if (++ring.stage == kStages) {
          ring.stage = 0;
          ring.phase ^= 1;
        }
      }
      wgmma_wait0();
      if (threadIdx.x % 32 == 0) {
        mbar_arrive(empty + 8 * prev);
        mbar_arrive(in_empty + 8 * buf);   // the input tile is read
      }
      PHASE(1)

      // ---- e = elu(y + b_up), 0 where the entry stands for a pixel outside
      //      the image, rounded into the output conv's A operand ----
      named_bar_sync(2, kConsumers * 128);   // the last tile's output conv is over
      PHASE(2)
      {
        // channel block p = 2 a2 + b2 (columns 48 p .. 48 p + 47) of entry
        // (gr, gc) stands for upsampled pixel (2 (gr - a2) + a2, 2 (gc - b2) + b2)
        const int gc = tl.j0 + L.g;
        const bool col_in[2] = {gc < p.W, gc >= 1 && gc <= p.W};   // by b2
        uint8_t* dst = es + (64 * wg + L.row0) * 16 + 4 * L.t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int gr = tl.i0 + 8 * wg + (L.row0 >> 3) + half;
          const bool row_in[2] = {gr < p.H, gr >= 1 && gr <= p.H};   // by a2
#pragma unroll
          for (int hb = 0; hb < 2; ++hb) {
#pragma unroll
            for (int j = 0; j < 12; ++j) {
              const int n = 96 * hb + 8 * j;   // + 2 t
              const bool inside = row_in[hb] && col_in[j >= 6];
              const float2 bv = *reinterpret_cast<const float2*>(bias + n + 2 * L.t);
              const float y0 = acc[hb][4 * j + 2 * half] + bv.x;
              const float y1 = acc[hb][4 * j + 2 * half + 1] + bv.y;
              const float e0 = y0 > 0.f ? y0 : exp_fast(y0) - 1.f;
              const float e1 = y1 > 0.f ? y1 : exp_fast(y1) - 1.f;
              *reinterpret_cast<uint32_t*>(dst + ((n >> 3) * kEnt + 8 * half) * 16) =
                  inside ? pack_bf16(e0, e1) : 0u;
            }
          }
        }
      }
      fence_proxy_async();
      PHASE(3)
      named_bar_sync(1, kConsumers * 128);   // both warpgroups' entries are in place
      PHASE(4)

      // ---- output conv: o = sum over taps of e[m + 8 u + v, :] @ Ky[u, v] ----
      float d[2][4];   // two independent sums, so that the products overlap
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4 * kN / 16; ++ks) {
        const int tap = ks / (kN / 16), u = tap >> 1, v = tap & 1;
        const int kb = ks % (kN / 16) * 2;
        wgmma_ss_n8<0, 0>(d[ks & 1],
                          make_desc(e_addr + (kb * kEnt + 8 * u + v) * 16, kEnt * 16, 128),
                          make_desc(smem_u32(kys) + ks * 256, 128, 128),
                          ks >= 2);
      }
      wgmma_commit();
      wgmma_wait0();
      PHASE(5)
      const float2 bo = *reinterpret_cast<const float2*>(p.bout);
      // lanes 2 t, 2 t + 1 of entry (i, j): pixel (2 i + t / 2, 2 j + t % 2)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = L.row0 + 8 * half;
        const int r = 8 * wg + m / 8, c = m % 8;
        const int i = tl.i0 + r, j = tl.j0 + c;
        if (r < kIn && c < kJn && i < p.H && j < p.W) {
          const size_t row = (size_t)tl.n * 2 * p.H + 2 * i + (L.t >> 1);
          *reinterpret_cast<uint32_t*>(p.out +
                                       (row * 2 * p.W + 2 * j + (L.t & 1)) * 2) =
              pack_bf16(bo.x + d[0][2 * half] + d[1][2 * half],
                        bo.y + d[0][2 * half + 1] + d[1][2 * half + 1]);
        }
      }
      PHASE(6)
      buf ^= 1;
      if (buf == 0) in_phase ^= 1;
    }
    PHASE_END
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block.
size_t decoder_tail_smem_bytes() { return kSmem; }

#ifdef SWIN_PHASE_CLOCKS
int decoder_tail_phase_clocks(long long* out) { return phase_clocks_read(out); }
#endif

// Bytes of scratch a launch needs: Kf and Ky packed.
long long decoder_tail_scratch_bytes() { return 4 * kCin * kN * 2 + kKyBytes; }

// Launches the tail on `stream` (a cudaStream_t) and returns the CUDA error
// code of the first failed launch (0 on success). x [N, H, W, 96] bf16; w_up
// [3, 3, 96, 48], bup [48], w_out [3, 3, 48, 2] and bout [2] f32; out
// [N, 2H, 2W, 2] bf16; scratch holds decoder_tail_scratch_bytes. Other widths
// come back as cudaErrorInvalidValue.
int decoder_tail_fwd(const void* x, const void* w_up, const void* bup,
                     const void* w_out, const void* bout, void* out,
                     void* scratch, int N, int H, int W, int Cin, int Cmid,
                     void* stream) {
  if (Cin != kCin || Cmid != kCmid || N < 1 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  uint8_t* kf = static_cast<uint8_t*>(scratch);
  uint8_t* ky = kf + 4 * kCin * kN * 2;
  pack_tail_weights_kernel<<<39, 256, 0, st>>>(static_cast<const float*>(w_up),
                                               static_cast<const float*>(w_out), kf,
                                               ky);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  TailParams p;
  p.x = static_cast<const bf16*>(x);
  p.kf = kf;
  p.bup = static_cast<const float*>(bup);
  p.ky = ky;
  p.bout = static_cast<const float*>(bout);
  p.out = static_cast<bf16*>(out);
  p.N = N;
  p.H = H;
  p.W = W;
  p.tiles_x = (W + kJn - 1) / kJn;
  p.tiles_y = (H + kIn - 1) / kIn;
  p.tiles = (long long)N * p.tiles_x * p.tiles_y;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(decoder_tail_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const unsigned grid = (unsigned)(p.tiles < sms ? p.tiles : sms);
  decoder_tail_kernel<<<grid, kBlockThreads, kSmem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
