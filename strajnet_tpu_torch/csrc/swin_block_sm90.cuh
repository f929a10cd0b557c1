// Hopper (sm_90a) building blocks of the fused Swin-block kernels
// (swin_block.cu, swin_block_bwd.cu), of the window-attention forward and
// backward (window_attention.cu), of the decoder tail (decoder_tail.cu) and
// of the split-K pass that sums a weight gradient over all tokens:
//
// - PTX wrappers: mbarriers, bulk asynchronous copies (cp.async.bulk), named
//   barriers, wgmma descriptors and instructions;
// - the shared-memory operand layout the fused kernels use (8x8 core
//   matrices, K-major, no swizzle) with the stores that produce it from wgmma
//   accumulator fragments;
// - atb_accum_sm90_kernel: dW[M, N] += A[tokens, M]^T B[tokens, N] with both
//   operands brought in through a ring of stages by plain bulk copies from
//   the token-blocked layout the backward window kernels write, and
//   multiplied by wgmma straight from those tiles;
// - the forward of one Swin block on one 64-token window, owned by one
//   warpgroup from LayerNorm to the last residual, with weights streamed
//   through a ring of shared-memory stages by a producer warp; its heads and
//   output projection (attention_heads_and_proj) are also the whole of the
//   window-attention forward, which hands the projection another epilogue.
//
// A wgmma accumulator of a 64 x N product lives in registers: thread `lane`
// of warp `w` of the warpgroup holds, for every 8-column block j, columns
// 8j + 2t and 8j + 2t + 1 (t = lane % 4) of rows 16w + g and 16w + g + 8
// (g = lane / 4) in d[4j], d[4j+1] and d[4j+2], d[4j+3]. Rounded to bf16 and
// packed in pairs, two neighbouring column blocks are exactly the A fragment
// of the next product's 16-deep step, so chained products (q k^T -> softmax ->
// P v -> projection; fc1 -> GELU -> fc2) never leave the registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {
namespace sm90 {

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spins until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Orders this thread's ordinary shared-memory writes before later reads by
// the asynchronous proxy (wgmma operands, bulk copies).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// `bytes` (a multiple of 16) of contiguous global memory -> shared memory;
// completion is counted on the mbarrier.
__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src,
                                              uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Waits for all but the newest committed group.
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// Shared-memory matrix descriptor of a wgmma operand laid out as 8x8 core
// matrices without swizzle: start address and the two byte strides between
// core matrices ("leading" and "stride").
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

// wgmma.mma_async m64nNk16, bf16 x bf16 -> f32. `ss`: A and B from shared
// memory (TA/TB = 1 reads the operand MN-major); `rs`: A from registers.
// d += A B when scale_d != 0, d = A B otherwise.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n8(float (&d)[4], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, %4, %5, p, 1, 1, %7, %8;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n96(float (&d)[48], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, %51, %52;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, %54;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d), "n"(TB));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// Diagnostic: with -DSWIN_PHASE_CLOCKS the first warpgroup of block 0 sums
// the clocks it spends in each phase of its windows (tools/
// swin_block_bwd_phases.py builds that variant of the two backward kernels and
// of the decoder tail and prints the shares). Each source that includes this
// header has its own sums and exports them through phase_clocks_read.
// PHASE_BEGIN opens a kernel's sums (shared memory, so that a stamp costs
// tens of clocks), PHASE_START a window or tile, PHASE(i) closes phase i,
// PHASE_END adds the kernel's sums to device memory.
#ifdef SWIN_PHASE_CLOCKS
constexpr int kPhases = 9;
__device__ long long g_phase_clocks[kPhases];
__shared__ long long s_phase[kPhases + 1];   // the sums, then the last stamp
#define PHASE_ON (blockIdx.x == 0 && threadIdx.x == 0)
#define PHASE_BEGIN                                          \
  if (PHASE_ON)                                              \
    for (int i = 0; i <= kPhases; ++i) s_phase[i] = 0;
#define PHASE_START \
  if (PHASE_ON) s_phase[kPhases] = clock64();
#define PHASE(i)                                             \
  if (PHASE_ON) {                                            \
    const long long now = clock64();                         \
    s_phase[i] += now - s_phase[kPhases];                    \
    s_phase[kPhases] = now;                                  \
  }
#define PHASE_END                                            \
  if (PHASE_ON)                                              \
    for (int i = 0; i < kPhases; ++i) g_phase_clocks[i] += s_phase[i];
// Copies the kPhases clock sums to `out` and zeroes them.
inline int phase_clocks_read(long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_clocks, sizeof(g_phase_clocks));
  if (err != cudaSuccess) return (int)err;
  const long long zero[kPhases] = {};
  return (int)cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(zero));
}
#else
#define PHASE_BEGIN
#define PHASE_START
#define PHASE(i)
#define PHASE_END
#endif

// ---------------------------------------------------------------------------
// dW[M, N] += A[tokens, M]^T @ B[tokens, N] over slices of the tokens
// ---------------------------------------------------------------------------
// A TPU grid is sequential and sums a weight gradient in scratch that
// persists from one grid step to the next; here blocks run in no order, so
// the window kernels write the two bf16 operands window by window and this
// split-K pass sums them. It is a plain GEMM whose K dimension (tokens) is
// the outer one of both operands in memory, so both are "MN-major" for
// wgmma, which the descriptors' transpose bits name: no transposing copy.
// One producer thread keeps loads of 64-token slabs in flight through a ring
// of stages (128 columns of A, 128 of B); two consumer warpgroups each own 64
// rows of the block's 128 x 128 tile in registers and add it into the zeroed
// f32 output at the end. Bound by the bytes of the operands (each read once
// per tile column or row).

constexpr int kAtbTile = 128;     // tile rows (M) and columns (N)
constexpr int kAtbSlab = 64;      // tokens per stage
constexpr int kAtbStages = 3;
constexpr int kAtbBox = kAtbSlab * 64 * 2;          // 64 tokens x 64 columns, bytes
constexpr int kAtbStageBytes = 4 * kAtbBox;         // 32 KB
constexpr int kAtbThreads = 384;                    // 2 consumer WGs + producer
constexpr int kAtbSmem = kAtbStages * kAtbStageBytes + 1024 + 64;

// Element offset of (row, col) in the token-blocked layout of one window's
// [64, M] operand: [col / 8][row][8]. An accumulator fragment written there
// gives 128 contiguous bytes per warp and 8-column block, and any range of
// column blocks of a window is contiguous, so this pass can fetch its slabs
// with plain bulk copies and needs no tensor map. (Row-major, the same stores
// are 16 bytes per row: the window kernel then spends most of its time
// waiting on its stores.)
__host__ __device__ __forceinline__ int blk_off(int row, int col) {
  return (col >> 3) * (kAtbSlab * 8) + row * 8 + (col & 7);
}

// A and B are [windows][M / 8][64][8] and [windows][N / 8][64][8] (blk_off).
__global__ void __launch_bounds__(kAtbThreads)
atb_accum_sm90_kernel(const bf16* __restrict__ a_blk, const bf16* __restrict__ b_blk,
                      float* __restrict__ out, int M, int N, long long ntok,
                      long long slice) {
  extern __shared__ uint8_t atb_smem_raw[];
  const uint32_t base = (smem_u32(atb_smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + kAtbStages * kAtbStageBytes;  // full[s], empty[s]

  const int n0 = blockIdx.x * kAtbTile, m0 = blockIdx.y * kAtbTile;
  const long long tok_begin = (long long)blockIdx.z * slice;
  long long tok_end = tok_begin + slice;
  if (tok_end > ntok) tok_end = ntok;
  const int iters =
      tok_begin < tok_end ? (int)((tok_end - tok_begin + kAtbSlab - 1) / kAtbSlab) : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kAtbStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kAtbStages + s), 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    if (threadIdx.x == 256) {
      int stage = 0;
      uint32_t phase = 0;
      // columns of the tile that exist: the rest of a stage is never written
      // and only feeds output rows and columns that the epilogue drops
      const uint32_t a_bytes = (uint32_t)(M - m0 < kAtbTile ? M - m0 : kAtbTile) * 128u;
      const uint32_t b_bytes = (uint32_t)(N - n0 < kAtbTile ? N - n0 : kAtbTile) * 128u;
      for (int it = 0; it < iters; ++it) {
        mbar_wait(bars + 8 * (kAtbStages + stage), phase ^ 1);
        const uint32_t full = bars + 8 * stage;
        const uint32_t dst = base + stage * kAtbStageBytes;
        // slices and the token count are multiples of the slab, so no
        // slab reaches into the next slice
        const long long tok = tok_begin + (long long)it * kAtbSlab;
        mbar_expect_tx(full, a_bytes + b_bytes);
        bulk_copy_g2s(dst, a_blk + tok * M + (size_t)m0 * kAtbSlab, a_bytes, full);
        bulk_copy_g2s(dst + 2 * kAtbBox, b_blk + tok * N + (size_t)n0 * kAtbSlab,
                      b_bytes, full);
        if (++stage == kAtbStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  const int lane = threadIdx.x % 32;
  for (int it = 0; it < iters; ++it) {
    mbar_wait(bars + 8 * stage, phase);
    const uint32_t sa = base + stage * kAtbStageBytes + wg * kAtbBox;
    const uint32_t sb = base + stage * kAtbStageBytes + 2 * kAtbBox;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kAtbSlab / 16; ++kk) {
      // [col / 8][token][8]: 8 tokens are 128 bytes (leading offset), the
      // next 8 columns 1024 bytes on (stride offset); 16 tokens per step
      const uint64_t da = make_desc(sa + kk * 256, 128, 1024);
      const uint64_t db = make_desc(sb + kk * 256, 128, 1024);
      wgmma_ss_n128<1, 1>(acc, da, db, 1);
    }
    wgmma_commit();
    wgmma_wait0();
    if (lane == 0) mbar_arrive(bars + 8 * (kAtbStages + stage));
    if (++stage == kAtbStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (iters == 0) return;
  const int g = lane / 4, t = lane % 4;
  const int row0 = m0 + wg * 64 + (threadIdx.x % 128) / 32 * 16 + g;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 8 * half;
      if (row < M) {
        if (col < N) atomicAdd(out + (size_t)row * N + col, acc[4 * j + 2 * half]);
        if (col + 1 < N)
          atomicAdd(out + (size_t)row * N + col + 1, acc[4 * j + 2 * half + 1]);
      }
    }
  }
}

// The card's number of SMs.
inline cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
}

// out[M, N] (f32, already holding the sum so far) += A^T B over ntok tokens.
// M and N must be multiples of 8 (16-byte blocks) and ntok of 64; A and B
// token-blocked (see the kernel).
inline cudaError_t launch_atb(const bf16* A, const bf16* Bm, float* out, int M,
                              int N, long long ntok, int sms,
                              cudaStream_t stream) {
  if (M % 8 || N % 8 || ntok % kAtbSlab) return cudaErrorInvalidValue;
  const int tiles_m = (M + kAtbTile - 1) / kAtbTile;
  const int tiles_n = (N + kAtbTile - 1) / kAtbTile;
  // about two blocks per SM over all tiles
  const long long want = (2LL * sms + tiles_m * tiles_n - 1) / (tiles_m * tiles_n);
  long long slice = (ntok + want - 1) / want;
  slice = (slice + kAtbSlab - 1) / kAtbSlab * kAtbSlab;
  const long long nsplit = (ntok + slice - 1) / slice;
  if (nsplit > 65535) return cudaErrorInvalidValue;
  cudaError_t err =
      cudaFuncSetAttribute(atb_accum_sm90_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kAtbSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)tiles_n, (unsigned)tiles_m, (unsigned)nsplit);
  atb_accum_sm90_kernel<<<grid, kAtbThreads, kAtbSmem, stream>>>(A, Bm, out, M, N,
                                                                 ntok, slice);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The fused block: geometry, operand layout, weight ring
// ---------------------------------------------------------------------------

constexpr int kWs = 8;     // window side
constexpr int kTok = 64;   // tokens per window: one wgmma M tile
constexpr int kHd = 32;    // head dim of every Swin stage of the model
constexpr int kConsumers = 2;                      // warpgroups, one window each
constexpr int kBlockThreads = (kConsumers + 1) * 128;  // + the producer's
// Registers per thread after the warpgroups rebalance (setmaxnreg): the
// block's 64 K registers go to the consumers but for 40 a producer thread.
// (Three consumers at 152 registers were no faster at C=96 and spilled at
// C=192.)
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
static_assert(kConsumers * 128 * kConsumerRegs + 128 * kProducerRegs <= 65536,
              "the register file of one SM");

// Compile-time shapes of the block at channel width C (96, 192 or 384).
template <int C>
struct Cfg {
  static_assert(C == 96 || C == 192 || C == 384, "channel widths of the model");
  static constexpr int kHeads = C / kHd;
  // K slab of a weight tile in the ring (rows of the weight per stage)
  static constexpr int kKs = (C % 64 == 0) ? 64 : 96;
  static constexpr int kNks = C / kKs;
  static constexpr int kKsteps = kKs / 16;   // wgmma steps per slab
  static constexpr int kNc = C / 96;         // 96-column chunks of a [64, C] product
  // A [64, C] f32 accumulator takes C/2 registers per thread: at C=384 the
  // products that sum one over a loop (fc2 over hidden chunks; dh2, dh1 in
  // the backward) run in two passes of 192 columns.
  static constexpr int kPasses = (C > 192) ? 2 : 1;
  static constexpr int kCw = C / kPasses;
  static constexpr int kNb = kCw / 96;
  static constexpr int kStageBytes = kKs * 96 * 2;   // largest tile
  static constexpr int kBufBytes = C * 128;          // one [64, C] bf16 operand
};

// Operand layout in shared memory: element (row, k) of a [rows, K] bf16
// matrix, K-major, as 8x8 core matrices without swizzle: the eight k of one
// row are 16 contiguous bytes, the rows of a k-block follow each other
// (stride-dimension offset 128 bytes per 8 rows), k-blocks are rows*16 bytes
// apart (leading-dimension offset). A is [64 tokens, K]; B is [N, K], i.e.
// the weight tile transposed. One wgmma step (16 k) spans two k-blocks.
__device__ __forceinline__ uint32_t kmaj_off(int row, int k, int rows) {
  return (uint32_t)((k >> 3) * rows * 16 + row * 16 + (k & 7) * 2);
}

__device__ __forceinline__ uint64_t kmaj_desc(uint32_t saddr, int rows, int kstep) {
  return make_desc(saddr + kstep * 2 * rows * 16, rows * 16, 128);
}

// A thread's place in its warpgroup's accumulator fragments.
struct Lane {
  int tid;    // 0..127 in the warpgroup
  int g, t;   // lane / 4, lane % 4
  int row0;   // 16 * warp + g; the second row is row0 + 8
};

__device__ __forceinline__ Lane make_lane() {
  Lane L;
  L.tid = threadIdx.x % 128;
  const int lane = L.tid % 32;
  L.g = lane / 4;
  L.t = lane % 4;
  L.row0 = (L.tid / 32) * 16 + L.g;
  return L;
}

// Rounds NJ 8-column blocks of an accumulator (from block j0) to bf16 as the
// A fragments of NJ / 2 wgmma steps.
template <int NJ>
__device__ __forceinline__ void acc_to_afrag(const float* d, uint32_t (*a)[4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    a[j / 2][(j % 2) * 2 + 0] = pack_bf16(d[4 * j + 0], d[4 * j + 1]);
    a[j / 2][(j % 2) * 2 + 1] = pack_bf16(d[4 * j + 2], d[4 * j + 3]);
  }
}

// Stores two packed bf16 pairs (rows row0 and row0 + 8, columns k, k + 1)
// into a K-major tile whose rows are the accumulator's rows.
__device__ __forceinline__ void st_direct(uint8_t* tile, int rows, const Lane& L,
                                          int k, uint32_t v0, uint32_t v1) {
  *reinterpret_cast<uint32_t*>(tile + kmaj_off(L.row0, k, rows)) = v0;
  *reinterpret_cast<uint32_t*>(tile + kmaj_off(L.row0 + 8, k, rows)) = v1;
}

// The same values into the transposed tile: its rows are the accumulator's
// columns (c, c + 1), its k the accumulator's rows.
__device__ __forceinline__ void st_transposed(uint8_t* tile, int rows, const Lane& L,
                                              int c, uint32_t v0, uint32_t v1) {
  const bf16* p0 = reinterpret_cast<const bf16*>(&v0);
  const bf16* p1 = reinterpret_cast<const bf16*>(&v1);
  *reinterpret_cast<bf16*>(tile + kmaj_off(c, L.row0, rows)) = p0[0];
  *reinterpret_cast<bf16*>(tile + kmaj_off(c + 1, L.row0, rows)) = p0[1];
  *reinterpret_cast<bf16*>(tile + kmaj_off(c, L.row0 + 8, rows)) = p1[0];
  *reinterpret_cast<bf16*>(tile + kmaj_off(c + 1, L.row0 + 8, rows)) = p1[1];
}

// The consumers' view of the weight ring. The producer fills stage after
// stage with the tiles of the packed weights in the order the consumers use
// them; every consumer warpgroup reads every tile, so a stage is free again
// when each of their warps has arrived on its `empty` barrier.
struct Ring {
  uint32_t data, full, empty;   // shared-memory addresses of stage 0
  int stages, stage_bytes;
  int stage;
  uint32_t phase;

  __device__ __forceinline__ uint32_t wait() {
    mbar_wait(full + 8 * stage, phase);
    return data + stage * stage_bytes;
  }
  // after wgmma_wait0: this warp has read the stage
  __device__ __forceinline__ void release() {
    if (threadIdx.x % 32 == 0) mbar_arrive(empty + 8 * stage);
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

__device__ __forceinline__ void ring_init(uint32_t full, uint32_t empty, int stages) {
  for (int s = 0; s < stages; ++s) {
    mbar_init(full + 8 * s, 1);
    mbar_init(empty + 8 * s, 4 * kConsumers);
  }
  fence_barrier_init();
}

// The producer thread: `steps` times the same sequence of tiles, `tile_bytes`
// giving the size of the i-th of the `tiles` tiles, which lie one after the
// other in `packed`.
template <typename TileBytes>
__device__ __forceinline__ void ring_produce(uint32_t data, uint32_t full,
                                             uint32_t empty, int stages,
                                             int stage_bytes, const uint8_t* packed,
                                             int steps, int tiles,
                                             TileBytes tile_bytes) {
  int stage = 0;
  uint32_t phase = 0;
  for (int s = 0; s < steps; ++s) {
    const uint8_t* src = packed;
    for (int i = 0; i < tiles; ++i) {
      const uint32_t bytes = tile_bytes(i);
      mbar_wait(empty + 8 * stage, phase ^ 1);
      mbar_expect_tx(full + 8 * stage, bytes);
      bulk_copy_g2s(data + stage * stage_bytes, src, bytes, full + 8 * stage);
      src += bytes;
      if (++stage == stages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// A warpgroup without a window in the block's last step still frees the
// stages its neighbour reads.
__device__ __forceinline__ void ring_drain(Ring& ring, int tiles) {
  for (int i = 0; i < tiles; ++i) {
    ring.wait();
    ring.release();
  }
}

// acc[64, 96] (+)= A[64, C] @ the next Cfg::kNks tiles [kKs, 96] of the ring,
// A in shared memory (K-major, 64 rows).
template <int C>
__device__ __forceinline__ void mma_smem_n96(float (&acc)[48], uint32_t a_addr,
                                             Ring& ring) {
  using K = Cfg<C>;
#pragma unroll 1
  for (int ks = 0; ks < K::kNks; ++ks) {
    const uint32_t st = ring.wait();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < K::kKsteps; ++kk)
      wgmma_ss_n96<0, 0>(acc, kmaj_desc(a_addr, 64, ks * K::kKsteps + kk),
                         kmaj_desc(st, 96, kk), (ks | kk) != 0);
    wgmma_commit();
    wgmma_wait0();
    ring.release();
  }
}

// The same with 64-column tiles [kKs, 64].
template <int C>
__device__ __forceinline__ void mma_smem_n64(float (&acc)[32], uint32_t a_addr,
                                             Ring& ring) {
  using K = Cfg<C>;
#pragma unroll 1
  for (int ks = 0; ks < K::kNks; ++ks) {
    const uint32_t st = ring.wait();
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < K::kKsteps; ++kk)
      wgmma_ss_n64<0, 0>(acc, kmaj_desc(a_addr, 64, ks * K::kKsteps + kk),
                         kmaj_desc(st, 64, kk), (ks | kk) != 0);
    wgmma_commit();
    wgmma_wait0();
    ring.release();
  }
}

// acc[64, 96] (+)= A @ one ring tile [16 * STEPS, 96], A from registers.
template <int STEPS>
__device__ __forceinline__ void mma_regs_n96(float (&acc)[48],
                                             uint32_t (*a)[4], Ring& ring,
                                             bool accumulate) {
  const uint32_t st = ring.wait();
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk)
    wgmma_rs_n96<0>(acc, a[kk], kmaj_desc(st, 96, kk), accumulate || kk != 0);
  wgmma_commit();
  wgmma_wait0();
  ring.release();
}

// The hardware's tanh (one instruction, relative error about 2^-11): its
// results are rounded to bf16 (2^-9) right away, and at the widths with the
// fewest FLOPs per element the kernels are bound by instruction issue, where
// tanhf's ~30 instructions per element are the largest single item.
__device__ __forceinline__ float tanh_fast(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float gelu_tanh(float z) {
  const float t = tanh_fast(0.7978845608028654f * (z + 0.044715f * z * z * z));
  return 0.5f * z * (1.0f + t);
}

// gelu_tanh(z) and its derivative from one tanh.
__device__ __forceinline__ void gelu_tanh_both(float z, float& g, float& dg) {
  const float t = tanh_fast(0.7978845608028654f * (z + 0.044715f * z * z * z));
  const float du = 0.7978845608028654f * (1.0f + 3.0f * 0.044715f * z * z);
  g = 0.5f * z * (1.0f + t);
  dg = 0.5f * (1.0f + t) + 0.5f * z * (1.0f - t * t) * du;
}

// Sum over the four lanes that share an accumulator row.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
  return v;
}

// ---------------------------------------------------------------------------
// One window's forward, by its warpgroup
// ---------------------------------------------------------------------------

// What the block's forward reads. Pointers to activations are to the whole
// [B, H, W, C] tensors.
struct BlockArgs {
  const bf16* x;
  const bf16* bqkv;       // [3C]
  const bf16* bproj;      // [C]
  const float* rel_bias;  // [heads, 64, 64]
  const float* mask;      // [nW, 64, 64] or null
  const float* ln1s;
  const float* ln1b;
  const float* ln2s;
  const float* ln2b;
  const float* b1;        // [hidden]
  const float* b2;        // [C]
  const float* dp;        // [B, 2]
  int B, H, W, hidden;
  float eps, scale;
};

// One window: where its tokens lie and what scales its branches.
struct Window {
  int b, wi, wy, wx;   // sample, window in the sample, its row and column
  float dp1, dp2;
  int H, W;
  // element offset of token t's channel vector in a [B, H, W, C] tensor
  template <int C>
  __device__ __forceinline__ size_t ofs(int t) const {
    const int row = wy * kWs + t / kWs, col = wx * kWs + t % kWs;
    return ((size_t)(b * H + row) * W + col) * (size_t)C;
  }
};

// Window `index` of a [B, H, W, C] tensor, both branches kept as they are.
__device__ __forceinline__ Window window_at(int H, int W, long long index) {
  Window w;
  const int nwx = W / kWs, per = nwx * (H / kWs);
  w.b = (int)(index / per);
  w.wi = (int)(index % per);
  w.wy = w.wi / nwx;
  w.wx = w.wi % nwx;
  w.dp1 = 1.0f;
  w.dp2 = 1.0f;
  w.H = H;
  w.W = W;
  return w;
}

__device__ __forceinline__ Window make_window(const BlockArgs& p, long long index) {
  Window w = window_at(p.H, p.W, index);
  w.dp1 = p.dp[2 * w.b];
  w.dp2 = p.dp[2 * w.b + 1];
  return w;
}

// The window's 64 rows of `x` as they are into the A operand `hbuf` ([64, C]
// K-major) and into `rows_out` ([64, C] token-blocked, or null): 16 bytes a
// thread, eight lanes on eight rows of one column block (dense loads and
// stores, as in layernorm_window below).
template <int C>
__device__ __forceinline__ void copy_window(const bf16* x, const Window& win,
                                            uint8_t* hbuf, bf16* rows_out, int tid) {
  constexpr int kPer = C / 32;   // 16-byte blocks per lane and row
  const int lane = tid % 32, q = lane / 8;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = (tid / 32) * 16 + (lane % 8) + 8 * half;
    const bf16* xr = x + win.ofs<C>(row);
    uint4 v[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      v[i] = *reinterpret_cast<const uint4*>(xr + (4 * i + q) * 8);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c0 = (4 * i + q) * 8;
      *reinterpret_cast<uint4*>(hbuf + kmaj_off(row, c0, 64)) = v[i];
      if (rows_out) *reinterpret_cast<uint4*>(rows_out + blk_off(row, c0)) = v[i];
    }
  }
}

// LayerNorm of the window's 64 rows of `x` into the A operand `hbuf`
// ([64, C] K-major), and into `rows_out` ([64, C] token-blocked, or null). Eight
// lanes take eight rows at the same 16-byte column block, so both the global
// loads (64 contiguous bytes per row and quarter warp) and the
// shared-memory stores (128 contiguous bytes) are dense.
template <int C>
__device__ __forceinline__ void layernorm_window(const bf16* x, const Window& win,
                                                 const float* s, const float* bv,
                                                 float eps, uint8_t* hbuf,
                                                 bf16* rows_out, int tid) {
  constexpr int kPer = C / 32;   // 16-byte blocks per lane and row
  const int lane = tid % 32, q = lane / 8;
#pragma unroll 1
  for (int half = 0; half < 2; ++half) {
    const int row = (tid / 32) * 16 + (lane % 8) + 8 * half;
    const bf16* xr = x + win.ofs<C>(row);
    uint4 v[kPer];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      v[i] = *reinterpret_cast<const uint4*>(xr + (4 * i + q) * 8);
      const uint32_t* w4 = reinterpret_cast<const uint32_t*>(&v[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack_bf16(w4[e]);
        sum += f.x + f.y;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 8);
    sum += __shfl_xor_sync(0xffffffffu, sum, 16);
    const float mu = sum / C;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const uint32_t* w4 = reinterpret_cast<const uint32_t*>(&v[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack_bf16(w4[e]);
        sq += (f.x - mu) * (f.x - mu) + (f.y - mu) * (f.y - mu);
      }
    }
    sq += __shfl_xor_sync(0xffffffffu, sq, 8);
    sq += __shfl_xor_sync(0xffffffffu, sq, 16);
    const float inv = rsqrtf(sq / C + eps);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c0 = (4 * i + q) * 8;
      const uint32_t* w4 = reinterpret_cast<const uint32_t*>(&v[i]);
      uint4 o;
      uint32_t* o4 = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = unpack_bf16(w4[e]);
        const float2 sc = *reinterpret_cast<const float2*>(s + c0 + 2 * e);
        const float2 bi = *reinterpret_cast<const float2*>(bv + c0 + 2 * e);
        o4[e] = pack_bf16((f.x - mu) * inv * sc.x + bi.x,
                          (f.y - mu) * inv * sc.y + bi.y);
      }
      *reinterpret_cast<uint4*>(hbuf + kmaj_off(row, c0, 64)) = o;
      if (rows_out) *reinterpret_cast<uint4*>(rows_out + blk_off(row, c0)) = o;
    }
  }
}

// Scratch of one window in the backward (null pointers in the forward), each
// in the token-blocked layout (blk_off).
struct FwdSaves {
  bf16* h1;      // [64, C]   LN1 output
  bf16* qkv;     // [64, 3C]  q | k | v
  bf16* merged;  // [64, C]   concatenated head outputs
  bf16* h2;      // [64, C]   LN2 output
};

// Where a thread parks pair `slot` (column block * 2 + row half) of a
// [64, C] array that only it reads back: [slot][128 threads], so every warp
// access is one contiguous run.
__device__ __forceinline__ int park_idx(int slot, const Lane& L) {
  return slot * 128 + L.tid;
}

// Per-row LayerNorm statistics of r1 that the backward needs again.
struct RowStats {
  float mu[2], inv[2];
};

// Softmax weights of head h in registers: S = q k^T from the A fragments `qa`
// and the K-major tile `kdir` ([64 keys, 32]), scaled, plus rel-pos bias and
// mask, normalised over each row (16 columns in this thread, the rest in the
// three other lanes of its quad). Returns f32 weights in s.
__device__ __forceinline__ void head_softmax(float (&s)[32], uint32_t (*qa)[4],
                                             uint32_t kdir, const float* rel_h,
                                             const float* mask_w, float scale,
                                             const Lane& L) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk)
    wgmma_rs_n64<0>(s, qa[kk], kmaj_desc(kdir, 64, kk), kk != 0);
  wgmma_commit();
  wgmma_wait0();
  float mx[2] = {-3.0e38f, -3.0e38f};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int o = (L.row0 + 8 * half) * kTok + 8 * j + 2 * L.t;
      float2 add = *reinterpret_cast<const float2*>(rel_h + o);
      if (mask_w) {
        const float2 m = *reinterpret_cast<const float2*>(mask_w + o);
        add.x += m.x;
        add.y += m.y;
      }
      s[4 * j + 2 * half] = s[4 * j + 2 * half] * scale + add.x;
      s[4 * j + 2 * half + 1] = s[4 * j + 2 * half + 1] * scale + add.y;
      mx[half] = fmaxf(mx[half], fmaxf(s[4 * j + 2 * half], s[4 * j + 2 * half + 1]));
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) mx[half] = quad_max(mx[half]);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = __expf(s[4 * j + 2 * half + e] - mx[half]);
        s[4 * j + 2 * half + e] = v;
        sum[half] += v;
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) sum[half] = 1.0f / quad_sum(sum[half]);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      s[4 * j + 2 * half] *= sum[half];
      s[4 * j + 2 * half + 1] *= sum[half];
    }
  }
}

// One head's output as the A fragments of its 32 columns of the merged heads,
// and the ring's position after the head's tiles.
struct HeadOut {
  uint32_t a[2][4];
  int stage;
  uint32_t phase;
};

// Head h of one window: q|k|v = h1 @ wqkv[:, head] + bias (kNks ring tiles),
// softmax(scale q k^T + rel-pos bias + mask), P v. k and v^T go through the
// 8 KB at `kdir`; with sv_qkv / sv_merged not null, q|k|v and the output are
// also written there (token-blocked). Not inlined on purpose: the block's
// code is walked once per window, and with one copy per head it outgrows the
// instruction cache (the same instructions then run about half as fast).
template <int C>
__device__ __noinline__ HeadOut attention_head(uint32_t h_addr, uint8_t* kdir, int h,
                                               const bf16* bqkv, const float* rel_h,
                                               const float* mask_w, float scale,
                                               Ring ring, bf16* sv_qkv,
                                               bf16* sv_merged, int bar_id, Lane L) {
  uint8_t* vt = kdir + 4096;   // [32, 64 keys] K-major: v^T; kdir is [64 keys, 32]
  HeadOut out;
  uint32_t qa[2][4];
  {
    // loads go out before the product and are used after it
    uint32_t bq[12];
#pragma unroll
    for (int j = 0; j < 12; ++j)
      bq[j] = *reinterpret_cast<const uint32_t*>(bqkv + (j / 4) * C + h * kHd +
                                                 8 * (j % 4) + 2 * L.t);
    float acc[48];
    mma_smem_n96<C>(acc, h_addr, ring);
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int part = j / 4, d = 8 * (j % 4) + 2 * L.t;
      const int col = part * C + h * kHd + d;
      const float2 bias = unpack_bf16(bq[j]);
      const uint32_t v0 = pack_bf16(acc[4 * j] + bias.x, acc[4 * j + 1] + bias.y);
      const uint32_t v1 = pack_bf16(acc[4 * j + 2] + bias.x, acc[4 * j + 3] + bias.y);
      if (part == 0) {
        qa[(j % 4) / 2][(j % 2) * 2] = v0;
        qa[(j % 4) / 2][(j % 2) * 2 + 1] = v1;
      } else if (part == 1) {
        st_direct(kdir, 64, L, d, v0, v1);
      } else {
        st_transposed(vt, 32, L, d, v0, v1);
      }
      if (sv_qkv) {
        *reinterpret_cast<uint32_t*>(sv_qkv + blk_off(L.row0, col)) = v0;
        *reinterpret_cast<uint32_t*>(sv_qkv + blk_off(L.row0 + 8, col)) = v1;
      }
    }
  }
  fence_proxy_async();
  named_bar_sync(bar_id, 128);   // k, v^T of all four warps are in place
  uint32_t pa[4][4];
  {
    float s[32];
    head_softmax(s, qa, smem_u32(kdir), rel_h, mask_w, scale, L);
    acc_to_afrag<8>(s, pa);
  }
  float o[16];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_n32<0>(o, pa[kk], kmaj_desc(smem_u32(vt), 32, kk), kk != 0);
  wgmma_commit();
  wgmma_wait0();
  acc_to_afrag<4>(o, out.a);
  if (sv_merged) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = h * kHd + 8 * j + 2 * L.t;
      *reinterpret_cast<uint32_t*>(sv_merged + blk_off(L.row0, col)) =
          out.a[j / 2][(j % 2) * 2];
      *reinterpret_cast<uint32_t*>(sv_merged + blk_off(L.row0 + 8, col)) =
          out.a[j / 2][(j % 2) * 2 + 1];
    }
  }
  out.stage = ring.stage;
  out.phase = ring.phase;
  return out;
}

// The heads and the output projection of one window, with its input (LN1(x)
// in K1 and K2, x itself in the window-attention forward) in the A operand
// at `h_addr`:
//   per head: q|k|v, softmax, P v -> merged (registers);
//   per 96-column chunk nc: acc = merged @ wproj, and for each of this
//   thread's pairs epi.put(nc, j, half, row, col, a0, a1) with
//   a = acc + bproj in f32 (columns col, col + 1 of `row`, 8-column block j
//   of the chunk). epi.load(nc, j) runs before the chunk's product, beside
//   the load of bproj, so that its loads are in flight while the tensor
//   cores work.
// `kv` is 16 KB of shared memory for two heads' k and v^T tiles. Consumes
// kHeads * kNks + kNc * kNks ring tiles. Every warp's reads of the A operand
// (the last head's q|k|v product) lie before its last barrier here, so the
// operand may be overwritten as soon as this returns; the k | v^T tiles are
// read until the end of the last head.
template <int C, typename Epilogue>
__device__ __forceinline__ void attention_heads_and_proj(
    const BlockArgs& p, const Window& win, uint32_t h_addr, uint8_t* kv, Ring& ring,
    const FwdSaves& sv, int bar_id, const Lane& L, Epilogue& epi) {
  using K = Cfg<C>;
  const float* mask_w = p.mask ? p.mask + (size_t)win.wi * kTok * kTok : nullptr;
  uint32_t ma[C / 16][4];   // merged heads as A fragments
#pragma unroll
  for (int h = 0; h < K::kHeads; ++h) {
    const HeadOut ho = attention_head<C>(
        h_addr, kv + (h & 1) * 8192, h, p.bqkv, p.rel_bias + (size_t)h * kTok * kTok,
        mask_w, p.scale, ring, sv.qkv, sv.merged, bar_id, L);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) ma[2 * h + i][e] = ho.a[i][e];
    ring.stage = ho.stage;
    ring.phase = ho.phase;
  }

#pragma unroll 1
  for (int nc = 0; nc < K::kNc; ++nc) {
    uint32_t bp[12];
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      bp[j] = *reinterpret_cast<const uint32_t*>(p.bproj + 96 * nc + 8 * j + 2 * L.t);
      epi.load(nc, j);
    }
    float acc[48];
#pragma unroll
    for (int ks = 0; ks < K::kNks; ++ks)
      mma_regs_n96<K::kKsteps>(acc, &ma[ks * K::kKsteps], ring, ks != 0);
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      const int col = 96 * nc + 8 * j + 2 * L.t;
      const float2 bias = unpack_bf16(bp[j]);
#pragma unroll
      for (int half = 0; half < 2; ++half)
        epi.put(nc, j, half, L.row0 + 8 * half, col, acc[4 * j + 2 * half] + bias.x,
                acc[4 * j + 2 * half + 1] + bias.y);
    }
  }
}

// The block's epilogue of the projection: r1 = x + dp1 * (merged @ wproj +
// bproj), rounded once, parked (64 * C / 2 pairs of this window, park_idx)
// and written over the A operand for LN2; sums each row for its mean.
template <int C>
struct ResidualEpilogue {
  const BlockArgs& p;
  const Window& win;
  uint8_t* hbuf;
  uint32_t* park;
  const Lane& L;
  float rsum[2];
  uint32_t xr[12][2];

  __device__ __forceinline__ void load(int nc, int j) {
#pragma unroll
    for (int half = 0; half < 2; ++half)
      xr[j][half] = *reinterpret_cast<const uint32_t*>(
          p.x + win.ofs<C>(L.row0 + 8 * half) + 96 * nc + 8 * j + 2 * L.t);
  }
  __device__ __forceinline__ void put(int nc, int j, int half, int row, int col,
                                      float a0, float a1) {
    const float2 xv = unpack_bf16(xr[j][half]);
    const uint32_t r = pack_bf16(xv.x + win.dp1 * a0, xv.y + win.dp1 * a1);
    park[park_idx((12 * nc + j) * 2 + half, L)] = r;
    *reinterpret_cast<uint32_t*>(hbuf + kmaj_off(row, col, 64)) = r;
    const float2 rf = unpack_bf16(r);
    rsum[half] += rf.x + rf.y;
  }
};

// The attention half of the block for one window:
//   LN1(x) -> hbuf;  per head: q|k|v, softmax, P v -> merged (registers);
//   r1 = x + dp1 * (merged @ wproj + bproj) -> `park` (64 * C / 2 pairs of
//   this window, park_idx) and hbuf;  LN2(r1) -> hbuf.
// `kv` is 16 KB of shared memory for two heads' k and v^T tiles. Consumes
// kHeads * kNks + kNc * kNks ring tiles. Ends with the warpgroup in step and
// hbuf visible to wgmma.
template <int C>
__device__ __forceinline__ void window_attention_half(
    const BlockArgs& p, const Window& win, uint8_t* hbuf, uint8_t* kv, Ring& ring,
    uint32_t* park, const FwdSaves& sv, RowStats& stats, int bar_id, const Lane& L) {
  layernorm_window<C>(p.x, win, p.ln1s, p.ln1b, p.eps, hbuf, sv.h1, L.tid);
  fence_proxy_async();
  named_bar_sync(bar_id, 128);

  // hbuf takes r1 as soon as the heads have read it
  ResidualEpilogue<C> epi = {p, win, hbuf, park, L, {0.f, 0.f}, {}};
  attention_heads_and_proj<C>(p, win, smem_u32(hbuf), kv, ring, sv, bar_id, L, epi);

  // ---- LN2 in place: every thread normalises the elements it wrote ----
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = L.row0 + 8 * half;
    const float mu = quad_sum(epi.rsum[half]) / C;
    float sq = 0.f;
#pragma unroll 4
    for (int jc = 0; jc < C / 8; ++jc) {
      const float2 rf = unpack_bf16(*reinterpret_cast<const uint32_t*>(
          hbuf + kmaj_off(row, 8 * jc + 2 * L.t, 64)));
      sq += (rf.x - mu) * (rf.x - mu) + (rf.y - mu) * (rf.y - mu);
    }
    const float inv = rsqrtf(quad_sum(sq) / C + p.eps);
    stats.mu[half] = mu;
    stats.inv[half] = inv;
#pragma unroll 4
    for (int jc = 0; jc < C / 8; ++jc) {
      const int col = 8 * jc + 2 * L.t;
      uint32_t* slot = reinterpret_cast<uint32_t*>(hbuf + kmaj_off(row, col, 64));
      const float2 rf = unpack_bf16(*slot);
      const float2 sc = *reinterpret_cast<const float2*>(p.ln2s + col);
      const float2 bi = *reinterpret_cast<const float2*>(p.ln2b + col);
      const uint32_t hv = pack_bf16((rf.x - mu) * inv * sc.x + bi.x,
                                    (rf.y - mu) * inv * sc.y + bi.y);
      *slot = hv;
      if (sv.h2) *reinterpret_cast<uint32_t*>(sv.h2 + blk_off(row, col)) = hv;
    }
  }
  fence_proxy_async();
  named_bar_sync(bar_id, 128);
}

// The MLP half for one window: out = r1 + dp2 * (gelu(h2 @ w1 + b1) @ w2 + b2)
// with h2 in hbuf and r1 in `park`. Per pass of kCw output columns and
// per 64 hidden columns: kNks tiles of w1, then kNb tiles [64, 96] of w2.
template <int C>
__device__ __forceinline__ void window_mlp_half(const BlockArgs& p, const Window& win,
                                                uint8_t* hbuf, Ring& ring,
                                                const uint32_t* park, bf16* out,
                                                const Lane& L) {
  using K = Cfg<C>;
  const uint32_t h_addr = smem_u32(hbuf);
#pragma unroll 1
  for (int pass = 0; pass < K::kPasses; ++pass) {
    float oacc[K::kCw / 2];
#pragma unroll
    for (int i = 0; i < K::kCw / 2; ++i) oacc[i] = 0.f;
#pragma unroll 1
    for (int j0 = 0; j0 < p.hidden; j0 += 64) {
      uint32_t ga[4][4];
      {
        float z[32];
        mma_smem_n64<C>(z, h_addr, ring);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 bias =
              *reinterpret_cast<const float2*>(p.b1 + j0 + 8 * j + 2 * L.t);
          z[4 * j] = gelu_tanh(z[4 * j] + bias.x);
          z[4 * j + 1] = gelu_tanh(z[4 * j + 1] + bias.y);
          z[4 * j + 2] = gelu_tanh(z[4 * j + 2] + bias.x);
          z[4 * j + 3] = gelu_tanh(z[4 * j + 3] + bias.y);
        }
        acc_to_afrag<8>(z, ga);
      }
#pragma unroll
      for (int nb = 0; nb < K::kNb; ++nb)
        mma_regs_n96<4>(*reinterpret_cast<float(*)[48]>(&oacc[48 * nb]), ga, ring,
                        true);
    }
    // r1 comes back in batches of 12 column blocks
#pragma unroll
    for (int jb = 0; jb < K::kCw / 8; jb += 12) {
      uint32_t r1v[12][2];
      float2 bias[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        const int col = pass * K::kCw + 8 * (jb + i) + 2 * L.t;
        bias[i] = *reinterpret_cast<const float2*>(p.b2 + col);
#pragma unroll
        for (int half = 0; half < 2; ++half)
          r1v[i][half] = park[park_idx((col >> 3) * 2 + half, L)];
      }
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        const int jc = jb + i, col = pass * K::kCw + 8 * jc + 2 * L.t;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const float2 r1 = unpack_bf16(r1v[i][half]);
          *reinterpret_cast<uint32_t*>(out + win.ofs<C>(L.row0 + 8 * half) + col) =
              pack_bf16(r1.x + win.dp2 * (oacc[4 * jc + 2 * half] + bias[i].x),
                        r1.y + win.dp2 * (oacc[4 * jc + 2 * half + 1] + bias[i].y));
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Packing weights into ring tiles
// ---------------------------------------------------------------------------
// A tile is B^T of one product step in the operand layout above: for its
// [KT, NT] slice of the weight, 16-byte blocks [k / 8][n][8 k]. The packing
// kernels write, per 16-byte block, eight elements gathered from the
// row-major weight; `src(k, n)` names the element.
template <typename Src>
__device__ __forceinline__ void pack_block(uint8_t* dst, Src src, int k8, int n) {
  uint4 o;
  bf16* e = reinterpret_cast<bf16*>(&o);
#pragma unroll
  for (int i = 0; i < 8; ++i) e[i] = src(k8 * 8 + i, n);
  *reinterpret_cast<uint4*>(dst) = o;
}

// Bytes of the forward's packed weights: wqkv by head, wproj by column chunk,
// then per pass and hidden chunk w1's columns and w2's rows.
template <int C>
__host__ __device__ constexpr long long fwd_attn_tiles_bytes() {
  return (long long)(Cfg<C>::kHeads + Cfg<C>::kNc) * C * 96 * 2;
}
template <int C>
__host__ __device__ constexpr long long fwd_mlp_group_bytes() {
  return (long long)C * 64 * 2 + (long long)Cfg<C>::kNb * 64 * 96 * 2;
}

// Packs the attention half's tiles: per head h, kNks tiles of
// wqkv[:, q|k|v columns of h]; per 96-column chunk, kNks tiles of wproj.
template <int C>
__device__ __forceinline__ void pack_attention_tiles(uint8_t* dst, const bf16* wqkv,
                                                     const bf16* wproj, long long i) {
  using K = Cfg<C>;
  constexpr int kPerTile = K::kKs / 8 * 96;   // 16-byte blocks per tile
  const int tile = (int)(i / kPerTile), r = (int)(i % kPerTile);
  const int k8 = r / 96, n = r % 96, ks = tile % K::kNks, grp = tile / K::kNks;
  uint8_t* o = dst + i * 16;
  if (grp < K::kHeads) {
    const int col = (n / kHd) * C + grp * kHd + n % kHd;
    pack_block(o, [&](int k, int) { return wqkv[(size_t)(ks * K::kKs + k) * 3 * C + col]; },
               k8, n);
  } else {
    const int col = (grp - K::kHeads) * 96 + n;
    pack_block(o, [&](int k, int) { return wproj[(size_t)(ks * K::kKs + k) * C + col]; },
               k8, n);
  }
}

template <int C>
__global__ void pack_fwd_kernel(uint8_t* dst, const bf16* wqkv, const bf16* wproj,
                                const bf16* w1, const bf16* w2, int hidden) {
  using K = Cfg<C>;
  constexpr long long kAttn = fwd_attn_tiles_bytes<C>() / 16;
  constexpr int kW1 = C / 8 * 64;              // blocks of w1 per hidden chunk
  constexpr int kGroup = kW1 + K::kNb * 8 * 96;
  const int chunks = hidden / 64;
  const long long total = kAttn + (long long)K::kPasses * chunks * kGroup;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < kAttn) {
      pack_attention_tiles<C>(dst, wqkv, wproj, i);
      continue;
    }
    const long long m = i - kAttn;
    const int grp = (int)(m / kGroup), r = (int)(m % kGroup);
    const int pass = grp / chunks, j0 = (grp % chunks) * 64;
    uint8_t* o = dst + i * 16;
    if (r < kW1) {
      const int ks = r / (K::kKs / 8 * 64), r2 = r % (K::kKs / 8 * 64);
      const int k8 = r2 / 64, n = r2 % 64;
      pack_block(o, [&](int k, int) {
        return w1[(size_t)(ks * K::kKs + k) * hidden + j0 + n]; }, k8, n);
    } else {
      const int r2 = r - kW1, nb = r2 / 768, r3 = r2 % 768;
      const int k8 = r3 / 96, n = r3 % 96;
      pack_block(o, [&](int k, int) {
        return w2[(size_t)(j0 + k) * C + pass * K::kCw + nb * 96 + n]; }, k8, n);
    }
  }
}

}  // namespace sm90
}  // namespace
