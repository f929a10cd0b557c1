// Tensor-core pieces shared by the general-route kernels (window_any.cu,
// decoder_tail_any.cu): element conversions, views of shared-memory tiles,
// mma.sync fragments in bf16 and 3xTF32, ldmatrix and cp.async. sm_80
// instructions, built for sm_90a.
//
// f32 runs as 3xTF32: a = hi + lo with hi = tf32(a), lo = tf32(a - hi)
// (round to nearest even), a b = lo_a hi_b + hi_a lo_b + hi_a hi_b; one TF32
// pass would miss the f32 limits (tests/test_torch_tf32x3.py). The tensor
// cores round their sums toward zero, so a deep f32 sum is kept in stages:
// Tc<float>::mma adds its three passes to a stage accumulator that the
// caller starts from zero, and the caller adds each stage to its f32 total
// to nearest (the product loop a 16-deep stage, the strips each k step:
// Tc<T>::step).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace msync {

typedef __nv_bfloat16 bf16;

// ------------------------------------------------------------ elements

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// v rounded to T
template <typename T>
__device__ __forceinline__ float rnd_t(float v) { return to_f(from_f<T>(v)); }

// lo and hi rounded to bf16 (nearest even) and packed low to high: the
// register of two consecutive elements of a bf16 fragment
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ------------------------------------------------------------ tensor cores

// f32 to TF32, round to nearest even
__device__ __forceinline__ uint32_t tf32_rne(float x) {
  uint32_t r;
  asm("cvt.rn.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A tile in shared memory: element (i, j) at p[i * ld + j] where JC (j
// contiguous), else at p[j * ld + i]. The fragments below read A as (row,
// k) and B as (col, k).
template <typename T, bool JC>
struct View {
  const T* p;
  int ld;
  __device__ __forceinline__ float at(int i, int j) const {
    return to_f(JC ? p[i * ld + j] : p[j * ld + i]);
  }
  // bf16: elements (i, j) and (i, j + 1), packed low to high
  __device__ __forceinline__ uint32_t pair(int i, int j) const {
    if (JC) return *reinterpret_cast<const uint32_t*>(p + i * ld + j);
    const uint32_t lo = __bfloat16_as_ushort(reinterpret_cast<const bf16*>(p)[j * ld + i]);
    const uint32_t hi = __bfloat16_as_ushort(reinterpret_cast<const bf16*>(p)[(j + 1) * ld + i]);
    return lo | (hi << 16);
  }
};

// mma.sync fragments of element type T read through a view v: v.at(i, j)
// the element (as float), and for bf16 v.pair(i, j) elements (i, j) and
// (i, j + 1) packed low to high. A is read as (row, k), B as (col, k); lane
// = g * 4 + t. The accumulator of an m16n8 tile: c[0], c[1] at (g, 2t),
// (g, 2t + 1); c[2], c[3] at (g + 8, 2t), (g + 8, 2t + 1).
template <typename T>
struct Tc;

template <>
struct Tc<bf16> {
  static constexpr int kK = 16;
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t r[2];
  };
  template <typename V>
  static __device__ __forceinline__ void load_a(A& f, const V& v, int r0, int k0, int lane) {
    const int r = r0 + (lane >> 2), k = k0 + 2 * (lane & 3);
    f.r[0] = v.pair(r, k);
    f.r[1] = v.pair(r + 8, k);
    f.r[2] = v.pair(r, k + 8);
    f.r[3] = v.pair(r + 8, k + 8);
  }
  template <typename V>
  static __device__ __forceinline__ void load_b(B& f, const V& v, int k0, int n0, int lane) {
    const int n = n0 + (lane >> 2), k = k0 + 2 * (lane & 3);
    f.r[0] = v.pair(n, k);
    f.r[1] = v.pair(n, k + 8);
  }
  static __device__ __forceinline__ void mma(float* c, const A& a, const B& b) {
    mma_bf16(c, a.r, b.r);
  }
  // one k step of a deep sum: in bf16 straight into the accumulator (the
  // operands' rounding is far coarser than its drift)
  static __device__ __forceinline__ void step(float* c, const A& a, const B& b) { mma(c, a, b); }
};

template <>
struct Tc<float> {
  static constexpr int kK = 8;
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };
  static __device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
    hi = tf32_rne(v);
    lo = tf32_rne(v - __uint_as_float(hi));
  }
  template <typename V>
  static __device__ __forceinline__ void load_a(A& f, const V& v, int r0, int k0, int lane) {
    const int r = r0 + (lane >> 2), k = k0 + (lane & 3);
    split(v.at(r, k), f.hi[0], f.lo[0]);
    split(v.at(r + 8, k), f.hi[1], f.lo[1]);
    split(v.at(r, k + 4), f.hi[2], f.lo[2]);
    split(v.at(r + 8, k + 4), f.hi[3], f.lo[3]);
  }
  template <typename V>
  static __device__ __forceinline__ void load_b(B& f, const V& v, int k0, int n0, int lane) {
    const int n = n0 + (lane >> 2), k = k0 + (lane & 3);
    split(v.at(n, k), f.hi[0], f.lo[0]);
    split(v.at(n, k + 4), f.hi[1], f.lo[1]);
  }
  // 3xTF32 into c, the small cross terms first. The tensor cores round
  // their sums toward zero, so c is a stage accumulator the caller started
  // from zero and adds to its f32 total to nearest: a long sum kept in
  // their accumulator would drift by an ulp a step.
  static __device__ __forceinline__ void mma(float* c, const A& a, const B& b) {
    mma_tf32(c, a.lo, b.hi);
    mma_tf32(c, a.hi, b.lo);
    mma_tf32(c, a.hi, b.hi);
  }
  // one k step of a deep sum as a stage of its own: from zero, then added
  // to c to nearest
  static __device__ __forceinline__ void step(float* c, const A& a, const B& b) {
    float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma(t, a, b);
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] += t[i];
  }
};

// bf16 fragments of f32 elements, each rounded to bf16 (nearest even) as it
// is read: the operands of a product whose plain version rounds them to
// bf16 first. The layouts of Tc<bf16>.
struct Bf16Of {
  template <typename V>
  static __device__ __forceinline__ void load_a(Tc<bf16>::A& f, const V& v, int r0, int k0,
                                                int lane) {
    const int r = r0 + (lane >> 2), k = k0 + 2 * (lane & 3);
    f.r[0] = pack_bf16(v.at(r, k), v.at(r, k + 1));
    f.r[1] = pack_bf16(v.at(r + 8, k), v.at(r + 8, k + 1));
    f.r[2] = pack_bf16(v.at(r, k + 8), v.at(r, k + 9));
    f.r[3] = pack_bf16(v.at(r + 8, k + 8), v.at(r + 8, k + 9));
  }
  template <typename V>
  static __device__ __forceinline__ void load_b(Tc<bf16>::B& f, const V& v, int k0, int n0,
                                                int lane) {
    const int n = n0 + (lane >> 2), k = k0 + 2 * (lane & 3);
    f.r[0] = pack_bf16(v.at(n, k), v.at(n, k + 1));
    f.r[1] = pack_bf16(v.at(n, k + 8), v.at(n, k + 9));
  }
};

// ------------------------------------------------------------ staging

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8 x 8 b16 matrices from shared memory, lane i giving the address of
// row i % 8 of matrix i / 8; thread (g, t) receives (row g, columns 2t,
// 2t + 1) of each, or with TRANS (rows 2t, 2t + 1, column g).
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(s));
}

}  // namespace msync
