// Building blocks of the fp32 flash-attention kernels on Hopper's tensor
// cores in 3xTF32 (flash_attention_fwd_tf32x3.cu, the forward, and
// flash_attention_bwd_tf32x3.cu, dQ and dK/dV): cp.async copies into
// padded shared-memory tiles, the 3xTF32 product on mma.sync.m16n8k8,
// and its fragment loads.  One definition for every such kernel, so that
// a change here (one TF32 product instead of three, say) reaches all.
//
// 3xTF32.  The tensor cores take TF32 (a 10-bit mantissa) at 495
// TFLOP/s.  Each fp32 operand x splits into hi = tf32(x) and
// lo = tf32(x - hi), and
//   a.b ~= a_lo.b_hi + a_hi.b_lo + a_hi.b_hi
// (a_lo.b_lo, ~2^-22 of a.b, dropped): ~22 mantissa bits, fp32's
// accuracy, at a peak of 495 / 3 = 165 TFLOP/s.  The small terms go
// first into the accumulator, so they are not lost against the large
// one.  A single TF32 product (~2^-11 relative per product) is never
// used.
//
// Shared-memory tiles hold fp32 rows padded to D + kPad floats: rows
// stay 16-byte aligned for cp.async, a K-major fragment load (8 rows x 4
// columns a warp) hits banks 4g + t and a permuted MN-major one (rows
// 2t, 2t + 1) banks 8t + g (+ 4): all 32 distinct either way.
#pragma once

#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace tf32x3 {

constexpr int kThreads = 128;   // 4 warps, 16 rows of the block's tile each
constexpr int kPad = 4;         // floats of padding per shared-memory row

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows x D fp32 of a (.., row_stride)-strided tensor into a tile of rows
// padded to D + kPad floats, 16 bytes a copy.
template <int ROWS, int D>
__device__ __forceinline__ void copy_tile(float* dst, const float* src,
                                          size_t row_stride) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    cp_async16(dst + r * (D + kPad) + 4 * c, src + r * row_stride + 4 * c);
  }
}

// n contiguous floats (n a multiple of 4).
__device__ __forceinline__ void copy_row(float* dst, const float* src,
                                         int n) {
  for (int i = threadIdx.x; i < n / 4; i += kThreads)
    cp_async16(dst + 4 * i, src + 4 * i);
}

// ------------------------------------------------------------- 3xTF32

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo (+ what tf32(x - hi) rounds away, < 2^-22 |x|).
template <int N>
struct Split {
  uint32_t hi[N], lo[N];
};

template <int N>
__device__ __forceinline__ Split<N> split(const float (&x)[N]) {
  Split<N> s;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s.hi[i] = to_tf32(x[i]);
    s.lo[i] = to_tf32(x[i] - __uint_as_float(s.hi[i]));
  }
  return s;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b in 3xTF32: the two small products first, then the large one.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const Split<4>& a,
                                           const Split<2>& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// ---------------------------------------------------------- fragments
// Lane = 4g + t.  A (16 x 8, rows m, k): a0 (g, t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4).  B (8 x 8, k x n): b0 (t, g),
// b1 (t + 4, g).  C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
// c3 (g + 8, 2t + 1).  P = D + kPad is a tile's row stride.
//
// The accumulator fragment gives a thread columns 2t and 2t + 1 of its
// rows, while the A fragment wants columns t and t + 4.  So a product
// whose A operand comes from a previous product's accumulators (P or dS)
// runs its k index permuted: logical k = t is column 2t and k = t + 4 is
// column 2t + 1, for A (straight from the accumulator, a_from_acc) and
// for B, whose rows are read from shared memory in the same order
// (load_b_mnmajor_permuted).  No shuffle.

// A from a row-major tile: rows m0.., columns k0.. .
template <int P>
__device__ __forceinline__ Split<4> load_a(const float* s, int m0, int k0,
                                           int g, int t) {
  const float* p = s + (m0 + g) * P + k0 + t;
  const float x[4] = {p[0], p[8 * P], p[4], p[8 * P + 4]};
  return split(x);
}

// B[k][n] = s[n][k] (K-major: the tile's rows are B's columns).
template <int P>
__device__ __forceinline__ Split<2> load_b_kmajor(const float* s, int n0,
                                                  int k0, int g, int t) {
  const float* p = s + (n0 + g) * P + k0 + t;
  const float x[2] = {p[0], p[4]};
  return split(x);
}

// B[k][n] = s[k][n] (MN-major) with k permuted as the accumulator-born A
// operand has it: logical k = t is row k0 + 2t, k = t + 4 row k0 + 2t + 1.
template <int P>
__device__ __forceinline__ Split<2> load_b_mnmajor_permuted(const float* s,
                                                            int k0, int n0,
                                                            int g, int t) {
  const float* p = s + (k0 + 2 * t) * P + n0 + g;
  const float x[2] = {p[0], p[P]};
  return split(x);
}

// The A operand of k-step kk taken from accumulator tile c[kk] (columns
// 8kk .. 8kk + 7), in the permuted k order of load_b_mnmajor_permuted.
__device__ __forceinline__ Split<4> a_from_acc(const float (&c)[4]) {
  const float x[4] = {c[0], c[2], c[1], c[3]};
  return split(x);
}

}  // namespace tf32x3
