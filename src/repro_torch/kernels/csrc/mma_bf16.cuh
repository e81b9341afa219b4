// Device helpers of the bf16 attention kernels (flash_attention_bf16.cu,
// flash_attention_bwd_bf16.cuh): bf16 tiles in shared memory read into
// mma fragments by ldmatrix, products on the bf16 tensor cores
// (mma.sync.m16n8k16, f32 accumulate), and the bf16 split of a computed
// f32 operand.
//
// The split: x = hi + lo + r with hi = bf16(x) and lo = bf16(x - hi),
// each rounded to nearest even; hi and lo carry 16 significant bits of
// x, and |r| <= 2^-17 |x|.  A product of a computed f32 operand (P or
// dS) with a bf16 input runs as hi * b + lo * b, two mma passes, each
// exact in its products; one pass (hi alone, 8 bits) fails the port's
// bf16 gates and two hold them (tests/test_torch_tf32.py emulates both).
//
// mma.sync.m16n8k16 (bf16) fragment layout, lane = 4 * g + t; each
// register holds two bf16, the lower column (or k) in the low half:
//   A (16 x 16, row):  a0 (g, 2t..2t+1)      a1 (g + 8, 2t..2t+1)
//                      a2 (g, 2t+8..2t+9)    a3 (g + 8, 2t+8..2t+9)
//   B (16 x 8, col):   b0 (k = 2t..2t+1, n = g)   b1 (k = 2t+8..2t+9, n = g)
//   C (16 x 8, f32):   c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
// So the accumulators of two neighbouring n-tiles, packed in pairs, are
// the A fragment of one k-step: P (or dS) moves from a product's output
// into the next product's input with no shuffle and no shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"  // cp_async16

namespace tryage {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async rows [r0, r0 + n) of one head of a (rows, heads, hd) bf16
// tensor (`src` at the head's row 0, rows `stride` elements apart) into a
// tile of HDP columns and rows of `ld` elements; rows at or past `lim`
// and columns at or past hd (up to HDP, hd rounded up to a k-step) are
// zero-filled.  `threads` share the copy, 16 bytes a copy.  Where a
// row's pieces divide the threads (HDP a power of two), each thread
// keeps one column and steps its pointers down the rows.
template <int HDP>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, int ld,
                                           const __nv_bfloat16* src,
                                           size_t stride, int r0, int n,
                                           int lim, int hd, int threads) {
  constexpr int kPieces = HDP / 8;  // 16 bytes a piece
  if constexpr ((kPieces & (kPieces - 1)) == 0) {
    const int c = (threadIdx.x % kPieces) * 8;
    const int step = threads / kPieces;
    const bool col_in = c < hd;
    int r = threadIdx.x / kPieces;
    const __nv_bfloat16* p = src + (size_t)(r0 + r) * stride + c;
    __nv_bfloat16* d = dst + r * ld + c;
    for (; r < n; r += step, p += step * stride, d += step * ld) {
      const bool in = col_in && r0 + r < lim;
      cp_async16(d, in ? p : src, in);
    }
  } else {
    for (int i = threadIdx.x; i < n * kPieces; i += threads) {
      const int r = i / kPieces, c = (i - r * kPieces) * 8;
      const bool in = r0 + r < lim && c < hd;
      cp_async16(dst + r * ld + c,
                 src + (in ? (size_t)(r0 + r) * stride + c : 0), in);
    }
  }
}

// ldmatrix.x4: lane l gives the address of row l % 8 of matrix l / 8 (16
// bytes each); register i of lane (g, t) receives row g, elements 2t and
// 2t + 1 of matrix i (with .trans: row 2t and 2t + 1, element g).
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The A fragment of rows [r0, r0 + 16) and columns [c0, c0 + 16) of a
// row-major bf16 tile with row stride `ld` elements.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int ld,
                                       int r0, int c0) {
  const int l = threadIdx.x & 31;
  ldsm4(a, tile + (r0 + (l & 7) + 8 * ((l >> 3) & 1)) * ld + c0 + 8 * (l >> 4));
}

// The B fragments of two n-tiles [n0, n0 + 16) at k-step [k0, k0 + 16)
// from a tile stored n-major (row n holds the k values: K for q k^T);
// b[i] is n-tile n0 / 8 + i.
__device__ __forceinline__ void load_b(uint32_t (&b)[2][2],
                                       const __nv_bfloat16* tile, int ld,
                                       int n0, int k0) {
  const int l = threadIdx.x & 31;
  uint32_t r[4];
  ldsm4(r, tile + (n0 + (l & 7) + 8 * (l >> 4)) * ld + k0 + 8 * ((l >> 3) & 1));
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

// The same from a tile stored k-major (row k holds the n values: V for
// P V), through ldmatrix.trans.
__device__ __forceinline__ void load_bt(uint32_t (&b)[2][2],
                                        const __nv_bfloat16* tile, int ld,
                                        int k0, int n0) {
  const int l = threadIdx.x & 31;
  uint32_t r[4];
  ldsm4_t(r, tile + (k0 + (l & 7) + 8 * ((l >> 3) & 1)) * ld + n0 + 8 * (l >> 4));
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

// d += A B on the bf16 tensor cores, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Two f32 values as their bf16 pieces hi and lo (see the header), x in
// the low half.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// The split A fragment of k-step kk from the accumulators c of n-tiles
// 2 kk and 2 kk + 1 (the layout note above).
__device__ __forceinline__ void split_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                        const float (&c0)[4],
                                        const float (&c1)[4]) {
  split_bf16(c0[0], c0[1], hi[0], lo[0]);
  split_bf16(c0[2], c0[3], hi[1], lo[1]);
  split_bf16(c1[0], c1[1], hi[2], lo[2]);
  split_bf16(c1[2], c1[3], hi[3], lo[3]);
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x in one MUFU.EX2 (ex2.approx.ftz: within 2 ulp, results below 2^-126
// flushed to 0); the softmax's exp(x - m) is 2^(x log2(e) - m log2(e)),
// the scale and log2(e) folded into one multiply of the scores.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// d += (hi + lo) B: the small piece first.
__device__ __forceinline__ void mma_split(float (&d)[4], const uint32_t (&hi)[4],
                                          const uint32_t (&lo)[4],
                                          const uint32_t (&b)[2]) {
  mma_bf16(d, lo, b);
  mma_bf16(d, hi, b);
}

// Named barrier `id` of `n` threads (id 0 is __syncthreads'): all wait,
// or a producer only arrives.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Split A fragments handed between the two warps of a pair through
// shared memory, [half][k-step][lane][hi, lo]: put_frags writes this
// warp's NH k-steps into slot `half`; after a barrier get_frags reads
// both halves' (half 0's first).
template <int NH>
__device__ __forceinline__ void put_frags(uint4* x, int half,
                                          const uint32_t (&hi)[NH][4],
                                          const uint32_t (&lo)[NH][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < NH; ++kk) {
    uint4* d = x + ((half * NH + kk) * 32 + lane) * 2;
    d[0] = make_uint4(hi[kk][0], hi[kk][1], hi[kk][2], hi[kk][3]);
    d[1] = make_uint4(lo[kk][0], lo[kk][1], lo[kk][2], lo[kk][3]);
  }
}

template <int N>
__device__ __forceinline__ void get_frags(const uint4* x, uint32_t (&hi)[N][4],
                                          uint32_t (&lo)[N][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < N; ++kk) {
    const uint4 u = x[(kk * 32 + lane) * 2], w = x[(kk * 32 + lane) * 2 + 1];
    hi[kk][0] = u.x;
    hi[kk][1] = u.y;
    hi[kk][2] = u.z;
    hi[kk][3] = u.w;
    lo[kk][0] = w.x;
    lo[kk][1] = w.y;
    lo[kk][2] = w.z;
    lo[kk][3] = w.w;
  }
}

// Whether a warp stores output n-tile c of NT = 2 KP: every one when it
// holds all the columns, else those of its half (with KP odd the two
// warps of a pair compute one tile of each other's).
template <bool kHalves, int KP>
__device__ __forceinline__ bool own_tile(int half, int c) {
  return !kHalves || (half == 0 ? c < KP : c >= KP);
}

// Keys [lo, hi) that some row of [row_lo, row_hi] may see under the
// masks, or all T where one of the rows sees none (past T with a
// window: its P is uniform over every key): the rule by which the
// kernels skip tiles (flash_attention/ops.py key_range).
__device__ __forceinline__ void key_range(int row_lo, int row_hi, int T,
                                          int causal, int window, int& lo,
                                          int& hi) {
  lo = 0;
  hi = T;
  if (window <= 0 || row_hi - window + 1 <= T - 1) {
    if (causal) hi = min(T, row_hi + 1);
    if (window > 0) lo = max(0, row_lo - window + 1);
  }
}

}  // namespace tryage
