// Device helpers shared by the tensor-core kernels (flash_attention.cu,
// flash_attention_bwd.cu, mlstm_scan.cu, mlstm_scan_bwd.cu): f32-exact
// products on the TF32 tensor cores (3xTF32), and cp.async staging (the
// bf16 attention kernels' too).
//
// 3xTF32: an f32 operand x is split into big = tf32(x) and
// small = tf32(x - big), each rounded as cvt.rna.tf32.f32 rounds (to
// nearest, ties away from zero).  A product a * b is then
// small_a * big_b + big_a * small_b + big_a * big_b, three mma.sync
// passes accumulated in f32; the dropped
// small_a * small_b term is below 2^-22 of |a b|.  A single TF32 pass
// keeps about 11 bits and fails the port's f32 tolerances
// (tests/test_torch_tf32.py).
//
// mma.sync.m16n8k8 (TF32) fragment layout, lane = 4 * g + t:
//   A (16 x 8, row):  a0 (g, t)  a1 (g + 8, t)  a2 (g, t + 4)  a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (k = t, n = g)  b1 (k = t + 4, n = g)
//   C (16 x 8):       c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tryage {

struct Split {
  uint32_t big, small;
};

// What cvt.rna.tf32.f32 computes, in two full-rate integer operations
// (add half a TF32 ulp to the bits, clear the low 13); the conversion
// instruction runs at a fraction of that rate, and a kernel that
// splits every operand it feeds the tensor cores would wait on it.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ Split split_tf32(float x) {
  const uint32_t big = to_tf32(x);
  return {big, to_tf32(x - __uint_as_float(big))};
}

// The same split with small left as the f32 difference x - big: the
// tensor cores read a TF32 operand's top 19 bits and drop the rest, so
// they truncate small themselves, two integer operations fewer per
// operand.  Truncated, small's error is below 2^-22 of |x|, against 2^-23
// rounded, far below the f32 gates (tests/test_torch_tf32.py emulates
// both).
__device__ __forceinline__ Split split_tf32_rz(float x) {
  const uint32_t big = to_tf32(x);
  return {big, __float_as_uint(x - __uint_as_float(big))};
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += A B in 3xTF32, with A and B already split: the small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const Split (&a)[4],
                                           const Split (&b)[2]) {
  mma_tf32(d, a[0].small, a[1].small, a[2].small, a[3].small, b[0].big,
           b[1].big);
  mma_tf32(d, a[0].big, a[1].big, a[2].big, a[3].big, b[0].small,
           b[1].small);
  mma_tf32(d, a[0].big, a[1].big, a[2].big, a[3].big, b[0].big, b[1].big);
}

// The same with each pass in its own accumulator: three independent
// chains, for a tile that runs many k-steps with few others beside it
// (mma.sync's latency, not its rate, would set the pace).  The sum is
// d[2] + (d[0] + d[1]).
__device__ __forceinline__ void mma_3xtf32_sep(float (&d)[3][4],
                                               const Split (&a)[4],
                                               const Split (&b)[2]) {
  mma_tf32(d[0], a[0].small, a[1].small, a[2].small, a[3].small, b[0].big,
           b[1].big);
  mma_tf32(d[1], a[0].big, a[1].big, a[2].big, a[3].big, b[0].small,
           b[1].small);
  mma_tf32(d[2], a[0].big, a[1].big, a[2].big, a[3].big, b[0].big, b[1].big);
}

__device__ __forceinline__ float sep_sum(const float (&d)[3][4], int e) {
  return d[2][e] + (d[0][e] + d[1][e]);
}

// 16-byte global -> shared copy; with `pred` false the 16 bytes are
// zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 16 : 0)
               : "memory");
}

// The same for 4 and 8 bytes (through L1: .cg takes 16 bytes only).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem,
                                          bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(gmem), "r"(pred ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace tryage
