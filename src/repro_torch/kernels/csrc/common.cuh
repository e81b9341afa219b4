// Device helpers shared by the router kernels (router_score.cu,
// router_cascade.cu).  The math matches the JAX package's defaults:
// jax.nn.gelu is the tanh approximation and jax.nn.softplus is
// logaddexp(x, 0), written here in its overflow-free form.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace tryage {

constexpr int kRouterThreads = 128;

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

// Stage `rows` embedding rows (row-major, width d) into shared memory.
__device__ __forceinline__ void load_rows(const float* __restrict__ src,
                                          int rows, int d, float* dst) {
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) dst[i] = src[i];
}

// h[r, j] = gelu(emb[r, :] @ w1[:, j] + b1[j]) for the block's rows.
// Threads run over (row, j); w1 is (d, hh) row-major, so neighbouring
// threads read neighbouring w1 columns and the loads coalesce.
__device__ __forceinline__ void mlp_hidden(const float* emb_s, int rows,
                                           int d,
                                           const float* __restrict__ w1,
                                           const float* __restrict__ b1,
                                           int hh, float* h_s) {
  for (int idx = threadIdx.x; idx < rows * hh; idx += blockDim.x) {
    const int r = idx / hh, j = idx - r * hh;
    const float* e = emb_s + r * d;
    float acc = 0.0f;
    for (int k = 0; k < d; ++k) acc = fmaf(e[k], w1[(size_t)k * hh + j], acc);
    h_s[idx] = gelu_tanh(acc + b1[j]);
  }
}

// h_row @ w2[:, m] + b2[m], with w2 (hh, M) row-major.
__device__ __forceinline__ float mlp_out(const float* h_row, int hh,
                                         const float* __restrict__ w2,
                                         const float* __restrict__ b2,
                                         int M, int m) {
  float acc = 0.0f;
  for (int j = 0; j < hh; ++j) acc = fmaf(h_row[j], w2[(size_t)j * M + m], acc);
  return acc + b2[m];
}

// lam[r, :] @ cvals[:, m], with cvals (n_c, M) row-major.
__device__ __forceinline__ float constraint_add(const float* __restrict__ lam_row,
                                                const float* __restrict__ cvals,
                                                int n_c, int M, int m) {
  float acc = 0.0f;
  for (int c = 0; c < n_c; ++c) acc = fmaf(lam_row[c], cvals[c * M + m], acc);
  return acc;
}

// First index of the minimum (ties go to the lowest index, like
// jnp.argmin and torch.argmin).
__device__ __forceinline__ int argmin_first(const float* v, int M) {
  int best = 0;
  float bv = v[0];
  for (int m = 1; m < M; ++m) {
    if (v[m] < bv) {
      bv = v[m];
      best = m;
    }
  }
  return best;
}

// Dynamic shared memory above the 48 KB default needs an opt-in.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace tryage
