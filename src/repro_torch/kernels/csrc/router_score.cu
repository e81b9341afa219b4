// Fused Tryage routing head on Hopper: one launch computes
//   pred   = softplus(gelu(emb @ w1 + b1) @ w2 + b2)      (B, M) f32
//   choice = argmin(pred + lam @ cvals)                    (B,)   i32
// Replaces the Pallas kernel _router_kernel (router_score_fused) of
// src/repro/kernels/router_score/kernel.py.
//
// Bound on the H100: the work is a few hundred kFLOP and ~90 KB of
// weights per call at the paper's shapes (d = hh = 128, M = 11), far
// below what either the f32 cores or HBM need microseconds for; the
// launch itself dominates.  So the design keeps everything in one
// launch with no intermediate in device memory: a block takes
// `block_b` rows, stages their embeddings and the hidden activations
// in shared memory, and finishes the argmin there.  d, hh, M and n_c
// are runtime values, so every library size shares one kernel.
#include "common.cuh"

using namespace tryage;

extern "C" __global__ void router_score_kernel(
    const float* __restrict__ emb, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ cvals,
    const float* __restrict__ lam, float* __restrict__ pred,
    int* __restrict__ choice, int B, int d, int hh, int M, int n_c,
    int block_b) {
  extern __shared__ float smem[];
  float* emb_s = smem;                    // block_b * d
  float* h_s = emb_s + block_b * d;       // block_b * hh
  float* comb_s = h_s + block_b * hh;     // block_b * M
  const int row0 = blockIdx.x * block_b;
  const int rows = min(block_b, B - row0);

  load_rows(emb + (size_t)row0 * d, rows, d, emb_s);
  __syncthreads();
  mlp_hidden(emb_s, rows, d, w1, b1, hh, h_s);
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * M; idx += blockDim.x) {
    const int r = idx / M, m = idx - r * M;
    const float p = softplus(mlp_out(h_s + r * hh, hh, w2, b2, M, m));
    pred[(size_t)(row0 + r) * M + m] = p;
    comb_s[idx] = p + constraint_add(lam + (size_t)(row0 + r) * n_c, cvals,
                                     n_c, M, m);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x)
    choice[row0 + r] = argmin_first(comb_s + r * M, M);
}

extern "C" int tryage_router_score(const float* emb, const float* w1,
                                   const float* b1, const float* w2,
                                   const float* b2, const float* cvals,
                                   const float* lam, float* pred, int* choice,
                                   int B, int d, int hh, int M, int n_c,
                                   int block_b, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = sizeof(float) * (size_t)block_b * (d + hh + M);
  cudaError_t err = allow_smem(router_score_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + block_b - 1) / block_b;
  router_score_kernel<<<grid, kRouterThreads, smem, (cudaStream_t)stream>>>(
      emb, w1, b1, w2, b2, cvals, lam, pred, choice, B, d, hh, M, n_c, block_b);
  return (int)cudaGetLastError();
}
