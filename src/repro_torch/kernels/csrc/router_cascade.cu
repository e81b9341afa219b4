// One-launch cascade decision on Hopper: the routing head of
// router_score.cu plus, on the same embedding rows,
//   sigma = softplus(gelu(emb @ uw1 + ub1) @ uw2 + ub2) + UNC_FLOOR
//   esc   = the constrained argmin over experts strictly above `choice`
//           on the size-sorted escalation ladder; ties go to the
//           earliest ladder rung, and esc == choice at the top rung.
// Replaces the Pallas kernel _cascade_kernel
// (router_score_cascade_fused) of src/repro/kernels/router_cascade/kernel.py.
//
// Bound on the H100: as for router_score, launch overhead -- the two
// heads read ~180 KB of weights and do well under a MFLOP per row tile.
// The design is the router_score body with a second hidden buffer in
// shared memory, so both heads and the escalation re-argmin finish in
// one launch without a host round trip or a second encoder pass.
#include "common.cuh"

using namespace tryage;

// core.router.UNC_FLOOR
constexpr float kUncFloor = 1e-3f;

extern "C" __global__ void router_cascade_kernel(
    const float* __restrict__ emb, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, const float* __restrict__ uw1,
    const float* __restrict__ ub1, const float* __restrict__ uw2,
    const float* __restrict__ ub2, const float* __restrict__ cvals,
    const float* __restrict__ lam, const int* __restrict__ ladder_pos,
    float* __restrict__ pred, float* __restrict__ sigma,
    int* __restrict__ choice, int* __restrict__ esc, int B, int d, int hh,
    int M, int n_c, int block_b) {
  extern __shared__ float smem[];
  float* emb_s = smem;                    // block_b * d
  float* h_s = emb_s + block_b * d;       // block_b * hh
  float* hu_s = h_s + block_b * hh;       // block_b * hh
  float* comb_s = hu_s + block_b * hh;    // block_b * M
  const int row0 = blockIdx.x * block_b;
  const int rows = min(block_b, B - row0);

  load_rows(emb + (size_t)row0 * d, rows, d, emb_s);
  __syncthreads();
  mlp_hidden(emb_s, rows, d, w1, b1, hh, h_s);
  mlp_hidden(emb_s, rows, d, uw1, ub1, hh, hu_s);
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * M; idx += blockDim.x) {
    const int r = idx / M, m = idx - r * M;
    const size_t out = (size_t)(row0 + r) * M + m;
    const float p = softplus(mlp_out(h_s + r * hh, hh, w2, b2, M, m));
    pred[out] = p;
    sigma[out] = softplus(mlp_out(hu_s + r * hh, hh, uw2, ub2, M, m)) + kUncFloor;
    comb_s[idx] = p + constraint_add(lam + (size_t)(row0 + r) * n_c, cvals,
                                     n_c, M, m);
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rows; r += blockDim.x) {
    const float* c = comb_s + r * M;
    const int pick = argmin_first(c, M);
    const int pick_pos = ladder_pos[pick];
    // minimum constrained score among the experts above the pick ...
    bool has_next = false;
    float minval = INFINITY;
    for (int m = 0; m < M; ++m) {
      if (ladder_pos[m] > pick_pos) {
        has_next = true;
        minval = fminf(minval, c[m]);
      }
    }
    // ... and, among those reaching it, the earliest ladder rung
    int target = pick;
    if (has_next) {
      int best_pos = M;
      for (int m = 0; m < M; ++m) {
        const int pos = ladder_pos[m];
        if (pos > pick_pos && c[m] == minval && pos < best_pos) {
          best_pos = pos;
          target = m;
        }
      }
    }
    choice[row0 + r] = pick;
    esc[row0 + r] = target;
  }
}

extern "C" int tryage_router_cascade(
    const float* emb, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* uw1, const float* ub1, const float* uw2,
    const float* ub2, const float* cvals, const float* lam,
    const int* ladder_pos, float* pred, float* sigma, int* choice, int* esc,
    int B, int d, int hh, int M, int n_c, int block_b, void* stream) {
  if (B <= 0) return 0;
  const size_t smem = sizeof(float) * (size_t)block_b * (d + 2 * hh + M);
  cudaError_t err = allow_smem(router_cascade_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (B + block_b - 1) / block_b;
  router_cascade_kernel<<<grid, kRouterThreads, smem, (cudaStream_t)stream>>>(
      emb, w1, b1, w2, b2, uw1, ub1, uw2, ub2, cvals, lam, ladder_pos, pred,
      sigma, choice, esc, B, d, hh, M, n_c, block_b);
  return (int)cudaGetLastError();
}
