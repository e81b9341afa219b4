// Fused Tryage routing head on Hopper: one launch computes
//   pred   = softplus(gelu(emb @ w1 + b1) @ w2 + b2)      (B, M) f32
//   choice = argmin(pred + lam @ cvals)                    (B,)   i32
// Replaces the Pallas kernel _router_kernel (router_score_fused) of
// src/repro/kernels/router_score/kernel.py.
//
// Bound on the H100: at the paper's shapes (d = hh = 128, M = 11,
// B <= 32) the call moves ~90 KB and does ~1 MFLOP: tens of nanoseconds
// at 3.35 TB/s, far below the launch floor (the device time of an empty
// kernel, csrc/launch_floor.cu, which chip_smoke.py times beside this
// one).  What is left to design for is latency; the first cut, 8 rows a
// block on 4 of the 132 SMs with a chain of ~1,000 dependent load + FMA
// steps a thread, took tens of microseconds.  The body (router_head.cuh)
// gives each row a cluster of 8 blocks of 256 threads: each block reads
// an eighth of w1 with all its loads in flight at once, and the shares
// of the second layer meet in the first block's shared memory.
#include "router_head.cuh"

using tryage::HeadArgs;

extern "C" __global__ void __cluster_dims__(tryage::kCluster, 1, 1)
    __launch_bounds__(tryage::kRouterMaxThreads)
    router_score_kernel(HeadArgs args) {
  tryage::router_head<false>(args);
}

extern "C" int tryage_router_score(const float* emb, const float* w1,
                                   const float* b1, const float* w2,
                                   const float* b2, const float* cvals,
                                   const float* lam, float* pred, int* choice,
                                   int B, int d, int hh, int M, int n_c,
                                   int threads, int k_groups, void* stream) {
  const HeadArgs args = {emb, w1, b1, w2, b2, nullptr, nullptr, nullptr,
                         nullptr, cvals, lam, nullptr, pred, nullptr, choice,
                         nullptr, d, hh, M, n_c, k_groups};
  return tryage::launch_router_head(router_score_kernel, args, 1, B, threads,
                                    stream);
}
