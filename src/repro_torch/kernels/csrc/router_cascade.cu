// One-launch cascade decision on Hopper: the routing head of
// router_score.cu plus, on the same embedding rows,
//   sigma = softplus(gelu(emb @ uw1 + ub1) @ uw2 + ub2) + UNC_FLOOR
//   esc   = the constrained argmin over experts strictly above `choice`
//           on the size-sorted escalation ladder; ties go to the
//           earliest ladder rung, and esc == choice at the top rung.
// Replaces the Pallas kernel _cascade_kernel
// (router_score_cascade_fused) of src/repro/kernels/router_cascade/kernel.py.
//
// Bound on the H100: as for router_score, bytes (~160 KB for both heads
// at B = 32), tens of nanoseconds, far below the launch floor; the limit
// is latency.  The body is router_score's (router_head.cuh) with both
// heads' hidden units side by side in each block of the row's cluster,
// so the second head widens each block's slice instead of adding a
// pass; loss and sigma outputs are separate threads' work, and the
// escalation target is one more shuffle reduction over (constrained
// score, ladder rung, index) after the argmin.
#include "router_head.cuh"

using tryage::HeadArgs;

extern "C" __global__ void __cluster_dims__(tryage::kCluster, 1, 1)
    __launch_bounds__(tryage::kRouterMaxThreads)
    router_cascade_kernel(HeadArgs args) {
  tryage::router_head<true>(args);
}

extern "C" int tryage_router_cascade(
    const float* emb, const float* w1, const float* b1, const float* w2,
    const float* b2, const float* uw1, const float* ub1, const float* uw2,
    const float* ub2, const float* cvals, const float* lam,
    const int* ladder_pos, float* pred, float* sigma, int* choice, int* esc,
    int B, int d, int hh, int M, int n_c, int threads, int k_groups,
    void* stream) {
  const HeadArgs args = {emb, w1, b1, w2, b2, uw1, ub1, uw2, ub2, cvals,
                         lam, ladder_pos, pred, sigma, choice, esc, d, hh,
                         M, n_c, k_groups};
  return tryage::launch_router_head(router_cascade_kernel, args, 2, B,
                                    threads, stream);
}
