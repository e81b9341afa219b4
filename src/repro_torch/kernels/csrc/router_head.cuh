// The one kernel body of both router heads (router_score.cu,
// router_cascade.cu), for one row of the batch per thread-block cluster:
//   pred   = softplus(gelu(emb @ w1 + b1) @ w2 + b2)             (M,)
//   choice = argmin(pred + lam @ cvals), ties to the lowest index
// and with kCascade also, from the same embedding row,
//   sigma  = softplus(gelu(emb @ uw1 + ub1) @ uw2 + ub2) + UNC_FLOOR
//   esc    = the constrained argmin over the experts strictly above
//            `choice` on the escalation ladder, ties to the earliest
//            rung; esc == choice at the top rung.
// The math matches the JAX package's defaults: jax.nn.gelu is the tanh
// approximation and jax.nn.softplus is logaddexp(x, 0), written here in
// its overflow-free form.  d, hh, M and n_c are runtime values.
//
// The arithmetic is tiny, and so are the bytes, far below an empty
// launch's device time; what costs is latency, above all the weights'
// trip from L2, which one SM makes at a low rate however many of its
// threads ask (a block per row reading a head's 64 KB of w1 took
// microseconds).  So a row's work is spread over a cluster of kCluster
// blocks on as many SMs, each with its own slice of the hidden units
// (both heads'), and each block waits on L2 once:
// 1. The block's slice of w2 and b1 (and, in rank 0, b2, cvals, the
//    row's lambdas and the ladder) start on their way to shared memory
//    by cp.async.
// 2. Meanwhile the hidden layer: a thread owns one (k-group, hidden
//    unit) pair.  Neighbouring threads read neighbouring w1 columns
//    (coalesced), the embedding row is a broadcast load, and all of a
//    thread's loads go out before its first FMA (dot_column).  The
//    k-groups' partial sums meet in shared memory, where the bias and
//    GELU follow.
// 3. Each block's share of the second layer, one thread per output
//    (head, m), goes to rank 0's shared memory (distributed shared
//    memory); after the cluster barrier rank 0 adds the kCluster shares
//    in rank order.  Every output m takes the same instructions in the
//    same order, so outputs that tie in exact arithmetic tie here too.
// 4. Rank 0's warp 0 takes the argmin, and for the cascade the
//    escalation target, by shuffle reductions over (value, rung, index).
// The products stay f32 on the CUDA cores: at 32 x 128 x 128 the tensor
// cores would save nothing measurable, and the 3xTF32 operand split that
// f32 accuracy needs there would only add instructions.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

#include <cooperative_groups.h>

#include "common.cuh"

namespace tryage {

constexpr int kRouterMaxThreads = 256;  // router_score/ops.py THREADS
// blocks of a row's cluster (router_score/ops.py CLUSTER)
constexpr int kCluster = 8;
constexpr float kUncFloor = 1e-3f;  // core.router.UNC_FLOOR

struct HeadArgs {
  const float* emb;        // (B, d)
  const float* w1;         // (d, hh)
  const float* b1;         // (hh,)
  const float* w2;         // (hh, M)
  const float* b2;         // (M,)
  const float* uw1;        // uncertainty head, same shapes (cascade only)
  const float* ub1;
  const float* uw2;
  const float* ub2;
  const float* cvals;      // (n_c, M)
  const float* lam;        // (B, n_c)
  const int* ladder_pos;   // (M,) rung of each expert (cascade only)
  float* pred;             // (B, M)
  float* sigma;            // (B, M) (cascade only)
  int* choice;             // (B,)
  int* esc;                // (B,) (cascade only)
  int d, hh, M, n_c;
  int k_groups;            // the hidden layer's split of k
};

__device__ __forceinline__ float gelu_tanh(float x) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(k * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

constexpr int kChunk = 16;   // k steps whose loads are in flight at once

// e[k0:k1] . w[k0 * ld : k1 * ld : ld], both from device memory: the
// loads of kChunk steps go out together (one wait on L2 for k1 - k0 <=
// kChunk), then four independent FMA chains.
__device__ __forceinline__ float dot_column(const float* __restrict__ e,
                                            const float* __restrict__ w,
                                            int ld, int k0, int k1) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int kc = k0; kc < k1; kc += kChunk) {
    float ev[kChunk], wv[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const bool in = kc + i < k1;
      ev[i] = in ? __ldg(e + kc + i) : 0.0f;
      wv[i] = in ? __ldg(w + (size_t)(kc + i) * ld) : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) acc[i & 3] = fmaf(ev[i], wv[i], acc[i & 3]);
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// 4 bytes from device to shared memory, without waiting.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// A candidate of an argmin, ordered by (v, key, m); m == INT_MAX marks
// no candidate.
struct Pick {
  float v;
  int key, m;
};

__device__ __forceinline__ bool before(const Pick& a, const Pick& b) {
  return a.v < b.v ||
         (a.v == b.v && (a.key < b.key || (a.key == b.key && a.m < b.m)));
}

// The least of the warp's picks, in every lane.
__device__ __forceinline__ Pick warp_min(Pick p) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Pick o = {__shfl_xor_sync(~0u, p.v, off),
                    __shfl_xor_sync(~0u, p.key, off),
                    __shfl_xor_sync(~0u, p.m, off)};
    if (before(o, p)) p = o;
  }
  return p;
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// 4-byte words of dynamic shared memory the body takes.
inline size_t head_smem_words(int heads, int hh, int M, int n_c,
                              int k_groups) {
  const size_t units = (size_t)heads * ((hh + kCluster - 1) / kCluster);
  const size_t tasks = (size_t)heads * M;
  return units * M + 2 * units + (size_t)k_groups * units +
         kCluster * tasks + tasks + (size_t)n_c * M + n_c + 2 * M;
}

template <bool kCascade>
__device__ __forceinline__ void router_head(const HeadArgs& a) {
  constexpr int kHeads = kCascade ? 2 : 1;
  extern __shared__ float smem[];
  const int d = a.d, hh = a.hh, M = a.M, n_c = a.n_c, G = a.k_groups;
  const int rank = blockIdx.x % kCluster;   // the block's rank in the cluster
  const int row = blockIdx.x / kCluster;
  const int U = (hh + kCluster - 1) / kCluster;   // units a block, per head
  const int j0 = rank * U;                        // this block's first unit
  const int nj = max(0, min(U, hh - j0));         // ... and how many
  const int units = kHeads * U;
  const int tasks = kHeads * M;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* w2_s = smem;                        // units rows of M
  float* b1_s = w2_s + units * M;            // units
  float* h_s = b1_s + units;                 // units
  float* part_s = h_s + units;               // G * units
  float* red_s = part_s + G * units;         // kCluster * tasks (rank 0)
  float* b2_s = red_s + kCluster * tasks;    // tasks
  float* cv_s = b2_s + tasks;                // n_c * M
  float* lam_s = cv_s + n_c * M;             // n_c
  int* pos_s = (int*)(lam_s + n_c);          // M
  float* comb_s = (float*)(pos_s + M);       // M

  // before any block writes to rank 0's shared memory, every block of the
  // cluster must have started: arrive now, wait in phase 3
  cluster_arrive_relaxed();

  // 1. the small inputs on their way to shared memory
  for (int head = 0; head < kHeads; ++head) {
    const float* w2 = (head ? a.uw2 : a.w2) + (size_t)j0 * M;
    for (int i = tid; i < nj * M; i += nt)
      cp_async4(w2_s + head * U * M + i, w2 + i);
    const float* b1 = (head ? a.ub1 : a.b1) + j0;
    for (int i = tid; i < nj; i += nt) cp_async4(b1_s + head * U + i, b1 + i);
  }
  if (rank == 0) {
    for (int t = tid; t < tasks; t += nt) {
      const int head = kCascade && t >= M;
      cp_async4(b2_s + t, (head ? a.ub2 : a.b2) + t - head * M);
    }
    for (int i = tid; i < n_c * M; i += nt) cp_async4(cv_s + i, a.cvals + i);
    for (int c = tid; c < n_c; c += nt)
      cp_async4(lam_s + c, a.lam + (size_t)row * n_c + c);
    if (kCascade)
      for (int m = tid; m < M; m += nt) cp_async4(pos_s + m, a.ladder_pos + m);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // 2. hidden layer, this block's units
  const float* e = a.emb + (size_t)row * d;
  const int kq = (d + G - 1) / G;
  for (int it = tid; it < G * units; it += nt) {
    const int g = it / units, u = it - g * units;
    const int head = kCascade && u >= U;
    const int jj = u - head * U;
    if (jj >= nj) continue;
    const int k0 = g * kq;
    part_s[it] = dot_column(e, (head ? a.uw1 : a.w1) + j0 + jj, hh, k0,
                            min(d, k0 + kq));
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  for (int u = tid; u < units; u += nt) {
    const int head = kCascade && u >= U;
    if (u - head * U >= nj) continue;
    float s = part_s[u];
    for (int g = 1; g < G; ++g) s += part_s[g * units + u];
    h_s[u] = gelu_tanh(s + b1_s[u]);
  }
  __syncthreads();

  // 3. this block's share of the second layer, to rank 0
  cluster_wait();
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  float* red0 = cluster.map_shared_rank(red_s, 0);
  for (int t = tid; t < tasks; t += nt) {
    const int head = kCascade && t >= M;
    const int m = t - head * M;
    const float* h = h_s + head * U;
    const float* w = w2_s + head * U * M + m;
    float acc = 0.0f;
    for (int j = 0; j < nj; ++j) acc = fmaf(h[j], w[j * M], acc);
    red0[rank * tasks + t] = acc;
  }
  cluster.sync();
  if (rank != 0) return;
  for (int t = tid; t < tasks; t += nt) {
    const int head = kCascade && t >= M;
    const int m = t - head * M;
    float acc = red_s[t];
    for (int c = 1; c < kCluster; ++c) acc += red_s[c * tasks + t];
    const float p = softplus(acc + b2_s[t]);
    const size_t out = (size_t)row * M + m;
    if (head) {
      a.sigma[out] = p + kUncFloor;
    } else {
      float con = 0.0f;
      for (int c = 0; c < n_c; ++c) con = fmaf(lam_s[c], cv_s[c * M + m], con);
      a.pred[out] = p;
      comb_s[m] = p + con;
    }
  }
  __syncthreads();

  // 4. argmin and escalation target
  if (tid >= 32) return;
  const int lane = tid;
  Pick best = {INFINITY, INT_MAX, INT_MAX};
  for (int m = lane; m < M; m += 32) {
    const Pick c = {comb_s[m], 0, m};
    if (before(c, best)) best = c;
  }
  const int pick = warp_min(best).m;
  if (kCascade) {
    const int pick_pos = pos_s[pick];
    Pick next = {INFINITY, INT_MAX, INT_MAX};
    for (int m = lane; m < M; m += 32) {
      const Pick c = {comb_s[m], pos_s[m], m};
      if (c.key > pick_pos && before(c, next)) next = c;
    }
    next = warp_min(next);
    if (lane == 0) a.esc[row] = next.m == INT_MAX ? pick : next.m;
  }
  if (lane == 0) a.choice[row] = pick;
}

// Launch `kernel` (a router_head<kCascade> instance, with cluster
// dimensions kCluster) over B rows.
template <typename Kernel>
__host__ int launch_router_head(Kernel kernel, const HeadArgs& args,
                                int heads, int B, int threads,
                                void* stream) {
  if (B <= 0) return 0;
  if (threads < 32 || threads > kRouterMaxThreads || threads % 32 ||
      args.k_groups < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * head_smem_words(heads, args.hh, args.M, args.n_c,
                                          args.k_groups);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<B * kCluster, threads, smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace tryage
