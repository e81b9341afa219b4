// The gradient of flash attention (flash_attention.cu) on Hopper, in the
// model layout: from q, dO (B, S, H, hd), k, v (B, T, KV, hd) and the
// forward's log-sum-exp lse (B, H, S), it writes dQ (B, S, H, hd) and
// dK, dV (B, T, KV, hd).  The Pallas kernel _attn_kernel
// (src/repro/kernels/flash_attention/kernel.py) has no backward: the JAX
// package trains through attention with XLA's autodiff of
// attend_full(impl="xla").  This is that gradient, for the masks of the
// forward: the scale 1/sqrt(hd) on the scores, the optional tanh softcap
// (dS is multiplied by 1 - tanh^2), causal and sliding-window masks (a
// masked score gets no gradient, as jnp.where gives none), and GQA (dK
// and dV sum over the H / KV query heads of a group).  A row whose every
// key is masked took the uniform average of V in the forward (softmax of
// equal fills); its lse is the mask fill itself, and its P is 1 / T here.
//
// Algorithm (FlashAttention-2's backward, with the softmax statistics
// made consistent with the recomputed P): P = exp(S - lse),
// dP = dO V^T, and with each row's own sums of P and of P dP over all
// keys, P <- P / sum P, D = sum(P dP) / sum(P), dS = P (dP - D); then
//   dV = P^T dO,  dK = dS^T q / sqrt(hd),  dQ = dS K / sqrt(hd).
// The forward's 3xTF32 scores and these differ by rounding, so exp(S -
// lse) sums over a row to 1 + eps, not 1; with D = rowsum(dO * O) the
// rows of dS would sum to eps * D and dQ would pick up eps * D times the
// keys' common direction (1.02e-4 of a weight gradient's largest
// magnitude on the card).  Renormalised, the rows of dS sum to 0 up to
// rounding, as in the softmax backward of the plain version.
//
// Bound on the H100: five products of 2 S T hd operations a head (S and
// dP, dV, dK, dQ); at three TF32 passes each on the tensor cores (495
// TFLOP/s) the bytes (q, k, v, dO and lse read, dQ, dK, dV written, at
// 3.35 TB/s) bound it at the training shapes (S = T = 128, hd 32 or 40):
// 0.0044 ms at (B, H, hd) = (16, 8, 32).  Every product runs in 3xTF32
// (mma_tf32.cuh): each f32 operand, the computed P and dS too, is split
// into big and small TF32 halves at use (split_tf32_rz: small is left
// for the tensor cores to truncate), which keeps f32 accuracy where one
// TF32 pass would not (tests/test_torch_tf32.py,
// tests/test_torch_attention_grad.py).  Design:
// * A block of 8 warps owns a block of up to 128 keys of one (batch, kv
//   head), 16 keys a warp; K and V of the block stay in shared memory.
//   It walks the group's query heads and their tiles of R query rows
//   (64, or 32 above hd 64) in a fixed order; each tile's q, dO and lse
//   arrive by cp.async, double-buffered, while the last tile is used.
//   Rows are padded to hd + 4 floats, so the fragment loads hit 32
//   different banks.
// * A warp computes S^T = K q^T and dP^T = V dO^T for its 16 keys and the
//   tile's rows, key-major as FlashAttention-2's dK/dV loop does, so
//   that P^T and dS^T sit in the accumulators as the A fragments of
//   dV += P^T dO and dK += dS^T q need them: lane (g, t) holds rows 2t
//   and 2t + 1 of each 8-row step, and the k index of those products is
//   permuted to match (A column t <-> row 2t, t + 4 <-> row 2t + 1, dO
//   and q read in the same order), as the forward does for P V.  dK and
//   dV accumulate in registers over all tiles.
// * T <= 128 (every shape training runs: S = T = 128): one launch, S and
//   dP once per (row, key).  The row sums come from the same pass: each
//   warp reduces its 16 keys by shuffles (a reduce-scatter over the 8
//   lanes of a row), the 8 warps' partial sums meet in shared memory and
//   are added in warp order.  dS^T goes to shared memory, and dQ = dS K
//   for the tile follows at once, complete, by the 8 warps (a 16-row
//   group and a share of the head dim each, each 3xTF32 pass in its own
//   accumulator: few n-tiles a warp would leave one chain waiting on
//   mma.sync's latency).
// * When B * KV blocks would fill under half the SMs, a cluster of 2-8
//   blocks splits the tiles of each (batch, kv head) and adds its dK
//   and dV through distributed shared memory in rank order: at
//   (16, 4, 128, 40) that is 128 blocks on the 132 SMs, not 64
//   (scripts/trace_flash_backward.py times both; PERF.md).
// * T > 128: two launches.  flash_attention_bwd_dq, a block per (b, h,
//   query tile), walks the key blocks twice, first for the row sums
//   (written out as 1 / sum P and D for the second launch), then for dS
//   and dQ; flash_attention_bwd_kernel then runs a block per (b, kv
//   head, key block) as above, with the row sums read, not summed, and
//   no dQ.  S and dP are computed three times there.
// * No branch inside an unrolled loop: the masks are selects, the
//   softcap a template argument, and the dQ loop's n-tile guard is known
//   at compile time where the split is even.  Even a uniform branch
//   there splits the loop into blocks whose exp and mma.sync latencies
//   cannot overlap, and the warps (8 a block, one block an SM) have few
//   others to hide them behind.
// * No atomics: every sum runs in a fixed order, so a rerun gives
//   bit-identical gradients.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

using tryage::Split;
using tryage::split_tf32_rz;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockKeys = 16 * kWarps;    // keys of a block, 16 a warp
constexpr int kMaxCluster = 8;
constexpr int kSMs = 132;
constexpr float kNegInf = -2.3819763e38f;  // the forward's mask fill
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const float* q;     // (B, S, H, hd)
  const float* k;     // (B, T, KV, hd)
  const float* v;
  const float* d_o;   // (B, S, H, hd)
  const float* lse;   // (B, H, S)
  float* rows;        // (B, H, S, 2): 1 / sum P and D; null at T <= 128
  float* dq;
  float* dk;
  float* dv;
  int B, S, T, H, KV, causal, window;
  float softcap, scale;
};

template <int KD>
struct Geo {
  static constexpr int HD = 8 * KD;
  static constexpr int R = KD <= 8 ? 64 : 32;  // query rows of a tile
  static constexpr int NR = R / 8;             // its 8-row steps
  static constexpr int KS = HD + 4;            // padded row: K, V, q, dO
  static constexpr int DS = R + 4;             // padded row of dS^T
  // dQ of a tile: 16-row groups, the warps that share one, n-tiles each
  static constexpr int RG = R / 16;
  static constexpr int NG = kWarps / RG;
  static constexpr int NQ = (KD + NG - 1) / NG;
  // shared memory, in floats
  static constexpr int kK = 0;
  static constexpr int kV = kK + kBlockKeys * KS;
  static constexpr int kQ = kV + kBlockKeys * KS;      // 2 buffers
  static constexpr int kDO = kQ + 2 * R * KS;          // 2 buffers
  static constexpr int kDS = kDO + 2 * R * KS;         // dS^T [key][row]
  static constexpr int kPart = kDS + kBlockKeys * DS;  // [warp][2][R]
  static constexpr int kLse = kPart + kWarps * 2 * R;  // 2 buffers
  static constexpr int kRow = kLse + 2 * R;            // 2 x [R][2]
  static constexpr int kFloats = kRow + 4 * R;
};

// cp.async rows [r0, r0 + n) of one head of a (rows, heads, HD) tensor
// into a tile of rows padded to HD + 4 floats; rows at or past `lim`
// are zero.
template <int KD>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int r0, int n, int lim,
                                           size_t stride) {
  constexpr int KS = 8 * KD + 4, kPieces = 2 * KD;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < n * kPieces; i += kThreads) {
    const int r = i / kPieces, c = (i - r * kPieces) * 4;
    const bool in = r0 + r < lim;
    tryage::cp_async16(dst + r * KS + c,
                       src + (size_t)(in ? r0 + r : 0) * stride + c, in);
  }
}

// cp.async the lse of rows [q0, q0 + R) of row `bh` of (B * H, S), and
// with `rows` their 1 / sum P and D; rows past S are zero.
__device__ __forceinline__ void stage_row_data(float* lse_s, float* row_s,
                                               const float* lse,
                                               const float* rows, size_t bh,
                                               int q0, int R, int S) {
  for (int i = threadIdx.x; i < R; i += kThreads) {
    const bool in = q0 + i < S;
    const size_t r = bh * S + (in ? q0 + i : 0);
    tryage::cp_async4(lse_s + i, lse + r, in);
    if (rows != nullptr) tryage::cp_async8(row_s + 2 * i, rows + 2 * r, in);
  }
}

// S^T = K q^T and dP^T = V dO^T, unscaled, for the warp's 16 keys of the
// block and the tile's R rows.  Lane (g, t) holds in [j][e] key
// 16 warp + g + 8 (e >> 1) and tile row 8 j + 2 t + (e & 1).
template <int KD>
__device__ __forceinline__ void products(const float* ks, const float* vs,
                                         const float* qs, const float* dos,
                                         float (&p)[Geo<KD>::NR][4],
                                         float (&dp)[Geo<KD>::NR][4]) {
  using G = Geo<KD>;
  constexpr int NR = G::NR, KS = G::KS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NR; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[j][e] = dp[j][e] = 0.0f;
  const float* kr = ks + (16 * warp + g) * KS + t;
  const float* vr = vs + (16 * warp + g) * KS + t;
#pragma unroll 4
  for (int kk = 0; kk < KD; ++kk) {
    const float* k0 = kr + 8 * kk;
    const float* v0 = vr + 8 * kk;
    const Split ak[4] = {split_tf32_rz(k0[0]), split_tf32_rz(k0[8 * KS]),
                         split_tf32_rz(k0[4]), split_tf32_rz(k0[8 * KS + 4])};
    const Split av[4] = {split_tf32_rz(v0[0]), split_tf32_rz(v0[8 * KS]),
                         split_tf32_rz(v0[4]), split_tf32_rz(v0[8 * KS + 4])};
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const float* qr = qs + (8 * j + g) * KS + 8 * kk + t;
      const float* dr = dos + (8 * j + g) * KS + 8 * kk + t;
      const Split bq[2] = {split_tf32_rz(qr[0]), split_tf32_rz(qr[4])};
      const Split bd[2] = {split_tf32_rz(dr[0]), split_tf32_rz(dr[4])};
      tryage::mma_3xtf32(p[j], ak, bq);
      tryage::mma_3xtf32(dp[j], av, bd);
    }
  }
}

// P in place of the scores: exp(S - lse) where the score is unmasked, 0
// where it is masked or out of range, 1 / T over the in-range keys of a
// row with no key.  With kCap the scores pass through the softcap, and
// with `dcap` its factor 1 - tanh^2 goes there, at the entry's place in
// dS^T.  The masks are selects, not branches, and the softcap a template
// argument: a branch in this loop would split it into blocks that the
// compiler cannot interleave, and each entry's exp would wait on the last.
template <int KD, bool kCap>
__device__ __forceinline__ void probs(const Args& a, const float* lse_s,
                                      int q0, int kb0,
                                      float (&p)[Geo<KD>::NR][4],
                                      float* dcap) {
  using G = Geo<KD>;
  constexpr int NR = G::NR, DS = G::DS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float uniform = 1.0f / (float)a.T;
  const bool causal = a.causal != 0, windowed = a.window > 0;
#pragma unroll
  for (int j = 0; j < NR; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int rr = 8 * j + 2 * t + (e & 1);
      const int kl = 16 * warp + g + 8 * (e >> 1);  // key in the block
      const int row = q0 + rr, key = kb0 + kl;
      const float l = lse_s[rr];
      float x = p[j][e] * a.scale;
      if constexpr (kCap) {
        const float th = tanhf(x / a.softcap);
        x = a.softcap * th;
        if (dcap != nullptr) dcap[kl * DS + rr] = 1.0f - th * th;
      }
      const bool in = (row < a.S) & (key < a.T);
      const bool ok = in & (!causal | (key <= row)) &
                      (!windowed | (key > row - a.window));
      const float ex = expf(x - l);
      p[j][e] = l <= kNegInf ? (in ? uniform : 0.0f) : (ok ? ex : 0.0f);
    }
}

// The scores of the tile (products) and their P (probs).
template <int KD>
__device__ __forceinline__ void scores(const Args& a, const float* ks,
                                       const float* vs, const float* qs,
                                       const float* dos, const float* lse_s,
                                       int q0, int kb0,
                                       float (&p)[Geo<KD>::NR][4],
                                       float (&dp)[Geo<KD>::NR][4],
                                       float* dcap) {
  products<KD>(ks, vs, qs, dos, p, dp);
  if (a.softcap > 0.0f)
    probs<KD, true>(a, lse_s, q0, kb0, p, dcap);
  else
    probs<KD, false>(a, lse_s, q0, kb0, p, dcap);
}

// One step of sum_scatter: the lanes that differ in lane bit `M` swap
// halves of v[0, 2 n); the one with the bit set keeps the upper half.
template <int N, int n, int M>
__device__ __forceinline__ void scatter_step(float (&v)[N]) {
  const bool hi = threadIdx.x & M;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    const float keep = hi ? v[i + n] : v[i];
    const float send = hi ? v[i] : v[i + n];
    v[i] = keep + __shfl_xor_sync(kFull, send, M);
  }
}

// Sum of v over the 8 lanes that share t (lane bits 2-4), scattered:
// lane (g, t) ends with the sums of entries [g N / 8, (g + 1) N / 8) in
// v[0, N / 8).
template <int N>
__device__ __forceinline__ void sum_scatter(float (&v)[N]) {
  scatter_step<N, N / 2, 16>(v);
  scatter_step<N, N / 4, 8>(v);
  scatter_step<N, N / 8, 4>(v);
}

// The warp's sums of P and of P dP over its 16 keys, for the tile rows
// of lane (g, t): entry i of [2 NR] is row 8 (i / 2) + 2 t + i % 2, and
// the lane keeps entries g NR / 4 + ii, ii < NR / 4.
template <int NR>
__device__ __forceinline__ void row_sums(const float (&p)[NR][4],
                                         const float (&dp)[NR][4],
                                         float (&ps)[NR / 4],
                                         float (&pd)[NR / 4]) {
  float vs[2 * NR], vd[2 * NR];
#pragma unroll
  for (int j = 0; j < NR; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      vs[2 * j + r] = p[j][r] + p[j][r + 2];
      vd[2 * j + r] = fmaf(p[j][r + 2], dp[j][r + 2], p[j][r] * dp[j][r]);
    }
  sum_scatter(vs);
  sum_scatter(vd);
#pragma unroll
  for (int ii = 0; ii < NR / 4; ++ii) {
    ps[ii] = vs[ii];
    pd[ii] = vd[ii];
  }
}

// The warp's row sums into part[warp][0 or 1][row].
template <int NR>
__device__ __forceinline__ void store_part(float* part,
                                           const float (&ps)[NR / 4],
                                           const float (&pd)[NR / 4]) {
  constexpr int R = 8 * NR;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ii = 0; ii < NR / 4; ++ii) {
    const int i = g * (NR / 4) + ii;
    const int row = 8 * (i >> 1) + 2 * t + (i & 1);
    part[2 * warp * R + row] = ps[ii];
    part[(2 * warp + 1) * R + row] = pd[ii];
  }
}

// Each tile row's totals over the warps, in warp order, as 1 / sum P (1
// on a row with no key) and D = sum(P dP) / sum(P) into row_s [R][2], and
// with `out` (the row's place in Args::rows) there too.
__device__ __forceinline__ void row_totals(const float* part,
                                           const float* lse_s, float* row_s,
                                           int R, float* out, int q0, int S) {
  for (int r = threadIdx.x; r < R; r += kThreads) {
    float ps = part[r], pd = part[R + r];
    for (int w = 1; w < kWarps; ++w) {
      ps += part[2 * w * R + r];
      pd += part[(2 * w + 1) * R + r];
    }
    const float inv = (lse_s[r] <= kNegInf || !(ps > 0.0f)) ? 1.0f : 1.0f / ps;
    const float d = ps > 0.0f ? pd / ps : 0.0f;
    row_s[2 * r] = inv;
    row_s[2 * r + 1] = d;
    if (out != nullptr && q0 + r < S) {
      out[2 * (q0 + r)] = inv;
      out[2 * (q0 + r) + 1] = d;
    }
  }
}

// P / sum P and dS = P (dP - D) (times the softcap factor with kCap; 0
// on a row with no key) in place of p and dp, and dS^T into ds_s
// [key][row].
template <int KD, bool kCap>
__device__ __forceinline__ void grads_t(float (&p)[Geo<KD>::NR][4],
                                      float (&dp)[Geo<KD>::NR][4],
                                      const float* lse_s, const float* row_s,
                                      float* ds_s) {
  using G = Geo<KD>;
  constexpr int NR = G::NR, DS = G::DS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  float* d0 = ds_s + (16 * warp + g) * DS + 2 * t;
#pragma unroll
  for (int j = 0; j < NR; ++j) {
    // rows 8j + 2t and 8j + 2t + 1: (1 / sum P, D) each, and their lse
    const float4 rc = *reinterpret_cast<const float4*>(row_s + 16 * j + 4 * t);
    const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool r1 = e & 1;
      const float inv = r1 ? rc.z : rc.x, dd = r1 ? rc.w : rc.y;
      const bool dead = (r1 ? l.y : l.x) <= kNegInf;
      const float dc = kCap ? d0[8 * DS * (e >> 1) + 8 * j + (e & 1)] : 1.0f;
      const float pb = p[j][e] * inv;
      p[j][e] = pb;
      dp[j][e] = dead ? 0.0f : pb * (dp[j][e] - dd) * dc;
    }
    *reinterpret_cast<float2*>(d0 + 8 * j) = make_float2(dp[j][0], dp[j][1]);
    *reinterpret_cast<float2*>(d0 + 8 * DS + 8 * j) =
        make_float2(dp[j][2], dp[j][3]);
  }
}

template <int KD>
__device__ __forceinline__ void grads(const Args& a,
                                      float (&p)[Geo<KD>::NR][4],
                                      float (&dp)[Geo<KD>::NR][4],
                                      const float* lse_s, const float* row_s,
                                      float* ds_s) {
  if (a.softcap > 0.0f)
    grads_t<KD, true>(p, dp, lse_s, row_s, ds_s);
  else
    grads_t<KD, false>(p, dp, lse_s, row_s, ds_s);
}

// acc += dS K over the block's first nk8 8-key steps, for the warp's
// 16-row group (warp % RG) of the tile and its n-tiles (dims 8 n for
// n = warp / RG + NG m).  dS is read from ds_s with the k index
// permuted as above (A column t <-> key 2t), K's rows in the same order.
// A warp has few n-tiles here, so each pass of 3xTF32 accumulates in its
// own registers: three independent mma.sync chains a tile, not one.
template <int KD>
__device__ __forceinline__ void dq_tile(const float* ds_s, const float* ks,
                                        int nk8,
                                        float (&acc)[Geo<KD>::NQ][3][4]) {
  using G = Geo<KD>;
  constexpr int KS = G::KS, DS = G::DS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % G::RG, ng = warp / G::RG;
#pragma unroll 2
  for (int kk = 0; kk < nk8; ++kk) {
    const float* d0 = ds_s + (8 * kk + 2 * t) * DS + 16 * rg + g;
    const Split sa[4] = {split_tf32_rz(d0[0]), split_tf32_rz(d0[8]),
                         split_tf32_rz(d0[DS]), split_tf32_rz(d0[DS + 8])};
    const float* k0 = ks + (8 * kk + 2 * t) * KS + g;
#pragma unroll
    for (int m = 0; m < G::NQ; ++m) {
      const int n = ng + G::NG * m;
      // known true at compile time but for the last n-tile of an uneven
      // split: a branch would keep the steps from interleaving
      if (m + 1 < G::NQ || KD % G::NG == 0 || n < KD) {
        const Split kb[2] = {split_tf32_rz(k0[8 * n]),
                             split_tf32_rz(k0[KS + 8 * n])};
        tryage::mma_3xtf32_sep(acc[m], sa, kb);
      }
    }
  }
}

// dQ of the tile (acc from dq_tile, times the scale) into the model
// layout; `out` is the head's first row.
template <int KD>
__device__ __forceinline__ void store_dq(float* out,
                                         const float (&acc)[Geo<KD>::NQ][3][4],
                                         int q0, int S, size_t stride,
                                         float scale) {
  using G = Geo<KD>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % G::RG, ng = warp / G::RG;
#pragma unroll
  for (int m = 0; m < G::NQ; ++m) {
    const int n = ng + G::NG * m;
    if (n >= KD) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 16 * rg + g + 8 * r;
      if (row < S)
        *reinterpret_cast<float2*>(out + (size_t)row * stride + 8 * n + 2 * t) =
            make_float2(tryage::sep_sum(acc[m], 2 * r) * scale,
                        tryage::sep_sum(acc[m], 2 * r + 1) * scale);
    }
  }
}

}  // namespace

// A block per (cluster rank, key block, b * KV + kv head); see the header.
template <int KD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_kernel(Args a) {
  using G = Geo<KD>;
  constexpr int HD = G::HD, R = G::R, NR = G::NR, KS = G::KS;
  extern __shared__ __align__(16) float sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int split = gridDim.x, rank = blockIdx.x;  // the cluster is along x
  const int kb0 = blockIdx.y * kBlockKeys;
  const int b = blockIdx.z / a.KV, kvh = blockIdx.z - b * a.KV;
  const int group = a.H / a.KV;
  const int n_qt = (a.S + R - 1) / R, items = group * n_qt;
  const bool whole = a.rows == nullptr;  // every key of the head is here
  const size_t q_stride = (size_t)a.H * HD, kv_stride = (size_t)a.KV * HD;
  const size_t kv_off = ((size_t)b * a.T * a.KV + kvh) * HD;
  float* ks = sm + G::kK;
  float* vs = sm + G::kV;
  float* ds_s = sm + G::kDS;
  const int nk8 = (min(kBlockKeys, a.T - kb0) + 7) / 8;

  stage_rows<KD>(ks, a.k + kv_off, kb0, kBlockKeys, a.T, kv_stride);
  stage_rows<KD>(vs, a.v + kv_off, kb0, kBlockKeys, a.T, kv_stride);
  auto stage = [&](int it, int buf) {
    const int h = kvh * group + it / n_qt, q0 = (it % n_qt) * R;
    const size_t q_off = ((size_t)b * a.S * a.H + h) * HD;
    stage_rows<KD>(sm + G::kQ + buf * R * KS, a.q + q_off, q0, R, a.S,
                   q_stride);
    stage_rows<KD>(sm + G::kDO + buf * R * KS, a.d_o + q_off, q0, R, a.S,
                   q_stride);
    stage_row_data(sm + G::kLse + buf * R, sm + G::kRow + buf * 2 * R, a.lse,
                   a.rows, (size_t)b * a.H + h, q0, R, a.S);
  };
  stage(rank, 0);  // rank < items: a cluster never outnumbers the tiles
  tryage::cp_async_commit();

  float dk[KD][4], dv[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;

  int buf = 0;
  for (int it = rank; it < items; it += split, buf ^= 1) {
    tryage::cp_async_wait<0>();
    __syncthreads();  // this tile is in; the last one is done with
    if (it + split < items) stage(it + split, buf ^ 1);
    tryage::cp_async_commit();
    const int h = kvh * group + it / n_qt, q0 = (it % n_qt) * R;
    const float* qs = sm + G::kQ + buf * R * KS;
    const float* dos = sm + G::kDO + buf * R * KS;
    const float* lse_s = sm + G::kLse + buf * R;
    float* row_s = sm + G::kRow + buf * 2 * R;

    float p[NR][4], dp[NR][4];
    scores<KD>(a, ks, vs, qs, dos, lse_s, q0, kb0, p, dp,
               a.softcap > 0.0f ? ds_s : nullptr);
    if (whole) {
      float ps[NR / 4], pd[NR / 4];
      row_sums<NR>(p, dp, ps, pd);
      store_part<NR>(sm + G::kPart, ps, pd);
      __syncthreads();
      row_totals(sm + G::kPart, lse_s, row_s, R, nullptr, q0, a.S);
      __syncthreads();
    }
    grads<KD>(a, p, dp, lse_s, row_s, ds_s);

    // dV += P^T dO, dK += dS^T q: the 8-row step j is a k-step, A column
    // t is row 2t and column t + 4 row 2t + 1 (see the header)
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const Split ap[4] = {split_tf32_rz(p[j][0]), split_tf32_rz(p[j][2]),
                           split_tf32_rz(p[j][1]), split_tf32_rz(p[j][3])};
      const Split as[4] = {split_tf32_rz(dp[j][0]), split_tf32_rz(dp[j][2]),
                           split_tf32_rz(dp[j][1]), split_tf32_rz(dp[j][3])};
      const float* dr = dos + (8 * j + 2 * t) * KS + g;
      const float* qr = qs + (8 * j + 2 * t) * KS + g;
#pragma unroll
      for (int n = 0; n < KD; ++n) {
        const Split bd[2] = {split_tf32_rz(dr[8 * n]),
                             split_tf32_rz(dr[KS + 8 * n])};
        const Split bq[2] = {split_tf32_rz(qr[8 * n]),
                             split_tf32_rz(qr[KS + 8 * n])};
        tryage::mma_3xtf32(dv[n], ap, bd);
        tryage::mma_3xtf32(dk[n], as, bq);
      }
    }

    if (whole) {  // dQ of the tile, complete: every key is in the block
      __syncthreads();  // dS^T is in
      float acc[G::NQ][3][4] = {};
      dq_tile<KD>(ds_s, ks, nk8, acc);
      store_dq<KD>(a.dq + ((size_t)b * a.S * a.H + h) * HD, acc, q0, a.S,
                   q_stride, a.scale);
    }
  }

  // dK and dV of the warp's 16 keys; a cluster adds its blocks' in rank
  // order, each block writing every split-th of the 2 KD fragments
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] *= a.scale;
  const int key = kb0 + 16 * warp + g;
  auto store = [&](int f, float4 x) {
    float* out = (f < KD ? a.dk + 8 * f : a.dv + 8 * (f - KD)) + kv_off;
    out += 2 * t;
    if (key < a.T)
      *reinterpret_cast<float2*>(out + (size_t)key * kv_stride) =
          make_float2(x.x, x.y);
    if (key + 8 < a.T)
      *reinterpret_cast<float2*>(out + (size_t)(key + 8) * kv_stride) =
          make_float2(x.z, x.w);
  };
  if (split == 1) {
#pragma unroll
    for (int f = 0; f < 2 * KD; ++f) {
      const float* x = f < KD ? dk[f] : dv[f - KD];
      store(f, make_float4(x[0], x[1], x[2], x[3]));
    }
    return;
  }
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();  // K and V are read for the last time; reuse them
  float4* red = reinterpret_cast<float4*>(sm);  // [warp][2 KD][lane]
#pragma unroll
  for (int f = 0; f < 2 * KD; ++f) {
    const float* x = f < KD ? dk[f] : dv[f - KD];
    red[(warp * 2 * KD + f) * 32 + lane] = make_float4(x[0], x[1], x[2], x[3]);
  }
  cluster.sync();
#pragma unroll
  for (int f = 0; f < 2 * KD; ++f) {
    if (f % split != rank) continue;
    const int at = (warp * 2 * KD + f) * 32 + lane;
    float4 s = cluster.map_shared_rank(red, 0)[at];
    for (int c = 1; c < split; ++c) {
      const float4 o = cluster.map_shared_rank(red, c)[at];
      s.x += o.x;
      s.y += o.y;
      s.z += o.z;
      s.w += o.w;
    }
    store(f, s);
  }
  cluster.sync();  // no block leaves while another reads its shares
}

// T > 128 only: a block per (query tile, b * H + h) takes the row sums
// over every key block, writes them to Args::rows, then walks the key
// blocks again for dS and dQ.
template <int KD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dq(Args a) {
  using G = Geo<KD>;
  constexpr int HD = G::HD, R = G::R, NR = G::NR;
  extern __shared__ __align__(16) float sm[];
  const int q0 = blockIdx.x * R, bh = blockIdx.y;
  const int b = bh / a.H, h = bh - b * a.H, kvh = h / (a.H / a.KV);
  const size_t q_stride = (size_t)a.H * HD, kv_stride = (size_t)a.KV * HD;
  const size_t q_off = ((size_t)b * a.S * a.H + h) * HD;
  const size_t kv_off = ((size_t)b * a.T * a.KV + kvh) * HD;
  float* ks = sm + G::kK;
  float* vs = sm + G::kV;
  const float* qs = sm + G::kQ;
  const float* dos = sm + G::kDO;
  float* ds_s = sm + G::kDS;
  const float* lse_s = sm + G::kLse;
  float* row_s = sm + G::kRow;
  const int n_kb = (a.T + kBlockKeys - 1) / kBlockKeys;

  stage_rows<KD>(sm + G::kQ, a.q + q_off, q0, R, a.S, q_stride);
  stage_rows<KD>(sm + G::kDO, a.d_o + q_off, q0, R, a.S, q_stride);
  stage_row_data(sm + G::kLse, row_s, a.lse, nullptr, bh, q0, R, a.S);

  float ps[NR / 4] = {}, pd[NR / 4] = {}, acc[G::NQ][3][4] = {};
  for (int pass = 0; pass < 2; ++pass) {
    for (int kb = 0; kb < n_kb; ++kb) {
      const int kb0 = kb * kBlockKeys;
      if (pass + kb > 0) __syncthreads();  // the last block is done with
      stage_rows<KD>(ks, a.k + kv_off, kb0, kBlockKeys, a.T, kv_stride);
      stage_rows<KD>(vs, a.v + kv_off, kb0, kBlockKeys, a.T, kv_stride);
      tryage::cp_async_commit();
      tryage::cp_async_wait<0>();
      __syncthreads();
      float p[NR][4], dp[NR][4];
      scores<KD>(a, ks, vs, qs, dos, lse_s, q0, kb0, p, dp,
                 pass == 1 && a.softcap > 0.0f ? ds_s : nullptr);
      if (pass == 0) {
        float bs[NR / 4], bd[NR / 4];
        row_sums<NR>(p, dp, bs, bd);
#pragma unroll
        for (int ii = 0; ii < NR / 4; ++ii) {
          ps[ii] += bs[ii];
          pd[ii] += bd[ii];
        }
        continue;
      }
      grads<KD>(a, p, dp, lse_s, row_s, ds_s);
      __syncthreads();  // dS^T is in
      dq_tile<KD>(ds_s, ks, (min(kBlockKeys, a.T - kb0) + 7) / 8, acc);
    }
    if (pass == 0) {
      store_part<NR>(sm + G::kPart, ps, pd);
      __syncthreads();
      row_totals(sm + G::kPart, lse_s, row_s, R, a.rows + 2 * (size_t)bh * a.S,
                 q0, a.S);
    }
  }
  store_dq<KD>(a.dq + q_off, acc, q0, a.S, q_stride, a.scale);
}

namespace {

// The opt-in to more than 48 KB of shared memory, once per device and
// kernel: a driver call on every launch would cost microseconds of
// host time a call.
template <typename Kernel>
cudaError_t allow_smem_once(Kernel kernel, size_t bytes,
                            unsigned long long& devices) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return tryage::allow_smem(kernel, bytes);
  if (devices >> dev & 1ull) return cudaSuccess;
  err = tryage::allow_smem(kernel, bytes);
  if (err == cudaSuccess) devices |= 1ull << dev;
  return err;
}

template <int KD>
int launch_bwd(const Args& a, cudaStream_t stream) {
  using G = Geo<KD>;
  static unsigned long long ready_main = 0, ready_dq = 0;
  const size_t smem = sizeof(float) * G::kFloats;
  cudaError_t err =
      allow_smem_once(flash_attention_bwd_kernel<KD>, smem, ready_main);
  if (err != cudaSuccess) return (int)err;
  const int n_kb = (a.T + kBlockKeys - 1) / kBlockKeys;
  const int n_qt = (a.S + G::R - 1) / G::R;
  if (n_kb > 1) {  // the row sums and dQ first; the second launch reads them
    err = allow_smem_once(flash_attention_bwd_dq<KD>, smem, ready_dq);
    if (err != cudaSuccess) return (int)err;
    flash_attention_bwd_dq<KD><<<dim3(n_qt, a.B * a.H), kThreads, smem,
                                 stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // a cluster splits each (b, kv head, key block)'s tiles while that
  // still leaves a block per SM
  const long units = (long)a.B * a.KV * n_kb;
  const int items = (a.H / a.KV) * n_qt;
  int split = 1;
  while (split < kMaxCluster && 2 * split <= items &&
         units * 2 * split <= kSMs)
    split *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, n_kb, a.B * a.KV);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_attention_bwd_kernel<KD>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// rows: (B, H, S, 2) f32 workspace for the row sums, read only when
// T > 128 (the two-launch path); may be null otherwise.
extern "C" int tryage_flash_attention_bwd(
    const float* q, const float* k, const float* v, const float* d_o,
    const float* lse, float* rows, float* dq, float* dk, float* dv, int B,
    int S, int T, int H, int KV, int hd, int causal, int window,
    float softcap, float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (T <= 0 || hd % 8 || hd < 8 || hd > 128 || KV <= 0 || H % KV)
    return (int)cudaErrorInvalidValue;
  if (T > kBlockKeys && rows == nullptr) return (int)cudaErrorInvalidValue;
  const Args a = {q, k, v, d_o, lse, T > kBlockKeys ? rows : nullptr, dq, dk,
                  dv, B, S, T, H, KV, causal, window, softcap, scale};
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd / 8) {
#define TRYAGE_HD(KD) \
  case KD:            \
    return launch_bwd<KD>(a, st);
    TRYAGE_HD(1) TRYAGE_HD(2) TRYAGE_HD(3) TRYAGE_HD(4)
    TRYAGE_HD(5) TRYAGE_HD(6) TRYAGE_HD(7) TRYAGE_HD(8)
    TRYAGE_HD(9) TRYAGE_HD(10) TRYAGE_HD(11) TRYAGE_HD(12)
    TRYAGE_HD(13) TRYAGE_HD(14) TRYAGE_HD(15) TRYAGE_HD(16)
#undef TRYAGE_HD
  }
  return (int)cudaErrorInvalidValue;
}
