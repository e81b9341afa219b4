// The f32 attention backward kernel's body, shared by its translation
// units: flash_attention_bwd.cu (the C entry point) and the f32 parts of
// flash_attention_bwd_part.cu (the instances), compiled side by side.
// The design notes are in flash_attention_bwd.cu; the bf16 instances
// have a body of their own (flash_attention_bwd_bf16.cuh).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "mma_tf32.cuh"

namespace tryage {

// The backward's arguments; in the tryage namespace (not the file's
// anonymous one) because the C entry point hands them to instances in
// other translation units.
struct Args {
  const void* q;      // (B, S, H, hd), f32 or bf16
  const void* k;      // (B, T, KV, hd)
  const void* v;
  const void* d_o;    // (B, S, H, hd)
  const float* lse;   // (B, H, S)
  float* rows;        // (B, H, S, 2): 1 / sum P and D; null on one launch
  void* dq;           // in the inputs' type
  void* dk;
  void* dv;
  int B, S, T, H, KV, causal, window;
  float softcap, scale;
};

}  // namespace tryage

namespace {

using tryage::Args;
using tryage::Split;
using tryage::split_tf32_rz;

constexpr int kMaxCluster = 8;
constexpr int kSMs = 132;
constexpr int kMaxKD = 32;                 // hd 256
constexpr float kNegInf = -2.3819763e38f;  // the forward's mask fill
constexpr unsigned kFull = 0xffffffffu;

// The geometry of one instance: Tin the input type (float), KD = hd / 8.
template <typename Tin, int KD>
struct Geo {
  static_assert(std::is_same<Tin, float>::value, "the f32 instances");
  // hd above 128: 4 warps (64 keys a block), one q/dO buffer, and the
  // output columns in two halves, one block each (see the header)
  static constexpr bool kWide = KD > 16;
  static constexpr int HD = 8 * KD;
  static constexpr int W = kWide ? 4 : 8;          // warps
  static constexpr int THREADS = 32 * W;
  static constexpr int BK = 16 * W;                // keys of a block
  static constexpr int NB = kWide ? 1 : 2;         // q/dO tile buffers
  static constexpr int CH = kWide ? 2 : 1;         // column halves
  static constexpr int KO = (KD + CH - 1) / CH;    // output n-tiles a block
  static constexpr int R = KD <= 8 ? 64 : 32;      // query rows of a tile
  static constexpr int NR = R / 8;                 // its 8-row steps
  static constexpr int KS = HD + 4;                // padded row: K, V, q, dO
  static constexpr int DS = R + 4;                 // padded row of dS^T
  // dQ of a tile: 16-row groups, the warps that share one, n-tiles each
  static constexpr int RG = R / 16;
  static constexpr int NG = W / RG;
  static constexpr int NQ = (KO + NG - 1) / NG;
  // shared memory, in floats
  static constexpr int kK = 0;
  static constexpr int kV = kK + BK * KS;
  static constexpr int kQ = kV + BK * KS;          // NB buffers
  static constexpr int kDO = kQ + NB * R * KS;     // NB buffers
  static constexpr int kDS = kDO + NB * R * KS;    // dS^T [key][row]
  static constexpr int kPart = kDS + BK * DS;      // [warp][2][R]
  static constexpr int kLse = kPart + W * 2 * R;   // 2 buffers
  static constexpr int kRow = kLse + 2 * R;        // 2 x [R][2]
  static constexpr int kFloats = kRow + 4 * R;
};

// Rows [r0, r0 + n) of one head of a (rows, heads, HD) tensor into a tile
// of f32 rows padded to HD + 4 floats by cp.async; rows at or past `lim`
// are zero.
template <typename Tin, int KD, int THREADS>
__device__ __forceinline__ void stage_rows(float* dst, const Tin* src, int r0,
                                           int n, int lim, size_t stride) {
  constexpr int KS = 8 * KD + 4;
  constexpr int kPieces = 2 * KD;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < n * kPieces; i += THREADS) {
    const int r = i / kPieces, c = (i - r * kPieces) * 4;
    const bool in = r0 + r < lim;
    tryage::cp_async16(dst + r * KS + c,
                       src + (size_t)(in ? r0 + r : 0) * stride + c, in);
  }
}

// cp.async the lse of rows [q0, q0 + R) of row `bh` of (B * H, S), and
// with `rows` their 1 / sum P and D; rows past S are zero.
template <int THREADS>
__device__ __forceinline__ void stage_row_data(float* lse_s, float* row_s,
                                               const float* lse,
                                               const float* rows, size_t bh,
                                               int q0, int R, int S) {
  for (int i = threadIdx.x; i < R; i += THREADS) {
    const bool in = q0 + i < S;
    const size_t r = bh * S + (in ? q0 + i : 0);
    tryage::cp_async4(lse_s + i, lse + r, in);
    if (rows != nullptr) tryage::cp_async8(row_s + 2 * i, rows + 2 * r, in);
  }
}

// S^T = K q^T and dP^T = V dO^T, unscaled, for the warp's 16 keys of the
// block and the tile's R rows, in 3xTF32.  Lane (g, t) holds in [j][e]
// key 16 warp + g + 8 (e >> 1) and tile row 8 j + 2 t + (e & 1).
template <typename G>
__device__ __forceinline__ void products(const float* ks, const float* vs,
                                         const float* qs, const float* dos,
                                         float (&p)[G::NR][4],
                                         float (&dp)[G::NR][4]) {
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
  for (int kk = 0; kk < G::HD / 8; ++kk) {
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

// d += A B for A computed in f32 (split) and B an input, in 3xTF32.
__device__ __forceinline__ void mma_in(float (&d)[4], const Split (&a)[4],
                                       float b0, float b1) {
  const Split b[2] = {split_tf32_rz(b0), split_tf32_rz(b1)};
  tryage::mma_3xtf32(d, a, b);
}

// Two floats of shared memory, loaded anew at every call: the compiler
// may neither reuse an earlier load nor keep the values it stored there.
__device__ __forceinline__ float2 lds2(const float* p) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "r"((unsigned)__cvta_generic_to_shared(p))
               : "memory");
  return v;
}

// P in place of the scores: exp(S - lse) where the score is unmasked, 0
// where it is masked or out of range, 1 / T over the in-range keys of a
// row with no key.  With kCap the scores pass through the softcap, and
// with `dcap` its factor 1 - tanh^2 goes there, at the entry's place in
// dS^T.  The masks are selects, not branches, and the softcap a template
// argument: a branch in this loop would split it into blocks that the
// compiler cannot interleave, and each entry's exp would wait on the last.
template <typename G, bool kCap>
__device__ __forceinline__ void probs(const Args& a, const float* lse_s,
                                      int q0, int kb0, float (&p)[G::NR][4],
                                      float* dcap) {
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
template <typename G>
__device__ __forceinline__ void scores(const Args& a, const float* ks,
                                       const float* vs, const float* qs,
                                       const float* dos, const float* lse_s,
                                       int q0, int kb0, float (&p)[G::NR][4],
                                       float (&dp)[G::NR][4], float* dcap) {
  products<G>(ks, vs, qs, dos, p, dp);
  if (a.softcap > 0.0f)
    probs<G, true>(a, lse_s, q0, kb0, p, dcap);
  else
    probs<G, false>(a, lse_s, q0, kb0, p, dcap);
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
template <typename G>
__device__ __forceinline__ void row_totals(const float* part,
                                           const float* lse_s, float* row_s,
                                           float* out, int q0, int S) {
  constexpr int R = G::R;
  for (int r = threadIdx.x; r < R; r += G::THREADS) {
    float ps = part[r], pd = part[R + r];
    for (int w = 1; w < G::W; ++w) {
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
template <typename G, bool kCap>
__device__ __forceinline__ void grads_t(float (&p)[G::NR][4],
                                        float (&dp)[G::NR][4],
                                        const float* lse_s, const float* row_s,
                                        float* ds_s) {
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

template <typename G>
__device__ __forceinline__ void grads(const Args& a, float (&p)[G::NR][4],
                                      float (&dp)[G::NR][4],
                                      const float* lse_s, const float* row_s,
                                      float* ds_s) {
  if (a.softcap > 0.0f)
    grads_t<G, true>(p, dp, lse_s, row_s, ds_s);
  else
    grads_t<G, false>(p, dp, lse_s, row_s, ds_s);
}

// acc += dS K over the block's first nk8 8-key steps, for the warp's
// 16-row group (warp % RG) of the tile and its n-tiles (dims 8 (n0 + n)
// for n = warp / RG + NG m; n0 + n < KD always, see first_tile).  dS is
// read from ds_s with the k index permuted as above (A column t <-> key 2t), K's rows in the same order.
// A warp has few n-tiles here, so each pass accumulates in its own
// registers: independent mma.sync chains a tile, not one.
template <typename G>
__device__ __forceinline__ void dq_tile(const float* ds_s, const float* ks,
                                        int nk8, int n0,
                                        float (&acc)[G::NQ][3][4]) {
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
      if (m + 1 < G::NQ || G::KO % G::NG == 0 || n < G::KO) {
        const Split kb[2] = {split_tf32_rz(k0[8 * (n0 + n)]),
                             split_tf32_rz(k0[KS + 8 * (n0 + n)])};
        tryage::mma_3xtf32_sep(acc[m], sa, kb);
      }
    }
  }
}

// Two values into `out`.
__device__ __forceinline__ void store2(float* out, float x, float y) {
  *reinterpret_cast<float2*>(out) = make_float2(x, y);
}

// The first output n-tile of column half `half`.  An odd KD's halves
// overlap by one tile (the second starts at KD - KO), so every tile a
// block computes exists and no load needs a guard; the first half stores
// the shared tile (see stored).
template <typename G>
__device__ __forceinline__ int first_tile(int half) {
  return half * (G::HD / 8 - G::KO);
}

// Whether a block stores its n-tile n: all but the second half's copy of
// an odd KD's shared tile.
template <typename G>
__device__ __forceinline__ bool stored(int n0, int n) {
  return n0 == 0 || n0 + n >= G::KO;
}

// dQ of the tile (acc from dq_tile, times the scale) into the model
// layout; `out` is the head's first row.
template <typename G, typename Tin>
__device__ __forceinline__ void store_dq(Tin* out,
                                         const float (&acc)[G::NQ][3][4],
                                         int q0, int S, int n0, size_t stride,
                                         float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % G::RG, ng = warp / G::RG;
#pragma unroll
  for (int m = 0; m < G::NQ; ++m) {
    const int n = ng + G::NG * m;
    if (n >= G::KO || !stored<G>(n0, n)) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 16 * rg + g + 8 * r;
      if (row < S)
        store2(out + (size_t)row * stride + 8 * (n0 + n) + 2 * t,
               tryage::sep_sum(acc[m], 2 * r) * scale,
               tryage::sep_sum(acc[m], 2 * r + 1) * scale);
    }
  }
}

}  // namespace

// A block per (cluster rank, key block x column half, b * KV + kv head);
// see the header.
template <typename Tin, int KD>
__global__ void __launch_bounds__(Geo<Tin, KD>::THREADS, 1)
flash_attention_bwd_kernel(Args a) {
  using G = Geo<Tin, KD>;
  constexpr int HD = G::HD, R = G::R, NR = G::NR, KS = G::KS, KO = G::KO;
  constexpr int BK = G::BK, THREADS = G::THREADS;
  extern __shared__ __align__(16) float sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int split = gridDim.x, rank = blockIdx.x;  // the cluster is along x
  const int kb0 = (blockIdx.y / G::CH) * BK;
  const int n0 = first_tile<G>(blockIdx.y % G::CH);
  const int b = blockIdx.z / a.KV, kvh = blockIdx.z - b * a.KV;
  const int group = a.H / a.KV;
  const int n_qt = (a.S + R - 1) / R, items = group * n_qt;
  // every key of the head is here (one launch): dQ in this kernel too
  const bool whole = !G::kWide && a.rows == nullptr;
  const size_t q_stride = (size_t)a.H * HD, kv_stride = (size_t)a.KV * HD;
  const size_t kv_off = ((size_t)b * a.T * a.KV + kvh) * HD;
  const Tin* q = static_cast<const Tin*>(a.q);
  const Tin* d_o = static_cast<const Tin*>(a.d_o);
  float* ks = sm + G::kK;
  float* vs = sm + G::kV;
  float* ds_s = sm + G::kDS;
  const int nk8 = (min(BK, a.T - kb0) + 7) / 8;

  stage_rows<Tin, KD, THREADS>(ks, static_cast<const Tin*>(a.k) + kv_off, kb0,
                               BK, a.T, kv_stride);
  stage_rows<Tin, KD, THREADS>(vs, static_cast<const Tin*>(a.v) + kv_off, kb0,
                               BK, a.T, kv_stride);
  auto stage = [&](int it, int buf) {
    const int h = kvh * group + it / n_qt, q0 = (it % n_qt) * R;
    const size_t q_off = ((size_t)b * a.S * a.H + h) * HD;
    stage_rows<Tin, KD, THREADS>(sm + G::kQ + buf * R * KS, q + q_off, q0, R,
                                 a.S, q_stride);
    stage_rows<Tin, KD, THREADS>(sm + G::kDO + buf * R * KS, d_o + q_off, q0,
                                 R, a.S, q_stride);
    stage_row_data<THREADS>(sm + G::kLse + buf * R, sm + G::kRow + buf * 2 * R,
                            a.lse, a.rows, (size_t)b * a.H + h, q0, R, a.S);
  };
  stage(rank, 0);  // rank < items: a cluster never outnumbers the tiles
  tryage::cp_async_commit();

  float dk[KO][4], dv[KO][4];
#pragma unroll
  for (int n = 0; n < KO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.0f;

  int buf = 0;
  for (int it = rank; it < items; it += split) {
    tryage::cp_async_wait<0>();
    __syncthreads();  // this tile is in; the last one is done with
    if (G::NB == 2 && it + split < items) stage(it + split, buf ^ 1);
    tryage::cp_async_commit();
    const int h = kvh * group + it / n_qt, q0 = (it % n_qt) * R;
    const float* qs = sm + G::kQ + buf * R * KS;
    const float* dos = sm + G::kDO + buf * R * KS;
    const float* lse_s = sm + G::kLse + buf * R;
    float* row_s = sm + G::kRow + buf * 2 * R;

    float p[NR][4], dp[NR][4];
    scores<G>(a, ks, vs, qs, dos, lse_s, q0, kb0, p, dp,
              a.softcap > 0.0f ? ds_s : nullptr);
    if (whole) {
      float ps[NR / 4], pd[NR / 4];
      row_sums<NR>(p, dp, ps, pd);
      store_part<NR>(sm + G::kPart, ps, pd);
      __syncthreads();
      row_totals<G>(sm + G::kPart, lse_s, row_s, nullptr, q0, a.S);
      __syncthreads();
    }
    grads<G>(a, p, dp, lse_s, row_s, ds_s);

    // dV += P^T dO over the tile, then dK += dS^T q: the 8-row step j is
    // a k-step, A column t is row 2t and column t + 4 row 2t + 1 (see the
    // header).  Two loops, not one: with both A fragments live at once,
    // 16 n-tiles (hd 128 and 256) spilled beside dK and dV.  Each
    // n-tile's NR k-steps run in a fresh accumulator, then added to dV
    // or dK: the tensor cores' f32 accumulate truncates toward zero, so
    // one chain over every tile of a long sequence drifts (at
    // starcoder2's 12 query heads of 4,608 rows, 6,912 k-steps a chain,
    // dK moved by 3.3e-4 of its largest value); NR k-steps and one
    // rounded add keep dK and dV at f32's rounding.  With the n-tiles
    // outside, every k-step's A fragment serves all of them: dS^T's are
    // read back from ds_s at each use (lds2; grads_t put them there), so
    // that its split halves need not all stay in registers, which
    // spilled beside dK and dV.
#pragma unroll
    for (int n = 0; n < KO; ++n) {
      const int c = 8 * (n0 + n);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const Split ap[4] = {split_tf32_rz(p[j][0]), split_tf32_rz(p[j][2]),
                             split_tf32_rz(p[j][1]), split_tf32_rz(p[j][3])};
        const float* dr = dos + (8 * j + 2 * t) * KS + g;
        mma_in(acc, ap, dr[c], dr[KS + c]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[n][e] += acc[e];
    }
    const float* dsw = ds_s + (16 * warp + g) * G::DS + 2 * t;
#pragma unroll
    for (int n = 0; n < KO; ++n) {
      const int c = 8 * (n0 + n);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const float2 x = lds2(dsw + 8 * j), y = lds2(dsw + 8 * G::DS + 8 * j);
        const Split as[4] = {split_tf32_rz(x.x), split_tf32_rz(y.x),
                             split_tf32_rz(x.y), split_tf32_rz(y.y)};
        const float* qr = qs + (8 * j + 2 * t) * KS + g;
        mma_in(acc, as, qr[c], qr[KS + c]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] += acc[e];
    }

    if constexpr (!G::kWide) {
      if (whole) {  // dQ of the tile, complete: every key is in the block
        __syncthreads();  // dS^T is in
        float acc[G::NQ][3][4] = {};
        dq_tile<G>(ds_s, ks, nk8, 0, acc);
        store_dq<G>(static_cast<Tin*>(a.dq) + ((size_t)b * a.S * a.H + h) * HD,
                    acc, q0, a.S, 0, q_stride, a.scale);
      }
    }
    if (G::NB == 2) {
      buf ^= 1;
    } else if (it + split < items) {  // one buffer: the next tile now
      __syncthreads();
      stage(it + split, 0);
      tryage::cp_async_commit();
    }
  }

  // dK and dV of the warp's 16 keys; a cluster adds its blocks' in rank
  // order, each block writing every split-th of the 2 KO fragments
#pragma unroll
  for (int n = 0; n < KO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] *= a.scale;
  const int key = kb0 + 16 * warp + g;
  auto store = [&](int f, float4 x) {
    const int n = f < KO ? f : f - KO;
    if (!stored<G>(n0, n)) return;  // the other half stores this tile
    Tin* out = static_cast<Tin*>(f < KO ? a.dk : a.dv) + kv_off +
               8 * (n0 + n) + 2 * t;
    if (key < a.T) store2(out + (size_t)key * kv_stride, x.x, x.y);
    if (key + 8 < a.T) store2(out + (size_t)(key + 8) * kv_stride, x.z, x.w);
  };
  if (split == 1) {
#pragma unroll
    for (int f = 0; f < 2 * KO; ++f) {
      const float* x = f < KO ? dk[f] : dv[f - KO];
      store(f, make_float4(x[0], x[1], x[2], x[3]));
    }
    return;
  }
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();  // K and V are read for the last time; reuse them
  float4* red = reinterpret_cast<float4*>(sm);  // [warp][2 KO][lane]
#pragma unroll
  for (int f = 0; f < 2 * KO; ++f) {
    const float* x = f < KO ? dk[f] : dv[f - KO];
    red[(warp * 2 * KO + f) * 32 + lane] = make_float4(x[0], x[1], x[2], x[3]);
  }
  cluster.sync();
#pragma unroll
  for (int f = 0; f < 2 * KO; ++f) {
    if (f % split != rank) continue;
    const int at = (warp * 2 * KO + f) * 32 + lane;
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

// The first of two launches: a block per (query tile, b * H + h, column
// half) takes the row sums over every key block, writes them to
// Args::rows (the first half only), then walks the key blocks again for
// dS and its half of dQ.
template <typename Tin, int KD>
__global__ void __launch_bounds__(Geo<Tin, KD>::THREADS, 1)
flash_attention_bwd_dq(Args a) {
  using G = Geo<Tin, KD>;
  constexpr int HD = G::HD, R = G::R, NR = G::NR, BK = G::BK;
  constexpr int THREADS = G::THREADS;
  extern __shared__ __align__(16) float sm[];
  const int q0 = blockIdx.x * R, bh = blockIdx.y;
  const int n0 = first_tile<G>(blockIdx.z);
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
  const int n_kb = (a.T + BK - 1) / BK;

  stage_rows<Tin, KD, THREADS>(sm + G::kQ, static_cast<const Tin*>(a.q) + q_off,
                               q0, R, a.S, q_stride);
  stage_rows<Tin, KD, THREADS>(sm + G::kDO,
                               static_cast<const Tin*>(a.d_o) + q_off, q0, R,
                               a.S, q_stride);
  stage_row_data<THREADS>(sm + G::kLse, row_s, a.lse, nullptr, bh, q0, R, a.S);

  float ps[NR / 4] = {}, pd[NR / 4] = {}, acc[G::NQ][3][4] = {};
  for (int pass = 0; pass < 2; ++pass) {
    for (int kb = 0; kb < n_kb; ++kb) {
      const int kb0 = kb * BK;
      if (pass + kb > 0) __syncthreads();  // the last block is done with
      stage_rows<Tin, KD, THREADS>(ks, static_cast<const Tin*>(a.k) + kv_off,
                                   kb0, BK, a.T, kv_stride);
      stage_rows<Tin, KD, THREADS>(vs, static_cast<const Tin*>(a.v) + kv_off,
                                   kb0, BK, a.T, kv_stride);
      tryage::cp_async_commit();
      tryage::cp_async_wait<0>();
      __syncthreads();
      float p[NR][4], dp[NR][4];
      scores<G>(a, ks, vs, qs, dos, lse_s, q0, kb0, p, dp,
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
      grads<G>(a, p, dp, lse_s, row_s, ds_s);
      __syncthreads();  // dS^T is in
      dq_tile<G>(ds_s, ks, (min(BK, a.T - kb0) + 7) / 8, n0, acc);
    }
    if (pass == 0) {
      store_part<NR>(sm + G::kPart, ps, pd);
      __syncthreads();
      row_totals<G>(sm + G::kPart, lse_s, row_s,
                    blockIdx.z == 0 ? a.rows + 2 * (size_t)bh * a.S : nullptr,
                    q0, a.S);
    }
  }
  store_dq<G>(static_cast<Tin*>(a.dq) + q_off, acc, q0, a.S, n0, q_stride,
              a.scale);
}

namespace {

// The opt-in to more than 48 KB of shared memory, once per device and
// kernel: a runtime call on every launch would cost microseconds of
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

template <typename Tin, int KD>
int launch_bwd(const Args& a, cudaStream_t stream) {
  using G = Geo<Tin, KD>;
  static unsigned long long ready_main = 0, ready_dq = 0;
  const size_t smem = sizeof(float) * G::kFloats;
  const int n_kb = (a.T + G::BK - 1) / G::BK;
  const bool two = n_kb > 1 || G::kWide;
  if (two != (a.rows != nullptr)) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem_once(flash_attention_bwd_kernel<Tin, KD>, smem,
                                    ready_main);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (a.S + G::R - 1) / G::R;
  if (two) {  // the row sums and dQ first; the second launch reads them
    err = allow_smem_once(flash_attention_bwd_dq<Tin, KD>, smem, ready_dq);
    if (err != cudaSuccess) return (int)err;
    flash_attention_bwd_dq<Tin, KD>
        <<<dim3(n_qt, a.B * a.H, G::CH), G::THREADS, smem, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  // a cluster splits each (b, kv head, key block, half)'s tiles while
  // that still leaves a block per SM
  const long units = (long)a.B * a.KV * n_kb * G::CH;
  const int items = (a.H / a.KV) * n_qt;
  int split = 1;
  while (split < kMaxCluster && 2 * split <= items &&
         units * 2 * split <= kSMs)
    split *= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, n_kb * G::CH, a.B * a.KV);
  cfg.blockDim = dim3(G::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, flash_attention_bwd_kernel<Tin, KD>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launch the instance for kd = hd / 8 among KD in [KD, Hi].
template <typename Tin, int KD, int Hi>
int dispatch_bwd(int kd, const Args& a, cudaStream_t stream) {
  if constexpr (KD > Hi) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (kd == KD) return launch_bwd<Tin, KD>(a, stream);
    return dispatch_bwd<Tin, KD + 1, Hi>(kd, a, stream);
  }
}

}  // namespace

namespace tryage {
// The instances come in eight parts, each its own translation unit
// (flash_attention_bwd_part.cu, compiled once per part with the part's
// type and hd / 8 range: kernels/build.py PARTS), built side by side;
// a part holds hd / 8 in [LO, LO + 7].
template <int BF16, int LO>
int flash_attention_bwd_part(int kd, const Args& a, cudaStream_t stream);
#define TRYAGE_BWD_PART(BF16, LO) \
  template <>                     \
  int flash_attention_bwd_part<BF16, LO>(int, const Args&, cudaStream_t);
TRYAGE_BWD_PART(0, 1) TRYAGE_BWD_PART(0, 9) TRYAGE_BWD_PART(0, 17)
TRYAGE_BWD_PART(0, 25) TRYAGE_BWD_PART(1, 1) TRYAGE_BWD_PART(1, 9)
TRYAGE_BWD_PART(1, 17) TRYAGE_BWD_PART(1, 25)
#undef TRYAGE_BWD_PART
}  // namespace tryage
