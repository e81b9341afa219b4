// The bf16 instances of the attention backward (the function of
// flash_attention_bwd.cu, whose notes give the algorithm, the masks and
// the C entry point), redesigned for Hopper's bf16 tensor cores at the
// zoo's training shapes (S = T = 512-4608, hd 64-256), where the
// operations bound it.  Included by the bf16 parts of
// flash_attention_bwd_part.cu.
//
// Numerics (mma_bf16.cuh): the products of two bf16 inputs, S = q k^T and
// dP = dO V^T, take one bf16 mma.sync.m16n8k16 pass on the unscaled
// inputs (exact products); the products with a computed f32 operand, P^T
// dO, dS^T q and dS K, take two, the operand's bf16 pieces hi and lo
// against the exact input (tests/test_torch_tf32.py and
// tests/test_torch_attention_grad.py emulate them: one piece fails the
// card's gate).  Every accumulator is fresh a tile: a tile's k-steps run
// in their own accumulator, then are added to dK, dV or dQ rounded, so
// no truncating f32 accumulate chain grows with the sequence.  The rows
// of dS are renormalised as in the f32 instances (P / sum P, D = sum(P
// dP) / sum P, both from this backward's own P).
// Design, two launches, no atomics (a rerun is bit-identical):
// * flash_attention_bwd_dq_bf16, a block per (b, h, tile of 64 query
//   rows), the last tile first (under the causal mask it sees the most
//   keys), four row groups of 16 rows.  q and dO of the tile sit in
//   shared memory; K and V arrive in blocks of 64 keys, double-buffered
//   by cp.async, over the key blocks twice: first S and dP for the row
//   sums (1 / sum P and D go to Args::rows for the second launch), then
//   S and dP again for dS and dQ += dS K.  A row group is one warp up
//   to hd 128; above, a pair of warps, each S and dP for half the keys
//   and dQ for half the columns, dS's split fragments and the row sums
//   handed over in shared memory (a named barrier of the pair): dQ's
//   accumulator for a whole row (128 registers a lane at hd 256)
//   spilled.
// * flash_attention_bwd_kv_bf16, a block of 8 warps per (b, kv head,
//   block of 64 keys; 32 above hd 128), the first key block first; it
//   walks the group's query heads and their tiles of 64 rows, q, dO, lse
//   and the row sums double-buffered by cp.async.  dK and dV are split
//   across warps, not across blocks: for each 16 keys one warp computes
//   S^T = K q^T, P and dV += P^T dO, another dP^T = V dO^T and dK +=
//   dS^T q, with P / sum P times the softcap's factor handed over in
//   shared memory (a named barrier).  Above hd 128 each role takes two
//   warps, each S^T or dP^T for half the tile's rows and dV or dK for
//   half the columns, the split fragments handed over too.  So a lane
//   holds one of dK and dV, for all the columns up to hd 128 (64
//   registers a lane) and half of them above (64 at hd 256), S and dP
//   are computed once per (row, key) here, three times in all over the
//   two launches, and the warps of a key group do the same work.
// * Key-major products (S^T, dP^T) leave P^T and dS^T in the
//   accumulators as the A fragments of P^T dO and dS^T q; row-major
//   ones leave dS as that of dS K.  Operands come from shared memory by
//   ldmatrix (.trans for those read across their rows), tiles staged in
//   bf16, never widened, rows padded by 16 bytes (bank-conflict-free
//   ldmatrix) and hd rounded up to 16 with zeros.  One instance per hd /
//   16 rounded up, hd an argument.
// * A tile that every row of it masks is never computed, in either
//   launch (key blocks in the first, query tiles in the second), by the
//   forward's rule: where a row of the tile sees no key at all (only
//   past T with a window), nothing is skipped, as such a row spreads its
//   P over every key.  flash_attention/ops.py:walked_tiles is the same
//   rule for the CPU tests.  The masks are applied only where a warp's
//   rows and keys hold a masked or out-of-range pair, and the exps run
//   on MUFU.EX2 with the scale and log2(e) folded into one multiply.
#pragma once

#include "flash_attention_bwd.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tryage::bar_arrive;
using tryage::bar_sync;
using tryage::kLog2e;

// The geometry of one instance: HDP = 16 KP, hd rounded up to a k-step.
template <int KP>
struct Bf16Bwd {
  static constexpr int HDP = 16 * KP;
  static constexpr int NT = HDP / 8;      // dims' n-tiles
  static constexpr int LD = HDP + 8;      // padded row, elements
  // above hd 128 a warp holds half the columns of dQ, dK or dV (its half
  // rounded up to an even count of n-tiles: NO), and the warp beside it
  // the other half
  static constexpr bool kWide = HDP > 128;
  static constexpr int NO = kWide ? 2 * ((KP + 1) / 2) : NT;
  // the dQ launch: 4 row groups of 16 rows (a warp each, a pair of warps
  // when kWide), key blocks of BNQ keys (a pair's warps take half each)
  static constexpr int QGROUPS = 4;
  static constexpr int QWARPS = QGROUPS * (kWide ? 2 : 1);
  static constexpr int QROWS = 16 * QGROUPS;
  static constexpr int BNQ = 64;
  static constexpr int QK = kWide ? BNQ / 2 : BNQ;  // keys of a warp's S, dP
  // a pair's exchange, in 32-bit words: [half][row] sums of P and of P dP,
  // then [half][k-step][lane] dS's split A fragments (hi, lo)
  static constexpr int kQXSum = 0, kQXFrag = 64;
  static constexpr int kQXWords = kWide ? kQXFrag + 2 * (QK / 16) * 32 * 8 : 0;
  static constexpr size_t dq_smem() {
    return sizeof(bf16) * (2 * (size_t)QROWS * LD + 4 * (size_t)BNQ * LD) +
           sizeof(uint32_t) * QGROUPS * (size_t)kQXWords;
  }
  // the dK/dV launch: 8 warps; a group of 16 keys has two roles (S^T, P
  // and dV; dP^T, dS and dK), a warp each, or two each when kWide (each
  // pair splits the tile's rows for S^T or dP^T and the columns of dV or
  // dK); tiles of R rows
  static constexpr int KVWARPS = 8;
  static constexpr int KSPLIT = kWide ? 2 : 1;
  static constexpr int KGROUPS = KVWARPS / (2 * KSPLIT);
  static constexpr int BK = 16 * KGROUPS;  // keys of a block
  static constexpr int R = 64;
  static constexpr int RW = R / KSPLIT;    // rows of a warp's S^T or dP^T
  static constexpr int kQ = 2 * BK * LD;   // bf16: K, V, then
  static constexpr int kBufElems = 2 * R * LD;  // [2][q, dO]
  static constexpr int kBf16Elems = kQ + 2 * kBufElems;
  // floats: P / sum P times the softcap's factor, [group][row half]
  // [RW / 8][lane][4]; when kWide, P^T's and dS^T's split A fragments,
  // [group][role][row half][RW / 16][lane][8] words
  static constexpr int kXchg = KGROUPS * KSPLIT * (RW / 8) * 32 * 4;
  static constexpr int kXFrag = kWide ? KGROUPS * 2 * KSPLIT * (RW / 16) * 32 * 8 : 0;
  static constexpr size_t kv_smem() {
    // then [2][lse R], [2][rows R][2]
    return sizeof(bf16) * (size_t)kBf16Elems +
           sizeof(float) * ((size_t)kXchg + kXFrag + 2 * R + 4 * R);
  }
};

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// P of one score s (unscaled): exp(s scale - l) where unmasked, 0 where
// masked or out of range, 1 / T over the in-range keys of a row with no
// key (its lse l is the mask fill); with kCap the scaled score passes
// through the softcap first and dc is its factor 1 - tanh^2.  The exp is
// 2^(x log2(e) - l2) on MUFU.EX2, l2 = l log2(e).  kMask false: a tile of
// rows and keys that are all in range and unmasked (mask_free), where
// none of that is looked at.
template <bool kCap, bool kMask>
__device__ __forceinline__ float prob(float s, const Args& a, float l,
                                      float l2, bool in, bool ok,
                                      float uniform, float& dc) {
  float y;
  dc = 1.0f;
  if constexpr (kCap) {
    const float th = tanhf(s * a.scale / a.softcap);
    y = a.softcap * kLog2e * th - l2;
    dc = 1.0f - th * th;
  } else {
    y = fmaf(s, a.scale * kLog2e, -l2);
  }
  const float ex = tryage::exp2_approx(y);
  if constexpr (!kMask) return ex;
  return l <= kNegInf ? (in ? uniform : 0.0f) : (ok ? ex : 0.0f);
}

struct Mask {
  int S, T, causal, window;
  // whether rows [r0, r1] and keys [k0, k1] are all in range and every
  // pair unmasked (then no row of them is one that sees no key)
  __device__ __forceinline__ bool mask_free(int r0, int r1, int k0,
                                            int k1) const {
    return r1 < S && k1 < T && (!causal || k1 <= r0) &&
           (window <= 0 || k0 > r1 - window);
  }
  __device__ __forceinline__ bool in(int row, int key) const {
    return (row < S) & (key < T);
  }
  __device__ __forceinline__ bool ok(int row, int key) const {
    return in(row, key) & (!causal | (key <= row)) &
           ((window <= 0) | (key > row - window));
  }
};

// The first launch's elementwise work on S and dP of the warp's 16 rows
// (r0 + g + 8 (e >> 1)) and NJ n-tiles of keys (k0 + 8 j + 2 t + (e & 1)):
// pass 0 adds each row's P and P dP to ps and pd; pass 1 puts dS = P /
// sum P (dP - D) (times the softcap's factor; 0 on a row with no key) in
// place of s.  l, inv, dd: the lane's two rows' lse, 1 / sum P and D.
template <bool kCap, bool kMask, bool kPass1, int NJ>
__device__ __forceinline__ void dq_elems(float (&s)[NJ][4],
                                         const float (&dp)[NJ][4],
                                         const Args& a, const Mask& mk,
                                         int r0, int k0, const float (&l)[2],
                                         const float (&inv)[2],
                                         const float (&dd)[2],
                                         float (&ps)[2], float (&pd)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float uniform = 1.0f / (float)a.T;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      const int row = r0 + g + 8 * r, key = k0 + 8 * j + 2 * t + (e & 1);
      float dc;
      const float p = prob<kCap, kMask>(s[j][e], a, l[r], l[r] * kLog2e,
                                        mk.in(row, key), mk.ok(row, key),
                                        uniform, dc);
      if constexpr (kPass1) {
        const float ds = p * inv[r] * (dp[j][e] - dd[r]) * dc;
        s[j][e] = kMask && l[r] <= kNegInf ? 0.0f : ds;
      } else {
        ps[r] += p;
        pd[r] = fmaf(p, dp[j][e], pd[r]);
      }
    }
}

template <bool kCap, bool kPass1, int NJ>
__device__ __forceinline__ void dq_step(bool mask, float (&s)[NJ][4],
                                        const float (&dp)[NJ][4],
                                        const Args& a, const Mask& mk, int r0,
                                        int k0, const float (&l)[2],
                                        const float (&inv)[2],
                                        const float (&dd)[2], float (&ps)[2],
                                        float (&pd)[2]) {
  if (mask)
    dq_elems<kCap, true, kPass1>(s, dp, a, mk, r0, k0, l, inv, dd, ps, pd);
  else
    dq_elems<kCap, false, kPass1>(s, dp, a, mk, r0, k0, l, inv, dd, ps, pd);
}

// acc (16 rows x NJ n-tiles of keys) += A B over KP k-steps: A the
// warp's 16 rows of a row-major tile `at`, B the key block's rows of `bt`
// (n-major): S = q k^T and dP = dO V^T.
template <int KP, int NJ, int LD>
__device__ __forceinline__ void rows_product(float (&c)[NJ][4],
                                             const bf16* at, const bf16* bt) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.0f;
#pragma unroll
  for (int kk = 0; kk < KP; ++kk) {
    uint32_t fa[4];
    tryage::load_a(fa, at, LD, 0, 16 * kk);
#pragma unroll
    for (int j = 0; j < NJ / 2; ++j) {
      uint32_t fb[2][2];
      tryage::load_b(fb, bt, LD, 16 * j, 16 * kk);
      tryage::mma_bf16(c[2 * j], fa, fb[0]);
      tryage::mma_bf16(c[2 * j + 1], fa, fb[1]);
    }
  }
}

// out[n] += (hi + lo) B for the NO n-tiles of the dims from n0, B from
// the rows [0, 16 NK) of the k-major tile `bt` (ldmatrix.trans); each
// n-tile pair's NK k-steps in a fresh accumulator, added after (rounded).
template <int NO, int NK, int LD>
__device__ __forceinline__ void split_product(float (&out)[NO][4],
                                              const uint32_t (&hi)[NK][4],
                                              const uint32_t (&lo)[NK][4],
                                              const bf16* bt, int n0) {
#pragma unroll
  for (int n = 0; n < NO; n += 2) {
    float f[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t fb[2][2];
      tryage::load_bt(fb, bt, LD, 16 * kk, 8 * (n0 + n));
      tryage::mma_split(f[0], hi[kk], lo[kk], fb[0]);
      tryage::mma_split(f[1], hi[kk], lo[kk], fb[1]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      out[n][e] += f[0][e];
      out[n + 1][e] += f[1][e];
    }
  }
}

}  // namespace

// The first launch: a block per (query tile, b * H + h), see the header.
// Tin is __nv_bfloat16 (a template argument so that the instance's name
// carries its type).
template <typename Tin, int KP>
__global__ void __launch_bounds__(Bf16Bwd<KP>::QWARPS * 32, 1)
flash_attention_bwd_dq_bf16(Args a, int hd) {
  static_assert(std::is_same<Tin, bf16>::value, "the bf16 instances");
  using G = Bf16Bwd<KP>;
  constexpr bool kWide = G::kWide;
  constexpr int LD = G::LD, NO = G::NO, BNQ = G::BNQ, QK = G::QK;
  constexpr int NJ = QK / 8, NH = QK / 16;
  constexpr int THREADS = G::QWARPS * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [QROWS][LD]
  bf16* dos = qs + G::QROWS * LD;                // [QROWS][LD]
  bf16* kvs = dos + G::QROWS * LD;               // [2][K, V][BNQ][LD]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = kWide ? warp >> 1 : warp, half = kWide ? warp & 1 : 0;
  uint32_t* xw = reinterpret_cast<uint32_t*>(kvs + 4 * BNQ * LD) +
                 grp * G::kQXWords;  // the pair's exchange
  uint4* xf = reinterpret_cast<uint4*>(xw + G::kQXFrag);
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * G::QROWS;
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh - b * a.H, kvh = h / (a.H / a.KV);
  const int r0 = q_lo + 16 * grp;
  const int n0 = half * (G::NT - NO);  // the warp's first n-tile of dQ
  const size_t q_stride = (size_t)a.H * hd, kv_stride = (size_t)a.KV * hd;
  const size_t q_off = ((size_t)b * a.S * a.H + h) * hd;
  const size_t kv_off = ((size_t)b * a.T * a.KV + kvh) * hd;
  const bf16* kg = static_cast<const bf16*>(a.k) + kv_off;
  const bf16* vg = static_cast<const bf16*>(a.v) + kv_off;
  const Mask mk = {a.S, a.T, a.causal, a.window};

  int key_lo, key_hi;
  tryage::key_range(q_lo, min(a.S, q_lo + G::QROWS) - 1, a.T, a.causal,
                    a.window, key_lo, key_hi);
  const int kb_lo = key_lo / BNQ, n = (key_hi + BNQ - 1) / BNQ - kb_lo;

  auto stage = [&](int kb, int buf) {
    bf16* ks = kvs + buf * 2 * BNQ * LD;
    tryage::stage_bf16<G::HDP>(ks, LD, kg, kv_stride, kb * BNQ, BNQ, a.T, hd,
                               THREADS);
    tryage::stage_bf16<G::HDP>(ks + BNQ * LD, LD, vg, kv_stride, kb * BNQ,
                               BNQ, a.T, hd, THREADS);
    tryage::cp_async_commit();
  };
  tryage::stage_bf16<G::HDP>(qs, LD, static_cast<const bf16*>(a.q) + q_off,
                             q_stride, q_lo, G::QROWS, a.S, hd, THREADS);
  tryage::stage_bf16<G::HDP>(dos, LD, static_cast<const bf16*>(a.d_o) + q_off,
                             q_stride, q_lo, G::QROWS, a.S, hd, THREADS);
  stage(kb_lo, 0);  // one group with q and dO

  float l[2], ps[2] = {0.0f, 0.0f}, pd[2] = {0.0f, 0.0f};
  float inv[2] = {1.0f, 1.0f}, dd[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    l[r] = row < a.S ? a.lse[(size_t)bh * a.S + row] : 0.0f;
  }
  float dq[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.0f;
  const bf16* qw = qs + 16 * grp * LD;
  const bf16* dow = dos + 16 * grp * LD;
  const bool cap = a.softcap > 0.0f;

  for (int i = 0; i < 2 * n; ++i) {
    const bool pass1 = i >= n;
    const int kb = kb_lo + (pass1 ? i - n : i), buf = i & 1;
    if (i + 1 < 2 * n) {
      stage(kb_lo + (i + 1) % n, buf ^ 1);
      tryage::cp_async_wait<1>();
    } else {
      tryage::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = kvs + buf * 2 * BNQ * LD;
    const bf16* vs = ks + BNQ * LD;
    if (i == n) {  // the row sums are complete
      float s_p[2], s_pd[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        s_p[r] = quad_sum(ps[r]);
        s_pd[r] = quad_sum(pd[r]);
      }
      if constexpr (kWide) {  // the pair's halves, half 0's first in both
        if (t == 0) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            xw[G::kQXSum + 16 * half + g + 8 * r] = __float_as_uint(s_p[r]);
            xw[G::kQXSum + 32 + 16 * half + g + 8 * r] =
                __float_as_uint(s_pd[r]);
          }
        }
        bar_sync(1 + grp, 64);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          s_p[r] = __uint_as_float(xw[G::kQXSum + g + 8 * r]) +
                   __uint_as_float(xw[G::kQXSum + 16 + g + 8 * r]);
          s_pd[r] = __uint_as_float(xw[G::kQXSum + 32 + g + 8 * r]) +
                    __uint_as_float(xw[G::kQXSum + 48 + g + 8 * r]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        inv[r] = (l[r] <= kNegInf || !(s_p[r] > 0.0f)) ? 1.0f : 1.0f / s_p[r];
        dd[r] = s_p[r] > 0.0f ? s_pd[r] / s_p[r] : 0.0f;
        const int row = r0 + g + 8 * r;
        if (t == 0 && half == 0 && row < a.S) {
          a.rows[2 * ((size_t)bh * a.S + row)] = inv[r];
          a.rows[2 * ((size_t)bh * a.S + row) + 1] = dd[r];
        }
      }
    }
    // S and dP of the row group's 16 rows and the warp's QK keys
    const int k0 = kb * BNQ + half * QK;
    float s[NJ][4], dp[NJ][4];
    rows_product<KP, NJ, LD>(s, qw, ks + half * QK * LD);
    rows_product<KP, NJ, LD>(dp, dow, vs + half * QK * LD);
    // a uniform branch of the warp, outside the unrolled loops
    const bool mask = !mk.mask_free(r0, r0 + 15, k0, k0 + QK - 1);
    if (!pass1) {
      if (cap)
        dq_step<true, false>(mask, s, dp, a, mk, r0, k0, l, inv, dd, ps, pd);
      else
        dq_step<false, false>(mask, s, dp, a, mk, r0, k0, l, inv, dd, ps,
                              pd);
    } else {
      if (cap)
        dq_step<true, true>(mask, s, dp, a, mk, r0, k0, l, inv, dd, ps, pd);
      else
        dq_step<false, true>(mask, s, dp, a, mk, r0, k0, l, inv, dd, ps, pd);
      // dQ += dS K: dS's pieces as A fragments (k = keys; a pair's two
      // halves through its exchange), K by ldmatrix.trans
      uint32_t hi[NH][4], lo[NH][4];
#pragma unroll
      for (int kk = 0; kk < NH; ++kk)
        tryage::split_a(hi[kk], lo[kk], s[2 * kk], s[2 * kk + 1]);
      if constexpr (!kWide) {
        split_product<NO, NH, LD>(dq, hi, lo, ks, 0);
      } else {
        tryage::put_frags(xf, half, hi, lo);
        bar_sync(1 + grp, 64);
        uint32_t fh[2 * NH][4], fl[2 * NH][4];
        tryage::get_frags(xf, fh, fl);
        split_product<NO, 2 * NH, LD>(dq, fh, fl, ks, n0);
      }
    }
    __syncthreads();  // this buffer is reloaded two blocks on
  }

  bf16* out = static_cast<bf16*>(a.dq) + q_off;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= a.S) continue;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int c = n0 + i;
      if (tryage::own_tile<kWide, KP>(half, c) && 8 * c < hd)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * q_stride +
                                           8 * c + 2 * t) =
            __floats2bfloat162_rn(dq[i][2 * r] * a.scale,
                                  dq[i][2 * r + 1] * a.scale);
    }
  }
}

namespace {

// The second launch's elementwise work for warp 0-3 of a pair (S^T of its
// 16 keys k0 + g + 8 (e >> 1) and the tile's rows q0 + 8 j + 2 t + (e &
// 1)): P / sum P in place of c, and that times the softcap's factor (0 on
// a row with no key) to the pair's exchange.
template <bool kCap, bool kMask, int NJ>
__device__ __forceinline__ void kv_probs(float (&c)[NJ][4], const Args& a,
                                         const Mask& mk, int q0, int k0,
                                         const float* lse_s,
                                         const float* row_s, float4* xchg) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const float uniform = 1.0f / (float)a.T;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    // rows 8j + 2t and 8j + 2t + 1: their lse, (1 / sum P, D) each
    const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * t);
    const float4 rc = *reinterpret_cast<const float4*>(row_s + 16 * j + 4 * t);
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool r1 = e & 1;
      const int row = q0 + 8 * j + 2 * t + (e & 1), key = k0 + g + 8 * (e >> 1);
      const float lr = r1 ? l.y : l.x;
      float dc;
      const float p = prob<kCap, kMask>(c[j][e], a, lr, lr * kLog2e,
                                        mk.in(row, key), mk.ok(row, key),
                                        uniform, dc);
      const float pb = p * (r1 ? rc.z : rc.x);
      c[j][e] = pb;
      x[e] = kMask && lr <= kNegInf ? 0.0f : pb * dc;
    }
    xchg[j * 32 + lane] = make_float4(x[0], x[1], x[2], x[3]);
  }
}

}  // namespace

// The second launch: a block per (key block, b * KV + kv head), see the
// header.  Tin as above.
template <typename Tin, int KP>
__global__ void __launch_bounds__(Bf16Bwd<KP>::KVWARPS * 32, 1)
flash_attention_bwd_kv_bf16(Args a, int hd) {
  static_assert(std::is_same<Tin, bf16>::value, "the bf16 instances");
  using G = Bf16Bwd<KP>;
  constexpr bool kWide = G::kWide;
  constexpr int LD = G::LD, NO = G::NO, R = G::R, RW = G::RW, BK = G::BK;
  constexpr int NJ = RW / 8, NH = RW / 16, KSPLIT = G::KSPLIT;
  constexpr int THREADS = G::KVWARPS * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BK][LD]
  bf16* vs = ks + BK * LD;                       // [BK][LD]
  bf16* bufs = ks + G::kQ;                       // [2][q, dO][R][LD]
  float* fl = reinterpret_cast<float*>(ks + G::kBf16Elems);
  float4* xchg_all = reinterpret_cast<float4*>(fl);  // see Bf16Bwd
  uint4* xfrag_all = reinterpret_cast<uint4*>(fl + G::kXchg);
  float* lse_all = fl + G::kXchg + G::kXFrag;        // [2][R]
  float* rows_all = lse_all + 2 * R;                 // [2][R][2]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // the warp's group of 16 keys, role (0: S^T, P and dV; 1: dP^T, dS and
  // dK) and, when kWide, its half of the rows and columns
  const int grp = warp % G::KGROUPS, rest = warp / G::KGROUPS;
  const bool second = rest >= KSPLIT;
  const int half = rest % KSPLIT;
  const int k0 = blockIdx.x * BK;
  const int b = blockIdx.y / a.KV, kvh = blockIdx.y - b * a.KV;
  const int group = a.H / a.KV, n_qt = (a.S + R - 1) / R;
  const int items = group * n_qt;
  const int n0 = half * (G::NT - NO);  // the warp's first n-tile of dV or dK
  const size_t q_stride = (size_t)a.H * hd, kv_stride = (size_t)a.KV * hd;
  const size_t kv_off = ((size_t)b * a.T * a.KV + kvh) * hd;
  const Mask mk = {a.S, a.T, a.causal, a.window};
  const int k1 = min(a.T, k0 + BK) - 1;  // the block's last key

  // whether query tile qt has a pair with the block's keys, or a row that
  // sees no key (the forward's rule, by key_range)
  auto live = [&](int qt) {
    int lo, hi;
    tryage::key_range(qt * R, min(a.S, qt * R + R) - 1, a.T, a.causal,
                      a.window, lo, hi);
    return lo <= k1 && k0 < hi;
  };
  auto next = [&](int it) {
    do {
      ++it;
    } while (it < items && !live(it % n_qt));
    return it;
  };
  auto stage = [&](int it, int buf) {
    const int h = kvh * group + it / n_qt, q0 = (it % n_qt) * R;
    const size_t q_off = ((size_t)b * a.S * a.H + h) * hd;
    bf16* qb = bufs + buf * G::kBufElems;
    tryage::stage_bf16<G::HDP>(qb, LD, static_cast<const bf16*>(a.q) + q_off,
                               q_stride, q0, R, a.S, hd, THREADS);
    tryage::stage_bf16<G::HDP>(qb + R * LD, LD,
                               static_cast<const bf16*>(a.d_o) + q_off,
                               q_stride, q0, R, a.S, hd, THREADS);
    const size_t rb = (size_t)(b * a.H + h) * a.S;
    for (int i = threadIdx.x; i < R; i += THREADS) {
      const bool in = q0 + i < a.S;
      const size_t r = rb + (in ? q0 + i : 0);
      tryage::cp_async4(lse_all + buf * R + i, a.lse + r, in);
      tryage::cp_async8(rows_all + buf * 2 * R + 2 * i, a.rows + 2 * r, in);
    }
  };

  tryage::stage_bf16<G::HDP>(ks, LD, static_cast<const bf16*>(a.k) + kv_off,
                             kv_stride, k0, BK, a.T, hd, THREADS);
  tryage::stage_bf16<G::HDP>(vs, LD, static_cast<const bf16*>(a.v) + kv_off,
                             kv_stride, k0, BK, a.T, hd, THREADS);
  int it = next(-1);
  if (it < items) stage(it, 0);
  tryage::cp_async_commit();

  float acc[NO][4];  // dV (the first role) or dK (the second)
#pragma unroll
  for (int i = 0; i < NO; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  // P / sum P times the softcap's factor, from the first role's warp of
  // these rows to the second's; the roles' split fragments (kWide)
  float4* xchg = xchg_all + (grp * KSPLIT + half) * NJ * 32;
  uint4* xfrag = xfrag_all + (grp * 2 + second) * KSPLIT * NH * 32 * 2;
  const int kg0 = k0 + 16 * grp;  // the group's first key
  const bool cap = a.softcap > 0.0f;

  for (int buf = 0; it < items; buf ^= 1) {
    const int nx = next(it);
    tryage::cp_async_wait<0>();
    __syncthreads();  // this tile is in; the last one is done with
    if (nx < items) stage(nx, buf ^ 1);
    tryage::cp_async_commit();
    const int q0 = (it % n_qt) * R + half * RW;  // the warp's first row
    const bf16* qs = bufs + buf * G::kBufElems;
    const bf16* dos = qs + R * LD;
    const float* lse_s = lse_all + buf * R + half * RW;
    const float* row_s = rows_all + buf * 2 * R + 2 * half * RW;

    float c[NJ][4];
    // S^T = K q^T or dP^T = V dO^T for the group's 16 keys and the warp's
    // RW rows
    rows_product<KP, NJ, LD>(c, (second ? vs : ks) + 16 * grp * LD,
                             (second ? dos : qs) + half * RW * LD);
    uint32_t hi[NH][4], lo[NH][4];
    if (!second) {
      const bool mask = !mk.mask_free(q0, q0 + RW - 1, kg0, kg0 + 15);
      if (cap) {
        if (mask)
          kv_probs<true, true>(c, a, mk, q0, kg0, lse_s, row_s, xchg);
        else
          kv_probs<true, false>(c, a, mk, q0, kg0, lse_s, row_s, xchg);
      } else {
        if (mask)
          kv_probs<false, true>(c, a, mk, q0, kg0, lse_s, row_s, xchg);
        else
          kv_probs<false, false>(c, a, mk, q0, kg0, lse_s, row_s, xchg);
      }
#pragma unroll
      for (int kk = 0; kk < NH; ++kk)
        tryage::split_a(hi[kk], lo[kk], c[2 * kk], c[2 * kk + 1]);
      if constexpr (kWide) {
        tryage::put_frags(xfrag, half, hi, lo);
        bar_sync(1 + grp, 128);
      } else {
        bar_arrive(1 + grp, 64);
      }
    } else {
      bar_sync(1 + grp, kWide ? 128 : 64);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 x = xchg[j * 32 + lane];
        const float4 rc =
            *reinterpret_cast<const float4*>(row_s + 16 * j + 4 * t);
        c[j][0] = x.x * (c[j][0] - rc.y);
        c[j][1] = x.y * (c[j][1] - rc.w);
        c[j][2] = x.z * (c[j][2] - rc.y);
        c[j][3] = x.w * (c[j][3] - rc.w);
      }
#pragma unroll
      for (int kk = 0; kk < NH; ++kk)
        tryage::split_a(hi[kk], lo[kk], c[2 * kk], c[2 * kk + 1]);
      if constexpr (kWide) {
        tryage::put_frags(xfrag, half, hi, lo);
        bar_sync(1 + G::KGROUPS + grp, 64);
      }
    }
    // dV += P^T dO or dK += dS^T q over the tile's R rows: the pieces of
    // P^T or dS^T as A fragments (k = rows; when kWide both warps' halves
    // from the exchange), dO or q by ldmatrix.trans
    const bf16* bt = second ? qs : dos;
    if constexpr (!kWide) {
      split_product<NO, NH, LD>(acc, hi, lo, bt, 0);
    } else {
      uint32_t fh[2 * NH][4], fo[2 * NH][4];
      tryage::get_frags(xfrag, fh, fo);
      split_product<NO, 2 * NH, LD>(acc, fh, fo, bt, n0);
    }
    it = nx;
  }

  // dV or dK (times the scale) of the group's keys kg0 + g and + 8
  const float f = second ? a.scale : 1.0f;
  bf16* out = static_cast<bf16*>(second ? a.dk : a.dv) + kv_off;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kg0 + g + 8 * r;
    if (key >= a.T) continue;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int c = n0 + i;
      if (tryage::own_tile<kWide, KP>(half, c) && 8 * c < hd)
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)key * kv_stride +
                                           8 * c + 2 * t) =
            __floats2bfloat162_rn(acc[i][2 * r] * f, acc[i][2 * r + 1] * f);
    }
  }
}

namespace {

template <int KP>
int launch_bwd_bf16(const Args& a, int hd, cudaStream_t stream) {
  using G = Bf16Bwd<KP>;
  static_assert(G::dq_smem() <= 232448 && G::kv_smem() <= 232448,
                "shared memory past the H100's 227 KB a block");
  static unsigned long long ready_dq = 0, ready_kv = 0;
  if (a.rows == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem_once(flash_attention_bwd_dq_bf16<bf16, KP>,
                                    G::dq_smem(), ready_dq);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem_once(flash_attention_bwd_kv_bf16<bf16, KP>, G::kv_smem(),
                        ready_kv);
  if (err != cudaSuccess) return (int)err;
  // the row sums and dQ first; the second launch reads the row sums
  flash_attention_bwd_dq_bf16<bf16, KP>
      <<<dim3((a.S + G::QROWS - 1) / G::QROWS, a.B * a.H), G::QWARPS * 32,
         G::dq_smem(), stream>>>(a, hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  flash_attention_bwd_kv_bf16<bf16, KP>
      <<<dim3((a.T + G::BK - 1) / G::BK, a.B * a.KV), G::KVWARPS * 32,
         G::kv_smem(), stream>>>(a, hd);
  return (int)cudaGetLastError();
}

// Launch the instance for kp = ceil(hd / 16) among KP in [KP, Hi].
template <int KP, int Hi>
int dispatch_bwd_bf16(int kp, const Args& a, int hd, cudaStream_t stream) {
  if constexpr (KP > Hi) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (kp == KP) return launch_bwd_bf16<KP>(a, hd, stream);
    return dispatch_bwd_bf16<KP + 1, Hi>(kp, a, hd, stream);
  }
}

}  // namespace
