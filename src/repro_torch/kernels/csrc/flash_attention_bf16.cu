// The bf16 instances of the attention kernel: the function of
// flash_attention.cu (whose notes give the masks, the layouts and the C
// entry point), redesigned for Hopper's bf16 tensor cores at the zoo's
// prefill shapes (S 512-4608, hd 64-256), where the operations bound it.
// In a translation unit of its own, built beside the f32 instances.
//
// Numerics (mma_bf16.cuh): S = q k^T takes one bf16 mma.sync.m16n8k16
// pass on the unscaled inputs (the products of two bf16 values are exact
// in the f32 accumulator), and the scale (times log2(e): the softmax runs
// in the log2 domain on MUFU.EX2) is applied to S in f32.  P is an f32
// softmax, so P V takes two passes, P's bf16 pieces hi and lo against the
// exact V: within one bf16 ulp of the plain version after o is rounded
// (tests/test_torch_tf32.py; one piece fails that gate).
// Design:
// * A row group of 16 query rows is one warp's up to hd 128.  Above, a
//   warp's O accumulator for a whole row (4 registers a lane for 8
//   columns: 128 at hd 256) spilled, so a pair of warps holds the group:
//   the pair splits the tile's keys for S = q k^T (each warp all hd
//   columns of q and K, half the keys) and O's columns for P V (each
//   warp half the columns, all the keys), so S is still computed once per
//   (row, key).  The pair meets twice a tile in shared memory (a named
//   barrier of its 64 threads): its halves' row maxima, then their P as
//   split A fragments and their row sums; both warps then hold the same
//   running m and l (each taken in the same order in both).  Up to hd
//   128 the pair's exchange and barriers cost more than they save.
// * A block holds 1, 2 or 4 row groups (the wrapper's `warps`: its
//   choice, or by default the most that still gives every SM a block),
//   and the grid is (query tiles, B * H), the last query tile first:
//   under the causal mask it sees the most keys.
// * q of the block, K and V arrive in shared memory in bf16 by cp.async,
//   never widened: q once, K and V in tiles of 64 keys, double-buffered.
//   A row holds hd rounded up to 16 (the k-step; the columns past hd are
//   zeros, so any hd that is a multiple of 8 runs on the same k16
//   instructions) and 8 elements of padding, so that ldmatrix's eight
//   16-byte rows of a matrix fall on 32 different banks.  One instance
//   per hd / 16 rounded up, hd itself an argument.
// * Fragments come from shared memory by ldmatrix: q as the A operand
//   and K as B of q k^T, V through ldmatrix.trans as B of P V.  q's
//   fragments are loaded once and held in registers across the key
//   tiles (up to 64 registers a lane at hd 256, beside O's half).
// * The online softmax runs in registers on S's accumulators (rows g and
//   g + 8 of a lane, shuffles across the 4 lanes of a row).  P leaves
//   them as A fragments with no shuffle: m16n8k16's accumulator layout
//   is its A layout (mma_bf16.cuh).  P V runs k-steps outside and output
//   n-tiles inside, so that the n-tiles' mma.sync chains interleave, and
//   O's accumulator runs one chain over the keys: the tensor cores' f32
//   accumulate truncates, but each element's drift stays a small share
//   of its own bf16 ulp, the gate (held at starcoder2's 4,608 keys),
//   unlike the backward's sums, gated against their largest value.
// * Tiles that every row of the block masks are skipped, by the rule of
//   the f32 instances (where a row of the block sees no key at all,
//   nothing is skipped: ops.walked_tiles); the masks are applied only
//   where a warp's rows and keys hold a masked or out-of-range pair.
#include "flash_attention.cuh"
#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;
using tryage::kLog2e;

// The geometry of one instance: HDP = 16 KP, hd rounded up to a k-step.
template <int KP>
struct Bf16Fwd {
  static constexpr int HDP = 16 * KP;
  static constexpr bool kPair = HDP > 128;    // a pair of warps a row group
  static constexpr int NT = HDP / 8;          // output n-tiles
  // n-tiles a warp computes: all, or (a pair) its half rounded up to even
  static constexpr int NO = kPair ? 2 * ((KP + 1) / 2) : NT;
  static constexpr int BN = 64;               // keys a tile
  static constexpr int kThreads = (kPair ? 64 : 32) * kMaxWarps;
  static constexpr int WK = kPair ? BN / 2 : BN;  // keys of a warp's S
  static constexpr int LD = HDP + 8;          // padded row, elements
  static constexpr int ROWS = 16 * kMaxWarps;  // q rows a block at most
  static constexpr int kTile = BN * LD;       // elements of a K or V tile
  // a pair's exchange, in 32-bit words: [half][row] maxima and sums, then
  // [half][k-step of the half][lane] P's split A fragments (hi, lo)
  static constexpr int kXMax = 0, kXSum = 32, kXFrag = 64;
  static constexpr int kXWords = kPair ? kXFrag + 2 * (WK / 16) * 32 * 8 : 0;
  static constexpr size_t smem_bytes() {
    return sizeof(bf16) * ((size_t)ROWS * LD + 4 * (size_t)kTile) +
           sizeof(uint32_t) * kMaxWarps * (size_t)kXWords;
  }
};

// Softcap and masks on the scores s of a warp's keys (rows r0 + g and
// r0 + g + 8, keys k0 + 8 j + 2 t + (e & 1)), in place, in the log2
// domain (times scale log2(e)), and the maximum of each of the lane's two
// rows over them.  The softcap and the masks are template arguments
// (kMask false: keys that every row sees), so that no branch sits in the
// unrolled loop.
template <bool kCap, bool kMask, int NJ>
__device__ __forceinline__ void scores(float (&s)[NJ][4], float (&mx)[2],
                                       int r0, int k0, int T, int causal,
                                       int window, float softcap,
                                       float scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool windowed = window > 0;
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x;
      if constexpr (kCap)
        x = softcap * kLog2e * tanhf(s[j][e] * scale / softcap);
      else
        x = s[j][e] * (scale * kLog2e);
      if constexpr (kMask) {
        const int row = r0 + g + 8 * (e >> 1);
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        const bool ok = (!causal | (key <= row)) &
                        (!windowed | (key > row - window));
        x = key < T ? (ok ? x : kNegInf) : -INFINITY;
      }
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
}

template <bool kCap, int NJ>
__device__ __forceinline__ void scores(bool mask, float (&s)[NJ][4],
                                       float (&mx)[2], int r0, int k0, int T,
                                       int causal, int window, float softcap,
                                       float scale) {
  if (mask)
    scores<kCap, true>(s, mx, r0, k0, T, causal, window, softcap, scale);
  else
    scores<kCap, false>(s, mx, r0, k0, T, causal, window, softcap, scale);
}

// P = 2^(s - m) in place, and each row's sum over the warp's keys.
template <int NJ>
__device__ __forceinline__ void probs(float (&s)[NJ][4], const float (&m)[2],
                                      float (&psum)[2]) {
  psum[0] = psum[1] = 0.0f;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = tryage::exp2_approx(s[j][e] - m[e >> 1]);
      s[j][e] = p;
      psum[e >> 1] += p;
    }
}

// O += P V for NO n-tiles of columns from n0: NK k-steps of P's split A
// fragments, V by ldmatrix.trans, k-steps outside so that the n-tiles'
// mma.sync chains interleave.
template <int NO, int NK, int LD>
__device__ __forceinline__ void pv(float (&acc)[NO][4],
                                   const uint32_t (&ph)[NK][4],
                                   const uint32_t (&pl)[NK][4],
                                   const bf16* vs, int n0) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int n = 0; n < NO; n += 2) {
      uint32_t bb[2][2];
      tryage::load_bt(bb, vs, LD, 16 * kk, 8 * (n0 + n));
      tryage::mma_split(acc[n], ph[kk], pl[kk], bb[0]);
      tryage::mma_split(acc[n + 1], ph[kk], pl[kk], bb[1]);
    }
}

}  // namespace

template <int KP>
__global__ void __launch_bounds__(Bf16Fwd<KP>::kThreads, 1)
flash_attention_kernel_bf16(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ o,
                            float* __restrict__ lse, int S, int T, int H,
                            int KV, int hd, int causal, int window,
                            float softcap, float scale) {
  using G = Bf16Fwd<KP>;
  constexpr bool kPair = G::kPair;
  constexpr int NO = G::NO, BN = G::BN, WK = G::WK, LD = G::LD;
  constexpr int NJ = WK / 8;   // n-tiles of the warp's S
  constexpr int NK = WK / 16;  // k-steps of P V in the warp's keys
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [ROWS][LD]
  bf16* kvs = qs + G::ROWS * LD;                 // [2][K, V][BN][LD]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // the warp's row group (16 rows) and, in a pair, its half
  const int grp = kPair ? warp >> 1 : warp, half = kPair ? warp & 1 : 0;
  uint32_t* xw = reinterpret_cast<uint32_t*>(kvs + 4 * G::kTile) +
                 grp * G::kXWords;  // the pair's exchange
  uint4* xf = reinterpret_cast<uint4*>(xw + G::kXFrag);  // [half][kk][lane][2]
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int rows = blockDim.x / (kPair ? 4 : 2);  // 16 a row group
  const int row_lo = (gridDim.x - 1 - blockIdx.x) * rows;
  const int r0 = row_lo + grp * 16;
  const int n0 = half * (G::NT - NO);  // the warp's first output n-tile
  const size_t q_stride = (size_t)H * hd, kv_stride = (size_t)KV * hd;
  const bf16* qb = q + ((size_t)b * S * H + h) * hd;
  const bf16* kb = k + ((size_t)b * T * KV + kvh) * hd;
  const bf16* vb = v + ((size_t)b * T * KV + kvh) * hd;
  bf16* ob = o + ((size_t)b * S * H + h) * hd;

  // keys [key_lo, key_hi) that some row of this block may see
  int key_lo, key_hi;
  tryage::key_range(row_lo, min(S, row_lo + rows) - 1, T, causal, window,
                    key_lo, key_hi);
  const int tile_lo = key_lo / BN, tile_hi = (key_hi + BN - 1) / BN;

  auto stage = [&](int tile, int buf) {
    bf16* ks = kvs + buf * 2 * G::kTile;
    tryage::stage_bf16<G::HDP>(ks, LD, kb, kv_stride, tile * BN, BN, T, hd,
                               blockDim.x);
    tryage::stage_bf16<G::HDP>(ks + G::kTile, LD, vb, kv_stride, tile * BN,
                               BN, T, hd, blockDim.x);
    tryage::cp_async_commit();
  };
  tryage::stage_bf16<G::HDP>(qs, LD, qb, q_stride, row_lo, rows, S, hd,
                             blockDim.x);
  stage(tile_lo, 0);  // one group with q

  const bf16* qw = qs + grp * 16 * LD;
  uint32_t qf[KP][4];  // q's A fragments, the same at every key tile
  // the running maximum in the log2 domain and sum of P of rows g, g + 8
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.0f, 0.0f};
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int it = tile_lo; it < tile_hi; ++it) {
    const int buf = (it - tile_lo) & 1;
    if (it + 1 < tile_hi) {
      stage(it + 1, buf ^ 1);
      tryage::cp_async_wait<1>();
    } else {
      tryage::cp_async_wait<0>();
    }
    __syncthreads();
    if (it == tile_lo) {  // q is in
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) tryage::load_a(qf[kk], qw, LD, 0, 16 * kk);
    }
    const bf16* ks = kvs + buf * 2 * G::kTile;
    const bf16* vs = ks + G::kTile;
    const int k0 = it * BN + half * WK;  // the warp's keys of the tile

    // S = q k^T for the row group's 16 rows and the warp's WK keys
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < KP; ++kk)
#pragma unroll
      for (int j = 0; j < NJ / 2; ++j) {
        uint32_t bb[2][2];
        tryage::load_b(bb, ks, LD, half * WK + 16 * j, 16 * kk);
        tryage::mma_bf16(s[2 * j], qf[kk], bb[0]);
        tryage::mma_bf16(s[2 * j + 1], qf[kk], bb[1]);
      }

    // softcap and masks (where a pair of the warp's may be masked or out
    // of range: a uniform branch of the warp), the rows' maxima
    const bool mask = k0 + WK > T || (causal && k0 + WK - 1 > r0) ||
                      (window > 0 && k0 <= r0 + 15 - window);
    float mx[2];
    if (softcap > 0.0f)
      scores<true>(mask, s, mx, r0, k0, T, causal, window, softcap, scale);
    else
      scores<false>(mask, s, mx, r0, k0, T, causal, window, softcap, scale);
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] = quad_max(mx[r]);
    if constexpr (kPair) {
      // the pair's two halves' maxima, half 0's first in both warps
      if (t == 0) {
        xw[G::kXMax + 16 * half + g] = __float_as_uint(mx[0]);
        xw[G::kXMax + 16 * half + g + 8] = __float_as_uint(mx[1]);
      }
      tryage::bar_sync(1 + grp, 64);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        mx[r] = fmaxf(__uint_as_float(xw[G::kXMax + g + 8 * r]),
                      __uint_as_float(xw[G::kXMax + 16 + g + 8 * r]));
    }
    float corr[2], psum[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m_i[r], mx[r]);
      corr[r] = tryage::exp2_approx(m_i[r] - m_new);
      m_i[r] = m_new;
    }
    probs(s, m_i, psum);
#pragma unroll
    for (int r = 0; r < 2; ++r) psum[r] = quad_sum(psum[r]);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];

    // O += P V: P's pieces as A fragments (no shuffle: the layout note of
    // mma_bf16.cuh), k-steps over the tile's keys
    if constexpr (!kPair) {
#pragma unroll
      for (int r = 0; r < 2; ++r) l_i[r] = corr[r] * l_i[r] + psum[r];
      uint32_t ph[NK][4], pl[NK][4];
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        tryage::split_a(ph[kk], pl[kk], s[2 * kk], s[2 * kk + 1]);
      pv<NO, NK, LD>(acc, ph, pl, vs, 0);
    } else {
      // the pair hands over its halves' P and sums; both warps add the
      // sums in the same order
      uint32_t hi[NK][4], lo[NK][4];
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        tryage::split_a(hi[kk], lo[kk], s[2 * kk], s[2 * kk + 1]);
      tryage::put_frags(xf, half, hi, lo);
      if (t == 0) {
        xw[G::kXSum + 16 * half + g] = __float_as_uint(psum[0]);
        xw[G::kXSum + 16 * half + g + 8] = __float_as_uint(psum[1]);
      }
      tryage::bar_sync(1 + grp, 64);
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l_i[r] = corr[r] * l_i[r] +
                 (__uint_as_float(xw[G::kXSum + g + 8 * r]) +
                  __uint_as_float(xw[G::kXSum + 16 + g + 8 * r]));
      uint32_t ph[2 * NK][4], pl[2 * NK][4];
      tryage::get_frags(xf, ph, pl);
      pv<NO, 2 * NK, LD>(acc, ph, pl, vs, n0);
    }
    __syncthreads();  // this buffer is reloaded two tiles on
  }

  // O / l and lse = (m + log2 l) ln 2 (the mask fill where the row saw no
  // key: m is the fill); a pair's warps store their own columns, n-tiles
  // [0, KP) and [KP, 2 KP) (with KP odd each computes one of the other's)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l_i[r], 1e-30f);
    if (lse != nullptr && t == 0 && half == 0)
      lse[(size_t)bh * S + row] =
          m_i[r] <= kNegInf ? kNegInf
                            : (m_i[r] + log2f(denom)) * (1.0f / kLog2e);
    bf16* orow = ob + (size_t)row * q_stride + 2 * t;
    const float inv = 1.0f / denom;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n0 + n;
      if (tryage::own_tile<kPair, KP>(half, c) && 8 * c < hd)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * c) =
            __floats2bfloat162_rn(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
  }
}

namespace {

template <int KP>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int S, int T, int H, int KV, int hd,
                int causal, int window, float softcap, float scale, int warps,
                cudaStream_t stream) {
  using G = Bf16Fwd<KP>;
  static_assert(G::smem_bytes() <= 232448,
                "shared memory past the H100's 227 KB a block");
  const size_t smem = G::smem_bytes();
  cudaError_t err =
      tryage::allow_smem(flash_attention_kernel_bf16<KP>, smem);
  if (err != cudaSuccess) return (int)err;
  if (warps == 0) {
    const long row_tiles = (long)B * H * ((S + 15) / 16);
    warps = kMaxWarps;
    while (warps > 1 && (row_tiles + warps - 1) / warps < kSMs) warps /= 2;
  }
  // `warps` row groups of 16 query rows, a warp or a pair of warps each
  dim3 grid((S + 16 * warps - 1) / (16 * warps), B * H);
  flash_attention_kernel_bf16<KP>
      <<<grid, (G::kPair ? 64 : 32) * warps, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, S, T, H, KV,
      hd, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <int KP>
int dispatch_bf16(int kp, const void* q, const void* k, const void* v,
                  void* o, float* lse, int B, int S, int T, int H, int KV,
                  int hd, int causal, int window, float softcap, float scale,
                  int warps, cudaStream_t stream) {
  if constexpr (KP > kMaxKD / 2) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (kp == KP)
      return launch_bf16<KP>(q, k, v, o, lse, B, S, T, H, KV, hd, causal,
                             window, softcap, scale, warps, stream);
    return dispatch_bf16<KP + 1>(kp, q, k, v, o, lse, B, S, T, H, KV, hd,
                                 causal, window, softcap, scale, warps,
                                 stream);
  }
}

}  // namespace

namespace tryage {

// kd = hd / 8: the instance of hd rounded up to 16.
int flash_attention_bf16(int kd, const void* q, const void* k, const void* v,
                         void* o, float* lse, int B, int S, int T, int H,
                         int KV, int causal, int window, float softcap,
                         float scale, int warps, cudaStream_t stream) {
  return dispatch_bf16<1>((kd + 1) / 2, q, k, v, o, lse, B, S, T, H, KV,
                          8 * kd, causal, window, softcap, scale, warps,
                          stream);
}

}  // namespace tryage
