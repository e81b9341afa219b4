// The gradient of the chunkwise mLSTM scan (mlstm_scan.cu) on Hopper, f32,
// in the model layout: from q, k, v (B, S, H, dh), i, f (B, S, H), the
// initial stabiliser m0 (B, H), the forward's h and its gradient dh
// (B, S, H, dh), and C, n and m at the start of each of the backward's
// chunks (Cst (B, H, S / L, dh, dh), nst (B, H, S / L, dh), mst (B, H,
// S / L): with one chunk the initial state, else what the forward writes
// when it is given them), it writes dq, dk, dv (B, S, H, dh) and di, df
// (B, S, H).  It replaces no Pallas kernel: _mlstm_kernel
// (src/repro/kernels/mlstm_scan/kernel.py, row 4 of PERF.md's table) has
// no backward, and the JAX package trains through XLA's autodiff of
// _mlstm_cell_chunkwise (src/repro/models/ssm.py:254).  This is that
// gradient, for a scan that starts from a state that needs no gradient
// and whose final state the loss does not read (training: the wrapper
// refuses anything else).
//
// Algorithm.  h does not depend on the stabiliser in exact arithmetic
// (num and den both carry e^{-m_t}, and either branch of max(|den|,
// e^{-m_t}) cancels it), so the stabiliser is held constant, i and f get
// their gradient through the log-weights alone, and the backward's chunk
// L need not be the forward's: the wrapper takes L = S (one chunk) where
// that takes fewer operations, else the forward's chunk
// (ops.backward_chunk).  Per row, in f64: F the cumulative log-sigmoid of
// f over the whole sequence, g_s = i_s - F_s, M_t = max(m0, max_{s<=t}
// g_s) (so m_t = F_t + M_t); in chunk c, which starts after step c0 - 1
// and ends at step e, with q~ = q / sqrt(dh):
//   D_ts = e^{g_s - M_t} (s <= t),  P_ts = D_ts (q~_t . k_s),
//   a_t = e^{M_{c0-1} - M_t},  w_s = e^{g_s - M_e},
//   decay = e^{M_{c0-1} - M_e},
//   num_t = kappa a_t q~_t C + sum_s P_ts v_s,  den_t likewise with n, 1,
//   h_t = num_t / max(|den_t|, e^{-m_t}),
// where kappa = e^{m_c - F_{c0-1} - M_{c0-1}} takes the forward's states,
// scaled by its own f32 stabiliser m_c, to this one (1 with one chunk).
// With r_t = 1 / max(..), dden_t = -sign(den_t) (dh_t . h_t) r_t where
// |den_t| binds (else 0), dP'_ts = dh_t . v_s, and G_c, dn_c the gradient
// of the state after chunk c (0 for the last chunk):
//   dS~_ts = (r_t dP'_ts + dden_t) D_ts / sqrt(dh),  P'_ts = r_t P_ts,
//   dq_t = sum_s dS~_ts k_s + kappa a_t / sqrt(dh) (r_t C dh_t + dden_t n),
//   dk_s = sum_t dS~_ts q_t + w_s (G v_s + dn),
//   dv_s = sum_t P'_ts dh_t + w_s G^T k_s,
//   G_{c-1} = decay G_c + sum_t (a_t r_t q~_t) dh_t^T,
//   dn_{c-1} = decay dn_c + sum_t dden_t a_t q~_t,
// and the log-weights' gradients: (r dP' + dden) P summed over s (to F_t)
// and over t (to i_s - F_s), the a_t terms to F_t, w_s (k_s . (G v_s +
// dn)) to F_e - F_s + i_s, decay kappa (<G, C> + <dn, n>) to F_e; then
// dlogsigmoid(f_u) = sum over the chunk's t >= u of dF_t, and df_u =
// that times sigmoid(-f_u).  With one chunk G and dn are 0, so the
// products of the state's gradient drop out, and a caller whose initial
// state is zero says so (zero_state): the products that read it (C dh
// and the a_t terms) are skipped.  The forward then writes no states.
//
// Bound on the H100: at xlstm-1.3b's training shape (B 2, S 512, H 4,
// dh 1024) with one chunk from a zero state, the five products (S and dP'
// with K = dh, then dS~ k, dS~^T q and P'^T dh with K over the causal
// range) take 5 dh S (S + 1) operations a row: 10.76 GFLOP for the call
// (37.0 at the forward's chunk of 64, where the state products were 93%
// of it), 0.161 ms on the f32 CUDA cores and 0.065 ms at three TF32
// passes on the tensor cores; the bytes it must move (q, k, v, h, dh in,
// dq, dk, dv out) are 134 MB, 0.040 ms.  So it is bound by operations:
// the design puts them on the tensor cores in 3xTF32 and feeds those
// from shared memory, whose traffic then holds it back: a 32-wide slice
// of a 64 x 128 tile (0.52 MFLOP of f32 work) moves about 176 KB through
// it (the copies, the split's reads and writes, the A fragments and
// wgmma's reads of B).
//
// Design: five launches from one C entry (six with chunks; the wrapper
// counts one launch):
// 1. mlstm_bwd_prep, a block per (16 steps, row): the gates by f64
//    scans over the row (each block scans the row again: S steps against
//    16 dh dot products), and per step dh . h and, with a state, q . n.
// 2. mlstm_bwd_mma_sdp: S = q k^T and dP' = dh v^T, a block per 64 x 128
//    tile on or below the causal diagonal of each chunk and per product;
//    the S blocks write P = D S / sqrt(dh) and its row sums (per tile),
//    the dP' blocks dP'.
// 3. mlstm_bwd_ds, a block per tile: den, r and dden of its rows from the
//    row sums, then dS~ and P' over dP' and P in place, and the
//    log-weights' gradient summed per tile row and column.
// 4. mlstm_bwd_mma_rec (chunks only), a block per 64 x 128 tile of G:
//    walks the chunks in reverse, its tile of G held in registers from
//    one chunk to the next; writes G and dn of each chunk and its part of
//    <G, C> + <dn, n>.
// 5. mlstm_bwd_mma_out: dq, dk and dv, a block per 64 x 128 output tile
//    of each: with a state, C dh (or v G^T, k G) first, scaled per row as
//    its A operand lands; then dS~ k, dS~^T q, P'^T dh over the causal
//    range only.
// 6. mlstm_bwd_gate_grads, a block per (row, chunk): di and df.
// Every product runs in one main loop on the tensor cores through wgmma:
// a 64 x 128 block tile, two warpgroups of 64 x 64 (wgmma m64n64k8 with
// TF32 operands), k slices of 32 in a ring of three shared-memory stages
// filled by 16-byte cp.async along each operand's stored rows.  A slice is
// split into TF32 halves (hi, lo) once, when it lands: A into [m][k] pairs
// that each warp loads as its wgmma register fragment, B into wgmma's
// K-major core matrices, hi and lo apart (wgmma cannot transpose a TF32
// operand, so an operand read transposed is transposed by the split).
// 3xTF32: three wgmma a k step (lo hi, hi lo, then hi hi), into a fresh
// accumulator for each slice added in f32 (the tensor cores' accumulation
// rounds toward zero).  The split of slice j + 1 and the copy of slice
// j + 3 run while slice j's wgmma run, one barrier a slice.  Tiles wholly
// above the diagonal are never launched.  Every sum runs in a fixed order
// and there are no atomics, so a rerun gives bit-identical gradients.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

using tryage::Split;

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxL = 2048;  // longest chunk: gate_grads keeps its dF on chip
constexpr int kStateL = 64;  // longest chunk shorter than the sequence
constexpr int kPrep = 16;    // steps a prep block

// product tiles: 64 x 128 a block, two warpgroups of 64 x 64, k slices of 32
constexpr int kBM = 64, kBN = 128, kBK = 32, kNS = 3;
constexpr int kSp = kBK + 4;  // float2 pitch of a split row: conflict-free
constexpr int kRawA = kBM * (kBK + 4), kRawB = kBN * (kBK + 4);
static_assert(kBK * (kBM + 4) <= kRawA && kBK * (kBN + 4) <= kRawB,
              "a transposed raw tile fits its stage");

struct Smem {
  // split B, its hi and lo halves apart, in wgmma's core matrices (8 n by
  // 4 k, 16 bytes a row): the core matrix of (n / 8, k / 4) at float
  // ((k / 4) (kBN / 8) + n / 8) 32
  float spBh[2][kBN * kBK];
  float spBl[2][kBN * kBK];
  float2 spA[2][kBM * kSp];  // split A (hi, lo), [m][k]
  float rawA[kNS][kRawA];  // slices as stored: [m][k], or [k][m]
  float rawB[kNS][kRawB];  // [n][k], or [k][n]
};

// An operand as stored: element (r, c) at p[r ld + c] for r < rows and c <
// cols (cols a multiple of 4; past either, zero); coef, where set, scales
// stored row r as the slice is split.
struct Opnd {
  const float* p;
  long long ld;
  int rows, cols;
  const float* coef;
};

}  // namespace

namespace tryage {
// The kernels' arguments (in a named namespace: the kernels' mangled names
// then carry no file name, which build checks match kernels by).
struct MlstmBwdArgs {
  const float *q, *k, *v, *ig, *fg, *m0, *Cst, *nst, *mst, *h, *dh_;
  float *dq, *dk, *dv, *di, *df;
  double *gg, *Mg;
  float *a, *w, *lo, *dhh, *qn, *r, *dd, *ar, *ars, *decay, *kappa;
  float *P, *dP, *prow, *lrow, *lcol, *dap, *dwp, *dw2p, *ddp, *dn, *G;
  int S, H, dh, L, nc, LP, nt, ns, nd, ni, tiles, zero_state;
  float scale;
};
}  // namespace tryage

namespace {

using Args = tryage::MlstmBwdArgs;

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// The block's sum of x, in a fixed order, in every thread.
__device__ __forceinline__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  x = warp_sum(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) s += red[w];
  __syncthreads();
  return s;
}

// The exclusive scan over the block's threads (in thread order) of x, by
// sum or by max, in a fixed order.
template <bool kMax>
__device__ __forceinline__ double block_excl(double x, double* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const double id = kMax ? -INFINITY : 0.0;
  double incl = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl = kMax ? fmax(incl, y) : incl + y;
  }
  double excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = id;
  if (lane == 31) tmp[warp] = incl;
  __syncthreads();
  double pre = id;
  for (int w = 0; w < warp; ++w) pre = kMax ? fmax(pre, tmp[w]) : pre + tmp[w];
  __syncthreads();
  return kMax ? fmax(pre, excl) : pre + excl;
}

// Rows of chunk c of a (B, S, H, dh) tensor, as an operand.
__device__ __forceinline__ Opnd rows_op(const float* p, const Args& a, int bh,
                                        int c, const float* coef = nullptr) {
  const int b = bh / a.H, hh = bh - b * a.H;
  return {p + (((size_t)b * a.S + (size_t)c * a.L) * a.H + hh) * a.dh,
          (long long)a.H * a.dh, a.L, a.dh, coef};
}

// Element (t, d) of chunk c of a (B, S, H, dh) tensor.
__device__ __forceinline__ size_t model_at(const Args& a, int bh, int c, int t,
                                           int d) {
  const int b = bh / a.H, hh = bh - b * a.H;
  return (((size_t)b * a.S + (size_t)c * a.L + t) * a.H + hh) * a.dh + d;
}

// Chunk-local tile idx -> (t-tile, s-tile): t-tile ti holds s-tiles 0 ..
// ti / 2 (64-row by 128-column tiles on or below the diagonal).
__device__ __forceinline__ void tile_of(int idx, int& ti, int& sj) {
  ti = 0;
  while (idx > (ti >> 1)) {
    idx -= (ti >> 1) + 1;
    ++ti;
  }
  sj = idx;
}

// ---------------------------------------------------------------- products

// Stored rows [r0, r0 + R) x columns [c0, c0 + C) of o into raw (pitch C +
// 4), 16 bytes a copy, zero outside o.
template <int R, int C>
__device__ __forceinline__ void stage(float* raw, const Opnd& o, int r0,
                                      int c0) {
  constexpr int kQ = C / 4;
  static_assert(R * kQ % kThreads == 0, "whole copies a thread");
#pragma unroll
  for (int it = 0; it < R * kQ / kThreads; ++it) {
    const int i = threadIdx.x + it * kThreads;
    const int r = i / kQ, c = (i - r * kQ) * 4;
    const int gr = r0 + r, gc = c0 + c;
    const bool in = gr < o.rows && gc < o.cols;
    tryage::cp_async16(raw + r * (C + 4) + c,
                       in ? o.p + (size_t)gr * o.ld + gc : o.p, in);
  }
}

// Element quad (r, kq .. kq + 3) of a landed slice of R rows by kBK, as
// stored: [row][k], or with T [k][row].
template <int R, bool T>
__device__ __forceinline__ void load_quad(float (&x)[4], const float* raw,
                                          int r, int kq) {
  if (T) {
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = raw[(kq + e) * (R + 4) + r];
  } else {
    const float4 y = *reinterpret_cast<const float4*>(raw + r * (kBK + 4) + kq);
    x[0] = y.x, x[1] = y.y, x[2] = y.z, x[3] = y.w;
  }
}

// Part it of splitting a landed A slice into sp[row][k] = (hi, lo), times
// o.coef of the stored row where set (stored row r0 + row, or with T k0 +
// k).  A lane takes 4 k of one row, the lanes of a warp consecutive rows;
// the upper half of each row's 4 goes first in every other group of 4
// rows, so that a quarter warp's 16-byte stores meet no bank twice.
template <int R, bool T>
__device__ __forceinline__ void split_part(float2* sp, const float* raw,
                                           const Opnd& o, int r0, int k0,
                                           int it) {
  static_assert(R * (kBK / 4) % kThreads == 0, "whole quads a thread");
  const int i = threadIdx.x + it * kThreads;
  const int r = i % R, kq = (i / R) * 4;
  float x[4];
  load_quad<R, T>(x, raw, r, kq);
  if (o.coef != nullptr) {
    if (T) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gk = k0 + kq + e;
        x[e] *= gk < o.rows ? o.coef[gk] : 0.0f;
      }
    } else {
      const int gr = r0 + r;
      const float cf = gr < o.rows ? o.coef[gr] : 0.0f;
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] *= cf;
    }
  }
  float s[8];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const Split z = tryage::split_tf32_rz(x[e]);
    s[2 * e] = __uint_as_float(z.big);
    s[2 * e + 1] = __uint_as_float(z.small);
  }
  const float4 first = make_float4(s[0], s[1], s[2], s[3]);
  const float4 second = make_float4(s[4], s[5], s[6], s[7]);
  float4* dst = reinterpret_cast<float4*>(sp + r * kSp + kq);
  const int h = (r >> 2) & 1;
  dst[h] = h ? second : first;
  dst[1 - h] = h ? first : second;
}

// Part it of splitting a landed B slice (kBN rows n) into the core-matrix
// halves hi and lo.  A lane takes 4 k of one n, the lanes of a warp
// consecutive n: a quarter warp writes one core matrix's 128 bytes.
template <bool T>
__device__ __forceinline__ void split_part_b(float* hi, float* lo,
                                             const float* raw, int it) {
  static_assert(kBN * (kBK / 4) % kThreads == 0, "whole quads a thread");
  const int i = threadIdx.x + it * kThreads;
  const int n = i % kBN, kq = (i / kBN) * 4;
  float x[4], h[4], l[4];
  load_quad<kBN, T>(x, raw, n, kq);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const Split z = tryage::split_tf32_rz(x[e]);
    h[e] = __uint_as_float(z.big);
    l[e] = __uint_as_float(z.small);
  }
  const int at = ((kq / 4) * (kBN / 8) + n / 8) * 32 + (n % 8) * 4;
  *reinterpret_cast<float4*>(hi + at) = make_float4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<float4*>(lo + at) = make_float4(l[0], l[1], l[2], l[3]);
}

// A wgmma descriptor of a K-major operand in core matrices, no swizzle:
// the two core matrices of a k step 2048 bytes apart (LBO), the 8-row
// groups 128 bytes apart (SBO).
__device__ __forceinline__ uint64_t core_desc(const float* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) |
         ((uint64_t)((kBN / 8) * 128 / 16) << 16) |
         ((uint64_t)(128 / 16) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared memory written by the threads, then read by wgmma
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d (+)= A B for the warpgroup's 64 x 64 tile and one k step of 8: A from
// registers (the warp's 16 rows, mma.sync's m16n8k8 layout), B from shared
// memory; d is zeroed first where scale_d is 0.
__device__ __forceinline__ void wgmma_tf32(float (&d)[2][4][4], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0][0]), "+f"(d[0][0][1]), "+f"(d[0][0][2]), "+f"(d[0][0][3]),
        "+f"(d[0][1][0]), "+f"(d[0][1][1]), "+f"(d[0][1][2]), "+f"(d[0][1][3]),
        "+f"(d[0][2][0]), "+f"(d[0][2][1]), "+f"(d[0][2][2]), "+f"(d[0][2][3]),
        "+f"(d[0][3][0]), "+f"(d[0][3][1]), "+f"(d[0][3][2]), "+f"(d[0][3][3]),
        "+f"(d[1][0][0]), "+f"(d[1][0][1]), "+f"(d[1][0][2]), "+f"(d[1][0][3]),
        "+f"(d[1][1][0]), "+f"(d[1][1][1]), "+f"(d[1][1][2]), "+f"(d[1][1][3]),
        "+f"(d[1][2][0]), "+f"(d[1][2][1]), "+f"(d[1][2][2]), "+f"(d[1][2][3]),
        "+f"(d[1][3][0]), "+f"(d[1][3][1]), "+f"(d[1][3][2]), "+f"(d[1][3][3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc), "r"(scale_d));
}

// part = the split slice's A B on the tensor cores: warpgroup w takes
// the tile's columns 64 w .. + 63, its warp v rows 16 v .. + 15 of A.
// Three TF32 passes a k step (the small terms first), issued async: the
// caller overlaps them and waits.
__device__ __forceinline__ void mma_slice(float (&part)[2][4][4],
                                          const float2* spA, const float* hi,
                                          const float* lo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, v = warp & 3, wg = warp >> 2;
  uint32_t ah[kBK / 8][4], al[kBK / 8][4];
#pragma unroll
  for (int ks = 0; ks < kBK / 8; ++ks) {
    const float2* p = spA + (16 * v + g) * kSp + 8 * ks + t;
    const float2 x[4] = {p[0], p[8 * kSp], p[4], p[8 * kSp + 4]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ah[ks][e] = __float_as_uint(x[e].x);
      al[ks][e] = __float_as_uint(x[e].y);
    }
  }
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < kBK / 8; ++ks) {
    // k step ks: core matrices 2 ks and 2 ks + 1 along k; the group's 8
    // along n
    const int at = (2 * ks * (kBN / 8) + 8 * wg) * 32;
    const uint64_t dh = core_desc(hi + at), dl = core_desc(lo + at);
    wgmma_tf32(part, al[ks][0], al[ks][1], al[ks][2], al[ks][3], dh, ks > 0);
    wgmma_tf32(part, ah[ks][0], ah[ks][1], ah[ks][2], ah[ks][3], dl, 1);
    wgmma_tf32(part, ah[ks][0], ah[ks][1], ah[ks][2], ah[ks][3], dh, 1);
  }
  wgmma_commit();
}

// acc += A[m0 .. m0 + 64, kbeg .. kend) B[kbeg .. kend, n0 .. n0 + 128):
// A (m, k) is stored row m (with TA: stored row k), B (k, n) stored row k
// (with TB: stored row n).  Slices of kBK past kend read what o holds
// there, which the callers keep zero on one side.  Leaves the shared
// memory free.
template <bool TA, bool TB>
__device__ __forceinline__ void mainloop(Smem& sm, float (&acc)[2][4][4],
                                      const Opnd& A, const Opnd& B, int m0,
                                      int n0, int kbeg, int kend) {
  const int nk = (kend - kbeg + kBK - 1) / kBK;
  if (nk <= 0) return;
  auto issue = [&](int j) {
    if (j < nk) {
      const int k0 = kbeg + j * kBK, st = j % kNS;
      if (TA) stage<kBK, kBM>(sm.rawA[st], A, k0, m0);
      else stage<kBM, kBK>(sm.rawA[st], A, m0, k0);
      if (TB) stage<kBN, kBK>(sm.rawB[st], B, n0, k0);
      else stage<kBK, kBN>(sm.rawB[st], B, k0, n0);
    }
    tryage::cp_async_commit();
  };
  // part u of splitting slice j: A's two parts, then B's four
  auto split_slice = [&](int j, int u) {
    const int k0 = kbeg + j * kBK, st = j % kNS;
    if (u < 2)
      split_part<kBM, TA>(sm.spA[j & 1], sm.rawA[st], A, m0, k0, u);
    else
      split_part_b<!TB>(sm.spBh[j & 1], sm.spBl[j & 1], sm.rawB[st], u - 2);
  };
  auto add = [&](const float (&x)[2][4][4]) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][jj][e] += x[i][jj][e];
  };
  issue(0);
  issue(1);
  tryage::cp_async_wait<1>();
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 6; ++u) split_slice(0, u);
  fence_async_smem();
  issue(2);
  float part[2][4][4];  // a fresh accumulator a slice, added in f32
  for (int j = 0; j < nk; ++j) {
    // slice j + 1 has landed, slice j is split, slice j - 1's products and
    // split are done (their buffers free)
    tryage::cp_async_wait<1>();
    __syncthreads();
    mma_slice(part, sm.spA[j & 1], sm.spBh[j & 1], sm.spBl[j & 1]);
    if (j + 1 < nk) {  // beside the tensor cores
#pragma unroll
      for (int u = 0; u < 6; ++u) split_slice(j + 1, u);
      fence_async_smem();
    }
    issue(j + 3);
    wgmma_wait();
    add(part);
  }
  tryage::cp_async_wait<0>();
  __syncthreads();
}

// For each accumulator element: f(row, col, i, j, e) with row < 64, col <
// 128 in the block tile (e & 1: the odd column of a pair): wgmma's
// accumulator layout, column block 4 i + j of 8 in the warpgroup's 64.
template <class F>
__device__ __forceinline__ void for_acc(F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, v = warp & 3, wg = warp >> 2;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(16 * v + g + 8 * (e >> 1),
          64 * wg + 8 * (4 * i + j) + 2 * t + (e & 1), i, j, e);
}

// Per tile row (thread tid < 64 gets row tid's), the sum over the tile's
// columns of x(row, col, value), in a fixed order.
template <class X>
__device__ __forceinline__ float tile_row_sums(const float (&acc)[2][4][4],
                                               float* red, X x) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, v = warp & 3, wg = warp >> 2;
  float s[2] = {0.0f, 0.0f};
  for_acc([&](int row, int col, int i, int j, int e) {
    s[e >> 1] += x(row, col, acc[i][j][e]);
  });
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float y = s[hf];
    y += __shfl_xor_sync(kFull, y, 1);
    y += __shfl_xor_sync(kFull, y, 2);
    if (t == 0) red[wg * kBM + 16 * v + g + 8 * hf] = y;
  }
  __syncthreads();
  float out = 0.0f;
  if (threadIdx.x < kBM) out = red[threadIdx.x] + red[kBM + threadIdx.x];
  __syncthreads();
  return out;
}

}  // namespace

// ------------------------------------------------------------------ 1. prep

// Per step of kPrep steps of a row: g, M (f64), a, w, the floor e^{-m_t},
// dh . h and q . n; per chunk that starts here: decay and kappa.
__global__ void __launch_bounds__(kThreads) mlstm_bwd_prep(Args a) {
  __shared__ double tmp[32];
  // M and F over steps t0 - kStateL .. t0 + kPrep + kStateL - 1
  __shared__ double winM[kPrep + 2 * kStateL], winF[kPrep + 2 * kStateL];
  __shared__ double tF[kPrep], tG[kPrep], tM[kPrep];
  const int t0 = blockIdx.x * kPrep, bh = blockIdx.y;
  const int b = bh / a.H, hh = bh - b * a.H, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, S = a.S, L = a.L, nc = a.nc;
  const float* ib = a.ig + (size_t)b * S * a.H + hh;  // stride H a step
  const float* fb = a.fg + (size_t)b * S * a.H + hh;
  const double m0 = a.m0[bh];
  const int seg = (S + kThreads - 1) / kThreads;
  const int u0 = min(S, tid * seg), u1 = min(S, u0 + seg);
  const int wbase = t0 - kStateL;
  double sum = 0.0;
  for (int u = u0; u < u1; ++u) sum += (double)log_sigmoid(fb[(size_t)u * a.H]);
  const double Fbase = block_excl<false>(sum, tmp);
  double F = Fbase, mx = -INFINITY;
  for (int u = u0; u < u1; ++u) {
    F += (double)log_sigmoid(fb[(size_t)u * a.H]);
    mx = fmax(mx, (double)ib[(size_t)u * a.H] - F);
  }
  const double Mbase = fmax(m0, block_excl<true>(mx, tmp));
  F = Fbase;
  double M = Mbase;
  for (int u = u0; u < u1; ++u) {  // the same sums again, kept where needed
    F += (double)log_sigmoid(fb[(size_t)u * a.H]);
    const double gu = (double)ib[(size_t)u * a.H] - F;
    M = fmax(M, gu);
    if (u >= t0 && u < t0 + kPrep)
      tF[u - t0] = F, tG[u - t0] = gu, tM[u - t0] = M;
    if (u >= wbase && u < wbase + kPrep + 2 * kStateL)
      winM[u - wbase] = M, winF[u - wbase] = F;
  }
  __syncthreads();
  if (tid < kPrep && t0 + tid < S) {
    const int t = t0 + tid, c = t / L, c0 = c * L, e = c0 + L - 1;
    const size_t at = (size_t)bh * S + t;
    // with chunks (L <= kStateL) the chunk's ends lie in the window
    const double Mp = c0 == 0 ? m0 : winM[c0 - 1 - wbase];
    const double Fp = c0 == 0 ? 0.0 : winF[c0 - 1 - wbase];
    const double Mt = tM[tid], gt = tG[tid];
    a.gg[at] = gt;
    a.Mg[at] = Mt;
    a.a[at] = expf((float)(Mp - Mt));
    a.lo[at] = expf((float)(-(tF[tid] + Mt)));
    a.w[at] = nc > 1 ? expf((float)(gt - winM[e - wbase])) : 0.0f;
    if (t == c0) {
      a.decay[(size_t)bh * nc + c] =
          nc > 1 ? expf((float)(Mp - winM[e - wbase])) : 0.0f;
      a.kappa[(size_t)bh * nc + c] =
          expf((float)((double)a.mst[(size_t)bh * nc + c] - Fp - Mp));
    }
  }
  // dh . h and, where the chunk reads a state, q . n: a warp a step
  for (int j = 0; j < kPrep / 8; ++j) {
    const int t = t0 + warp + 8 * j;
    if (t >= S) break;
    const int c = t / L;
    const bool has_state = c > 0 || !a.zero_state;
    const size_t row = (((size_t)b * S + t) * a.H + hh) * a.dh;
    const float* n = a.nst + ((size_t)bh * nc + c) * a.dh;
    float s1 = 0.0f, s2 = 0.0f;
    for (int d = 4 * lane; d < a.dh; d += 128) {
      const float4 x = *reinterpret_cast<const float4*>(a.dh_ + row + d);
      const float4 y = *reinterpret_cast<const float4*>(a.h + row + d);
      s1 += x.x * y.x + x.y * y.y + x.z * y.z + x.w * y.w;
      if (has_state) {
        const float4 qq = *reinterpret_cast<const float4*>(a.q + row + d);
        const float4 nn = *reinterpret_cast<const float4*>(n + d);
        s2 += qq.x * nn.x + qq.y * nn.y + qq.z * nn.z + qq.w * nn.w;
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      a.dhh[(size_t)bh * S + t] = s1;
      a.qn[(size_t)bh * S + t] = s2;
    }
  }
}

// ------------------------------------------------------------ 2. S and dP'

// S = q k^T (blockIdx.y 0) or dP' = dh v^T (1) on one 64 x 128 tile of a
// chunk: S becomes P = D S / sqrt(dh) with its row sums over the tile.
__global__ void __launch_bounds__(kThreads, 1) mlstm_bwd_mma_sdp(Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int c = blockIdx.x / a.tiles, job = blockIdx.y, bh = blockIdx.z;
  int ti, sj;
  tile_of(blockIdx.x - c * a.tiles, ti, sj);
  const int t0 = ti * kBM, s0 = sj * kBN;
  float acc[2][4][4];
  for_acc([&](int, int, int i, int j, int e) { acc[i][j][e] = 0.0f; });
  mainloop<false, true>(sm, acc, rows_op(job ? a.dh_ : a.q, a, bh, c),
                        rows_op(job ? a.v : a.k, a, bh, c), t0, s0, 0, a.dh);
  const size_t st0 = (size_t)bh * a.S + (size_t)c * a.L;
  float* out = (job ? a.dP : a.P) + ((size_t)bh * a.nc + c) * a.L * a.LP;
  if (job == 0) {  // P = D S / sqrt(dh), masked
    for_acc([&](int row, int col, int i, int j, int e) {
      const int t = t0 + row, s = s0 + col;
      float p = 0.0f;
      if (s <= t && t < a.L)
        p = expf((float)(a.gg[st0 + s] - a.Mg[st0 + t])) * a.scale *
            acc[i][j][e];
      acc[i][j][e] = p;
    });
  } else {
    for_acc([&](int row, int col, int i, int j, int e) {
      if (s0 + col > t0 + row) acc[i][j][e] = 0.0f;
    });
  }
  for_acc([&](int row, int col, int i, int j, int e) {
    const int t = t0 + row, s = s0 + col;
    if (!(e & 1) && t < a.L && s < a.LP)
      *reinterpret_cast<float2*>(out + (size_t)t * a.LP + s) =
          make_float2(acc[i][j][e], acc[i][j][e + 1]);
  });
  if (job == 0) {
    const float rs = tile_row_sums(acc, sm.rawA[0],
                                   [](int, int, float x) { return x; });
    if (threadIdx.x < kBM && t0 + (int)threadIdx.x < a.L)
      a.prow[(st0 + t0 + threadIdx.x) * a.ns + sj] = rs;
  }
}

// --------------------------------------------------------------- 3. dS~, P'

// On one tile: den, r, dden of its rows (the s-tile 0 block writes them
// with a r / sqrt(dh), for the products), then dS~ over dP' and P' over
// P, and the log-weights' gradient (r dP' + dden) P summed per row and
// per column of the tile.
__global__ void __launch_bounds__(kThreads) mlstm_bwd_ds(Args a) {
  __shared__ float r_s[64], dd_s[64];
  __shared__ double M_s[64], g_s[128];
  __shared__ float csum[kThreads / 32][128];
  const int c = blockIdx.x / a.tiles, bh = blockIdx.y, tid = threadIdx.x;
  int ti, sj;
  tile_of(blockIdx.x - c * a.tiles, ti, sj);
  const int t0 = ti * kBM, s0 = sj * kBN, L = a.L, LP = a.LP;
  const size_t st0 = (size_t)bh * a.S + (size_t)c * L;
  const bool has_state = c > 0 || !a.zero_state;
  if (tid < 64) {
    const int t = t0 + tid;
    float r = 0.0f, dd = 0.0f;
    double M = 0.0;
    if (t < L) {
      const size_t at = st0 + t;
      float den = 0.0f;
      for (int j = 0; j <= (ti >> 1); ++j) den += a.prow[at * a.ns + j];
      const float as = a.a[at] * a.kappa[(size_t)bh * a.nc + c];
      if (has_state) den += as * a.scale * a.qn[at];
      const float lo = a.lo[at];
      r = 1.0f / fmaxf(fabsf(den), lo);
      dd = fabsf(den) > lo ? -copysignf(1.0f, den) * a.dhh[at] * r : 0.0f;
      M = a.Mg[at];
      if (sj == 0) {
        a.r[at] = r;
        a.dd[at] = dd;
        a.ar[at] = a.scale * a.a[at] * r;
        a.ars[at] = a.scale * as * r;
      }
    }
    r_s[tid] = r;
    dd_s[tid] = dd;
    M_s[tid] = M;
  }
  if (tid < 128) g_s[tid] = s0 + tid < L ? a.gg[st0 + s0 + tid] : 0.0;
  __syncthreads();
  const int lane = tid & 31, warp = tid >> 5, s = s0 + 4 * lane;
  float* Pm = a.P + ((size_t)bh * a.nc + c) * L * LP;
  float* dPm = a.dP + ((size_t)bh * a.nc + c) * L * LP;
  float cs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = 0; i < 8; ++i) {
    const int tl = warp + 8 * i, t = t0 + tl;
    float rs = 0.0f;
    if (t < L && s < LP) {
      const size_t at = (size_t)t * LP + s;
      const float4 p4 = *reinterpret_cast<const float4*>(Pm + at);
      const float4 x4 = *reinterpret_cast<const float4*>(dPm + at);
      const float p[4] = {p4.x, p4.y, p4.z, p4.w};
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
      float ds[4], pp[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ds[e] = pp[e] = 0.0f;
        if (s + e <= t) {
          const float E = expf((float)(g_s[4 * lane + e] - M_s[tl])) * a.scale;
          const float dPv = r_s[tl] * x[e] + dd_s[tl];
          const float l = dPv * p[e];
          ds[e] = dPv * E;
          pp[e] = r_s[tl] * p[e];
          rs += l;
          cs[e] += l;
        }
      }
      *reinterpret_cast<float4*>(dPm + at) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
      *reinterpret_cast<float4*>(Pm + at) =
          make_float4(pp[0], pp[1], pp[2], pp[3]);
    }
    rs = warp_sum(rs);
    if (lane == 0 && t < L) a.lrow[(st0 + t) * a.ns + sj] = rs;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) csum[warp][4 * lane + e] = cs[e];
  __syncthreads();
  if (tid < 128 && s0 + tid < L) {
    float x = 0.0f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) x += csum[w][tid];
    a.lcol[(st0 + s0 + tid) * a.nt + ti] = x;
  }
}

// ---------------------------------------------- 4. the state's gradient

// One 64 x 128 tile of G per block, over the chunks in reverse: G of the
// last chunk is 0, G_{c-1} = decay_c G_c + sum_t (a_t r_t q~_t) dh_t^T; the
// tile stays in registers and is written for each chunk but the last.
// Blocks of column tile 0 carry dn over their rows likewise.  Each block
// writes its part of <G_c, C_c> + <dn_c, n_c> for every chunk.
__global__ void __launch_bounds__(kThreads, 1) mlstm_bwd_mma_rec(Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  __shared__ float red[kThreads / 32];
  __shared__ float dnq[kThreads / kBM][kBM];
  const int j0 = blockIdx.x * kBN, i0 = blockIdx.y * kBM, bh = blockIdx.z;
  const int tid = threadIdx.x, dh = a.dh, nc = a.nc;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  const int ntile = gridDim.x * gridDim.y;
  const bool dn_row = blockIdx.x == 0 && tid < kBM && i0 + tid < dh;
  float acc[2][4][4];
  for_acc([&](int, int, int i, int j, int e) { acc[i][j][e] = 0.0f; });
  float dn = 0.0f;
  for (int c = nc - 1;; --c) {
    const size_t z = (size_t)bh * nc + c;
    float part = 0.0f;
    if (c < nc - 1 && (c > 0 || !a.zero_state)) {
      const float* C = a.Cst + z * dh * dh;
      for_acc([&](int row, int col, int i, int j, int e) {
        const int ii = i0 + row, jj = j0 + col;
        if (ii < dh && jj < dh) part += acc[i][j][e] * C[(size_t)ii * dh + jj];
      });
      if (dn_row) part += dn * a.nst[z * dh + i0 + tid];
    }
    part = block_sum(part, red);
    if (tid == 0) a.ddp[z * ntile + tile] = part;
    if (c == 0) break;
    const float decay = a.decay[z];
    for_acc([&](int, int, int i, int j, int e) { acc[i][j][e] *= decay; });
    const size_t st0 = (size_t)bh * a.S + (size_t)c * a.L;
    mainloop<true, false>(sm, acc, rows_op(a.q, a, bh, c, a.ar + st0),
                          rows_op(a.dh_, a, bh, c), i0, j0, 0, a.L);
    float* Gp = a.G + (z - 1) * dh * dh;
    for_acc([&](int row, int col, int i, int j, int e) {
      const int ii = i0 + row, jj = j0 + col;
      if (!(e & 1) && ii < dh && jj < dh)
        *reinterpret_cast<float2*>(Gp + (size_t)ii * dh + jj) =
            make_float2(acc[i][j][e], acc[i][j][e + 1]);
    });
    if (blockIdx.x == 0) {  // the block's quarters take every fourth step
      const int i = tid % kBM, qt = tid / kBM;
      float s = 0.0f;
      if (i0 + i < dh) {
#pragma unroll 4
        for (int t = qt; t < a.L; t += kThreads / kBM)
          s += a.dd[st0 + t] * (a.scale * a.a[st0 + t]) *
               a.q[model_at(a, bh, c, t, i0 + i)];
      }
      dnq[qt][i] = s;
      __syncthreads();
      if (dn_row) {
        dn = decay * dn +
             ((dnq[0][tid] + dnq[1][tid]) + (dnq[2][tid] + dnq[3][tid]));
        a.dn[(z - 1) * dh + i0 + tid] = dn;
      }
      __syncthreads();
    }
  }
}

// ------------------------------------------------------- 5. dq, dk, dv

// One 64 x 128 tile of dq (blockIdx.y 0), dk (1) or dv (2) of a chunk.
__global__ void __launch_bounds__(kThreads, 1) mlstm_bwd_mma_out(Args a) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int nm = (a.L + kBM - 1) / kBM, per = nm * a.nd;
  const int c = blockIdx.x / per, rem = blockIdx.x - c * per;
  const int mi = rem / a.nd, dj = rem - mi * a.nd;
  const int job = blockIdx.y, bh = blockIdx.z, dh = a.dh, L = a.L;
  const int m0 = mi * kBM, n0 = dj * kBN;
  const bool has_state = c > 0 || !a.zero_state, has_G = c < a.nc - 1;
  const size_t z = (size_t)bh * a.nc + c;
  const size_t st0 = (size_t)bh * a.S + (size_t)c * L;
  const Opnd mat = {(job == 2 ? a.P : a.dP) + z * L * a.LP, a.LP, L, a.LP,
                    nullptr};
  float acc[2][4][4];
  for_acc([&](int, int, int i, int j, int e) { acc[i][j][e] = 0.0f; });
  float* red = sm.rawA[0];
  if (job == 0) {
    if (has_state) {  // kappa a_t r_t / sqrt(dh) C dh_t, and its dot with q_t
      const Opnd C = {a.Cst + z * dh * dh, dh, dh, dh, nullptr};
      mainloop<false, true>(sm, acc, rows_op(a.dh_, a, bh, c, a.ars + st0), C,
                            m0, n0, 0, dh);
      const float x = tile_row_sums(acc, red, [&](int row, int col, float y) {
        const int t = m0 + row, d = n0 + col;
        return t < L && d < dh ? a.q[model_at(a, bh, c, t, d)] * y : 0.0f;
      });
      if (threadIdx.x < kBM && m0 + (int)threadIdx.x < L)
        a.dap[(st0 + m0 + threadIdx.x) * a.nd + dj] = x;
    }
    mainloop<false, false>(sm, acc, mat, rows_op(a.k, a, bh, c), m0, n0, 0,
                           min(m0 + kBM, L));
  } else if (job == 1) {
    if (has_G) {  // w_s G v_s
      const Opnd G = {a.G + z * dh * dh, dh, dh, dh, nullptr};
      mainloop<false, true>(sm, acc, rows_op(a.v, a, bh, c, a.w + st0), G, m0,
                            n0, 0, dh);
      const float x = tile_row_sums(acc, red, [&](int row, int col, float) {
        const int s = m0 + row, d = n0 + col;
        return s < L && d < dh
                   ? a.k[model_at(a, bh, c, s, d)] * a.dn[z * dh + d]
                   : 0.0f;
      });
      if (threadIdx.x < kBM && m0 + (int)threadIdx.x < L)
        a.dwp[(st0 + m0 + threadIdx.x) * a.nd + dj] = x;
    }
    mainloop<true, false>(sm, acc, mat, rows_op(a.q, a, bh, c), m0, n0, m0, L);
  } else {
    if (has_G) {  // w_s G^T k_s, and its dot with v_s
      const Opnd G = {a.G + z * dh * dh, dh, dh, dh, nullptr};
      mainloop<false, false>(sm, acc, rows_op(a.k, a, bh, c, a.w + st0), G, m0,
                             n0, 0, dh);
      const float x = tile_row_sums(acc, red, [&](int row, int col, float y) {
        const int s = m0 + row, d = n0 + col;
        return s < L && d < dh ? a.v[model_at(a, bh, c, s, d)] * y : 0.0f;
      });
      if (threadIdx.x < kBM && m0 + (int)threadIdx.x < L)
        a.dw2p[(st0 + m0 + threadIdx.x) * a.nd + dj] = x;
    }
    mainloop<true, false>(sm, acc, mat, rows_op(a.dh_, a, bh, c), m0, n0, m0,
                          L);
  }
  float* out = job == 0 ? a.dq : job == 1 ? a.dk : a.dv;
  const float kap = a.kappa[z];
  for_acc([&](int row, int col, int i, int j, int e) {
    const int t = m0 + row, d = n0 + col;
    if ((e & 1) || t >= L || d >= dh) return;
    float x0 = acc[i][j][e], x1 = acc[i][j][e + 1];
    if (job == 0 && has_state) {
      const float f = a.scale * a.a[st0 + t] * kap * a.dd[st0 + t];
      x0 += f * a.nst[z * dh + d];
      x1 += f * a.nst[z * dh + d + 1];
    } else if (job == 1 && has_G) {
      const float f = a.w[st0 + t];
      x0 += f * a.dn[z * dh + d];
      x1 += f * a.dn[z * dh + d + 1];
    }
    *reinterpret_cast<float2*>(out + model_at(a, bh, c, t, d)) =
        make_float2(x0, x1);
  });
}

// ------------------------------------------------------------ 6. di, df

// di and df of one (row, chunk) from the sums: dF_t, then the reverse sum
// over the chunk for dlogsigmoid(f), times sigmoid(-f).  A thread holds a
// run of consecutive steps.
__global__ void __launch_bounds__(kThreads) mlstm_bwd_gate_grads(Args a) {
  __shared__ float dF[kMaxL];
  __shared__ float tot[kThreads];
  __shared__ float red[kThreads / 32];
  const int c = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x, L = a.L;
  const int b = bh / a.H, hh = bh - b * a.H;
  const size_t z = (size_t)bh * a.nc + c;
  const size_t st0 = (size_t)bh * a.S + (size_t)c * L;
  const bool has_state = c > 0 || !a.zero_state, has_G = c < a.nc - 1;
  const float kap = a.kappa[z];
  const int seg = (L + kThreads - 1) / kThreads;
  const int u0 = min(L, tid * seg), u1 = min(L, u0 + seg);
  float wsum = 0.0f;
  for (int t = u0; t < u1; ++t) {
    const size_t at = st0 + t;
    float rs = 0.0f, cs = 0.0f, da = 0.0f, ww = 0.0f;
    for (int j = 0; j <= ((t >> 6) >> 1); ++j) rs += a.lrow[at * a.ns + j];
    for (int j = 2 * (t >> 7); j < a.nt; ++j) cs += a.lcol[at * a.nt + j];
    if (has_state) {
      for (int j = 0; j < a.nd; ++j) da += a.dap[at * a.nd + j];
      da += a.scale * a.a[at] * kap * a.dd[at] * a.qn[at];
    }
    if (has_G) {
      float x = 0.0f, y = 0.0f;
      for (int j = 0; j < a.nd; ++j) {
        x += a.dw2p[at * a.nd + j];
        y += a.dwp[at * a.nd + j];
      }
      ww = x + a.w[at] * y;
    }
    dF[t] = rs - cs + da - ww;
    a.di[((size_t)b * a.S + (size_t)c * L + t) * a.H + hh] = cs + ww;
    wsum += ww;
  }
  wsum = block_sum(wsum, red);
  if (tid == 0) {  // F at the chunk's end: the decay's and the w's terms
    float dd = 0.0f;
    if (has_G) {
      const int ntile = a.nd * a.ni;
      for (int j = 0; j < ntile; ++j) dd += a.ddp[z * ntile + j];
    }
    dF[L - 1] += kap * dd * a.decay[z] + wsum;
  }
  __syncthreads();
  float run = 0.0f;
  for (int t = u1 - 1; t >= u0; --t) run += dF[t];
  tot[tid] = run;
  __syncthreads();
  run = 0.0f;
  for (int j = kThreads - 1; j > tid; --j) run += tot[j];
  for (int t = u1 - 1; t >= u0; --t) {
    run += dF[t];
    const size_t at = ((size_t)b * a.S + (size_t)c * L + t) * a.H + hh;
    a.df[at] = run / (1.0f + expf(a.fg[at]));
  }
}

namespace {

size_t up4(size_t n) { return (n + 3) / 4 * 4; }

int tiles_per_chunk(int L) {
  int n = 0;
  for (int ti = 0; ti * kBM < L; ++ti) n += (ti >> 1) + 1;
  return n;
}

// The workspace's parts, in floats, in order (f64 parts take two floats).
struct Work {
  size_t gg, Mg, a, w, lo, dhh, qn, r, dd, ar, ars, decay, kappa, P, dP, prow,
      lrow, lcol, dap, dwp, dw2p, ddp, dn, G, total;
  int nc, LP, nt, ns, nd, ni;
  Work(int B, int S, int H, int dh, int L) {
    nc = S / L;
    LP = (L + 3) / 4 * 4;
    nt = (L + kBM - 1) / kBM;
    ns = (L + kBN - 1) / kBN;
    nd = (dh + kBN - 1) / kBN;
    ni = (dh + kBM - 1) / kBM;
    const size_t BH = (size_t)B * H, N = BH * S, Z = BH * nc;
    size_t at = 0;
    auto take = [&](size_t n) {
      const size_t here = at;
      at += up4(n);
      return here;
    };
    gg = take(2 * N);
    Mg = take(2 * N);
    a = take(N);
    w = take(N);
    lo = take(N);
    dhh = take(N);
    qn = take(N);
    r = take(N);
    dd = take(N);
    ar = take(N);
    ars = take(N);
    decay = take(Z);
    kappa = take(Z);
    P = take(Z * L * LP);
    dP = take(Z * L * LP);
    prow = take(N * ns);
    lrow = take(N * ns);
    lcol = take(N * nt);
    dap = take(N * nd);
    dwp = take(N * nd);
    dw2p = take(N * nd);
    ddp = take(Z * nd * ni);
    dn = take(Z * dh);
    G = take(nc > 1 ? Z * dh * dh : 0);
    total = at;
  }
};

bool valid(int B, int S, int H, int dh, int L) {
  return B > 0 && H > 0 && dh > 0 && S > 0 && L > 0 && S % L == 0 &&
         dh % 8 == 0 && L <= kMaxL && (L == S || L <= kStateL);
}

}  // namespace

extern "C" int tryage_mlstm_scan_bwd(
    const float* q, const float* k, const float* v, const float* ig,
    const float* fg, const float* m0, const float* Cst, const float* nst,
    const float* mst, const float* h, const float* dh_, float* dq, float* dk,
    float* dv, float* di, float* df, float* work, int B, int S, int H, int dh,
    int L, int zero_state, float scale, void* stream) {
  if (B <= 0 || H <= 0 || dh <= 0) return 0;
  if (!valid(B, S, H, dh, L)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const Work w(B, S, H, dh, L);
  const int BH = B * H;
  Args a;
  a.q = q, a.k = k, a.v = v, a.ig = ig, a.fg = fg, a.m0 = m0, a.Cst = Cst;
  a.nst = nst, a.mst = mst, a.h = h, a.dh_ = dh_;
  a.dq = dq, a.dk = dk, a.dv = dv, a.di = di, a.df = df;
  a.gg = reinterpret_cast<double*>(work + w.gg);
  a.Mg = reinterpret_cast<double*>(work + w.Mg);
  a.a = work + w.a, a.w = work + w.w, a.lo = work + w.lo, a.dhh = work + w.dhh;
  a.qn = work + w.qn, a.r = work + w.r, a.dd = work + w.dd, a.ar = work + w.ar;
  a.ars = work + w.ars, a.decay = work + w.decay, a.kappa = work + w.kappa;
  a.P = work + w.P, a.dP = work + w.dP, a.prow = work + w.prow;
  a.lrow = work + w.lrow, a.lcol = work + w.lcol, a.dap = work + w.dap;
  a.dwp = work + w.dwp, a.dw2p = work + w.dw2p, a.ddp = work + w.ddp;
  a.dn = work + w.dn, a.G = work + w.G;
  a.S = S, a.H = H, a.dh = dh, a.L = L, a.nc = w.nc, a.LP = w.LP, a.nt = w.nt;
  a.ns = w.ns, a.nd = w.nd, a.ni = w.ni, a.tiles = tiles_per_chunk(L);
  a.zero_state = zero_state, a.scale = scale;
  const size_t smem = sizeof(Smem);
  cudaError_t err;
#define TRYAGE_CHECK(x)            \
  if ((err = (x)) != cudaSuccess) \
    return (int)err;
  TRYAGE_CHECK(tryage::allow_smem(mlstm_bwd_mma_sdp, smem));
  TRYAGE_CHECK(tryage::allow_smem(mlstm_bwd_mma_rec, smem));
  TRYAGE_CHECK(tryage::allow_smem(mlstm_bwd_mma_out, smem));
  mlstm_bwd_prep<<<dim3((S + kPrep - 1) / kPrep, BH), kThreads, 0, st>>>(a);
  TRYAGE_CHECK(cudaGetLastError());
  mlstm_bwd_mma_sdp<<<dim3(w.nc * a.tiles, 2, BH), kThreads, smem, st>>>(a);
  TRYAGE_CHECK(cudaGetLastError());
  mlstm_bwd_ds<<<dim3(w.nc * a.tiles, BH), kThreads, 0, st>>>(a);
  TRYAGE_CHECK(cudaGetLastError());
  if (w.nc > 1) {
    mlstm_bwd_mma_rec<<<dim3(w.nd, w.ni, BH), kThreads, smem, st>>>(a);
    TRYAGE_CHECK(cudaGetLastError());
  }
  const int nm = (L + kBM - 1) / kBM;
  mlstm_bwd_mma_out<<<dim3(w.nc * nm * w.nd, 3, BH), kThreads, smem, st>>>(a);
  TRYAGE_CHECK(cudaGetLastError());
  mlstm_bwd_gate_grads<<<dim3(w.nc, BH), kThreads, 0, st>>>(a);
  TRYAGE_CHECK(cudaGetLastError());
#undef TRYAGE_CHECK
  return 0;
}

// Floats of workspace tryage_mlstm_scan_bwd needs, for the wrapper.
extern "C" long long tryage_mlstm_scan_bwd_workspace(int B, int S, int H,
                                                     int dh, int L) {
  if (!valid(B, S, H, dh, L)) return 0;
  return (long long)Work(B, S, H, dh, L).total;
}
