// The gradient of the chunkwise mLSTM scan (mlstm_scan.cu) on Hopper, f32,
// in the model layout: from q, k, v (B, S, H, dh), i, f (B, S, H), the
// initial stabiliser m0 (B, H), the forward's h and its gradient dh
// (B, S, H, dh), and C and n at each chunk's start (Cst (B, H, S / L, dh,
// dh), nst (B, H, S / L, dh), which the forward writes when it is given
// them), it writes dq, dk, dv (B, S, H, dh) and di, df (B, S, H).  The
// Pallas kernel _mlstm_kernel (src/repro/kernels/mlstm_scan/kernel.py)
// has no backward: the JAX package trains through XLA's autodiff of
// _mlstm_cell_chunkwise (src/repro/models/ssm.py).  This is that
// gradient, for a scan that starts from a state that needs no gradient
// and whose final state the loss does not read (training: the wrapper
// refuses anything else).
//
// Algorithm.  In chunk c of L steps, with q~ = q / sqrt(dh), the
// forward's F, m_t and m (the stabiliser at the chunk's start),
//   a_t = e^{F_t + m - m_t},  D_ts = e^{F_t - F_s + i_s - m_t} (s <= t),
//   P_ts = D_ts (q~_t . k_s),  num_t = a_t q~_t C + sum_s P_ts v_s,
//   den_t = a_t q~_t . n + sum_s P_ts,  h_t = num_t / max(|den_t|, e^{-m_t}),
//   C' = decay C + sum_s w_s k_s v_s^T,  n' = decay n + sum_s w_s k_s,
// w_s = e^{F_L - F_s + i_s - m_L}, decay = e^{F_L + m - m_L}.  h does not
// depend on the stabilisers in exact arithmetic (num and den both carry
// e^{-m_t}, and either branch of the max cancels it), so m_t and m are
// held constant and i and f get their gradient through F and the
// log-weights alone.  With dnum_t = dh_t / max(..), dden_t = -sign(den_t)
// (dh_t . h_t) / max(..) where |den_t| binds (else 0), and G_c the
// gradient of the state after chunk c (G of the last chunk is 0):
//   G_{c-1} = decay_c G_c + sum_t (a_t q~_t) dnum_t^T   (dn likewise)
//   dq~_t = a_t (C dnum_t + dden_t n) + sum_s dS_ts k_s,
//   dk_s = w_s (G v_s + dn') + sum_t dS_ts q~_t,  dv_s = w_s G^T k_s
//          + sum_t P_ts dnum_t,
// with dP_ts = dnum_t . v_s + dden_t, dS_ts = dP_ts D_ts, and the
// log-weights' gradients dP_ts P_ts (rows to F_t, columns to i_s - F_s),
// a_t (dnum_t . q~_t C + dden_t q~_t . n) to F_t, w_s (k_s . (G v_s +
// dn')) to F_L - F_s + i_s, decay (<G, C> + <dn', n>) to F_L; then
// dlogsigmoid(f_u) = sum over the chunk's t >= u of dF_t, and df_u =
// that times sigmoid(-f_u).
//
// Bound on the H100: at xlstm-1.3b's training shape (B 2, S 512, H 4,
// dh 1024, L 64) the operations: three products of 2 L dh^2 a (row,
// chunk) (C dnum, G v, G^T k) and the recurrence's one, beside five of 2
// L^2 dh; the bytes are Cst, G (written and read) and the (B, S, H, dh)
// tensors.  Design: the work is a chain of launches from one C entry
// point (the wrapper counts one launch):
// * every product runs in mlstm_bwd_gemm, one batched product kernel
//   (64 x 64 output tiles, 8 warps, 3xTF32 on the tensor cores as the
//   forward, a fresh accumulator for each 32-wide k slice added in f32 so
//   that no mma.sync chain is long), with an operand read as stored or
//   transposed (template flags) and a batch index that walks (row,
//   chunk) in the layouts above;
// * the recurrence over chunks is one such product per chunk, walked in
//   reverse (G_{c-1} from G_c), batched over the rows; G is written for
//   every chunk (B H (S / L) dh^2 floats of workspace), so the three
//   big products of every chunk then run at once;
// * the rest is small and runs on the CUDA cores in f32, one block per
//   (row, chunk): the gates (the forward's scan, again), den and the
//   per-step factors, dS, the states' dot product, the outputs and the
//   gate gradients.  Every sum runs in a fixed order and there are no
//   atomics: dq's sum over the columns of C is one product's k loop, so
//   a rerun gives bit-identical gradients.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

using tryage::Split;
using tryage::split_tf32;

constexpr int kL = 64;                 // most steps per chunk
// per (row, chunk) gates: F, i, m_t, a, w, then decay and m at the start
constexpr int kGB = 5 * kL + 4;
constexpr int kF = 0, kI = kL, kMT = 2 * kL, kA = 3 * kL, kW = 4 * kL;
constexpr int kDec = 5 * kL, kMp = 5 * kL + 1;
// per (row, chunk) gradient sums: the log-weights' row and column sums,
// da, dw, then d decay
constexpr int kGG = 4 * kL + 4;
constexpr int kRS = 0, kCS = kL, kDA = 2 * kL, kDW = 3 * kL, kDD = 4 * kL;
constexpr unsigned kFull = 0xffffffffu;

// product tiles
constexpr int kThreads = 256;
constexpr int kBM = 64, kBN = 64, kBKg = 32, kPg = kBKg + 4;

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// An operand of a batched product: batch (bh, c) starts at
// p + (bh / H) sb + (bh % H) sh + c sc, and row r of it at + r ld.
struct Op {
  const float* p;
  long long sb, sh, sc;
  int ld;
  __device__ __forceinline__ const float* at(int bh, int c, int H) const {
    return p + (bh / H) * sb + (bh % H) * sh + c * sc;
  }
};

struct GemmArgs {
  Op a, b, cin, out;   // cin: added times beta (p null: nothing added)
  const float* beta;   // beta of row bh at beta[bh * beta_bh]
  long long beta_bh;
  int M, N, K, H, nzc;  // the batch index z is bh * nzc + c
};

}  // namespace

// out[z] (M x N) = beta cin[z] + A[z] B[z]: A (m, k) is a[m][k], or with
// TA a[k][m]; B (k, n) is b[k][n], or with TB b[n][k].  A block per 64 x
// 64 output tile of one batch.
template <bool TA, bool TB>
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_gemm(GemmArgs g) {
  __shared__ __align__(16) float as[kBM * kPg], bs[kBN * kPg];
  const int z = blockIdx.z, bh = z / g.nzc, c = z - bh * g.nzc;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const float* A = g.a.at(bh, c, g.H);
  const float* Bm = g.b.at(bh, c, g.H);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // 16 rows, 32 columns a warp
  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;

  for (int k0 = 0; k0 < g.K; k0 += kBKg) {
    // the tiles as [m][k] and [n][k], each read along its stored rows
    for (int i = tid; i < kBM * kBKg; i += kThreads) {
      const int m = TA ? i % kBM : i / kBKg, kk = TA ? i / kBM : i % kBKg;
      const int gm = m0 + m, gk = k0 + kk;
      float x = 0.0f;
      if (gm < g.M && gk < g.K)
        x = TA ? A[(size_t)gk * g.a.ld + gm] : A[(size_t)gm * g.a.ld + gk];
      as[m * kPg + kk] = x;
    }
    for (int i = tid; i < kBN * kBKg; i += kThreads) {
      const int n = TB ? i / kBKg : i % kBN, kk = TB ? i % kBKg : i / kBN;
      const int gn = n0 + n, gk = k0 + kk;
      float x = 0.0f;
      if (gn < g.N && gk < g.K)
        x = TB ? Bm[(size_t)gn * g.b.ld + gk] : Bm[(size_t)gk * g.b.ld + gn];
      bs[n * kPg + kk] = x;
    }
    __syncthreads();
    // a fresh accumulator per slice, added in f32: the tensor cores'
    // accumulation rounds toward zero, so one chain over all of K would
    // carry a bias
    float part[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kBKg / 8; ++ks) {
      const float* ar = as + (16 * wm + gq) * kPg + 8 * ks + t;
      const Split a[4] = {split_tf32(ar[0]), split_tf32(ar[8 * kPg]),
                          split_tf32(ar[4]), split_tf32(ar[8 * kPg + 4])};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* br = bs + (32 * wn + 8 * j + gq) * kPg + 8 * ks + t;
        const Split b[2] = {split_tf32(br[0]), split_tf32(br[4])};
        tryage::mma_3xtf32(part[j], a, b);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
    __syncthreads();  // the tiles are restaged
  }

  float* out = const_cast<float*>(g.out.at(bh, c, g.H));
  const float* cin = g.cin.p != nullptr ? g.cin.at(bh, c, g.H) : nullptr;
  const float beta = cin != nullptr ? g.beta[bh * g.beta_bh] : 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + 16 * wm + gq + 8 * (e >> 1);
      const int n = n0 + 32 * wn + 8 * j + 2 * t + (e & 1);
      if (m < g.M && n < g.N) {
        float x = acc[j][e];
        if (cin != nullptr) x = fmaf(beta, cin[(size_t)m * g.cin.ld + n], x);
        out[(size_t)m * g.out.ld + n] = x;
      }
    }
}

// The gates of each (row, chunk), as the forward's launch 1 scans them:
// one warp walks the row's earlier chunks for m at this chunk's start,
// then F, i, m_t of its own; a, w and decay follow.  Lane holds steps
// 2 lane and 2 lane + 1.
__global__ void __launch_bounds__(32)
mlstm_bwd_gates(const float* __restrict__ ig, const float* __restrict__ fg,
                const float* __restrict__ m0, float* __restrict__ gates, int S,
                int H, int L) {
  const int c = blockIdx.x, nc = gridDim.x, bh = blockIdx.y;
  const int b = bh / H, hh = bh - b * H, lane = threadIdx.x;
  const float* ib = ig + (size_t)b * S * H + hh;  // stride H per step
  const float* fb = fg + (size_t)b * S * H + hh;
  float* gz = gates + ((size_t)bh * nc + c) * kGB;
  const int ta = 2 * lane, tb = ta + 1;
  float m = m0[bh], Fa = 0.0f, Fb = 0.0f, ia = 0.0f, ibb = 0.0f, mta = 0.0f,
        mtb = 0.0f;
  for (int cc = 0; cc <= c; ++cc) {
    const size_t s0 = (size_t)cc * L;
    const float fa = ta < L ? log_sigmoid(fb[(s0 + ta) * H]) : 0.0f;
    const float fbb = tb < L ? log_sigmoid(fb[(s0 + tb) * H]) : 0.0f;
    ia = ta < L ? ib[(s0 + ta) * H] : 0.0f;
    ibb = tb < L ? ib[(s0 + tb) * H] : 0.0f;
    float incl = fa + fbb;
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += y;
    }
    float excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0.0f;
    Fa = excl + fa;
    Fb = Fa + fbb;
    const float ga = ta < L ? ia - Fa : -INFINITY;
    const float gb = tb < L ? ibb - Fb : -INFINITY;
    float mx = fmaxf(ga, gb);
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(kFull, mx, off);
      if (lane >= off) mx = fmaxf(mx, y);
    }
    float exm = __shfl_up_sync(kFull, mx, 1);
    if (lane == 0) exm = -INFINITY;
    const float Ga = fmaxf(exm, ga), Gb = fmaxf(Ga, gb);
    mta = Fa + fmaxf(m, Ga);
    mtb = Fb + fmaxf(m, Gb);
    if (cc < c) m = __shfl_sync(kFull, ((L - 1) & 1) ? mtb : mta, (L - 1) >> 1);
  }
  const int last = (L - 1) >> 1;
  const float F_last = __shfl_sync(kFull, ((L - 1) & 1) ? Fb : Fa, last);
  const float m_last = __shfl_sync(kFull, ((L - 1) & 1) ? mtb : mta, last);
  const float Fs[2] = {Fa, Fb}, is[2] = {ia, ibb}, ms[2] = {mta, mtb};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int s = ta + e;
    if (s >= kL) continue;
    const bool in = s < L;
    gz[kF + s] = in ? Fs[e] : 0.0f;
    gz[kI + s] = in ? is[e] : 0.0f;
    gz[kMT + s] = in ? ms[e] : 0.0f;
    gz[kA + s] = in ? expf(Fs[e] + m - ms[e]) : 0.0f;
    gz[kW + s] = in ? expf(F_last - Fs[e] + is[e] - m_last) : 0.0f;
  }
  if (lane == 0) {
    gz[kDec] = expf(F_last + m - m_last);
    gz[kMp] = m;
  }
}

// Per step of each (row, chunk): den_t from Sm (q . k, unscaled) and
// q . n, the denominator's factor r = 1 / max(|den|, e^{-m_t}) and
// dden_t into step [2]; dnum_t = dh_t r and aq_t = a_t q~_t (B, H, S, dh).
// A warp per step.
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_den(const float* __restrict__ q, const float* __restrict__ h,
              const float* __restrict__ dh_, const float* __restrict__ nst,
              const float* __restrict__ gates, const float* __restrict__ Sm,
              float* __restrict__ step, float* __restrict__ dnum,
              float* __restrict__ aq, int S, int H, int dh, int L,
              float scale) {
  const int z = blockIdx.x, nc = S / L, bh = z / nc, c = z - bh * nc;
  const int b = bh / H, hh = bh - b * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* gz = gates + (size_t)z * kGB;
  const float* n = nst + (size_t)z * dh;
  const float* sz = Sm + (size_t)z * L * L;
  for (int t = warp; t < L; t += kThreads / 32) {
    const size_t row = (((size_t)b * S + c * L + t) * H + hh) * dh;
    const size_t out = ((size_t)bh * S + c * L + t) * dh;
    float qn = 0.0f, dhh = 0.0f;
    for (int d = lane; d < dh; d += 32) {
      qn = fmaf(q[row + d], n[d], qn);
      dhh = fmaf(dh_[row + d], h[row + d], dhh);
    }
    const float Ft = gz[kF + t], mt = gz[kMT + t], at = gz[kA + t];
    float intra = 0.0f;
    for (int s = lane; s <= t; s += 32)
      intra += expf((Ft - mt) + (gz[kI + s] - gz[kF + s])) * scale *
               sz[t * L + s];
    qn = warp_sum(qn);
    dhh = warp_sum(dhh);
    intra = warp_sum(intra);
    const float den = at * scale * qn + intra, lo = expf(-mt);
    const float r = 1.0f / fmaxf(fabsf(den), lo);
    const float dden = fabsf(den) > lo ? -copysignf(1.0f, den) * dhh * r
                                       : 0.0f;
    if (lane == 0) {
      step[2 * ((size_t)z * L + t)] = r;
      step[2 * ((size_t)z * L + t) + 1] = dden;
    }
    for (int d = lane; d < dh; d += 32) {
      dnum[out + d] = dh_[row + d] * r;
      aq[out + d] = at * scale * q[row + d];
    }
  }
}

// dS~ = (dP + dden_t) D scale and the masked P = D scale (q . k) of each
// (row, chunk), [t][s], zero past the diagonal; and the log-weights'
// gradient (dP + dden_t) P summed over s (rows) and over t (columns).
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_ds(const float* __restrict__ gates, const float* __restrict__ step,
             const float* __restrict__ Sm, const float* __restrict__ dPm,
             float* __restrict__ dSt, float* __restrict__ Pm,
             float* __restrict__ ggr, int L, float scale) {
  __shared__ float lg[kL * (kL + 1)];
  __shared__ float Fm[kL], iF[kL], dd[kL];
  const int z = blockIdx.x, tid = threadIdx.x;
  const float* gz = gates + (size_t)z * kGB;
  const size_t base = (size_t)z * L * L;
  if (tid < L) {
    Fm[tid] = gz[kF + tid] - gz[kMT + tid];
    iF[tid] = gz[kI + tid] - gz[kF + tid];
    dd[tid] = step[2 * ((size_t)z * L + tid) + 1];
  }
  __syncthreads();
  for (int i = tid; i < L * L; i += kThreads) {
    const int t = i / L, s = i - t * L;
    float ds = 0.0f, p = 0.0f, l = 0.0f;
    if (s <= t) {
      const float D = expf(Fm[t] + iF[s]);
      const float dP = dPm[base + i] + dd[t];
      p = D * scale * Sm[base + i];
      ds = dP * D * scale;
      l = dP * p;
    }
    dSt[base + i] = ds;
    Pm[base + i] = p;
    lg[t * (kL + 1) + s] = l;
  }
  __syncthreads();
  float* gg = ggr + (size_t)z * kGG;
  if (tid < L) {
    float rs = 0.0f;
    for (int s = 0; s < L; ++s) rs += lg[tid * (kL + 1) + s];
    gg[kRS + tid] = rs;
  } else if (tid >= kL && tid < kL + L) {
    const int s = tid - kL;
    float cs = 0.0f;
    for (int t = 0; t < L; ++t) cs += lg[t * (kL + 1) + s];
    gg[kCS + s] = cs;
  }
}

// The gradient of n after each chunk, in reverse: dn of the last chunk
// is 0 and dn_{c-1} = decay_c dn_c + sum_t dden_t aq_t; and G of the
// last chunk zeroed.  A thread per (row, dimension).
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_dn(const float* __restrict__ aq, const float* __restrict__ step,
             const float* __restrict__ gates, float* __restrict__ dnc,
             float* __restrict__ G, int S, int dh, int L) {
  const int nc = S / L, bh = blockIdx.y;
  float* gl = G + ((size_t)bh * nc + nc - 1) * dh * dh;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x;
       i < (size_t)dh * dh; i += (size_t)gridDim.x * kThreads)
    gl[i] = 0.0f;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= dh) return;
  float acc = 0.0f;
  dnc[((size_t)bh * nc + nc - 1) * dh + d] = 0.0f;
  for (int c = nc - 1; c >= 1; --c) {
    const size_t z = (size_t)bh * nc + c;
    float sum = 0.0f;
    for (int t = 0; t < L; ++t)
      sum = fmaf(step[2 * (z * L + t) + 1],
                 aq[((size_t)bh * S + c * L + t) * dh + d], sum);
    acc = fmaf(gates[z * kGB + kDec], acc, sum);
    dnc[(z - 1) * dh + d] = acc;
  }
}

// d decay of each (row, chunk): <G, C> + <dn, n>, in a fixed order.
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_dot(const float* __restrict__ G, const float* __restrict__ Cst,
              const float* __restrict__ dnc, const float* __restrict__ nst,
              float* __restrict__ ggr, int dh) {
  __shared__ float red[kThreads];
  const int z = blockIdx.x, tid = threadIdx.x;
  const size_t n2 = (size_t)dh * dh;
  const float* gz = G + (size_t)z * n2;
  const float* cz = Cst + (size_t)z * n2;
  float sum = 0.0f;
  for (size_t i = tid; i < n2; i += kThreads) sum = fmaf(gz[i], cz[i], sum);
  for (int d = tid; d < dh; d += kThreads)
    sum = fmaf(dnc[(size_t)z * dh + d], nst[(size_t)z * dh + d], sum);
  red[tid] = sum;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w) red[tid] += red[tid + w];
    __syncthreads();
  }
  if (tid == 0) ggr[(size_t)z * kGG + kDD] = red[0];
}

// dq, dk, dv of each step from the products' parts, into the model
// layout, and da_t, dw_s for the gates.  A warp per step.
__global__ void __launch_bounds__(kThreads)
mlstm_bwd_out(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ nst, const float* __restrict__ dnc,
              const float* __restrict__ gates, const float* __restrict__ step,
              const float* __restrict__ u, const float* __restrict__ x,
              const float* __restrict__ y, const float* __restrict__ dSq,
              const float* __restrict__ dSk, const float* __restrict__ Pd,
              float* __restrict__ dq, float* __restrict__ dk,
              float* __restrict__ dv, float* __restrict__ ggr, int S, int H,
              int dh, int L, float scale) {
  const int z = blockIdx.x, nc = S / L, bh = z / nc, c = z - bh * nc;
  const int b = bh / H, hh = bh - b * H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* gz = gates + (size_t)z * kGB;
  const float* n = nst + (size_t)z * dh;
  const float* dn = dnc + (size_t)z * dh;
  float* gg = ggr + (size_t)z * kGG;
  for (int t = warp; t < L; t += kThreads / 32) {
    const size_t row = (((size_t)b * S + c * L + t) * H + hh) * dh;
    const size_t w = ((size_t)bh * S + c * L + t) * dh;
    const float at = gz[kA + t], wt = gz[kW + t];
    const float dd = step[2 * ((size_t)z * L + t) + 1];
    float sa = 0.0f, sw = 0.0f;
    for (int d = lane; d < dh; d += 32) {
      const float qc = u[w + d] + dd * n[d];  // C dnum_t + dden_t n
      const float kc = x[w + d] + dn[d];      // G v_t + dn
      dq[row + d] = scale * at * qc + dSq[w + d];
      dk[row + d] = wt * kc + dSk[w + d];
      dv[row + d] = wt * y[w + d] + Pd[w + d];
      sa = fmaf(q[row + d], qc, sa);
      sw = fmaf(k[row + d], kc, sw);
    }
    sa = warp_sum(sa);
    sw = warp_sum(sw);
    if (lane == 0) {
      gg[kDA + t] = scale * sa;
      gg[kDW + t] = sw;
    }
  }
}

// di and df of each (row, chunk) from the gradient sums: dF_t, then the
// reverse sum over the chunk for dlogsigmoid(f), times sigmoid(-f).
__global__ void __launch_bounds__(kL)
mlstm_bwd_gate_grads(const float* __restrict__ fg,
                     const float* __restrict__ gates,
                     const float* __restrict__ ggr, float* __restrict__ di,
                     float* __restrict__ df, int S, int H, int L) {
  __shared__ float dF[kL], dwv[kL];
  const int z = blockIdx.x, nc = S / L, bh = z / nc, c = z - bh * nc;
  const int b = bh / H, hh = bh - b * H, t = threadIdx.x;
  const float* gz = gates + (size_t)z * kGB;
  const float* gg = ggr + (size_t)z * kGG;
  const size_t at = ((size_t)b * S + c * L + t) * H + hh;
  if (t < L) {
    const float ww = gg[kDW + t] * gz[kW + t];
    dwv[t] = ww;
    dF[t] = gg[kRS + t] - gg[kCS + t] + gg[kDA + t] * gz[kA + t] - ww;
    di[at] = gg[kCS + t] + ww;
  }
  __syncthreads();
  if (t == 0) {  // F_L's terms, then the reverse sum, in order
    float tail = gg[kDD] * gz[kDec];
    for (int s = 0; s < L; ++s) tail += dwv[s];
    dF[L - 1] += tail;
    float run = 0.0f;
    for (int s = L - 1; s >= 0; --s) {
      run += dF[s];
      dF[s] = run;
    }
  }
  __syncthreads();
  if (t < L) df[at] = dF[t] / (1.0f + expf(fg[at]));
}

namespace {

Op op(const float* p, long long sb, long long sh, long long sc, int ld) {
  return Op{p, sb, sh, sc, ld};
}

template <bool TA, bool TB>
cudaError_t gemm(const GemmArgs& g, int nz, cudaStream_t st) {
  const dim3 grid((g.N + kBN - 1) / kBN, (g.M + kBM - 1) / kBM, nz);
  mlstm_bwd_gemm<TA, TB><<<grid, kThreads, 0, st>>>(g);
  return cudaGetLastError();
}

size_t up4(size_t n) { return (n + 3) / 4 * 4; }

// The workspace's parts, in floats, in order.
struct Work {
  size_t gates, step, ggr, Sm, dPm, dSt, Pm, dnum, aq, u, x, y, dSq, dSk, Pd,
      dnc, G, total;
  Work(int B, int S, int H, int dh, int L) {
    const size_t Z = (size_t)B * H * (S / L), N = (size_t)B * H * S * dh;
    const size_t LL = (size_t)B * H * S * L;
    size_t at = 0;
    auto take = [&](size_t n) {
      const size_t here = at;
      at += up4(n);
      return here;
    };
    gates = take(Z * kGB);
    step = take(2 * (size_t)B * H * S);
    ggr = take(Z * kGG);
    Sm = take(LL);
    dPm = take(LL);
    dSt = take(LL);
    Pm = take(LL);
    dnum = take(N);
    aq = take(N);
    u = take(N);
    x = take(N);
    y = take(N);
    dSq = take(N);
    dSk = take(N);
    Pd = take(N);
    dnc = take(Z * dh);
    G = take(Z * dh * dh);
    total = at;
  }
};

}  // namespace

extern "C" int tryage_mlstm_scan_bwd(
    const float* q, const float* k, const float* v, const float* ig,
    const float* fg, const float* m0, const float* Cst, const float* nst,
    const float* h, const float* dh_, float* dq, float* dk, float* dv,
    float* di, float* df, float* work, int B, int S, int H, int dh, int L,
    float scale, void* stream) {
  if (B <= 0 || H <= 0 || dh <= 0) return 0;
  if (S <= 0 || L <= 0 || L > kL || S % L || dh % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nc = S / L, BH = B * H, Z = BH * nc;
  const Work w(B, S, H, dh, L);
  float* gates = work + w.gates;
  float* step = work + w.step;
  float* ggr = work + w.ggr;
  float* Sm = work + w.Sm;
  float* dPm = work + w.dPm;
  float* dSt = work + w.dSt;
  float* Pm = work + w.Pm;
  float* dnum = work + w.dnum;
  float* aq = work + w.aq;
  float* G = work + w.G;
  float* dnc = work + w.dnc;
  // layouts of a (row, chunk): the model's (B, S, H, dh), the workspace's
  // (B, H, S, dh) and (B, H, S / L, L, L), and the states (B, H, S / L,
  // dh, dh)
  const long long D = dh, SD = (long long)S * dh, LD = (long long)L * dh;
  const long long HD = (long long)H * dh;
  const long long SL = (long long)S * L, LL = (long long)L * L;
  const long long D2 = D * D;
  auto model = [&](const float* p) { return op(p, S * HD, D, L * HD, H * dh); };
  auto rows = [&](const float* p) { return op(p, H * SD, SD, LD, dh); };
  auto sq = [&](const float* p) { return op(p, H * SL, SL, LL, L); };
  auto state = [&](const float* p) {
    return op(p, H * nc * D2, nc * D2, D2, dh);
  };
  const Op none = op(nullptr, 0, 0, 0, 0);
  cudaError_t err;
#define TRYAGE_CHECK(x)            \
  if ((err = (x)) != cudaSuccess) \
    return (int)err;

  mlstm_bwd_gates<<<dim3(nc, BH), 32, 0, st>>>(ig, fg, m0, gates, S, H, L);
  TRYAGE_CHECK(cudaGetLastError());
  // S = q k^T
  TRYAGE_CHECK((gemm<false, true>(
      {model(q), model(k), none, sq(Sm), nullptr, 0, L, L, dh, H, nc}, Z, st)));
  mlstm_bwd_den<<<Z, kThreads, 0, st>>>(q, h, dh_, nst, gates, Sm, step, dnum,
                                        aq, S, H, dh, L, scale);
  TRYAGE_CHECK(cudaGetLastError());
  // dP = dnum v^T
  TRYAGE_CHECK((gemm<false, true>(
      {rows(dnum), model(v), none, sq(dPm), nullptr, 0, L, L, dh, H, nc}, Z,
      st)));
  mlstm_bwd_ds<<<Z, kThreads, 0, st>>>(gates, step, Sm, dPm, dSt, Pm, ggr, L,
                                       scale);
  TRYAGE_CHECK(cudaGetLastError());
  mlstm_bwd_dn<<<dim3((dh + kThreads - 1) / kThreads, BH), kThreads, 0, st>>>(
      aq, step, gates, dnc, G, S, dh, L);
  TRYAGE_CHECK(cudaGetLastError());
  // G_{c-1} = decay_c G_c + aq_c^T dnum_c, chunk by chunk in reverse
  for (int c = nc - 1; c >= 1; --c) {
    const float* aqc = aq + (size_t)c * LD;
    const float* dnc_c = dnum + (size_t)c * LD;
    const Op gc = op(G + c * D2, H * nc * D2, nc * D2, 0, dh);
    const Op gp = op(G + (c - 1) * D2, H * nc * D2, nc * D2, 0, dh);
    TRYAGE_CHECK((gemm<true, false>(
        {op(aqc, H * SD, SD, 0, dh), op(dnc_c, H * SD, SD, 0, dh), gc, gp,
         gates + (size_t)c * kGB + kDec, (long long)nc * kGB, dh, dh, L, H, 1},
        BH, st)));
  }
  float* u = work + w.u;
  float* x = work + w.x;
  float* y = work + w.y;
  // u = dnum C^T, x = v G^T, y = k G
  TRYAGE_CHECK((gemm<false, true>(
      {rows(dnum), state(Cst), none, rows(u), nullptr, 0, L, dh, dh, H, nc}, Z,
      st)));
  TRYAGE_CHECK((gemm<false, true>(
      {model(v), state(G), none, rows(x), nullptr, 0, L, dh, dh, H, nc}, Z,
      st)));
  TRYAGE_CHECK((gemm<false, false>(
      {model(k), state(G), none, rows(y), nullptr, 0, L, dh, dh, H, nc}, Z,
      st)));
  mlstm_bwd_dot<<<Z, kThreads, 0, st>>>(G, Cst, dnc, nst, ggr, dh);
  TRYAGE_CHECK(cudaGetLastError());
  float* dSq = work + w.dSq;
  float* dSk = work + w.dSk;
  float* Pd = work + w.Pd;
  // dS~ k, dS~^T q, P^T dnum
  TRYAGE_CHECK((gemm<false, false>(
      {sq(dSt), model(k), none, rows(dSq), nullptr, 0, L, dh, L, H, nc}, Z,
      st)));
  TRYAGE_CHECK((gemm<true, false>(
      {sq(dSt), model(q), none, rows(dSk), nullptr, 0, L, dh, L, H, nc}, Z,
      st)));
  TRYAGE_CHECK((gemm<true, false>(
      {sq(Pm), rows(dnum), none, rows(Pd), nullptr, 0, L, dh, L, H, nc}, Z,
      st)));
  mlstm_bwd_out<<<Z, kThreads, 0, st>>>(q, k, nst, dnc, gates, step, u, x, y,
                                        dSq, dSk, Pd, dq, dk, dv, ggr, S, H,
                                        dh, L, scale);
  TRYAGE_CHECK(cudaGetLastError());
  mlstm_bwd_gate_grads<<<Z, kL, 0, st>>>(fg, gates, ggr, di, df, S, H, L);
  TRYAGE_CHECK(cudaGetLastError());
#undef TRYAGE_CHECK
  return 0;
}

// Floats of workspace tryage_mlstm_scan_bwd needs, for the wrapper.
extern "C" long long tryage_mlstm_scan_bwd_workspace(int B, int S, int H,
                                                     int dh, int L) {
  if (B <= 0 || H <= 0 || S <= 0 || dh <= 0 || L <= 0 || S % L) return 0;
  return (long long)Work(B, S, H, dh, L).total;
}
