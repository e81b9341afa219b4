// Chunkwise mLSTM recurrence (xLSTM) on Hopper, f32, in the model layout:
//   q, k, v, h (B, S, H, dh);  i, f (B, S, H);
//   C0, C1 (B, H, dh, dh);  n0, n1 (B, H, dh);  m0, m1 (B, H).
// Replaces the Pallas kernel _mlstm_kernel (mlstm_chunkwise_bh) of
// src/repro/kernels/mlstm_scan/kernel.py.  Per (batch, head) row the
// sequence is walked in chunks of L steps (L divides S, L <= 64); in a
// chunk, with q scaled by 1/sqrt(dh),
//   F = cumsum(logsigmoid(f)),  g = cummax(i - F),  m_t = F + max(m, g)
//   num_t = e^{F_t + m - m_t} q_t C + sum_{s<=t} e^{F_t - F_s + i_s - m_t}
//           (q_t . k_s) v_s,   den_t likewise with n and 1 in place of C, v
//   h_t = num_t / max(|den_t|, e^{-m_t})
// and the chunk's end updates C, n and m (the closed form in the Pallas
// kernel's docstring).  Masked (s > t) weights are exactly 0;
// logsigmoid is min(x, 0) - log1p(exp(-|x|)); dh is a multiple of 8.
//
// Bound on the H100: at the serving shape (dh = 1024, L = 64) the
// operations (about 4 L^2 dh + 4 L dh^2 per row and chunk) outweigh
// the bytes (q, k, v, h, C0, C1) on the f32 CUDA cores and, at three
// TF32 passes per product, on the tensor cores too.  Every product
// runs on the tensor cores in 3xTF32 (mma_tf32.cuh), which keeps f32
// accuracy.  The design is two launches:
//
// 1. mlstm_scan_chunk_kernel, one block of 4 warps per (row, chunk):
//    the work that depends on neither the state nor the columns of C.
//    S = q k^T (L x L, dh streamed in 32-wide slices, cp.async double
//    buffer) runs on the tensor cores.  One warp scans the gates with
//    shuffles: it walks the row's earlier chunks to find the stabiliser
//    m at this chunk's start (a scalar recurrence, at most S / L short
//    scans, so every chunk runs in parallel), then F, g and m_t of its
//    own chunk.  The block writes P = W * S (L x L) and the chunk's
//    per-step factors (e^{F_t + m - m_t}, the row sums of P, m_t, the
//    update weights e^{F_L - F_s + i_s - m_L}, the decay) to a
//    workspace, and the last chunk writes m1.
// 2. mlstm_scan_kernel, one block of 8 warps per (row, 32 columns of C
//    and h), walks the chunks in order.  Its 32 columns of C stay in
//    shared memory for the whole sequence (dh x 32 floats, 128 KB at
//    dh = 1024, swizzled so both fragment loads are conflict-free):
//    C is read once from C0 and written once to C1.  Per chunk, q and
//    k stream through shared memory in 64-wide slices of dh (cp.async
//    double buffer).  Step j of a chunk adds q C[slice j] to the h
//    accumulators and updates C[slice j - 1] (rows the first does not
//    read), with one barrier a step while q slice j + 1 and k slice j
//    load.  q C is split over k: warp w takes k-step w of the slice for
//    all 4 x 4 output tiles, so each element of q and C is split into
//    TF32 halves once (a warp per output tile would split each C
//    element four times); the 8 partial sums meet in shared memory at
//    the chunk's end, in f32.  The update is C = decay C + (k w)^T v
//    with C as the accumulator, a warp per 16 x 16 tile; with two tiles
//    a warp, each TF32 pass gets its own accumulator, so three chains
//    of mma.sync run side by side rather than one.  v is split once
//    per chunk and kept split in shared memory; the update weights stay
//    in registers.  Last, h = (e^{..} q C + P v) / max(|den|, e^{-m_t}),
//    P v on the tensor cores too.  n is one vector per row; each block
//    keeps it in shared memory, q . n rides along q C as column 0 of one
//    more n-tile, and the n update runs on the CUDA cores, in the same
//    order in every block (1/32 of the block's products); block 0 of
//    the row writes n1.
//    Each product's accumulation chain is short (the tensor cores'
//    f32 accumulation rounds toward zero, so a chain over all of dh
//    would add a bias of about 3 dh / 8 ulps): launch 1 adds a fresh
//    accumulator per 32-wide slice to its sum, launch 2's split over
//    k leaves each warp 3 dh / 64 chained steps.
//
// With non-null Cst (B, H, S / L, dh, dh), nst (B, H, S / L, dh) and mst
// (B, H, S / L), C, n and the stabiliser m as they stand at each chunk's
// start are written too (launch 2 writes C and n, launch 1 m), for the
// backward when it takes chunks shorter than the sequence
// (mlstm_scan_bwd.cu); serving and one-chunk backwards pass null.
//
// The C entry point launches both, so the wrapper counts one launch.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

using tryage::Split;
using tryage::split_tf32;

constexpr int kL = 64;              // most steps per chunk
constexpr int kG = 4 * kL + 4;      // per-chunk factors: a, rs, m_t, w, decay
constexpr int kA = 0, kRS = kL, kMT = 2 * kL, kW = 3 * kL, kDecay = 4 * kL;
constexpr unsigned kFull = 0xffffffffu;

// launch 1
constexpr int kThreads1 = 128;
constexpr int kK1 = 32;             // dh slice
constexpr int kP1 = kK1 + 4;        // padded q/k row: conflict-free loads

// launch 2
constexpr int kThreads2 = 256;
constexpr int kCols = 32;           // columns of C and h per block
constexpr int kKS = 64;             // dh slice
constexpr int kQS = kKS + 4;        // q row: A loads (row g, col t)
constexpr int kKP = kKS + 8;        // k row: transposed A loads (col g, row t)
constexpr int kVS = kCols + 8;      // v row: B loads (row t, col g)
constexpr int kRed = 8 * 16 * 4 * 32;  // the warps' partial q C tiles
static_assert(kRed + 8 * kL <= 2 * kL * (kQS + kKP),
              "the chunk-end partials reuse the q/k buffers");

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

// C slice index: row r, column c of the block's 32; the XOR spreads the
// 4 rows of a B fragment (and the 8 rows of an accumulator) over banks
__device__ __forceinline__ int cidx(int r, int c) {
  return r * kCols + (c ^ ((r & 3) << 3));
}

struct BFrag {  // a B fragment, split
  Split b[2];
};

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

}  // namespace

extern "C" __global__ void __launch_bounds__(kThreads1)
mlstm_scan_chunk_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ ig, const float* __restrict__ fg,
                        const float* __restrict__ m0, float* __restrict__ work,
                        float* __restrict__ m1, float* __restrict__ mst, int S,
                        int H, int dh, int L, float scale, size_t gate_off) {
  __shared__ __align__(16) float qk_s[2][2][kL * kP1];
  __shared__ float F_s[kL], i_s[kL], mt_s[kL];
  __shared__ float mprev_s;

  const int c = blockIdx.x, nc = gridDim.x, bh = blockIdx.y;
  const int b = bh / H, hh = bh - b * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t step = (size_t)H * dh;
  const size_t base = (size_t)b * S * step + (size_t)hh * dh + (size_t)c * L * step;
  const float* ib = ig + (size_t)b * S * H + hh;  // stride H per step
  const float* fb = fg + (size_t)b * S * H + hh;
  float* P = work + ((size_t)bh * S + (size_t)c * L) * L;
  float* gates = work + gate_off + ((size_t)bh * nc + c) * kG;

  auto stage = [&](int sl, int buf) {
    for (int i = tid; i < kL * (kK1 / 4); i += kThreads1) {
      const int row = i / (kK1 / 4), col = (i % (kK1 / 4)) * 4;
      const int d = sl * kK1 + col;
      const bool in = row < L && d < dh;
      const size_t off = in ? base + (size_t)row * step + d : 0;
      tryage::cp_async16(&qk_s[buf][0][row * kP1 + col], q + off, in);
      tryage::cp_async16(&qk_s[buf][1][row * kP1 + col], k + off, in);
    }
    tryage::cp_async_commit();
  };
  const int n_slices = (dh + kK1 - 1) / kK1;
  stage(0, 0);

  // ---- gates (warp 0): m at this chunk's start, then F, i, m_t.  Lane
  // holds steps 2 lane and 2 lane + 1.
  if (warp == 0) {
    float m = m0[bh];
    const int ta = 2 * lane, tb = ta + 1;
    for (int cc = 0; cc <= c; ++cc) {
      const size_t s0 = (size_t)cc * L;
      const float fa = ta < L ? log_sigmoid(fb[(s0 + ta) * H]) : 0.0f;
      const float fbb = tb < L ? log_sigmoid(fb[(s0 + tb) * H]) : 0.0f;
      const float ia = ta < L ? ib[(s0 + ta) * H] : 0.0f;
      const float ibb = tb < L ? ib[(s0 + tb) * H] : 0.0f;
      float incl = fa + fbb;
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += y;
      }
      float excl = __shfl_up_sync(kFull, incl, 1);
      if (lane == 0) excl = 0.0f;
      const float Fa = excl + fa, Fb = Fa + fbb;
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
      const float mta = Fa + fmaxf(m, Ga), mtb = Fb + fmaxf(m, Gb);
      if (cc < c) {
        m = __shfl_sync(kFull, ((L - 1) & 1) ? mtb : mta, (L - 1) >> 1);
      } else {
        if (ta < L) F_s[ta] = Fa, i_s[ta] = ia, mt_s[ta] = mta;
        if (tb < L) F_s[tb] = Fb, i_s[tb] = ibb, mt_s[tb] = mtb;
        if (lane == 0) {
          mprev_s = m;
          if (mst != nullptr) mst[(size_t)bh * nc + c] = m;
        }
      }
    }
  }

  // ---- S = q k^T: warp w owns rows 16 w .. 16 w + 15, all 64 keys
  float sacc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) sacc[j][e] = 0.0f;
  const bool active = 16 * warp < L;
  for (int sl = 0; sl < n_slices; ++sl) {
    if (sl + 1 < n_slices) {
      stage(sl + 1, (sl + 1) & 1);
      tryage::cp_async_wait<1>();
    } else {
      tryage::cp_async_wait<0>();
    }
    __syncthreads();
    const float* qs = qk_s[sl & 1][0];
    const float* ks = qk_s[sl & 1][1];
    if (active) {
      // a fresh accumulator per slice, added to sacc in f32: the tensor
      // cores' accumulation rounds toward zero, so one chain over all
      // of dh would carry a bias of about (3 dh / 8) ulps
      float part[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kK1 / 8; ++kk) {
        const float* qa = qs + (16 * warp + g) * kP1 + 8 * kk + t;
        const Split a[4] = {split_tf32(qa[0] * scale),
                            split_tf32(qa[8 * kP1] * scale),
                            split_tf32(qa[4] * scale),
                            split_tf32(qa[8 * kP1 + 4] * scale)};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float* kr = ks + (8 * j + g) * kP1 + 8 * kk + t;
          const Split bb[2] = {split_tf32(kr[0]), split_tf32(kr[4])};
          tryage::mma_3xtf32(part[j], a, bb);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[j][e] += part[j][e];
    }
    __syncthreads();  // this buffer is reloaded two slices on
  }

  // ---- P = W * S and its row sums
  const float mprev = mprev_s;
  if (active) {
    float rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * warp + g + 8 * (e >> 1);
        const int col = 8 * j + 2 * t + (e & 1);
        float p = 0.0f;
        if (row < L && col <= row)
          p = expf((F_s[row] - mt_s[row]) + (i_s[col] - F_s[col])) * sacc[j][e];
        rs[e >> 1] += p;
        if (row < L && col < L) P[row * L + col] = p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float sum = quad_sum(rs[r]);
      const int row = 16 * warp + g + 8 * r;
      if (t == 0 && row < L) gates[kRS + row] = sum;
    }
  }
  const float F_last = F_s[L - 1], m_last = mt_s[L - 1];
  if (tid < kL) {
    const bool in = tid < L;
    gates[kA + tid] = in ? expf(F_s[tid] + mprev - mt_s[tid]) : 0.0f;
    gates[kMT + tid] = in ? mt_s[tid] : 0.0f;
    gates[kW + tid] = in ? expf(F_last - F_s[tid] + i_s[tid] - m_last) : 0.0f;
    if (!in) gates[kRS + tid] = 0.0f;
  } else if (tid < kL + 4) {
    gates[kDecay + tid - kL] = tid == kL ? expf(F_last + mprev - m_last) : 0.0f;
  }
  if (tid == 0 && c == nc - 1) m1[bh] = m_last;
}

extern "C" __global__ void __launch_bounds__(kThreads2, 1)
mlstm_scan_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ C0,
                  const float* __restrict__ n0, const float* __restrict__ work,
                  float* __restrict__ h, float* __restrict__ C1,
                  float* __restrict__ n1, float* __restrict__ Cst,
                  float* __restrict__ nst, int S, int H, int dh, int L,
                  float scale, size_t gate_off) {
  extern __shared__ __align__(16) float smem[];
  const int rows = (dh + kKS - 1) / kKS * kKS;
  const int n_slices = rows / kKS;
  float* c_s = smem;                        // rows x 32, swizzled
  float* q_s = c_s + rows * kCols;          // 2 x kL x kQS
  float* k_s = q_s + 2 * kL * kQS;          // 2 x kL x kKP
  float* v_s = k_s + 2 * kL * kKP;          // kL x kVS: v, then its big half
  float* vsm_s = v_s + kL * kVS;            // kL x kVS: v's small half
  float* n_s = vsm_s + kL * kVS;            // rows
  float* g_s = n_s + rows;                  // kG
  float* den_s = g_s + kG;                  // kL
  // at a chunk's end, in the free q/k buffers: the 8 warps' partial
  // q C (16 tiles each) and q . n (kL rows each)
  float* red_s = q_s;
  float* red_qn = red_s + kRed;

  const int bh = blockIdx.x, col0 = blockIdx.y * kCols;
  const int nc = S / L;
  const int b = bh / H, hh = bh - b * H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp >> 1, nt0 = (warp & 1) * 2;  // m-tile, first n-tile
  const size_t step = (size_t)H * dh;
  const size_t base = (size_t)b * S * step + (size_t)hh * dh;
  const float* c_in = C0 + (size_t)bh * dh * dh;

  // the block's columns of C and the row's n, once
  for (int i = tid; i < rows * (kCols / 4); i += kThreads2) {
    const int r = i / (kCols / 4), cc = (i % (kCols / 4)) * 4;
    const bool in = r < dh && col0 + cc < dh;
    tryage::cp_async16(c_s + cidx(r, cc),
                       c_in + (in ? (size_t)r * dh + col0 + cc : 0), in);
  }
  for (int d = 4 * tid; d < rows; d += 4 * kThreads2)
    tryage::cp_async16(n_s + d, n0 + (size_t)bh * dh + (d < dh ? d : 0), d < dh);
  tryage::cp_async_commit();

  // rows of q or k for chunk c, dh slice sl, into buffer buf (rows
  // past L and columns past dh are zero-filled)
  auto stage = [&](const float* src, float* dst, int pitch, int c, int sl,
                   int buf) {
    dst += buf * kL * pitch;
    for (int i = tid; i < kL * (kKS / 4); i += kThreads2) {
      const int row = i / (kKS / 4), cc = (i % (kKS / 4)) * 4;
      const int d = sl * kKS + cc;
      const bool in = row < L && d < dh;
      const size_t off = in ? base + (size_t)(c * L + row) * step + d : 0;
      tryage::cp_async16(dst + row * pitch + cc, src + off, in);
    }
  };

  // v's B fragments, split: rows 8 s8 + t and 8 s8 + t + 4, columns of
  // n-tile nt0 + jj
  auto v_frag = [&](int s8, int jj) {
    const int idx = (8 * s8 + t) * kVS + 8 * (nt0 + jj) + g;
    return BFrag{{{__float_as_uint(v_s[idx]), __float_as_uint(vsm_s[idx])},
                  {__float_as_uint(v_s[idx + 4 * kVS]),
                   __float_as_uint(vsm_s[idx + 4 * kVS])}}};
  };

  for (int c = 0; c < nc; ++c) {
    __syncthreads();  // the previous chunk is done with every buffer
    for (int i = tid; i < kL * (kCols / 4); i += kThreads2) {
      const int row = i / (kCols / 4), cc = (i % (kCols / 4)) * 4;
      const bool in = row < L && col0 + cc < dh;
      const size_t off = in ? base + (size_t)(c * L + row) * step + col0 + cc : 0;
      tryage::cp_async16(v_s + row * kVS + cc, v + off, in);
    }
    const float* gsrc = work + gate_off + ((size_t)bh * nc + c) * kG;
    for (int i = 4 * tid; i < kG; i += 4 * kThreads2)
      tryage::cp_async16(g_s + i, gsrc + i, true);
    stage(q, q_s, kQS, c, 0, 0);
    tryage::cp_async_commit();  // v, the factors and q slice 0

    // q C and q . n, split over k: warp w takes k-step w of every slice
    // for all 4 x 4 output tiles and n's column, so each q and C element
    // is split once
    float hacc[4][4][4], nacc[4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        nacc[mi][e] = 0.0f;
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) hacc[mi][ni][e] = 0.0f;
      }
    // held for the whole chunk: the update weights w_s of the steps
    // s = t + 4 i
    float wv[kL / 4];

    // step j: q C for slice j and the update of slice j - 1 (disjoint
    // rows of C and n), one barrier a step; q slice j + 1 and k slice j
    // load meanwhile into the buffers step j - 1 read
    for (int j = 0; j <= n_slices; ++j) {
      tryage::cp_async_wait<0>();
      __syncthreads();
      if (j + 1 < n_slices) stage(q, q_s, kQS, c, j + 1, (j + 1) & 1);
      if (j < n_slices) stage(k, k_s, kKP, c, j, j & 1);
      tryage::cp_async_commit();

      if (j == 0) {  // split v once for the chunk, in place
        if (Cst != nullptr) {  // C and n at the chunk's start, for the backward
          float* cz = Cst + ((size_t)bh * nc + c) * dh * dh;
          for (int i = tid; i < dh * (kCols / 4); i += kThreads2) {
            const int r = i / (kCols / 4), cc = (i % (kCols / 4)) * 4;
            if (col0 + cc < dh)
              *reinterpret_cast<float4*>(cz + (size_t)r * dh + col0 + cc) =
                  *reinterpret_cast<const float4*>(c_s + cidx(r, cc));
          }
          if (blockIdx.y == 0)
            for (int d = tid; d < dh; d += kThreads2)
              nst[((size_t)bh * nc + c) * dh + d] = n_s[d];
        }
#pragma unroll
        for (int i = 0; i < kL / 4; ++i) wv[i] = g_s[kW + t + 4 * i];
        for (int i = tid; i < kL * kCols; i += kThreads2) {
          const int idx = (i / kCols) * kVS + i % kCols;
          const Split x = split_tf32(v_s[idx]);
          v_s[idx] = __uint_as_float(x.big);
          vsm_s[idx] = __uint_as_float(x.small);
        }
      }

      if (j < n_slices) {
        // h accumulators += q[:, slice] C[slice, cols], and q . n
        const float* qs = q_s + (j & 1) * kL * kQS;
        const int r = j * kKS + 8 * warp + t;
        Split bb[4][2];
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          bb[ni][0] = split_tf32(c_s[cidx(r, 8 * ni + g)]);
          bb[ni][1] = split_tf32(c_s[cidx(r + 4, 8 * ni + g)]);
        }
        // n as column 0 of an n-tile whose other columns are 0
        const Split bn[2] = {split_tf32(g == 0 ? n_s[r] : 0.0f),
                             split_tf32(g == 0 ? n_s[r + 4] : 0.0f)};
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          if (16 * mi >= L) break;
          const float* qa = qs + (16 * mi + g) * kQS + 8 * warp + t;
          const Split a[4] = {split_tf32(qa[0] * scale),
                              split_tf32(qa[8 * kQS] * scale),
                              split_tf32(qa[4] * scale),
                              split_tf32(qa[8 * kQS + 4] * scale)};
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) tryage::mma_3xtf32(hacc[mi][ni], a, bb[ni]);
          tryage::mma_3xtf32(nacc[mi], a, bn);
        }
      }

      if (j > 0) {
        // C[slice, cols] = decay C + (k w)^T v, with C as the accumulator
        const float* ks = k_s + ((j - 1) & 1) * kL * kKP;
        const int d0 = (j - 1) * kKS;
        const float decay = g_s[kDecay];
        const int ra = d0 + 16 * mt + g, rb = ra + 8;
        float cacc[2][3][4];  // per tile, one accumulator per TF32 pass
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int col = 8 * (nt0 + jj) + 2 * t;
          const float2 x = *reinterpret_cast<const float2*>(c_s + cidx(ra, col));
          const float2 y = *reinterpret_cast<const float2*>(c_s + cidx(rb, col));
#pragma unroll
          for (int e = 0; e < 4; ++e) cacc[jj][0][e] = cacc[jj][1][e] = 0.0f;
          cacc[jj][2][0] = decay * x.x;
          cacc[jj][2][1] = decay * x.y;
          cacc[jj][2][2] = decay * y.x;
          cacc[jj][2][3] = decay * y.y;
        }
#pragma unroll
        for (int s8 = 0; s8 < kL / 8; ++s8) {
          if (8 * s8 >= L) break;
          const float wa = wv[2 * s8], wb = wv[2 * s8 + 1];
          const float* ka = ks + (8 * s8 + t) * kKP + 16 * mt + g;
          const float* kb = ka + 4 * kKP;
          const Split a[4] = {split_tf32(ka[0] * wa), split_tf32(ka[8] * wa),
                              split_tf32(kb[0] * wb), split_tf32(kb[8] * wb)};
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
            tryage::mma_3xtf32_sep(cacc[jj], a, v_frag(s8, jj).b);
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int col = 8 * (nt0 + jj) + 2 * t;
          *reinterpret_cast<float2*>(c_s + cidx(ra, col)) = make_float2(
              tryage::sep_sum(cacc[jj], 0), tryage::sep_sum(cacc[jj], 1));
          *reinterpret_cast<float2*>(c_s + cidx(rb, col)) = make_float2(
              tryage::sep_sum(cacc[jj], 2), tryage::sep_sum(cacc[jj], 3));
        }
        // n[slice] = decay n + sum_s k_s w_s: 4 threads a dimension, the
        // thread of lane t taking the steps s = t + 4 i
        const int d = tid >> 2;
        float sum = 0.0f;
#pragma unroll
        for (int i = 0; i < kL / 4; ++i) {
          if (t + 4 * i >= L) break;
          sum += ks[(t + 4 * i) * kKP + d] * wv[i];
        }
        sum = quad_sum(sum);
        if (t == 0) n_s[d0 + d] = decay * n_s[d0 + d] + sum;
      }
    }
    __syncthreads();  // the last update is done with the k buffer

    // the warps' partials into the free q/k buffers
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red_s[((warp * 16 + mi * 4 + ni) * 4 + e) * 32 + lane] = hacc[mi][ni][e];
      if (t == 0) {
        red_qn[warp * kL + 16 * mi + g] = nacc[mi][0];
        red_qn[warp * kL + 16 * mi + g + 8] = nacc[mi][2];
      }
    }
    __syncthreads();
    // den_t = e^{F_t + m - m_t} (q_t . n) + sum_s P[t, s]
    if (tid < L) {
      float qn = 0.0f;
#pragma unroll
      for (int w = 0; w < kThreads2 / 32; ++w) qn += red_qn[w * kL + tid];
      den_s[tid] = g_s[kA + tid] * qn + g_s[kRS + tid];
    }
    __syncthreads();

    // h = (e^{F_t + m - m_t} q C + P v) / max(|den|, e^{-m_t})
    if (16 * mt < L) {
      const int ra = 16 * mt + g, rb = ra + 8;
      const float aa = g_s[kA + ra], ab = g_s[kA + rb];
      float acc[2][3][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float sum = 0.0f;
#pragma unroll
          for (int w = 0; w < kThreads2 / 32; ++w)
            sum += red_s[((w * 16 + mt * 4 + nt0 + jj) * 4 + e) * 32 + lane];
          acc[jj][0][e] = acc[jj][1][e] = 0.0f;
          acc[jj][2][e] = (e < 2 ? aa : ab) * sum;
        }
      const float* P = work + ((size_t)bh * S + (size_t)c * L) * L;
#pragma unroll
      for (int s8 = 0; s8 < kL / 8; ++s8) {
        if (8 * s8 >= L) break;
        const int sa = 8 * s8 + t, sb = sa + 4;
        const bool ina = sa < L, inb = sb < L;
        const Split a[4] = {
            split_tf32(ra < L && ina ? P[ra * L + sa] : 0.0f),
            split_tf32(rb < L && ina ? P[rb * L + sa] : 0.0f),
            split_tf32(ra < L && inb ? P[ra * L + sb] : 0.0f),
            split_tf32(rb < L && inb ? P[rb * L + sb] : 0.0f)};
#pragma unroll
        for (int jj = 0; jj < 2; ++jj)
          tryage::mma_3xtf32_sep(acc[jj], a, v_frag(s8, jj).b);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r ? rb : ra;
        if (row >= L) continue;
        const float denom = fmaxf(fabsf(den_s[row]), expf(-g_s[kMT + row]));
        float* hrow = h + base + (size_t)(c * L + row) * step + col0 + 2 * t;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          if (col0 + 8 * (nt0 + jj) >= dh) continue;
          *reinterpret_cast<float2*>(hrow + 8 * (nt0 + jj)) =
              make_float2(tryage::sep_sum(acc[jj], 2 * r) / denom,
                          tryage::sep_sum(acc[jj], 2 * r + 1) / denom);
        }
      }
    }
  }

  __syncthreads();
  float* c_out = C1 + (size_t)bh * dh * dh;
  for (int i = tid; i < dh * (kCols / 4); i += kThreads2) {
    const int r = i / (kCols / 4), cc = (i % (kCols / 4)) * 4;
    if (col0 + cc < dh)
      *reinterpret_cast<float4*>(c_out + (size_t)r * dh + col0 + cc) =
          *reinterpret_cast<const float4*>(c_s + cidx(r, cc));
  }
  if (blockIdx.y == 0)
    for (int d = tid; d < dh; d += kThreads2) n1[(size_t)bh * dh + d] = n_s[d];
}

extern "C" int tryage_mlstm_scan(const float* q, const float* k, const float* v,
                                 const float* ig, const float* fg,
                                 const float* C0, const float* n0,
                                 const float* m0, float* h, float* C1,
                                 float* n1, float* m1, float* work,
                                 float* Cst, float* nst, float* mst, int B,
                                 int S, int H, int dh, int L, float scale,
                                 void* stream) {
  if (B <= 0 || H <= 0 || dh <= 0) return 0;
  if (S <= 0 || L <= 0 || L > kL || S % L || dh % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nc = S / L;
  // workspace: P (B H S L floats), then kG factors per (row, chunk)
  const size_t gate_off = ((size_t)B * H * S * L + 3) / 4 * 4;
  mlstm_scan_chunk_kernel<<<dim3(nc, B * H), kThreads1, 0, st>>>(
      q, k, ig, fg, m0, work, m1, mst, S, H, dh, L, scale, gate_off);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t rows = (size_t)(dh + kKS - 1) / kKS * kKS;
  const size_t smem = sizeof(float) * (rows * kCols + 2 * kL * kQS + 2 * kL * kKP +
                                       2 * kL * kVS + rows + kG + kL);
  err = tryage::allow_smem(mlstm_scan_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  mlstm_scan_kernel<<<dim3(B * H, (dh + kCols - 1) / kCols), kThreads2, smem, st>>>(
      q, k, v, C0, n0, work, h, C1, n1, Cst, nst, S, H, dh, L, scale,
      gate_off);
  return (int)cudaGetLastError();
}

// Floats of workspace tryage_mlstm_scan needs, for the wrapper.
extern "C" long long tryage_mlstm_scan_workspace(int B, int S, int H, int L) {
  if (B <= 0 || H <= 0 || S <= 0 || L <= 0 || S % L) return 0;
  return (long long)(((size_t)B * H * S * L + 3) / 4 * 4) +
         (long long)B * H * (S / L) * kG;
}
