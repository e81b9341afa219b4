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
// kernel's docstring).
//
// Bound on the H100: at the serving shape (dh = 1024, L = 64) the f32
// operations (about 4 L^2 dh + 4 L dh^2 per row and chunk) outweigh the
// bytes (q, k, v, h, C0, C1) by about 7x, so the f32 CUDA-core rate
// bounds it.  The Pallas kernel keeps C (dh x dh, 4 MB at dh = 1024) in
// VMEM; an SM has 227 KB of shared memory, so here the state is split
// by columns: block (row, j) owns columns [64 j, 64 j + 64) of C and of
// h, keeps that slice of C in the output buffer C1 (per chunk read
// twice and written once, from L2 or device memory), and streams q and
// k through shared memory in 32-wide slices of the head dimension.  The
// gates, S = q k^T, q . n and the n update do not depend on the columns;
// every block of a row computes them itself, in the same order, so all
// blocks derive the same m and n (about 1.4x the minimal operations at
// dh = 1024).  Block 0 of each row writes n1 and m1.  Each of the 256
// threads holds a 4 x 4 register tile (rows ty + 16 i, columns tx + 16 j)
// of S and of q C; f32 FMAs only, no tensor cores.  Masked (s > t)
// weights are exactly 0; logsigmoid is min(x, 0) - log1p(exp(-|x|)).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kL = 64;              // chunk rows of the in-chunk tiles
constexpr int kTV = 64;             // columns of C and h per block
constexpr int kKT = 32;             // head-dimension slice staged at once
constexpr int kQP = kKT + 1;        // padded q/k slice row (bank spread)
constexpr int kWP = kL + 1;         // padded W*S row

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

}  // namespace

extern "C" __global__ void __launch_bounds__(kThreads)
mlstm_scan_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ ig,
                  const float* __restrict__ fg, const float* C0,
                  const float* __restrict__ n0, const float* __restrict__ m0,
                  float* __restrict__ h, float* C1, float* __restrict__ n1,
                  float* __restrict__ m1, int S, int H, int dh, int L,
                  float scale) {
  extern __shared__ float smem[];
  float* q_s = smem;                  // kL x kQP, q slice (scaled)
  float* k_s = q_s + kL * kQP;        // kL x kQP, k slice
  float* c_s = k_s + kL * kQP;        // kKT x kTV, C slice
  float* v_s = c_s + kKT * kTV;       // kL x kTV, v columns of the block
  float* w_s = v_s + kL * kTV;        // kL x kWP, W * S
  float* n_s = w_s + kL * kWP;        // dh, the row's n
  __shared__ float F_s[kL], i_s[kL], mt_s[kL], ws_s[kL], qn_s[kL], den_s[kL];

  const int bh = blockIdx.x;
  const int b = bh / H, hh = bh - b * H;
  const int v0 = blockIdx.y * kTV;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t step = (size_t)H * dh;           // between time steps
  const size_t base = (size_t)b * S * step + (size_t)hh * dh;
  const float* qb = q + base;
  const float* kb = k + base;
  const float* vb = v + base;
  float* hb = h + base;
  const float* ib = ig + (size_t)b * S * H + hh;  // stride H per step
  const float* fb = fg + (size_t)b * S * H + hh;
  // no __restrict__ on C0/C1: c_src below reads C1 after the first
  // chunk, and those reads must not go through the read-only cache
  const float* c_in = C0 + (size_t)bh * dh * dh;
  float* c_out = C1 + (size_t)bh * dh * dh;

  for (int i = tid; i < dh; i += kThreads) n_s[i] = n0[(size_t)bh * dh + i];
  float m = m0[bh];

  for (int t0 = 0; t0 < S; t0 += L) {
    // C as the previous chunk left it (in C1 after the first chunk)
    const float* c_src = t0 == 0 ? c_in : c_out;
    __syncthreads();  // the previous chunk is done with every shared buffer

    // ---- gates: F, i, m_t (the same in every block of the row)
    if (tid < L) {
      i_s[tid] = ib[(size_t)(t0 + tid) * H];
      F_s[tid] = log_sigmoid(fb[(size_t)(t0 + tid) * H]);
    }
    __syncthreads();
    if (tid == 0) {
      float F = 0.0f, g = -INFINITY;
      for (int t = 0; t < L; ++t) {
        F += F_s[t];
        g = fmaxf(g, i_s[t] - F);
        F_s[t] = F;
        mt_s[t] = F + fmaxf(m, g);
      }
    }

    // ---- S = q k^T (rows t, cols s), N = q C (rows t, this block's cols)
    float acc_s[4][4], acc_n[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc_s[i][j] = acc_n[i][j] = 0.0f;
    float qn = 0.0f;
    for (int k0 = 0; k0 < dh; k0 += kKT) {
      for (int idx = tid; idx < kL * kKT; idx += kThreads) {
        const int t = idx / kKT, c = idx - t * kKT;
        const bool in = t < L && k0 + c < dh;
        const size_t off = (size_t)(t0 + t) * step + k0 + c;
        q_s[t * kQP + c] = in ? qb[off] * scale : 0.0f;
        k_s[t * kQP + c] = in ? kb[off] : 0.0f;
      }
      for (int idx = tid; idx < kKT * kTV; idx += kThreads) {
        const int r = idx / kTV, c = idx - r * kTV;
        const bool in = k0 + r < dh && v0 + c < dh;
        c_s[idx] = in ? c_src[(size_t)(k0 + r) * dh + v0 + c] : 0.0f;
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < kKT; ++c) {
        float a[4], bk[4], bc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * kQP + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bk[j] = k_s[(tx + 16 * j) * kQP + c];
          bc[j] = c_s[c * kTV + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc_s[i][j] = fmaf(a[i], bk[j], acc_s[i][j]);
            acc_n[i][j] = fmaf(a[i], bc[j], acc_n[i][j]);
          }
      }
      if (tid < kL) {
        const int cmax = min(kKT, dh - k0);
        for (int c = 0; c < cmax; ++c)
          qn = fmaf(q_s[tid * kQP + c], n_s[k0 + c], qn);
      }
      __syncthreads();
    }
    if (tid < kL) qn_s[tid] = qn;

    // ---- in-chunk weights W[t, s] = e^{F_t - F_s + i_s - m_t}, s <= t
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = tx + 16 * j;
        float w = 0.0f;
        if (s <= t && t < L)
          w = expf((F_s[t] - mt_s[t]) + (i_s[s] - F_s[s])) * acc_s[i][j];
        w_s[t * kWP + s] = w;
      }
    }
    for (int idx = tid; idx < kL * kTV; idx += kThreads) {
      const int t = idx / kTV, c = idx - t * kTV;
      v_s[idx] = (t < L && v0 + c < dh) ? vb[(size_t)(t0 + t) * step + v0 + c]
                                        : 0.0f;
    }
    __syncthreads();

    const float m_prev = m;
    if (tid < L) {
      float sum = 0.0f;
      for (int s = 0; s < L; ++s) sum += w_s[tid * kWP + s];
      den_s[tid] = expf(F_s[tid] + m_prev - mt_s[tid]) * qn_s[tid] + sum;
    }
    __syncthreads();

    // ---- h = (e^{F_t + m - m_t} q C + (W * S) v) / max(|den|, e^{-m_t})
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = ty + 16 * i;
      if (t >= L) continue;
      const float w_inter = expf(F_s[t] + m_prev - mt_s[t]);
      const float denom = fmaxf(fabsf(den_s[t]), expf(-mt_s[t]));
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float acc = w_inter * acc_n[i][j];
        for (int s = 0; s < L; ++s)
          acc = fmaf(w_s[t * kWP + s], v_s[s * kTV + tx + 16 * j], acc);
        const int col = v0 + tx + 16 * j;
        if (col < dh) hb[(size_t)(t0 + t) * step + col] = acc / denom;
      }
    }

    // ---- end of chunk: C = decay C + (k * w)^T v,  n = decay n + sum k * w
    const float m_last = mt_s[L - 1];
    const float decay = expf(F_s[L - 1] + m_prev - m_last);
    if (tid < L) ws_s[tid] = expf(F_s[L - 1] - F_s[tid] + i_s[tid] - m_last);
    __syncthreads();
    for (int k0 = 0; k0 < dh; k0 += kKT) {
      for (int idx = tid; idx < kL * kKT; idx += kThreads) {
        const int s = idx / kKT, c = idx - s * kKT;
        k_s[s * kQP + c] = (s < L && k0 + c < dh)
                               ? kb[(size_t)(t0 + s) * step + k0 + c] * ws_s[s]
                               : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kKT / 16; ++i) {
        const int r = ty + 16 * i, row = k0 + r;
        if (row >= dh) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = v0 + tx + 16 * j;
          if (col >= dh) continue;
          const size_t off = (size_t)row * dh + col;
          float acc = decay * c_src[off];
          for (int s = 0; s < L; ++s)
            acc = fmaf(k_s[s * kQP + r], v_s[s * kTV + tx + 16 * j], acc);
          c_out[off] = acc;
        }
      }
      if (tid < kKT && k0 + tid < dh) {
        float acc = decay * n_s[k0 + tid];
        for (int s = 0; s < L; ++s) acc += k_s[s * kQP + tid];
        n_s[k0 + tid] = acc;
      }
      __syncthreads();
    }
    m = m_last;
  }

  if (blockIdx.y == 0) {
    for (int i = tid; i < dh; i += kThreads) n1[(size_t)bh * dh + i] = n_s[i];
    if (tid == 0) m1[bh] = m;
  }
}

extern "C" int tryage_mlstm_scan(const float* q, const float* k, const float* v,
                                 const float* ig, const float* fg,
                                 const float* C0, const float* n0,
                                 const float* m0, float* h, float* C1,
                                 float* n1, float* m1, int B, int S, int H,
                                 int dh, int L, float scale, void* stream) {
  if (B <= 0 || H <= 0 || dh <= 0) return 0;
  if (S <= 0 || L <= 0 || L > kL || S % L) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)2 * kL * kQP + (size_t)kKT * kTV +
                                       (size_t)kL * kTV + (size_t)kL * kWP +
                                       (size_t)dh);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mlstm_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(B * H, (dh + kTV - 1) / kTV);
  mlstm_scan_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      q, k, v, ig, fg, C0, n0, m0, h, C1, n1, m1, S, H, dh, L, scale);
  return (int)cudaGetLastError();
}
