// The gradient of flash attention (flash_attention.cu) on Hopper, f32, in
// the model layout: from q, dO (B, S, H, hd), k, v (B, T, KV, hd) and the
// forward's log-sum-exp lse (B, H, S), it writes dQ (B, S, H, hd) and
// dK, dV (B, T, KV, hd).  The Pallas kernel _attn_kernel
// (src/repro/kernels/flash_attention/kernel.py) has no backward: the JAX
// package trains through attention with XLA's autodiff of
// attend_full(impl="xla").  This is that gradient, for the masks of the
// forward: the scale 1/sqrt(hd) on q, the optional tanh softcap (dS is
// multiplied by 1 - tanh^2), causal and sliding-window masks (a masked
// score gets no gradient, as jnp.where gives none), and GQA (dK and dV
// sum over the H / KV query heads of a group).  A row whose every key is
// masked took the uniform average of V in the forward (softmax of equal
// fills); its lse is the mask fill itself, and its P is 1 / T here.
//
// Algorithm (FlashAttention-2's backward, with the softmax statistics
// made consistent with the recomputed P): P = exp(S - lse) per tile,
// dP = dO V^T, dS = P (dP - D), and
//   dV = P^T dO,  dK = dS^T (q / sqrt(hd)),  dQ = dS K / sqrt(hd).
// The forward's scores come from 3xTF32 products, the backward's from
// f32 FMAs, so exp(S - lse) sums over a row to 1 + eps, not 1.  With
// D = rowsum(dO * O) the rows of dS then sum to eps * D, not 0, and dQ
// picks up eps * D times the keys' common direction: on the card that
// put a layer's dQ-driven weight gradient 1.02e-4 of its largest
// magnitude off the CPU's.  So the dQ kernel first sums each row's
// recomputed P and P dP over all keys, and both kernels use
// lse + log(sum P) and D = sum(P dP) / sum(P): the rows of dS sum to 0
// up to rounding, as in the softmax backward of the plain version.
//
// Bound on the H100: 10 S T hd operations per head (S and dP recomputed
// by both kernels: 4; dV, dK, dQ: 6; the dQ kernel's statistics pass
// adds 2 more that the bound does not count), which outweigh the bytes
// at the training shapes (S = T = 128, hd 32 or 40).  This first version
// runs them as f32 FMAs on the CUDA cores from shared-memory tiles,
// which is simple and exact to f32 rounding; the tensor cores (3xTF32)
// are later work.  Design:
// * Two launches, no atomics, so a rerun gives bit-identical gradients.
//   flash_attention_bwd_dq: a block per (b, h, 32 query rows) walks the
//   key tiles twice, first for its rows' statistics (written out for the
//   second launch), then accumulating dQ in registers.
//   flash_attention_bwd_dkv: a block per (b, kv head, 32 keys) walks the
//   group's query heads and their query tiles in a fixed order,
//   accumulating dK and dV in registers.
// * 256 threads.  For the 32 x 32 score tile each thread owns one row
//   and four keys (j = lane % 8 + 8 c), and computes S and dP together;
//   rows are padded to hd + 1 floats, so the eight keys a warp reads and
//   the four rows it broadcasts fall in different banks.  For the
//   accumulation each thread owns one row (dQ) or one key (dK, dV) and
//   hd / 8 dims (d = lane % 8 + 8 c), one template instance per hd / 8.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kTile = 32;                  // query rows and keys per tile
constexpr int kThreads = 256;
constexpr float kNegInf = -2.3819763e38f;  // the forward's mask fill

// Shared-memory layout of both kernels: four (kTile, hd + 1) tiles, the
// P and dS tiles, and lse and D of the query tile's rows.
template <int KD>
struct Smem {
  static constexpr int HD = 8 * KD;
  static constexpr int RS = HD + 1;   // padded row
  float q[kTile * RS];                // q / sqrt(hd)
  float d_o[kTile * RS];
  float k[kTile * RS];
  float v[kTile * RS];
  float p[kTile * (kTile + 1)];
  float ds[kTile * (kTile + 1)];
  float lse[kTile];
  float dsum[kTile];
};

// Stage rows [r0, r0 + kTile) of one head of a (rows, heads, HD) tensor
// into a padded tile, times `mul`; rows past `n` read as zero.
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int n, size_t stride,
                                          float mul) {
  for (int i = threadIdx.x; i < kTile * HD; i += kThreads) {
    const int r = i / HD, c = i - r * HD;
    dst[r * (HD + 1) + c] =
        r0 + r < n ? src[(size_t)(r0 + r) * stride + c] * mul : 0.0f;
  }
}

// S, P and dP of the thread's four entries of one (query tile, key tile)
// pair from the staged q, dO, k, v tiles and the rows' lse: P is 0 where
// the entry is masked or out of range, 1 / T on a row with no key; `keep`
// is whether the score gets a gradient, `dcap` its softcap factor.
// Thread: row i = tid / 8, keys j = tid % 8 + 8 c.
template <int KD>
__device__ __forceinline__ void scores(const Smem<KD>& sm, int q0, int k0,
                                       int S, int T, int causal, int window,
                                       float softcap, float (&p)[4],
                                       float (&dp)[4], float (&dcap)[4],
                                       bool (&keep)[4]) {
  constexpr int RS = Smem<KD>::RS;
  const int i = threadIdx.x >> 3, j0 = threadIdx.x & 7;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < 4; ++c) dp[c] = 0.0f;
  const float* qr = sm.q + i * RS;
  const float* dor = sm.d_o + i * RS;
#pragma unroll 4
  for (int d = 0; d < 8 * KD; ++d) {
    const float qd = qr[d], dod = dor[d];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + 8 * c;
      s[c] = fmaf(qd, sm.k[j * RS + d], s[c]);
      dp[c] = fmaf(dod, sm.v[j * RS + d], dp[c]);
    }
  }
  const int row = q0 + i;
  const float lse = sm.lse[i];
  const bool dead = lse <= kNegInf;   // every key of the row masked
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int key = k0 + j0 + 8 * c;
    float x = s[c];
    dcap[c] = 1.0f;
    if (softcap > 0.0f) {
      const float th = tanhf(x / softcap);
      x = softcap * th;
      dcap[c] = 1.0f - th * th;
    }
    const bool in = row < S && key < T;
    bool ok = in;
    if (causal) ok = ok && key <= row;
    if (window > 0) ok = ok && key > row - window;
    p[c] = dead ? (in ? 1.0f / (float)T : 0.0f)
                : (ok ? expf(x - lse) : 0.0f);
    keep[c] = ok && !dead;
  }
}

// P and dS of one tile pair into smem.p / smem.ds.
template <int KD>
__device__ __forceinline__ void score_tile(Smem<KD>& sm, int q0, int k0,
                                           int S, int T, int causal,
                                           int window, float softcap) {
  float p[4], dp[4], dcap[4];
  bool keep[4];
  scores<KD>(sm, q0, k0, S, T, causal, window, softcap, p, dp, dcap, keep);
  const int i = threadIdx.x >> 3, j0 = threadIdx.x & 7;
  const float dsum = sm.dsum[i];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = j0 + 8 * c;
    sm.p[i * (kTile + 1) + j] = p[c];
    sm.ds[i * (kTile + 1) + j] = keep[c] ? p[c] * (dp[c] - dsum) * dcap[c]
                                         : 0.0f;
  }
}

// Sum of eight lanes' values (the eight threads of one row).
__device__ __forceinline__ float row_sum8(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

}  // namespace

template <int KD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dq(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ d_o,
                       const float* __restrict__ lse, float* __restrict__ dsum,
                       float* __restrict__ lse_b, float* __restrict__ dq,
                       int S, int T, int H, int KV, int causal, int window,
                       float softcap, float scale) {
  constexpr int HD = 8 * KD, RS = HD + 1;
  extern __shared__ __align__(16) float smem_raw[];
  Smem<KD>& sm = *reinterpret_cast<Smem<KD>*>(smem_raw);
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kTile;
  const size_t q_stride = (size_t)H * HD, kv_stride = (size_t)KV * HD;
  const size_t q_off = ((size_t)b * S * H + h) * HD;
  const float* kb = k + ((size_t)b * T * KV + kvh) * HD;
  const float* vb = v + ((size_t)b * T * KV + kvh) * HD;

  load_tile<HD>(sm.q, q + q_off, q0, S, q_stride, scale);
  load_tile<HD>(sm.d_o, d_o + q_off, q0, S, q_stride, 1.0f);
  if (threadIdx.x < kTile) {
    const int r = q0 + threadIdx.x;
    sm.lse[threadIdx.x] = r < S ? lse[(size_t)bh * S + r] : 0.0f;
  }
  const int i = threadIdx.x >> 3, d0 = threadIdx.x & 7;
  const int row = q0 + i;

  // pass 1: each row's sum of the recomputed P and of P dP over all keys
  float ps = 0.0f, pd = 0.0f;
  for (int k0 = 0; k0 < T; k0 += kTile) {
    load_tile<HD>(sm.k, kb, k0, T, kv_stride, 1.0f);
    load_tile<HD>(sm.v, vb, k0, T, kv_stride, 1.0f);
    __syncthreads();
    float p[4], dp[4], dcap[4];
    bool keep[4];
    scores<KD>(sm, q0, k0, S, T, causal, window, softcap, p, dp, dcap, keep);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      ps += p[c];
      pd = fmaf(p[c], dp[c], pd);
    }
    __syncthreads();  // the next key tile overwrites k, v
  }
  ps = row_sum8(ps);
  pd = row_sum8(pd);
  if (d0 == 0) {
    // the log-sum-exp that normalises the recomputed P, and D = sum(P dP)
    const float l = sm.lse[i];
    const float lb = (l <= kNegInf || ps <= 0.0f) ? l : l + logf(ps);
    const float dd = ps > 0.0f ? pd / ps : 0.0f;
    sm.lse[i] = lb;
    sm.dsum[i] = dd;
    if (row < S) {
      lse_b[(size_t)bh * S + row] = lb;
      dsum[(size_t)bh * S + row] = dd;
    }
  }

  // pass 2: dS and dQ (the first tile's __syncthreads publishes lse, D)
  float acc[KD];
#pragma unroll
  for (int c = 0; c < KD; ++c) acc[c] = 0.0f;
  for (int k0 = 0; k0 < T; k0 += kTile) {
    load_tile<HD>(sm.k, kb, k0, T, kv_stride, 1.0f);
    load_tile<HD>(sm.v, vb, k0, T, kv_stride, 1.0f);
    __syncthreads();
    score_tile<KD>(sm, q0, k0, S, T, causal, window, softcap);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTile; ++j) {
      const float ds = sm.ds[i * (kTile + 1) + j];
#pragma unroll
      for (int c = 0; c < KD; ++c) acc[c] = fmaf(ds, sm.k[j * RS + d0 + 8 * c], acc[c]);
    }
    __syncthreads();  // the next key tile overwrites k, v
  }
  if (row < S) {
    float* out = dq + q_off + (size_t)row * q_stride;
#pragma unroll
    for (int c = 0; c < KD; ++c) out[d0 + 8 * c] = acc[c] * scale;
  }
}

template <int KD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bwd_dkv(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ d_o,
                        const float* __restrict__ lse_b,
                        const float* __restrict__ dsum, float* __restrict__ dk,
                        float* __restrict__ dv, int S, int T, int H, int KV,
                        int causal, int window, float softcap, float scale) {
  constexpr int HD = 8 * KD, RS = HD + 1;
  extern __shared__ __align__(16) float smem_raw[];
  Smem<KD>& sm = *reinterpret_cast<Smem<KD>*>(smem_raw);
  const int bkv = blockIdx.y, b = bkv / KV, kvh = bkv - b * KV;
  const int G = H / KV;
  const int k0 = blockIdx.x * kTile;
  const size_t q_stride = (size_t)H * HD, kv_stride = (size_t)KV * HD;
  const size_t kv_off = ((size_t)b * T * KV + kvh) * HD;
  load_tile<HD>(sm.k, k + kv_off, k0, T, kv_stride, 1.0f);
  load_tile<HD>(sm.v, v + kv_off, k0, T, kv_stride, 1.0f);

  const int j = threadIdx.x >> 3, d0 = threadIdx.x & 7;
  float acc_k[KD], acc_v[KD];
#pragma unroll
  for (int c = 0; c < KD; ++c) acc_k[c] = acc_v[c] = 0.0f;
  for (int hg = 0; hg < G; ++hg) {
    const int h = kvh * G + hg;
    const size_t q_off = ((size_t)b * S * H + h) * HD;
    const size_t row_off = ((size_t)b * H + h) * S;
    for (int q0 = 0; q0 < S; q0 += kTile) {
      load_tile<HD>(sm.q, q + q_off, q0, S, q_stride, scale);
      load_tile<HD>(sm.d_o, d_o + q_off, q0, S, q_stride, 1.0f);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        sm.lse[threadIdx.x] = row < S ? lse_b[row_off + row] : 0.0f;
        sm.dsum[threadIdx.x] = row < S ? dsum[row_off + row] : 0.0f;
      }
      __syncthreads();
      score_tile<KD>(sm, q0, k0, S, T, causal, window, softcap);
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < kTile; ++i) {
        const float p = sm.p[i * (kTile + 1) + j];
        const float ds = sm.ds[i * (kTile + 1) + j];
#pragma unroll
        for (int c = 0; c < KD; ++c) {
          acc_v[c] = fmaf(p, sm.d_o[i * RS + d0 + 8 * c], acc_v[c]);
          acc_k[c] = fmaf(ds, sm.q[i * RS + d0 + 8 * c], acc_k[c]);
        }
      }
      __syncthreads();  // the next query tile overwrites q, dO, lse, D
    }
  }
  const int key = k0 + j;
  if (key < T) {
    const size_t off = kv_off + (size_t)key * kv_stride;
#pragma unroll
    for (int c = 0; c < KD; ++c) {
      dk[off + d0 + 8 * c] = acc_k[c];
      dv[off + d0 + 8 * c] = acc_v[c];
    }
  }
}

namespace {

template <int KD>
int launch_bwd(const float* q, const float* k, const float* v,
               const float* d_o, const float* lse, float* dsum, float* lse_b,
               float* dq, float* dk, float* dv, int B, int S, int T, int H,
               int KV, int causal, int window, float softcap, float scale,
               cudaStream_t stream) {
  const size_t smem = sizeof(Smem<KD>);
  cudaError_t err = tryage::allow_smem(flash_attention_bwd_dq<KD>, smem);
  if (err == cudaSuccess)
    err = tryage::allow_smem(flash_attention_bwd_dkv<KD>, smem);
  if (err != cudaSuccess) return (int)err;
  // dQ first: it writes the rows' statistics, which the dK / dV launch reads
  dim3 grid_q((S + kTile - 1) / kTile, B * H);
  flash_attention_bwd_dq<KD><<<grid_q, kThreads, smem, stream>>>(
      q, k, v, d_o, lse, dsum, lse_b, dq, S, T, H, KV, causal, window,
      softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid_kv((T + kTile - 1) / kTile, B * KV);
  flash_attention_bwd_dkv<KD><<<grid_kv, kThreads, smem, stream>>>(
      q, k, v, d_o, lse_b, dsum, dk, dv, S, T, H, KV, causal, window,
      softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dsum, lse_b: (B, H, S) f32 workspaces for D and the rows' log-sum-exp.
extern "C" int tryage_flash_attention_bwd(
    const float* q, const float* k, const float* v, const float* d_o,
    const float* lse, float* dsum, float* lse_b, float* dq, float* dk,
    float* dv, int B, int S, int T, int H, int KV, int hd, int causal,
    int window, float softcap, float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (T <= 0 || hd % 8 || hd < 8 || hd > 128 || KV <= 0 || H % KV)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd / 8) {
#define TRYAGE_HD(KD)                                                        \
  case KD:                                                                   \
    return launch_bwd<KD>(q, k, v, d_o, lse, dsum, lse_b, dq, dk, dv, B, S, \
                          T, H, KV, causal, window, softcap, scale, st);
    TRYAGE_HD(1) TRYAGE_HD(2) TRYAGE_HD(3) TRYAGE_HD(4)
    TRYAGE_HD(5) TRYAGE_HD(6) TRYAGE_HD(7) TRYAGE_HD(8)
    TRYAGE_HD(9) TRYAGE_HD(10) TRYAGE_HD(11) TRYAGE_HD(12)
    TRYAGE_HD(13) TRYAGE_HD(14) TRYAGE_HD(15) TRYAGE_HD(16)
#undef TRYAGE_HD
  }
  return (int)cudaErrorInvalidValue;
}
