// Online-softmax (flash) attention on Hopper, f32, in the model layout:
//   q, o (B, S, H, hd);  k, v (B, T, KV, hd);  H % KV == 0 (GQA maps
//   query head h to key/value head h / (H / KV), no repeat in memory).
// Replaces the Pallas kernel _attn_kernel (flash_attention_bhsd) of
// src/repro/kernels/flash_attention/kernel.py, with its whole function:
// scale 1/sqrt(hd) applied to q, optional tanh softcap, causal and
// sliding-window masks filled with NEG_INF (keys past T get -inf), and
// the normaliser l clamped at 1e-30.  hd is a multiple of 8 up to 128
// (one template instance per hd / 8); S and T are any length.  With a
// non-null lse the kernel also writes each row's log-sum-exp
// m + log(max(l, 1e-30)) (B, H, S), which the backward
// (flash_attention_bwd.cu) recomputes P from; serving passes null.
//
// Bound on the H100: at the main path's shapes (S = T = 128, hd 32 or
// 40) the operations (4 S T hd per head) outweigh the bytes on the f32
// CUDA cores; on the tensor cores, at three TF32 passes per product,
// the bytes bound it.  Both products run on the tensor cores in 3xTF32
// (mma_tf32.cuh), which keeps f32 accuracy: one TF32 pass would not.
// Design:
// * One warp owns 16 query rows.  A block holds 1, 2 or 4 warps: the
//   most that still gives at least one block per SM (132) for this
//   call's B * H * ceil(S / 16) row tiles, so a batch-1 call spreads
//   over many SMs and a batch-32 call shares each K/V tile among four
//   warps.  The grid is (query tiles, B * H).
// * The warp's q rows sit in registers as A fragments, pre-scaled (above
//   hd 64 in the warp's own rows of shared memory, or registers spill);
//   they are split into big/small TF32 halves at each use (four cvt per
//   k-step, far fewer than the products they feed), which halves the
//   registers a pre-split copy would hold.
// * K and V tiles of 64 keys are staged in shared memory with cp.async,
//   double-buffered: the next tile loads while this one is used (at
//   T <= 128 the whole head is staged once).  Rows are padded to
//   hd + 4 floats, so the B-fragment loads of S = q k^T (8 keys x 4
//   dims per warp) and of P V (4 key pairs x 8 dims) hit 32 different
//   banks.
// * S = q k^T accumulates in mma fragments, 32 keys at a time (a 64-key
//   step held twice the registers and spilled at hd > 80); softcap and
//   the masks are applied there, and the online softmax runs in
//   registers: a row's 8 values per lane, then a shuffle across the 4
//   lanes that share it.  Steps past T are skipped.
// * P V needs P as an A fragment.  The accumulator gives lane (g, t)
//   keys 2t and 2t+1 of a k-step, where A wants t and t+4; the k index
//   of the product is permuted instead (A column t <-> key 2t, column
//   t+4 <-> key 2t+1, and V's rows read in the same order), so P moves
//   into A with no shuffle and no shared-memory stage.
// * The epilogue divides by max(l, 1e-30) and stores float2 pairs in
//   the model layout.
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

using tryage::Split;
using tryage::split_tf32;

constexpr int kBK = 64;                    // keys per shared-memory tile
constexpr int kSub = 32;                   // keys per online-softmax step
constexpr int kMaxWarps = 4;
constexpr int kSMs = 132;
constexpr float kNegInf = -2.3819763e38f;  // the Pallas kernel's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

}  // namespace

template <int KD>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, int S, int T, int H, int KV,
                       int causal, int window, float softcap, float scale) {
  constexpr int HD = 8 * KD;
  constexpr int KS = HD + 4;            // padded K/V row
  constexpr int kTile = kBK * KS;
  extern __shared__ __align__(16) float smem[];  // [2][K tile, V tile]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int r0 = (blockIdx.x * (blockDim.x >> 5) + warp) * 16;
  const size_t q_stride = (size_t)H * HD;    // between sequence positions
  const size_t kv_stride = (size_t)KV * HD;
  const float* qb = q + ((size_t)b * S * H + h) * HD;
  const float* kb = k + ((size_t)b * T * KV + kvh) * HD;
  const float* vb = v + ((size_t)b * T * KV + kvh) * HD;
  float* ob = o + ((size_t)b * S * H + h) * HD;

  auto stage = [&](int tile, int buf) {
    float* ks = smem + buf * 2 * kTile;
    float* vs = ks + kTile;
    constexpr int kPieces = HD / 4;     // 16-byte pieces per row
    for (int i = threadIdx.x; i < kBK * kPieces; i += blockDim.x) {
      const int j = i / kPieces, c = (i - j * kPieces) * 4;
      const int tk = tile * kBK + j;
      const bool in = tk < T;
      const size_t off = (size_t)(in ? tk : 0) * kv_stride + c;
      tryage::cp_async16(ks + j * KS + c, kb + off, in);
      tryage::cp_async16(vs + j * KS + c, vb + off, in);
    }
    tryage::cp_async_commit();
  };
  const int n_tiles = (T + kBK - 1) / kBK;
  stage(0, 0);

  // q's A fragments, pre-scaled: a0..a3 of k-step kk are rows g, g + 8,
  // g, g + 8 and columns 8 kk + t, 8 kk + t, 8 kk + t + 4, 8 kk + t + 4
  // of the warp's 16 rows.  In registers up to hd 64; above, in the
  // warp's own 16 padded rows of shared memory (registers would spill).
  constexpr bool kQShared = KD > 8;
  float qf[kQShared ? 1 : KD][4];
  float* qw = smem + 4 * kTile + warp * 16 * KS;
  if constexpr (kQShared) {
    for (int i = lane; i < 16 * HD; i += 32) {
      const int r = i / HD, c = i - r * HD;
      qw[r * KS + c] =
          r0 + r < S ? qb[(size_t)(r0 + r) * q_stride + c] * scale : 0.0f;
    }
    __syncwarp();
  } else {
    const bool in0 = r0 + g < S, in1 = r0 + g + 8 < S;
    const float* q0 = qb + (size_t)(r0 + g) * q_stride + t;
    const float* q1 = q0 + 8 * q_stride;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      qf[kk][0] = in0 ? q0[8 * kk] * scale : 0.0f;
      qf[kk][1] = in1 ? q1[8 * kk] * scale : 0.0f;
      qf[kk][2] = in0 ? q0[8 * kk + 4] * scale : 0.0f;
      qf[kk][3] = in1 ? q1[8 * kk + 4] * scale : 0.0f;
    }
  }
  auto q_frag = [&](int kk, int e) -> float {
    if constexpr (kQShared)
      return qw[(g + 8 * (e & 1)) * KS + 8 * kk + t + 4 * (e >> 1)];
    else
      return qf[kk][e];
  };

  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.0f, 0.0f};
  float acc[KD][4];
#pragma unroll
  for (int n = 0; n < KD; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      stage(it + 1, (it + 1) & 1);
      tryage::cp_async_wait<1>();
    } else {
      tryage::cp_async_wait<0>();
    }
    __syncthreads();
    const float* ks = smem + (it & 1) * 2 * kTile;
    const float* vs = ks + kTile;

    // 32 keys at a time: S for 16 rows x 32 keys (4 n-tiles), the
    // online softmax, then O += P V
#pragma unroll 1
    for (int kb0 = 0; kb0 < kBK && it * kBK + kb0 < T; kb0 += kSub) {
      float s[kSub / 8][4];
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const Split a[4] = {split_tf32(q_frag(kk, 0)), split_tf32(q_frag(kk, 1)),
                            split_tf32(q_frag(kk, 2)), split_tf32(q_frag(kk, 3))};
#pragma unroll
        for (int j = 0; j < kSub / 8; ++j) {
          const float* kr = ks + (kb0 + 8 * j + g) * KS + 8 * kk + t;
          const Split bb[2] = {split_tf32(kr[0]), split_tf32(kr[4])};
          tryage::mma_3xtf32(s[j], a, bb);
        }
      }

      // softcap, masks, online softmax (rows g and g + 8 of the warp)
      const int kt = it * kBK + kb0;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + g + (e >> 1) * 8;
          const int key = kt + 8 * j + 2 * t + (e & 1);
          float x = s[j][e];
          if (softcap > 0.0f) x = softcap * tanhf(x / softcap);
          bool ok = true;
          if (causal) ok = ok && key <= row;
          if (window > 0) ok = ok && key > row - window;
          x = key < T ? (ok ? x : kNegInf) : -INFINITY;
          s[j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float corr[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_i[r], quad_max(mx[r]));
        corr[r] = expf(m_i[r] - m_new);
        m_i[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = expf(s[j][e] - m_i[e >> 1]);
          s[j][e] = p;
          psum[e >> 1] += p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_i[r] = corr[r] * l_i[r] + quad_sum(psum[r]);
#pragma unroll
      for (int n = 0; n < KD; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }

      // O += P V; k-step j covers keys 8j..8j+7, A column t is key 2t
      // and column t + 4 is key 2t + 1 (see the note above)
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j) {
        const Split a[4] = {split_tf32(s[j][0]), split_tf32(s[j][2]),
                            split_tf32(s[j][1]), split_tf32(s[j][3])};
        const float* v0 = vs + (kb0 + 8 * j + 2 * t) * KS + g;
#pragma unroll
        for (int n = 0; n < KD; ++n) {
          const Split bb[2] = {split_tf32(v0[8 * n]), split_tf32(v0[KS + 8 * n])};
          tryage::mma_3xtf32(acc[n], a, bb);
        }
      }
    }
    __syncthreads();  // this buffer is reloaded two tiles on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + g + 8 * r;
    if (row >= S) continue;
    const float denom = fmaxf(l_i[r], 1e-30f);
    if (lse != nullptr && t == 0)
      lse[(size_t)bh * S + row] = m_i[r] + logf(denom);
    float* orow = ob + (size_t)row * q_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < KD; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(acc[n][2 * r] / denom, acc[n][2 * r + 1] / denom);
  }
}

namespace {

template <int KD>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int B, int S, int T, int H, int KV, int causal,
           int window, float softcap, float scale, cudaStream_t stream) {
  // two stages of K and V tiles, and q above hd 64
  const size_t smem = sizeof(float) * (8 * KD + 4) *
                      (2 * 2 * kBK + (KD > 8 ? kMaxWarps * 16 : 0));
  cudaError_t err = tryage::allow_smem(flash_attention_kernel<KD>, smem);
  if (err != cudaSuccess) return (int)err;
  const long row_tiles = (long)B * H * ((S + 15) / 16);
  int warps = kMaxWarps;
  while (warps > 1 && (row_tiles + warps - 1) / warps < kSMs) warps /= 2;
  dim3 grid((S + 16 * warps - 1) / (16 * warps), B * H);
  flash_attention_kernel<KD><<<grid, 32 * warps, smem, stream>>>(
      q, k, v, o, lse, S, T, H, KV, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int tryage_flash_attention(const float* q, const float* k,
                                      const float* v, float* o, float* lse,
                                      int B, int S, int T, int H, int KV,
                                      int hd, int causal,
                                      int window, float softcap, float scale,
                                      void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (T <= 0 || hd % 8 || hd < 8 || hd > 128) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd / 8) {
#define TRYAGE_HD(KD) \
  case KD:            \
    return launch<KD>(q, k, v, o, lse, B, S, T, H, KV, causal, window, softcap, \
                      scale, st);
    TRYAGE_HD(1) TRYAGE_HD(2) TRYAGE_HD(3) TRYAGE_HD(4)
    TRYAGE_HD(5) TRYAGE_HD(6) TRYAGE_HD(7) TRYAGE_HD(8)
    TRYAGE_HD(9) TRYAGE_HD(10) TRYAGE_HD(11) TRYAGE_HD(12)
    TRYAGE_HD(13) TRYAGE_HD(14) TRYAGE_HD(15) TRYAGE_HD(16)
#undef TRYAGE_HD
  }
  return (int)cudaErrorInvalidValue;
}
