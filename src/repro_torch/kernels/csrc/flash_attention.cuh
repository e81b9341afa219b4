// The f32 attention kernel's body (the instances are built in
// flash_attention.cu, whose notes give its design), and the helpers the
// bf16 instances of flash_attention_bf16.cu share with it.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"
#include "mma_tf32.cuh"

namespace {

using tryage::Split;
using tryage::split_tf32;

constexpr int kSub = 32;                   // keys per online-softmax step
constexpr int kMaxWarps = 4;
constexpr int kSMs = 132;
constexpr int kMaxKD = 32;                 // hd 256
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

__device__ __forceinline__ float to_f32(float x) { return x; }

// The tile geometry of one instance: Tin the input type (float), KD =
// hd / 8 k-steps of q k^T, KO the k-steps of O one block accumulates.
template <typename Tin, int KD>
struct Geometry {
  static_assert(std::is_same<Tin, float>::value, "the f32 instances");
  static constexpr int HD = 8 * KD;
  static constexpr int KO = KD <= 16 ? KD : (KD + 1) / 2;
  static constexpr int NC = (KD + KO - 1) / KO;   // column splits
  static constexpr int VW = 8 * KO;               // V columns a block stages
  static constexpr int kPad = 16 / (int)sizeof(Tin);
  static constexpr int KS = HD + kPad;            // padded K row
  static constexpr int VS = VW + kPad;            // padded V row
  static constexpr int BK = KD > 16 ? 32 : 64;    // keys a tile
  static constexpr int QS = HD + 4;               // padded q row (f32)
  static constexpr bool kQShared = KD > 8;
  static constexpr size_t kStageBytes = sizeof(Tin) * BK * (KS + VS);
  static constexpr size_t smem_bytes() {
    return 2 * kStageBytes +
           (kQShared ? sizeof(float) * kMaxWarps * 16 * QS : 0);
  }
};

}  // namespace

template <typename Tin, int KD>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
flash_attention_kernel(const Tin* __restrict__ q, const Tin* __restrict__ k,
                       const Tin* __restrict__ v, Tin* __restrict__ o,
                       float* __restrict__ lse, int S, int T, int H, int KV,
                       int causal, int window, float softcap, float scale) {
  using G = Geometry<Tin, KD>;
  constexpr int HD = G::HD, KO = G::KO, VW = G::VW, KS = G::KS, VS = G::VS;
  constexpr int BK = G::BK, QS = G::QS;
  constexpr bool kQShared = G::kQShared;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [2][K tile, V tile] in Tin, then the warps' q rows in f32

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int col0 = blockIdx.z * VW;          // first output column
  const int rows = blockDim.x >> 1;          // 16 per warp
  const int r0 = blockIdx.x * rows + warp * 16;
  const size_t q_stride = (size_t)H * HD;    // between sequence positions
  const size_t kv_stride = (size_t)KV * HD;
  const Tin* qb = q + ((size_t)b * S * H + h) * HD;
  const Tin* kb = k + ((size_t)b * T * KV + kvh) * HD;
  const Tin* vb = v + ((size_t)b * T * KV + kvh) * HD;
  Tin* ob = o + ((size_t)b * S * H + h) * HD;

  // keys [key_lo, key_hi) that some row of this block may see (above)
  const int row_lo = blockIdx.x * rows;
  const int row_hi = min(S, row_lo + rows) - 1;
  int key_lo = 0, key_hi = T;
  if (window <= 0 || row_hi - window + 1 <= T - 1) {
    if (causal) key_hi = min(T, row_hi + 1);
    if (window > 0) key_lo = max(0, row_lo - window + 1);
  }
  const int tile_lo = key_lo / BK, tile_hi = (key_hi + BK - 1) / BK;

  auto stage = [&](int tile, int buf) {
    Tin* ks = reinterpret_cast<Tin*>(smem_raw + buf * G::kStageBytes);
    Tin* vs = ks + BK * KS;
    constexpr int EP = 16 / (int)sizeof(Tin);   // elements a 16-byte piece
    constexpr int kPieces = HD / EP, vPieces = VW / EP;
    for (int i = threadIdx.x; i < BK * kPieces; i += blockDim.x) {
      const int j = i / kPieces, c = (i - j * kPieces) * EP;
      const int tk = tile * BK + j;
      const bool in = tk < T;
      tryage::cp_async16(ks + j * KS + c,
                         kb + (size_t)(in ? tk : 0) * kv_stride + c, in);
    }
    for (int i = threadIdx.x; i < BK * vPieces; i += blockDim.x) {
      const int j = i / vPieces, c = (i - j * vPieces) * EP;
      const int tk = tile * BK + j;
      // columns past hd (the second half of an odd KD) are zero-filled
      const bool in = tk < T && col0 + c < HD;
      tryage::cp_async16(
          vs + j * VS + c,
          vb + (in ? (size_t)tk * kv_stride + col0 + c : 0), in);
    }
    tryage::cp_async_commit();
  };
  stage(tile_lo, 0);

  // q's A fragments: a0..a3 of k-step kk are rows g, g + 8, g, g + 8
  // and columns 8 kk + t, 8 kk + t, 8 kk + t + 4, 8 kk + t + 4 of the
  // warp's 16 rows, pre-scaled.  In registers up to hd 64; above, in the
  // warp's own 16 padded rows of shared memory.
  float qf[kQShared ? 1 : KD][4];
  float* qw = reinterpret_cast<float*>(smem_raw + 2 * G::kStageBytes) +
              warp * 16 * QS;
  if constexpr (kQShared) {
    for (int i = lane; i < 16 * HD; i += 32) {
      const int r = i / HD, c = i - r * HD;
      qw[r * QS + c] = r0 + r < S
                           ? to_f32(qb[(size_t)(r0 + r) * q_stride + c]) * scale
                           : 0.0f;
    }
    __syncwarp();
  } else {
    const bool in0 = r0 + g < S, in1 = r0 + g + 8 < S;
    const Tin* q0 = qb + (size_t)(r0 + g) * q_stride + t;
    const Tin* q1 = q0 + 8 * q_stride;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      qf[kk][0] = in0 ? to_f32(q0[8 * kk]) * scale : 0.0f;
      qf[kk][1] = in1 ? to_f32(q1[8 * kk]) * scale : 0.0f;
      qf[kk][2] = in0 ? to_f32(q0[8 * kk + 4]) * scale : 0.0f;
      qf[kk][3] = in1 ? to_f32(q1[8 * kk + 4]) * scale : 0.0f;
    }
  }
  auto q_frag = [&](int kk, int e) -> float {
    if constexpr (kQShared)
      return qw[(g + 8 * (e & 1)) * QS + 8 * kk + t + 4 * (e >> 1)];
    else
      return qf[kk][e];
  };

  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.0f, 0.0f};
  float acc[KO][4];
#pragma unroll
  for (int n = 0; n < KO; ++n)
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
    const Tin* ks = reinterpret_cast<const Tin*>(smem_raw + buf * G::kStageBytes);
    const Tin* vs = ks + BK * KS;

    // 32 keys at a time: S for 16 rows x 32 keys (4 n-tiles), the
    // online softmax, then O += P V
#pragma unroll 1
    for (int kb0 = 0; kb0 < BK && it * BK + kb0 < key_hi; kb0 += kSub) {
      float s[kSub / 8][4];
#pragma unroll
      for (int j = 0; j < kSub / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const Split a[4] = {split_tf32(q_frag(kk, 0)),
                            split_tf32(q_frag(kk, 1)),
                            split_tf32(q_frag(kk, 2)),
                            split_tf32(q_frag(kk, 3))};
#pragma unroll
        for (int j = 0; j < kSub / 8; ++j) {
          const Tin* kr = ks + (kb0 + 8 * j + g) * KS + 8 * kk + t;
          const Split bb[2] = {split_tf32(to_f32(kr[0])),
                               split_tf32(to_f32(kr[4]))};
          tryage::mma_3xtf32(s[j], a, bb);
        }
      }

      // softcap, masks, online softmax (rows g and g + 8)
      const int kt = it * BK + kb0;
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
      for (int n = 0; n < KO; ++n) {
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
        const Tin* v0 = vs + (kb0 + 8 * j + 2 * t) * VS + g;
#pragma unroll
        for (int n = 0; n < KO; ++n) {
          const Split bb[2] = {split_tf32(v0[8 * n]),
                               split_tf32(v0[VS + 8 * n])};
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
    if (lse != nullptr && t == 0 && blockIdx.z == 0)
      lse[(size_t)bh * S + row] = m_i[r] + logf(denom);
    Tin* orow = ob + (size_t)row * q_stride + col0 + 2 * t;
#pragma unroll
    for (int n = 0; n < KO; ++n) {
      if (G::NC > 1 && col0 + 8 * n >= HD) continue;
      const float x0 = acc[n][2 * r] / denom, x1 = acc[n][2 * r + 1] / denom;
      *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(x0, x1);
    }
  }
}

namespace {

// warps: a block's warps (1, 2 or 4, e.g. from the launch-config table
// through the wrapper), or 0 for the most that still gives every SM a
// block.
template <typename Tin, int KD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int S, int T, int H, int KV, int causal, int window,
           float softcap, float scale, int warps, cudaStream_t stream) {
  using G = Geometry<Tin, KD>;
  const size_t smem = G::smem_bytes();
  cudaError_t err = tryage::allow_smem(flash_attention_kernel<Tin, KD>, smem);
  if (err != cudaSuccess) return (int)err;
  if (warps == 0) {
    const long row_tiles = (long)B * H * G::NC * ((S + 15) / 16);
    warps = kMaxWarps;
    while (warps > 1 && (row_tiles + warps - 1) / warps < kSMs) warps /= 2;
  }
  dim3 grid((S + 16 * warps - 1) / (16 * warps), B * H, G::NC);
  flash_attention_kernel<Tin, KD><<<grid, 32 * warps, smem, stream>>>(
      static_cast<const Tin*>(q), static_cast<const Tin*>(k),
      static_cast<const Tin*>(v), static_cast<Tin*>(o), lse, S, T, H, KV,
      causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename Tin, int KD>
int dispatch(int kd, const void* q, const void* k, const void* v, void* o,
             float* lse, int B, int S, int T, int H, int KV, int causal,
             int window, float softcap, float scale, int warps,
             cudaStream_t stream) {
  if constexpr (KD > kMaxKD) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (kd == KD)
      return launch<Tin, KD>(q, k, v, o, lse, B, S, T, H, KV, causal, window,
                             softcap, scale, warps, stream);
    return dispatch<Tin, KD + 1>(kd, q, k, v, o, lse, B, S, T, H, KV, causal,
                                 window, softcap, scale, warps, stream);
  }
}

}  // namespace

