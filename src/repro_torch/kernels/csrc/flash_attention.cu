// Online-softmax (flash) attention on Hopper, f32, in the model layout:
//   q, o (B, S, H, hd);  k, v (B, T, KV, hd);  H % KV == 0 (GQA maps
//   query head h to key/value head h / (H / KV), no repeat in memory).
// Replaces the Pallas kernel _attn_kernel (flash_attention_bhsd) of
// src/repro/kernels/flash_attention/kernel.py, with its whole function:
// scale 1/sqrt(hd) applied to q, optional tanh softcap, causal and
// sliding-window masks filled with NEG_INF, and the normaliser l
// clamped at 1e-30.
//
// Bound on the H100: at the main path's shapes (S = T = 128, hd 32 or
// 40) the f32 FLOPs (4 * S * T * hd per head) outweigh the bytes, so
// the f32 CUDA-core rate bounds it.  The design is the simple one:
// one block of four warps per (batch*head, 32-query tile); K/V tiles of
// 64 keys are staged in shared memory (K rows padded to hd + 1 floats
// so lanes reading different keys hit different banks); each warp owns
// eight query rows and keeps their running max, normaliser and output
// accumulator in registers.  Lanes split the keys of a tile for the
// scores and the head dimension for the output, so any hd up to 128
// works -- the library has hd = 40, which a power-of-two tile would not.
// Shared memory is dynamic and opted in above 48 KB (hd > 64).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 32;               // query rows per block
constexpr int kBK = 64;               // keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kRowsPerWarp = kBQ / kWarps;
constexpr int kKeysPerLane = kBK / 32;
constexpr int kMaxHd = 128;
constexpr int kDimsPerLane = kMaxHd / 32;
constexpr float kNegInf = -2.3819763e38f;  // the Pallas kernel's NEG_INF
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

}  // namespace

extern "C" __global__ void __launch_bounds__(kWarps * 32)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int S, int T, int H, int KV, int hd, int causal,
                       int window, float softcap, float scale) {
  extern __shared__ float smem[];
  const int ks = hd + 1;                 // padded K row stride
  float* q_s = smem;                     // kBQ * hd, pre-scaled
  float* k_s = q_s + kBQ * hd;           // kBK * ks
  float* v_s = k_s + kBK * ks;           // kBK * hd

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.y * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t q_stride = (size_t)H * hd;    // between sequence positions
  const size_t kv_stride = (size_t)KV * hd;
  const float* qb = q + ((size_t)b * S * H + h) * hd;
  const float* kb = k + ((size_t)b * T * KV + kvh) * hd;
  const float* vb = v + ((size_t)b * T * KV + kvh) * hd;
  float* ob = o + ((size_t)b * S * H + h) * hd;

  for (int i = threadIdx.x; i < kBQ * hd; i += blockDim.x) {
    const int r = i / hd, c = i - r * hd;
    const int s = q0 + r;
    q_s[i] = s < S ? qb[(size_t)s * q_stride + c] * scale : 0.0f;
  }

  float m_i[kRowsPerWarp], l_i[kRowsPerWarp];
  float acc[kRowsPerWarp][kDimsPerLane];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m_i[rr] = kNegInf;
    l_i[rr] = 0.0f;
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) acc[rr][i] = 0.0f;
  }

  for (int kt = 0; kt < T; kt += kBK) {
    __syncthreads();  // the previous tile is consumed (and q_s written)
    for (int i = threadIdx.x; i < kBK * hd; i += blockDim.x) {
      const int j = i / hd, c = i - j * hd;
      const int t = kt + j;
      const bool in = t < T;
      k_s[j * ks + c] = in ? kb[(size_t)t * kv_stride + c] : 0.0f;
      v_s[j * hd + c] = in ? vb[(size_t)t * kv_stride + c] : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int qpos = q0 + r;
      const float* qr = q_s + r * hd;
      float s_[kKeysPerLane];
      float tile_max = -INFINITY;
#pragma unroll
      for (int u = 0; u < kKeysPerLane; ++u) {
        const int j = lane + 32 * u, t = kt + j;
        float sc = -INFINITY;            // past T: no weight at all
        if (t < T) {
          const float* kr = k_s + j * ks;
          float a = 0.0f;
          for (int c = 0; c < hd; ++c) a = fmaf(qr[c], kr[c], a);
          if (softcap > 0.0f) a = softcap * tanhf(a / softcap);
          bool ok = true;
          if (causal) ok = ok && t <= qpos;
          if (window > 0) ok = ok && t > qpos - window;
          sc = ok ? a : kNegInf;
        }
        s_[u] = sc;
        tile_max = fmaxf(tile_max, sc);
      }
      const float m_new = fmaxf(m_i[rr], warp_max(tile_max));
      float p_[kKeysPerLane];
      float psum = 0.0f;
#pragma unroll
      for (int u = 0; u < kKeysPerLane; ++u) {
        p_[u] = expf(s_[u] - m_new);
        psum += p_[u];
      }
      const float corr = expf(m_i[rr] - m_new);
      l_i[rr] = corr * l_i[rr] + warp_sum(psum);
      m_i[rr] = m_new;
#pragma unroll
      for (int i = 0; i < kDimsPerLane; ++i) acc[rr][i] *= corr;
#pragma unroll
      for (int u = 0; u < kKeysPerLane; ++u) {
        for (int src = 0; src < 32; ++src) {
          const float pj = __shfl_sync(kFull, p_[u], src);
          const float* vr = v_s + (u * 32 + src) * hd;
#pragma unroll
          for (int i = 0; i < kDimsPerLane; ++i) {
            const int c = lane + 32 * i;
            if (c < hd) acc[rr][i] = fmaf(pj, vr[c], acc[rr][i]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int s = q0 + warp * kRowsPerWarp + rr;
    if (s >= S) continue;
    const float denom = fmaxf(l_i[rr], 1e-30f);
#pragma unroll
    for (int i = 0; i < kDimsPerLane; ++i) {
      const int c = lane + 32 * i;
      if (c < hd) ob[(size_t)s * q_stride + c] = acc[rr][i] / denom;
    }
  }
}

extern "C" int tryage_flash_attention(const float* q, const float* k,
                                      const float* v, float* o, int B, int S,
                                      int T, int H, int KV, int hd, int causal,
                                      int window, float softcap, float scale,
                                      void* stream) {
  if (B <= 0 || S <= 0) return 0;
  const size_t smem = sizeof(float) * ((size_t)kBQ * hd + (size_t)kBK * (hd + 1) +
                                       (size_t)kBK * hd);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(B * H, (S + kBQ - 1) / kBQ);
  flash_attention_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      q, k, v, o, S, T, H, KV, hd, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}
