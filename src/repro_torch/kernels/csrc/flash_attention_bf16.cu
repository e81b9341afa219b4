// The bf16 instances of the attention kernel (flash_attention.cuh; the
// design notes and the C entry point are in flash_attention.cu), in a
// translation unit of their own so that nvcc builds them beside the f32
// ones.
#include "flash_attention.cuh"

namespace tryage {

int flash_attention_bf16(int kd, const void* q, const void* k, const void* v,
                         void* o, float* lse, int B, int S, int T, int H,
                         int KV, int causal, int window, float softcap,
                         float scale, int warps, cudaStream_t stream) {
  return dispatch<__nv_bfloat16, 1>(kd, q, k, v, o, lse, B, S, T, H, KV,
                                    causal, window, softcap, scale, warps,
                                    stream);
}

}  // namespace tryage
