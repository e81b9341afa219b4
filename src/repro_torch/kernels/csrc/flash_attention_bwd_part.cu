// One part of the attention backward kernel's instances
// (flash_attention_bwd.cuh; the design notes and the C entry point are in
// flash_attention_bwd.cu): inputs of type TRYAGE_BWD_BF16 (0: f32, 1:
// bf16) and hd / 8 in [TRYAGE_BWD_LO, TRYAGE_BWD_LO + 7].  kernels/build.py
// compiles this file once per part (PARTS), all parts side by side.
#include "flash_attention_bwd.cuh"

namespace tryage {

template <>
int flash_attention_bwd_part<TRYAGE_BWD_BF16, TRYAGE_BWD_LO>(
    int kd, const Args& a, cudaStream_t stream) {
  using Tin = std::conditional_t<TRYAGE_BWD_BF16 != 0, __nv_bfloat16, float>;
  return dispatch_bwd<Tin, TRYAGE_BWD_LO, TRYAGE_BWD_LO + 7>(kd, a, stream);
}

}  // namespace tryage
