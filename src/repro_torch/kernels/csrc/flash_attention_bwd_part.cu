// One part of the attention backward kernel's instances (the design
// notes and the C entry point are in flash_attention_bwd.cu): inputs of
// type TRYAGE_BWD_BF16 (0: f32, body flash_attention_bwd.cuh; 1: bf16,
// body flash_attention_bwd_bf16.cuh) and hd / 8 in [TRYAGE_BWD_LO,
// TRYAGE_BWD_LO + 7] (bf16: the instances of hd / 16 rounded up in
// [(TRYAGE_BWD_LO + 1) / 2, (TRYAGE_BWD_LO + 1) / 2 + 3]).
// kernels/build.py compiles this file once per part (PARTS), all parts
// side by side.
#if TRYAGE_BWD_BF16
#include "flash_attention_bwd_bf16.cuh"
#else
#include "flash_attention_bwd.cuh"
#endif

namespace tryage {

template <>
int flash_attention_bwd_part<TRYAGE_BWD_BF16, TRYAGE_BWD_LO>(
    int kd, const Args& a, cudaStream_t stream) {
#if TRYAGE_BWD_BF16
  constexpr int lo = (TRYAGE_BWD_LO + 1) / 2;
  return dispatch_bwd_bf16<lo, lo + 3>((kd + 1) / 2, a, 8 * kd, stream);
#else
  return dispatch_bwd<float, TRYAGE_BWD_LO, TRYAGE_BWD_LO + 7>(kd, a, stream);
#endif
}

}  // namespace tryage
