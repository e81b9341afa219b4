// Host helpers shared by the port's kernels.
#pragma once

#include <cuda_runtime.h>

namespace tryage {

// Dynamic shared memory above the 48 KB default needs an opt-in.
template <typename Kernel>
__host__ cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace tryage
