// An empty kernel: its device time is the floor under any launch on
// this card, which the small kernels (the router heads) are held beside.
// It computes nothing and replaces no TPU kernel.
#include <cuda_runtime.h>

extern "C" __global__ void launch_floor_kernel() {}

extern "C" int tryage_launch_floor(int grid, int threads, void* stream) {
  launch_floor_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
