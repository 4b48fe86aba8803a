// Host helper shared by the kernels that take dynamic shared memory past
// the 48 KB a launch gets by default (csrc/flash_fwd.cu, csrc/ssd_fwd.cu,
// csrc/zen_encode.cu).
#pragma once

#include <cuda_runtime.h>

constexpr int kMaxDevices = 64;

// Raises kernel's dynamic shared memory limit to `bytes` on the current
// device, once: `done` keeps the largest limit set per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int (&done)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess) done[dev] = bytes;
  return err;
}
