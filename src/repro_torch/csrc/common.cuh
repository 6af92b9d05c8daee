// Host helpers that every kernel source in this directory shares.
#pragma once

#include <cuda_runtime.h>

#include <mutex>

// Dynamic shared bytes a block may have on an H100 (227 KB), when the
// kernel has no static shared memory: the plans' ceiling.
constexpr int kMaxSmem = 232448;

// Lets `kernel` take `bytes` of dynamic shared memory on `device`. The
// attribute is set once per kernel and device, to the most the kernel can
// have there: the device's opt-in limit less the kernel's own static shared
// memory (the two together may not pass the limit). A cudaFuncSetAttribute
// per call would cost host time and, once torch.profiler has run in the
// process, a kernel record of a later profile. Returns
// cudaErrorInvalidValue when `bytes` is more than the kernel can have.
inline cudaError_t allow_smem(const void* kernel, int bytes, int device) {
  struct Entry {
    const void* kernel;
    int device, most;
  };
  constexpr int kEntries = 256;
  static Entry seen[kEntries];
  static int n = 0;
  static std::mutex mu;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n; ++i)
    if (seen[i].kernel == kernel && seen[i].device == device)
      return bytes <= seen[i].most ? cudaSuccess : cudaErrorInvalidValue;
  if (n == kEntries) return cudaErrorMemoryAllocation;
  cudaFuncAttributes attr;
  int optin = 0;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  const int most = optin - (int)attr.sharedSizeBytes;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err != cudaSuccess) return err;
  seen[n++] = {kernel, device, most};
  return bytes <= most ? cudaSuccess : cudaErrorInvalidValue;
}
