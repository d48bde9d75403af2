// Launch helper shared by the kernels' C entry points.
#pragma once
#include <cuda_runtime.h>

// Opt the kernel `fn` in to `smem` bytes of dynamic shared memory where that
// is above the 48 KB every kernel may use without asking.  The caller has
// made the tensors' device current (the Python wrappers hold torch's device
// guard around each launch), so nothing here changes the current device.
static inline cudaError_t prepare(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}
