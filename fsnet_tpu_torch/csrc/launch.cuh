// Host-side launch helpers shared by the kernels' C entry points: the
// 16-byte alignment that their vector routes need of every pointer, the SM
// count that sizes their grids, and the dynamic shared-memory limit of a
// kernel that needs more than 48 KB.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// SMs of the current device (132 where the query fails)
inline int sm_count() {
  int dev = 0, n = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n > 0 ? n : 132;
}

// Raises the dynamic shared-memory limit of kernel `kern` to `bytes` on the
// current device, once per device: `done`, a static of the caller's for
// this kernel, keeps one bit for each of the first 32 devices (any other
// is set on every call).
template <typename K>
inline cudaError_t allow_smem(K kern, int bytes, unsigned& done) {
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 32 && ((done >> dev) & 1u)) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess && dev < 32) done |= 1u << dev;
  return e;
}

}  // namespace
