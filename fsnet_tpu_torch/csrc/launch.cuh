// Host-side launch helpers shared by the kernels' C entry points: the
// 16-byte alignment that their vector routes need of every pointer, and the
// SM count that sizes their grids.
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

}  // namespace
