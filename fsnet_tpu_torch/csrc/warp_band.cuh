// Shared by the band-warp kernels of warp_grid.cu (E, F) and warp_grad.cu
// (K): the corner indices, weights and validity of one sample, and the band
// start of one output row, rounded once per operation in the order of
// indices_and_weights in ops/warp_fast.py, so every kernel sees the plain
// version's corners exactly. Blocks of kThreads threads.
#pragma once

#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kThreads = 256;

struct Corners {
  int x0, x1, y0, y1;        // corners clipped to the image
  float wx0, wx1, wy0, wy1;  // corner weights, zeros-padding masks folded in
  float mx0, mx1, my0, my1;  // corner validity (1 under border padding)
};

__device__ __forceinline__ float unnormalize(float c, int size) {
  return __fmul_rn(__fmul_rn(__fadd_rn(c, 1.f), 0.5f), (float)(size - 1));
}

// the clipped row of the first corner: the band start's input
__device__ __forceinline__ int first_row(float gy, int H, bool nearest,
                                         bool zeros) {
  float y = unnormalize(gy, H);
  const float hmax = (float)(H - 1);
  if (!zeros) y = fminf(fmaxf(y, 0.f), hmax);
  const float y0f = nearest ? floorf(__fadd_rn(y, 0.5f)) : floorf(y);
  return (int)fminf(fmaxf(y0f, 0.f), hmax);
}

__device__ __forceinline__ void axis(float c, int size, bool nearest,
                                     bool zeros, int& i0, int& i1, float& w0,
                                     float& w1, float& m0, float& m1) {
  const float cmax = (float)(size - 1);
  float v = unnormalize(c, size);
  if (!zeros) v = fminf(fmaxf(v, 0.f), cmax);
  float f0, frac;
  if (nearest) {
    f0 = floorf(__fadd_rn(v, 0.5f));
    frac = 0.f;
  } else {
    f0 = floorf(v);
    frac = __fsub_rn(v, f0);
  }
  const float f1 = __fadd_rn(f0, 1.f);
  w0 = __fsub_rn(1.f, frac);
  w1 = frac;
  m0 = m1 = 1.f;
  if (zeros) {
    m0 = (f0 >= 0.f && f0 <= cmax) ? 1.f : 0.f;
    m1 = (f1 >= 0.f && f1 <= cmax) ? 1.f : 0.f;
    if (m0 == 0.f) w0 = 0.f;
    if (m1 == 0.f) w1 = 0.f;
  }
  i0 = (int)fminf(fmaxf(f0, 0.f), cmax);
  i1 = (int)fminf(fmaxf(f1, 0.f), cmax);
}

__device__ __forceinline__ Corners corners(const float* g, int H, int W,
                                           bool nearest, bool zeros) {
  Corners k;
  axis(g[0], W, nearest, zeros, k.x0, k.x1, k.wx0, k.wx1, k.mx0, k.mx1);
  axis(g[1], H, nearest, zeros, k.y0, k.y1, k.wy0, k.wy1, k.my0, k.my1);
  return k;
}

// min y0c over the row, clipped to [0, H - band] and rounded down to even
__device__ __forceinline__ int band_start(const float* grow, int Wo, int H,
                                          int band, bool nearest, bool zeros) {
  __shared__ int s_min[kThreads / 32];
  int lo = INT_MAX;
  for (int j = threadIdx.x; j < Wo; j += kThreads)
    lo = min(lo, first_row(grow[2 * j + 1], H, nearest, zeros));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
  if ((threadIdx.x & 31) == 0) s_min[threadIdx.x >> 5] = lo;
  __syncthreads();
  int ymin = s_min[0];
#pragma unroll
  for (int k = 1; k < kThreads / 32; ++k) ymin = min(ymin, s_min[k]);
  ymin = min(max(ymin, 0), max(H - band, 0));
  return ymin - (ymin & 1);
}

}  // namespace
