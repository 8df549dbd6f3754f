// Shared by the vector routes of the projecting warps, kernel A
// (warp_depth.cu) and kernel G (warp_mei.cu), and by the row route of the
// grid warps, kernels E and F (warp_grid.cu): one block per (warp n,
// output row) of W pixels, W / 4 threads (whole warps at the recipes'
// W = 640 and 384), each thread projecting pixels t, t + W/4, t + W/4*2,
// t + W/4*3 once (E and F: reading their grid once) and keeping their
// coordinates in registers, so a warp works on 32 neighbouring pixels at a
// time and its corner gathers touch as few cache lines as the narrow
// route's. The row's three NHWC outputs (E: one) and its overlap bytes (A
// and G) are staged in shared memory and leave as
// contiguous 16-byte streaming stores (each warp store covers 512 bytes of
// the row; a thread storing its own 4 pixels' 4C floats would cover a
// 16C-byte stride per lane, as many sectors as scalar stores) and 4-byte
// overlap stores of 4 pixels. Kernel G's bfloat16 form stages its outputs
// as bfloat16 (2-byte elements: a 16-byte store carries 8 values), which
// needs W C a multiple of 8 (the fisheye row, 384 x 3 x 2 = 2304 bytes).
// The element-type helpers below serve the bfloat16 forms of kernels B, G
// and H: operands widened exactly to float32, float32 arithmetic, results
// rounded once.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "launch.cuh"

namespace {

constexpr int kRowPix = 4;             // pixels per thread
// at most 512 threads a block (so W <= 2048), 3 blocks of them an SM: the
// kernels' launch bound, which holds them to 40 registers. At the recipes
// on an H100, G ran 8% and A 2% faster than at the 64 and 55 registers of
// a bound of 1024 threads; A ran slower at 2 or 8 pixels a thread, G 1.6%
// faster at 2 and slower at 8 (scripts/proj_variants.py).
constexpr int kRowMaxThreads = 512;
constexpr int kRowMinBlocks = 3;
// the dynamic shared memory a block may take, less room for the kernels'
// static arrays
constexpr int kRowMaxSmem = 232448 - 1024;

// threads of a row's block: W / 4 rounded up to whole warps
inline int row_threads(int W) { return (W / kRowPix + 31) / 32 * 32; }

// the projecting warps' staged row: out, va, vb (W C elements of `elem`
// bytes each), then W overlap bytes
inline long row_smem(int W, int C, int elem = 4) {
  return 3L * elem * W * C + W;
}

// the rows a row-staging kernel takes: W / 4 threads of at most 512 and
// `smem` bytes of staged row
inline bool row_fits_bytes(int W, long smem) {
  return W > 0 && W % kRowPix == 0 && W / kRowPix <= kRowMaxThreads &&
         smem <= kRowMaxSmem;
}

// the shapes the projecting warps' vector route takes at `elem`-byte
// outputs: each output row a whole number of 16-byte stores (the host's
// proj_route mirrors this)
inline bool row_fits(int W, int C, int elem = 4) {
  return C > 0 && (long)W * C * elem % 16 == 0 &&
         row_fits_bytes(W, row_smem(W, C, elem));
}

// float32 as it is, a bfloat16 widened (exactly)
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// a float32 result stored as T: as it is, or rounded to nearest bfloat16
template <typename T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// the channel products of kernels B and H (gfx = sum_c g va): float32 as
// they are; on bfloat16 operands each product rounded to bfloat16, as
// PyTorch's bfloat16 multiply rounds it, and widened back
__device__ __forceinline__ float product(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float product(__nv_bfloat16 a, __nv_bfloat16 b) {
  return widen(narrow<__nv_bfloat16>(__fmul_rn(widen(a), widen(b))));
}
// their channel sum, taken in float32, as stored in T and widened back
template <typename T>
__device__ __forceinline__ float rounded(float v) {
  return widen(narrow<T>(v));
}

// The band start of the row from each thread's min floor(y): the block's
// minimum, clipped to [0, H - band] and rounded down to even. Every thread
// of the block calls it.
__device__ __forceinline__ int row_band_start(int lo, int H, int band) {
  __shared__ int s_min[kRowMaxThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
  if ((threadIdx.x & 31) == 0) s_min[threadIdx.x >> 5] = lo;
  __syncthreads();
  int ymin = s_min[0];
  for (int k = 1; k < (int)(blockDim.x >> 5); ++k) ymin = min(ymin, s_min[k]);
  ymin = min(max(ymin, 0), max(H - band, 0));
  return ymin - (ymin & 1);
}

// The staged row in dynamic shared memory, of T elements.
template <typename T>
struct RowStageOf {
  T *out, *va, *vb;
  uint8_t* overlap;
};
using RowStage = RowStageOf<float>;

template <typename T = float>
__device__ __forceinline__ RowStageOf<T> row_stage(float4* smem, int W,
                                                   int C) {
  T* s = reinterpret_cast<T*>(smem);
  const int wc = W * C;
  return RowStageOf<T>{s, s + wc, s + 2 * wc,
                       reinterpret_cast<uint8_t*>(s + 3 * wc)};
}

// Writes the staged row to row `row` (= n H + i) of out [., W, C], where
// `va` is not null of va and vb [., W, C] too (kernel E's row route stages
// out alone), and where `overlap` is not null of overlap [., W]; every
// thread of the block calls it after the barrier that ends the staging.
// Each 16-byte store carries 16 / sizeof(T) elements.
template <typename T>
__device__ __forceinline__ void row_flush(const RowStageOf<T>& st,
                                          size_t row, int W, int C, T* out,
                                          T* va, T* vb, uint8_t* overlap) {
  const int q16 = W * C * (int)sizeof(T) / 16;
  const size_t o16 = row * (size_t)q16;
  const float4* so = reinterpret_cast<const float4*>(st.out);
  const float4* sa = reinterpret_cast<const float4*>(st.va);
  const float4* sb = reinterpret_cast<const float4*>(st.vb);
  for (int q = threadIdx.x; q < q16; q += blockDim.x) {
    __stcs(reinterpret_cast<float4*>(out) + o16 + q, so[q]);
    if (va != nullptr) {
      __stcs(reinterpret_cast<float4*>(va) + o16 + q, sa[q]);
      __stcs(reinterpret_cast<float4*>(vb) + o16 + q, sb[q]);
    }
  }
  if (overlap != nullptr) {
    const uchar4* sv = reinterpret_cast<const uchar4*>(st.overlap);
    uchar4* ov = reinterpret_cast<uchar4*>(overlap) + row * (size_t)(W / 4);
    for (int q = threadIdx.x; q < W / 4; q += blockDim.x)
      __stcs(ov + q, sv[q]);
  }
}

// Launches `kern` on grid (H, N) with the row's block and `smem` bytes of
// dynamic shared memory, raising the kernel's shared-memory limit first
// where the row needs more than 48 KB (`smem_set`: the caller's static for
// this kernel).
template <typename K, typename... Args>
inline int row_launch_bytes(K kern, unsigned& smem_set, long smem, int N,
                            int H, int W, void* stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = allow_smem(kern, (int)smem, smem_set);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3((unsigned)H, (unsigned)N), row_threads(W), (size_t)smem,
         static_cast<cudaStream_t>(stream)>>>(args...);
  return (int)cudaGetLastError();
}

// the same with the projecting warps' staged row of T outputs
template <typename T = float, typename K, typename... Args>
inline int row_launch(K kern, unsigned& smem_set, int N, int H, int W, int C,
                      void* stream, Args... args) {
  return row_launch_bytes(kern, smem_set, row_smem(W, C, (int)sizeof(T)), N,
                          H, W, stream, args...);
}

}  // namespace
