// Shared by the band-warp kernels of warp_grid.cu (E, F) and warp_grad.cu
// (K): the corner indices, weights and validity of one sample, the band
// start of one output row and the blend, rounded once per operation in the
// order of indices_and_weights and band_sample in ops/warp_fast.py, so every
// kernel sees the plain version's corners and values exactly. Blocks of
// kThreads threads (the row route's: csrc/warp_rows.cuh).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

#include "launch.cuh"

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

// the corners of the sample at normalized (gx, gy): the one piece of
// corner arithmetic of the narrow, channel-wide and row routes
__device__ __forceinline__ Corners corners_at(float gx, float gy, int H,
                                              int W, bool nearest,
                                              bool zeros) {
  Corners k;
  axis(gx, W, nearest, zeros, k.x0, k.x1, k.wx0, k.wx1, k.mx0, k.mx1);
  axis(gy, H, nearest, zeros, k.y0, k.y1, k.wy0, k.wy1, k.my0, k.my1);
  return k;
}

__device__ __forceinline__ Corners corners(const float* g, int H, int W,
                                           bool nearest, bool zeros) {
  return corners_at(g[0], g[1], H, W, nearest, zeros);
}

// the sample's two rows clamped into the band [ymin, ymin + band)
__device__ __forceinline__ void band_clamp(Corners& k, int ymin, int band) {
  k.y0 = ymin + min(max(k.y0 - ymin, 0), band - 1);
  k.y1 = ymin + min(max(k.y1 - ymin, 0), band - 1);
}

// the band start from the row's min y0c: clipped to [0, H - band] and
// rounded down to even
__device__ __forceinline__ int band_round(int ymin, int H, int band) {
  ymin = min(max(ymin, 0), max(H - band, 0));
  return ymin - (ymin & 1);
}

__device__ __forceinline__ int warp_min(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// min y0c over the row, clipped to [0, H - band] and rounded down to even;
// every thread of the block calls it
__device__ __forceinline__ int band_start(const float* grow, int Wo, int H,
                                          int band, bool nearest, bool zeros) {
  __shared__ int s_min[kThreads / 32];
  int lo = INT_MAX;
  for (int j = threadIdx.x; j < Wo; j += kThreads)
    lo = min(lo, first_row(grow[2 * j + 1], H, nearest, zeros));
  lo = warp_min(lo);
  if ((threadIdx.x & 31) == 0) s_min[threadIdx.x >> 5] = lo;
  __syncthreads();
  int ymin = s_min[0];
#pragma unroll
  for (int k = 1; k < kThreads / 32; ++k) ymin = min(ymin, s_min[k]);
  return band_round(ymin, H, band);
}

// the same over the whole row by one warp alone (every lane calls it): the
// channel-wide kernels split a row among warps, and each reduces the full
// row itself, so no barrier ties the warps of a block together
__device__ __forceinline__ int band_start_warp(const float* grow, int Wo,
                                               int H, int band, bool nearest,
                                               bool zeros) {
  int lo = INT_MAX;
  for (int j = threadIdx.x & 31; j < Wo; j += 32)
    lo = min(lo, first_row(grow[2 * j + 1], H, nearest, zeros));
  return band_round(warp_min(lo), H, band);
}

// Channel-wide layout (C bytes a multiple of 16, every pointer 16-byte
// aligned): Q = 16-byte vectors per sample (C / 4 in float32, C / 8 in
// bfloat16), L = the power of two >= min(32, Q) lanes per sample, each lane
// owning one vector of consecutive channels and stepping by L vectors, so
// one warp covers 32 / L samples at a time. A warp task is (output row, part):
// a row of warp n is split into `parts` tasks, part p taking the samples
// (p + m parts) 32 / L + (lane / L), m = 0, 1, ...: the warps of a block
// cover neighbouring samples and share their corners in L1.
struct VecTask {
  int row;   // n * Ho + i
  int part;
};

__device__ __forceinline__ VecTask vec_task(int parts) {
  const int task = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  return VecTask{task / parts, task % parts};
}

// parts per row: enough warp tasks for one wave of resident warps on every
// SM (64 warps an SM), and at least one sample group per task. One task per
// row leaves SMs idle at the small DCN shapes (648 rows of 20 samples at
// 6x20x512) and makes the warps of the large ones long; every further part
// repeats the row's band reduction. At the 16 DCN shapes two waves timed
// the same as one (ahead in one run, behind in the next), one task per row
// was slower and four waves no faster.
inline int vec_parts(int rows, int Wo, int samples_per_warp, int sms) {
  const long want = (long)sms * 64;
  const int groups = (Wo + samples_per_warp - 1) / samples_per_warp;
  const long parts = (want + rows - 1) / rows;
  return (int)(parts < 1 ? 1 : parts > groups ? groups : parts);
}

inline bool bad_dims(int M, int N, int H, int W, int C, int Ho, int Wo,
                     int band) {
  return M <= 0 || N <= 0 || N % M || H <= 0 || W <= 0 || C <= 0 || Ho <= 0 ||
         Wo <= 0 || band <= 0 || band > H;
}

// The channel-wide launch of N warps of Ho x Wo samples of Q vectors:
// lanes per sample (log2), parts per row, and blocks of kThreads; false
// where the blocks would exceed the launch limit.
struct VecLaunch {
  int lanes_log2, parts, rows;
  unsigned blocks;
};

inline bool vec_launch(int Q, int N, int Ho, int Wo, VecLaunch& v) {
  const int q = Q < 32 ? Q : 32;
  v.lanes_log2 = 0;
  while ((1 << v.lanes_log2) < q) ++v.lanes_log2;
  v.rows = N * Ho;
  v.parts = vec_parts(v.rows, Wo, 32 >> v.lanes_log2, sm_count());
  const long blocks =
      ((long)v.rows * v.parts + kThreads / 32 - 1) / (kThreads / 32);
  v.blocks = (unsigned)blocks;
  return blocks <= 0x7fffffffL;
}

// The corners of sample j of a row, its rows clamped into the band
// [ymin, ymin + band); j is clamped into the row, so a lane past its end
// computes a valid sample and discards it.
__device__ __forceinline__ Corners band_corners(const float* grow, int j,
                                                int Wo, int H, int W, int ymin,
                                                int band, bool nearest,
                                                bool zeros) {
  Corners k = corners(grow + 2 * min(j, Wo - 1), H, W, nearest, zeros);
  band_clamp(k, ymin, band);
  return k;
}

// Iteration m of a warp task takes sample vec_sample_index(m) in each
// segment of L lanes; every lane of the segment computes the sample's
// corners itself (about 25 operations, the same in each lane: cheaper than
// computing each once and broadcasting them by __shfl_sync, which timed
// the same for E and slower for K).
__device__ __forceinline__ int vec_sample_index(int m, int part, int parts,
                                                int lanes_log2, int lane) {
  return ((part + m * parts) << (5 - lanes_log2)) + (lane >> lanes_log2);
}

// one channel's blend, rounded as the plain version rounds it
__device__ __forceinline__ float blend(float i00, float i01, float i10,
                                       float i11, const Corners& k) {
  const float h0 = __fadd_rn(__fmul_rn(i00, k.wx0), __fmul_rn(i01, k.wx1));
  const float h1 = __fadd_rn(__fmul_rn(i10, k.wx0), __fmul_rn(i11, k.wx1));
  return __fadd_rn(__fmul_rn(h0, k.wy0), __fmul_rn(h1, k.wy1));
}

// one channel's blend and the values of its VJP (kernel F): va = d out/d
// fx, vb = d out/d fy, rounded as the plain version rounds them
struct Blended {
  float out, va, vb;
};

__device__ __forceinline__ Blended blend_vjp(float i00, float i01, float i10,
                                             float i11, const Corners& k) {
  const float h0 = __fadd_rn(__fmul_rn(i00, k.wx0), __fmul_rn(i01, k.wx1));
  const float h1 = __fadd_rn(__fmul_rn(i10, k.wx0), __fmul_rn(i11, k.wx1));
  const float a0 = __fsub_rn(__fmul_rn(i01, k.mx1), __fmul_rn(i00, k.mx0));
  const float a1 = __fsub_rn(__fmul_rn(i11, k.mx1), __fmul_rn(i10, k.mx0));
  return Blended{__fadd_rn(__fmul_rn(h0, k.wy0), __fmul_rn(h1, k.wy1)),
                 __fadd_rn(__fmul_rn(a0, k.wy0), __fmul_rn(a1, k.wy1)),
                 __fsub_rn(__fmul_rn(h1, k.my1), __fmul_rn(h0, k.my0))};
}

// 16 bytes of consecutive channels widened to float (exactly) and back: 4
// float32 values, or 8 bfloat16 values (channel 2k in the low half of
// word k), rounded to nearest even as PyTorch's .to(torch.bfloat16) rounds.
template <typename T>
struct Vec16 {
  static constexpr int kN = 16 / (int)sizeof(T);
};

__device__ __forceinline__ void widen(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void widen(const uint4& u, float (&v)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// 4 bfloat16 values (8 bytes) widened to float
__device__ __forceinline__ void widen(const uint2& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}

__device__ __forceinline__ uint4 narrow(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}

__device__ __forceinline__ uint4 narrow(const float (&v)[8]) {
  unsigned w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
    w[k] = *reinterpret_cast<const unsigned*>(&p);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

}  // namespace
