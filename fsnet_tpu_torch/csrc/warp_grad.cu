// Backward of the band warp by a sampling grid for Hopper (sm_90a), bound
// through a plain C interface (ctypes): kernel K, both cotangents of
// fsnet_tpu_torch.ops.warp_fast.grid_sample with image_grad (the deformable
// conv's taps), recomputed from the image instead of saved by the forward.
//
// Layouts: image [M, H, W, C] NHWC f32, grid [N, Ho, Wo, 2] f32 with
// normalized (x, y) in [-1, 1] (align_corners), N a multiple of M, and the
// output cotangent g [N, Ho, Wo, C] f32. Warp n reads image n mod M and
// scatters into its cotangent: the K*K taps of a deformable conv run as one
// grid batch of K*K*B against B images.
//
// Per sample, with the corners, weights, validity and band of warp_band.cuh
// (the forward's, kernels E and F), it writes
//   gfx = sum_c g * d out/d fx,  d out/d fx = (i01 mx1 - i00 mx0) wy0
//                                            + (i11 mx1 - i10 mx0) wy1,
//   gfy = sum_c g * d out/d fy,  d out/d fy = h1 my1 - h0 my0,
// (h0 = i00 wx0 + i01 wx1, h1 = i10 wx0 + i11 wx1; the pixel-space grid
// cotangent, [N, Ho, Wo] each), and adds (g wy0) wx0, (g wy0) wx1,
// (g wy1) wx0 and (g wy1) wx1 into the image cotangent at the four corners
// (r0|r1, x0|x1), the rows clamped into the band as the forward read them.
// dimage must be zero on entry.
//
// Kernel K replaces fsnet_tpu/ops/pallas/warp_kernel.py
// warp_rows_pallas_dma_bwd (the grid cotangent, band rows gathered by DMA)
// and its twin on materialized bands, warp_rows_pallas_bwd, and fuses in
// the image cotangent that fsnet_tpu/ops/warp_fast.py _bwd computes in XLA
// (one-hot band scatter-add).
//
// Two routes, chosen on the host as kernel E's (ops/warp_fast.py
// warp_route), never one after the other fails:
// - narrow (C not a multiple of 4, or a pointer not 16-byte aligned): one
//   block per (warp n, output row); the block reduces the band start, then
//   each of its 8 warps takes one output sample at a time with its lanes
//   over the channels, one scalar load and four scalar atomicAdd per
//   channel.
// - channel-wide (C a multiple of 4: the deformable convs, C = 64-512):
//   the layout of warp_band.cuh, L <= 32 lanes per sample with a float4 of
//   channels each. g is read once, as streaming 16-byte loads (__ldcs); the
//   corners as 16-byte loads through the read-only path; and the four
//   corner products go to dimage as vector float atomics
//   (atomicAdd(float4*, float4), one red.global.add.v4.f32 per 4 channels,
//   a quarter of the L2 operations of scalar adds). Each lane sums gfx and
//   gfy over its channels, then the L lanes of a sample reduce by
//   __shfl_xor_sync in a fixed order: gfx and gfy are reproducible launch
//   to launch; dimage's atomic sums are not.
// What bounds it on an H100: bytes, on paper: it reads g once and the ~4
// band rows of each output row (L1/L2 resident), adds into dimage (L2
// atomics), and writes 2 floats per sample; about 32 operations per sample
// and channel. In practice the L2's atomic units set the pace: every
// sample and channel adds 4 floats, 7.75 GB of atomic payload per DLA
// step at bs12 @192x640 (484 M vector adds), which the H100 80GB HBM3 runs
// at about 2 TB/s (1.9 G scalar adds ran at 1.5 TB/s). Pre-summing the 9
// taps of a row in a shared-memory window of dimage cuts the global adds
// by 4.5 but needs float atomics in shared memory, which compile to
// compare-and-swap loops (ATOMS.CAST.SPIN): it ran 2.5 times slower.
#include <cuda_runtime.h>

#include <cstddef>

#include "warp_band.cuh"

namespace {

// One channel of the backward, rounded as the plain version rounds it: adds
// g va and g vb to the sums sa, sb and returns the four corner products
// (g wy0) wx0, (g wy0) wx1, (g wy1) wx0, (g wy1) wx1.
struct CornerAdds {
  float d00, d01, d10, d11;
};

__device__ __forceinline__ CornerAdds channel_bwd(float gc, float i00,
                                                  float i01, float i10,
                                                  float i11, const Corners& k,
                                                  float& sa, float& sb) {
  const float h0 = __fadd_rn(__fmul_rn(i00, k.wx0), __fmul_rn(i01, k.wx1));
  const float h1 = __fadd_rn(__fmul_rn(i10, k.wx0), __fmul_rn(i11, k.wx1));
  const float a0 = __fsub_rn(__fmul_rn(i01, k.mx1), __fmul_rn(i00, k.mx0));
  const float a1 = __fsub_rn(__fmul_rn(i11, k.mx1), __fmul_rn(i10, k.mx0));
  const float va = __fadd_rn(__fmul_rn(a0, k.wy0), __fmul_rn(a1, k.wy1));
  const float vb = __fsub_rn(__fmul_rn(h1, k.my1), __fmul_rn(h0, k.my0));
  sa = __fadd_rn(sa, __fmul_rn(gc, va));
  sb = __fadd_rn(sb, __fmul_rn(gc, vb));
  const float g0 = __fmul_rn(gc, k.wy0), g1 = __fmul_rn(gc, k.wy1);
  return CornerAdds{__fmul_rn(g0, k.wx0), __fmul_rn(g0, k.wx1),
                    __fmul_rn(g1, k.wx0), __fmul_rn(g1, k.wx1)};
}

__global__ void __launch_bounds__(kThreads)
warp_grid_bwd_kernel(const float* __restrict__ image,
                     const float* __restrict__ grid,
                     const float* __restrict__ g, float* __restrict__ gfx,
                     float* __restrict__ gfy, float* __restrict__ dimage,
                     int M, int H, int W, int C, int Ho, int Wo, int band,
                     bool nearest, bool zeros) {
  const int i = blockIdx.x;                // output row
  const int n = blockIdx.y;                // warp
  const float* grow = grid + ((size_t)n * Ho + i) * Wo * 2;
  const int ymin = band_start(grow, Wo, H, band, nearest, zeros);
  const size_t img = (size_t)(n % M) * H * W * C;
  const float* src = image + img;
  float* dst = dimage + img;
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < Wo; j += kThreads / 32) {
    const Corners k =
        band_corners(grow, j, Wo, H, W, ymin, band, nearest, zeros);
    const size_t c00 = ((size_t)k.y0 * W + k.x0) * C;
    const size_t c01 = ((size_t)k.y0 * W + k.x1) * C;
    const size_t c10 = ((size_t)k.y1 * W + k.x0) * C;
    const size_t c11 = ((size_t)k.y1 * W + k.x1) * C;
    const size_t o = ((size_t)n * Ho + i) * Wo + j;
    const float* gp = g + o * C;
    float sa = 0.f, sb = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float gc = __ldg(gp + c);
      const float i00 = __ldg(src + c00 + c), i01 = __ldg(src + c01 + c);
      const float i10 = __ldg(src + c10 + c), i11 = __ldg(src + c11 + c);
      const CornerAdds d = channel_bwd(gc, i00, i01, i10, i11, k, sa, sb);
      atomicAdd(dst + c00 + c, d.d00);
      atomicAdd(dst + c01 + c, d.d01);
      atomicAdd(dst + c10 + c, d.d10);
      atomicAdd(dst + c11 + c, d.d11);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      sa += __shfl_xor_sync(0xffffffffu, sa, off);
      sb += __shfl_xor_sync(0xffffffffu, sb, off);
    }
    if (lane == 0) {
      gfx[o] = sa;
      gfy[o] = sb;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
warp_grid_bwd_vec_kernel(const float4* __restrict__ image,
                         const float* __restrict__ grid,
                         const float4* __restrict__ g, float* __restrict__ gfx,
                         float* __restrict__ gfy, float4* __restrict__ dimage,
                         int M, int H, int W, int Q, int Ho, int Wo, int band,
                         int lanes_log2, int parts, int rows, bool nearest,
                         bool zeros) {
  const VecTask t = vec_task(parts);
  if (t.row >= rows) return;               // whole warps: tasks are warps
  const float* grow = grid + (size_t)t.row * Wo * 2;
  const int ymin = band_start_warp(grow, Wo, H, band, nearest, zeros);
  const int lane = threadIdx.x & 31, L = 1 << lanes_log2;
  const size_t img = (size_t)(t.row / Ho % M) * H * W * Q;
  const float4* src = image + img;
  float4* dst = dimage + img;
  const int groups = (Wo + (32 >> lanes_log2) - 1) >> (5 - lanes_log2);
  const int iters = (groups - t.part + parts - 1) / parts;
  for (int m = 0; m < iters; ++m) {
    const int j = vec_sample_index(m, t.part, parts, lanes_log2, lane);
    const Corners k =
        band_corners(grow, j, Wo, H, W, ymin, band, nearest, zeros);
    float sa = 0.f, sb = 0.f;
    if (j < Wo) {
      const size_t c00 = ((size_t)k.y0 * W + k.x0) * Q;
      const size_t c01 = ((size_t)k.y0 * W + k.x1) * Q;
      const size_t c10 = ((size_t)k.y1 * W + k.x0) * Q;
      const size_t c11 = ((size_t)k.y1 * W + k.x1) * Q;
      const float4* gp = g + ((size_t)t.row * Wo + j) * Q;
      for (int q = lane & (L - 1); q < Q; q += L) {
        const float4 gv = __ldcs(gp + q);
        const float4 a = __ldg(src + c00 + q), b = __ldg(src + c01 + q);
        const float4 c = __ldg(src + c10 + q), d = __ldg(src + c11 + q);
        const CornerAdds x = channel_bwd(gv.x, a.x, b.x, c.x, d.x, k, sa, sb);
        const CornerAdds y = channel_bwd(gv.y, a.y, b.y, c.y, d.y, k, sa, sb);
        const CornerAdds z = channel_bwd(gv.z, a.z, b.z, c.z, d.z, k, sa, sb);
        const CornerAdds w = channel_bwd(gv.w, a.w, b.w, c.w, d.w, k, sa, sb);
        atomicAdd(dst + c00 + q, make_float4(x.d00, y.d00, z.d00, w.d00));
        atomicAdd(dst + c01 + q, make_float4(x.d01, y.d01, z.d01, w.d01));
        atomicAdd(dst + c10 + q, make_float4(x.d10, y.d10, z.d10, w.d10));
        atomicAdd(dst + c11 + q, make_float4(x.d11, y.d11, z.d11, w.d11));
      }
    }
    // the segment's L lanes, in a fixed order (every lane of the warp takes
    // part: the loop's trip count is the warp's)
    for (int off = L >> 1; off > 0; off >>= 1) {
      sa += __shfl_xor_sync(0xffffffffu, sa, off);
      sb += __shfl_xor_sync(0xffffffffu, sb, off);
    }
    if (j < Wo && (lane & (L - 1)) == 0) {
      gfx[(size_t)t.row * Wo + j] = sa;
      gfy[(size_t)t.row * Wo + j] = sb;
    }
  }
}

}  // namespace

// Kernel K, the narrow route. image [M,H,W,C], grid [N,Ho,Wo,2], g [N,Ho,Wo,C] f32
// (N % M == 0); writes gfx, gfy [N,Ho,Wo] f32 and adds into dimage
// [M,H,W,C] f32, which must be zero on entry. nearest: 0 bilinear, 1
// nearest; zeros: 0 border, 1 zeros padding. All contiguous. Launches on
// `stream` and returns cudaGetLastError() (0 on success); never
// synchronises.
extern "C" int fsnet_warp_grid_bwd(const void* image, const void* grid,
                                   const void* g, void* gfx, void* gfy,
                                   void* dimage, int M, int N, int H, int W,
                                   int C, int Ho, int Wo, int band,
                                   int nearest, int zeros, void* stream) {
  if (bad_dims(M, N, H, W, C, Ho, Wo, band) || N > 65535)
    return (int)cudaErrorInvalidValue;
  warp_grid_bwd_kernel<<<dim3((unsigned)Ho, (unsigned)N), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(image), static_cast<const float*>(grid),
      static_cast<const float*>(g), static_cast<float*>(gfx),
      static_cast<float*>(gfy), static_cast<float*>(dimage), M, H, W, C, Ho,
      Wo, band, nearest != 0, zeros != 0);
  return (int)cudaGetLastError();
}

// Kernel K, the channel-wide route: as fsnet_warp_grid_bwd, for C a
// multiple of 4 with image, g and dimage 16-byte aligned (else
// cudaErrorInvalidValue, nothing launched).
extern "C" int fsnet_warp_grid_bwd_vec(const void* image, const void* grid,
                                       const void* g, void* gfx, void* gfy,
                                       void* dimage, int M, int N, int H,
                                       int W, int C, int Ho, int Wo, int band,
                                       int nearest, int zeros, void* stream) {
  if (bad_dims(M, N, H, W, C, Ho, Wo, band) || C % 4 ||
      !aligned16(image) || !aligned16(g) || !aligned16(dimage))
    return (int)cudaErrorInvalidValue;
  VecLaunch v;
  if (!vec_launch(C, N, Ho, Wo, v)) return (int)cudaErrorInvalidValue;
  warp_grid_bwd_vec_kernel<<<v.blocks, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(image), static_cast<const float*>(grid),
      static_cast<const float4*>(g), static_cast<float*>(gfx),
      static_cast<float*>(gfy), static_cast<float4*>(dimage), M, H, W, C / 4,
      Ho, Wo, band, v.lanes_log2, v.parts, v.rows, nearest != 0, zeros != 0);
  return (int)cudaGetLastError();
}
