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
// (one-hot band scatter-add). One block per (warp n, output row): the block
// reduces the band start, then each of its 8 warps takes one output sample
// at a time with its lanes over the channels (NHWC is channel-contiguous,
// so g, the corners and the atomic adds are coalesced), sums gfx and gfy
// per lane and across the warp with shuffles, and scatters with atomicAdd.
// The atomics make dimage's sums run in no fixed order: not bitwise
// reproducible run to run.
// What bounds it on an H100: bytes. It reads g once and the ~4 band rows
// of each output row (L1/L2 resident), adds into dimage (L2 atomics), and
// writes 2 floats per sample; about 32 operations per sample and channel.
#include <cuda_runtime.h>

#include <cstddef>

#include "warp_band.cuh"

namespace {

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
    const Corners k = corners(grow + 2 * j, H, W, nearest, zeros);
    const int r0 = ymin + min(max(k.y0 - ymin, 0), band - 1);
    const int r1 = ymin + min(max(k.y1 - ymin, 0), band - 1);
    const size_t c00 = ((size_t)r0 * W + k.x0) * C;
    const size_t c01 = ((size_t)r0 * W + k.x1) * C;
    const size_t c10 = ((size_t)r1 * W + k.x0) * C;
    const size_t c11 = ((size_t)r1 * W + k.x1) * C;
    const size_t o = ((size_t)n * Ho + i) * Wo + j;
    const float* gp = g + o * C;
    float sa = 0.f, sb = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float gc = __ldg(gp + c);
      const float i00 = __ldg(src + c00 + c), i01 = __ldg(src + c01 + c);
      const float i10 = __ldg(src + c10 + c), i11 = __ldg(src + c11 + c);
      const float h0 = __fadd_rn(__fmul_rn(i00, k.wx0), __fmul_rn(i01, k.wx1));
      const float h1 = __fadd_rn(__fmul_rn(i10, k.wx0), __fmul_rn(i11, k.wx1));
      const float a0 = __fsub_rn(__fmul_rn(i01, k.mx1), __fmul_rn(i00, k.mx0));
      const float a1 = __fsub_rn(__fmul_rn(i11, k.mx1), __fmul_rn(i10, k.mx0));
      const float va = __fadd_rn(__fmul_rn(a0, k.wy0), __fmul_rn(a1, k.wy1));
      const float vb = __fsub_rn(__fmul_rn(h1, k.my1), __fmul_rn(h0, k.my0));
      sa = __fadd_rn(sa, __fmul_rn(gc, va));
      sb = __fadd_rn(sb, __fmul_rn(gc, vb));
      const float g0 = __fmul_rn(gc, k.wy0), g1 = __fmul_rn(gc, k.wy1);
      atomicAdd(dst + c00 + c, __fmul_rn(g0, k.wx0));
      atomicAdd(dst + c01 + c, __fmul_rn(g0, k.wx1));
      atomicAdd(dst + c10 + c, __fmul_rn(g1, k.wx0));
      atomicAdd(dst + c11 + c, __fmul_rn(g1, k.wx1));
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

}  // namespace

// Kernel K. image [M,H,W,C], grid [N,Ho,Wo,2], g [N,Ho,Wo,C] f32
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
  if (M <= 0 || N <= 0 || N % M || H <= 0 || W <= 0 || C <= 0 || Ho <= 0 ||
      Wo <= 0 || band <= 0 || band > H || N > 65535)
    return (int)cudaErrorInvalidValue;
  warp_grid_bwd_kernel<<<dim3((unsigned)Ho, (unsigned)N), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(image), static_cast<const float*>(grid),
      static_cast<const float*>(g), static_cast<float*>(gfx),
      static_cast<float*>(gfy), static_cast<float*>(dimage), M, H, W, C, Ho,
      Wo, band, nearest != 0, zeros != 0);
  return (int)cudaGetLastError();
}
