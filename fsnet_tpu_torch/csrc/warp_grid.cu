// Band-limited warp of images by a sampling grid for Hopper (sm_90a), bound
// through a plain C interface (ctypes): the forward (kernel E) and the
// forward with the values of its VJP (kernel F) of the band warp
// fsnet_tpu_torch.ops.warp_fast.grid_sample.
//
// Layouts: image [M, H, W, C] NHWC f32, grid [N, Ho, Wo, 2] f32 with
// normalized (x, y) in [-1, 1] (align_corners), N a multiple of M. Warp n
// reads image n mod M: the images are indexed modulo the grid batch, never
// tiled (the S scales x F frames of the loss warp F*B sources).
//
// Per sample, exactly as the plain version in ops/warp_fast.py computes it,
// one rounding per operation (the _rn intrinsics are never contracted into
// an FMA, and floor() of a coordinate one ulp off picks another corner):
//   x = (gx + 1) / 2 * (W - 1), y likewise with H (the halving is exact);
//   border padding clamps x to [0, W-1] and y to [0, H-1]; zeros padding
//   does not, and gives each corner the weight 0 where it lies outside;
//   bilinear: x0 = floor(x), fx = x - x0, weights (1 - fx, fx);
//   nearest:  x0 = floor(x + 0.5), weights (1, 0);
//   corners clipped to the image: x0c = clip(x0), x1c = clip(x0 + 1).
// The rows are limited to a band: per output row, ymin = min over the row
// of y0c, clipped to [0, H - band] and rounded down to even, and each
// sample's two rows are clamped into [ymin, ymin + band).
// Blend, per channel: h0 = i00 wx0 + i01 wx1, h1 = i10 wx0 + i11 wx1,
// out = h0 wy0 + h1 wy1; kernel F also writes
// va = d out/d fx = (i01 mx1 - i00 mx0) wy0 + (i11 mx1 - i10 mx0) wy1 and
// vb = d out/d fy = h1 my1 - h0 my0, m* the corners' validity (1 under
// border padding). With nearest weights the blend multiplies by exact 0s
// and 1s, so a warped {0, 1} mask stays exactly {0, 1}.
//
// Kernel E replaces fsnet_tpu/ops/pallas/warp_kernel.py warp_rows_pallas_dma
// and its twin on materialized bands, warp_rows_pallas; kernel F replaces
// warp_rows_pallas_dma_fused and warp_rows_pallas_fused on the grid route
// (grid_sample_band_pallas_fused). One block per (warp n, output row): pass
// 1 reduces min y0c over the row, pass 2 gathers the corners of image
// n mod M in the band's rows and writes the outputs. The TPU kernels also
// clamped x0/x1 into a 3-tile window of 384 columns per 128-lane output
// tile, an artifact of their lane tiling that fires only at W > 384; these
// kernels do not.
// What bounds them on an H100: bytes. They read the grid (twice; the second
// read hits L1/L2) and ~4 source rows per output row, and write C (E) or
// 3C (F) floats per sample; about 30 operations per output value.
#include <cuda_runtime.h>

#include <cstddef>

#include "warp_band.cuh"

namespace {

template <bool FUSED>
__global__ void __launch_bounds__(kThreads)
warp_grid_kernel(const float* __restrict__ image,
                 const float* __restrict__ grid, float* __restrict__ out,
                 float* __restrict__ va, float* __restrict__ vb, int M, int H,
                 int W, int C, int Ho, int Wo, int band, bool nearest,
                 bool zeros) {
  const int i = blockIdx.x;                // output row
  const int n = blockIdx.y;                // warp
  const float* grow = grid + ((size_t)n * Ho + i) * Wo * 2;
  const int ymin = band_start(grow, Wo, H, band, nearest, zeros);
  const float* src = image + (size_t)(n % M) * H * W * C;
  for (int j = threadIdx.x; j < Wo; j += kThreads) {
    const Corners k = corners(grow + 2 * j, H, W, nearest, zeros);
    const int r0 = ymin + min(max(k.y0 - ymin, 0), band - 1);
    const int r1 = ymin + min(max(k.y1 - ymin, 0), band - 1);
    const float* p00 = src + ((size_t)r0 * W + k.x0) * C;
    const float* p01 = src + ((size_t)r0 * W + k.x1) * C;
    const float* p10 = src + ((size_t)r1 * W + k.x0) * C;
    const float* p11 = src + ((size_t)r1 * W + k.x1) * C;
    const size_t o = (((size_t)n * Ho + i) * Wo + j) * C;
    for (int c = 0; c < C; ++c) {
      const float i00 = __ldg(p00 + c), i01 = __ldg(p01 + c);
      const float i10 = __ldg(p10 + c), i11 = __ldg(p11 + c);
      const float h0 = __fadd_rn(__fmul_rn(i00, k.wx0), __fmul_rn(i01, k.wx1));
      const float h1 = __fadd_rn(__fmul_rn(i10, k.wx0), __fmul_rn(i11, k.wx1));
      out[o + c] = __fadd_rn(__fmul_rn(h0, k.wy0), __fmul_rn(h1, k.wy1));
      if (FUSED) {
        const float a0 =
            __fsub_rn(__fmul_rn(i01, k.mx1), __fmul_rn(i00, k.mx0));
        const float a1 =
            __fsub_rn(__fmul_rn(i11, k.mx1), __fmul_rn(i10, k.mx0));
        va[o + c] = __fadd_rn(__fmul_rn(a0, k.wy0), __fmul_rn(a1, k.wy1));
        vb[o + c] = __fsub_rn(__fmul_rn(h1, k.my1), __fmul_rn(h0, k.my0));
      }
    }
  }
}

int launch(bool fused, const void* image, const void* grid, void* out,
           void* va, void* vb, int M, int N, int H, int W, int C, int Ho,
           int Wo, int band, int nearest, int zeros, void* stream) {
  if (M <= 0 || N <= 0 || N % M || H <= 0 || W <= 0 || C <= 0 || Ho <= 0 ||
      Wo <= 0 || band <= 0 || band > H || N > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 blocks((unsigned)Ho, (unsigned)N);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* img = static_cast<const float*>(image);
  const float* g = static_cast<const float*>(grid);
  if (fused)
    warp_grid_kernel<true><<<blocks, kThreads, 0, s>>>(
        img, g, static_cast<float*>(out), static_cast<float*>(va),
        static_cast<float*>(vb), M, H, W, C, Ho, Wo, band, false, zeros != 0);
  else
    warp_grid_kernel<false><<<blocks, kThreads, 0, s>>>(
        img, g, static_cast<float*>(out), nullptr, nullptr, M, H, W, C, Ho,
        Wo, band, nearest != 0, zeros != 0);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel E. image [M,H,W,C], grid [N,Ho,Wo,2] f32 (N % M == 0); writes out
// [N,Ho,Wo,C] f32. nearest: 0 bilinear, 1 nearest; zeros: 0 border, 1 zeros
// padding. All contiguous. Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int fsnet_warp_grid_fwd(const void* image, const void* grid,
                                   void* out, int M, int N, int H, int W,
                                   int C, int Ho, int Wo, int band,
                                   int nearest, int zeros, void* stream) {
  return launch(false, image, grid, out, nullptr, nullptr, M, N, H, W, C, Ho,
                Wo, band, nearest, zeros, stream);
}

// Kernel F, bilinear. As kernel E, and also writes va, vb [N,Ho,Wo,C] f32.
extern "C" int fsnet_warp_grid_fused(const void* image, const void* grid,
                                     void* out, void* va, void* vb, int M,
                                     int N, int H, int W, int C, int Ho,
                                     int Wo, int band, int zeros,
                                     void* stream) {
  return launch(true, image, grid, out, va, vb, M, N, H, W, C, Ho, Wo, band,
                0, zeros, stream);
}
