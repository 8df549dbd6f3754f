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
// (grid_sample_band_pallas_fused). The TPU kernels also clamped x0/x1 into
// a 3-tile window of 384 columns per 128-lane output tile, an artifact of
// their lane tiling that fires only at W > 384; these kernels do not.
//
// Three routes, chosen on the host from C, the row width Wo and the
// pointers' alignment (ops/warp_fast.py warp_route), never one after the
// other fails:
// - narrow (kernels E and F, any shape: a ragged or too wide row, or a
//   pointer not 16-byte aligned): one block of kThreads per (warp n,
//   output row); pass 1 reduces min y0c over the row, pass 2 reads the
//   grid again, gives each thread one output sample and loops over its C
//   channels, each value a scalar store.
// - row (kernels E and F where the channel-wide route does not apply and
//   Wo % 4 == 0, Wo <= 2048, the staged row within shared memory and every
//   pointer 16-byte aligned: the grid route's mask, C = 1, and F's frames,
//   C = 3): the row staging of warp_rows.cuh, as kernel A's vector route;
//   each sample's grid read once, the row written as 16-byte stores.
// - channel-wide (kernel E at C a multiple of 4: the deformable convs'
//   taps, C = 64-512): the layout of warp_band.cuh, L <= 32 lanes per
//   sample with a float4 of channels each, so a warp's corner loads and
//   its store are 16 bytes a lane on consecutive addresses. The loads go
//   through the read-only path (__ldg): the image is read by 9 taps and
//   stays in L2 (at most 23.6 MB at the DLA's shapes). The output is
//   written once and never read here, so it goes out as streaming stores
//   (__stcs) that do not push the image out of L2. Each warp reduces its
//   row's band start itself, so a row can be split among warps and every
//   DCN shape fills the SMs (vec_parts).
// What bounds them on an H100: bytes. They read the grid and ~4 source rows
// per output row (L1/L2 resident), and write C (E) or 3C (F) floats per
// sample; about 30 operations per output value. The channel-wide route
// moves 4 L2 reads of 16 bytes and one 16-byte write per 4 output values;
// the write of the output to HBM is its floor.
#include <cuda_runtime.h>

#include <cstddef>

#include "warp_band.cuh"
#include "warp_rows.cuh"

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
    const Corners k =
        band_corners(grow, j, Wo, H, W, ymin, band, nearest, zeros);
    const float* p00 = src + ((size_t)k.y0 * W + k.x0) * C;
    const float* p01 = src + ((size_t)k.y0 * W + k.x1) * C;
    const float* p10 = src + ((size_t)k.y1 * W + k.x0) * C;
    const float* p11 = src + ((size_t)k.y1 * W + k.x1) * C;
    const size_t o = (((size_t)n * Ho + i) * Wo + j) * C;
    for (int c = 0; c < C; ++c) {
      const float i00 = __ldg(p00 + c), i01 = __ldg(p01 + c);
      const float i10 = __ldg(p10 + c), i11 = __ldg(p11 + c);
      if (FUSED) {
        const Blended v = blend_vjp(i00, i01, i10, i11, k);
        out[o + c] = v.out;
        va[o + c] = v.va;
        vb[o + c] = v.vb;
      } else {
        out[o + c] = blend(i00, i01, i10, i11, k);
      }
    }
  }
}

// Kernels E and F, row route: thread t of the row's block takes samples
// t + k Wo/4, k = 0..3 (csrc/warp_rows.cuh). It reads each sample's
// (gx, gy) once, as one 8-byte load, and keeps the four pairs in registers
// from the band reduction to the corners; the row's out (and F's va, vb)
// is staged in shared memory and leaves as 16-byte streaming stores. KC
// the channels where fixed at compile time (0: C at run time).
template <bool FUSED, int KC>
__global__ void __launch_bounds__(kRowMaxThreads, kRowMinBlocks)
warp_grid_row_kernel(const float* __restrict__ image,
                     const float2* __restrict__ grid,
                     float* __restrict__ out, float* __restrict__ va,
                     float* __restrict__ vb, int M, int H, int W, int C_,
                     int Ho, int Wo, int band, bool nearest, bool zeros) {
  extern __shared__ float4 s_row[];
  const int C = KC > 0 ? KC : C_;
  const int i = blockIdx.x;                // output row
  const int n = blockIdx.y;                // warp
  const int T = Wo / kRowPix;
  const int t = threadIdx.x;
  const bool live = t < T;                 // lanes past Wo / 4 only reduce
  const size_t row = (size_t)n * Ho + i;
  const float2* grow = grid + row * Wo;

  // pass 1: each sample's grid read once; the row's band start
  float2 g[kRowPix];
  int lo = INT_MAX;
#pragma unroll
  for (int k = 0; k < kRowPix; ++k) {
    g[k] = __ldg(grow + (live ? t + k * T : 0));
    if (live) lo = min(lo, first_row(g[k].y, H, nearest, zeros));
  }
  const int ymin = row_band_start(lo, H, band);

  // pass 2: corners from the registers, gathers and blend, staged
  const RowStage st = row_stage(s_row, Wo, C);
  const float* src = image + (size_t)(n % M) * H * W * C;
  if (live) {
#pragma unroll
    for (int k = 0; k < kRowPix; ++k) {
      const int j = t + k * T;
      Corners q = corners_at(g[k].x, g[k].y, H, W, nearest, zeros);
      band_clamp(q, ymin, band);
      const float* p00 = src + ((size_t)q.y0 * W + q.x0) * C;
      const float* p01 = src + ((size_t)q.y0 * W + q.x1) * C;
      const float* p10 = src + ((size_t)q.y1 * W + q.x0) * C;
      const float* p11 = src + ((size_t)q.y1 * W + q.x1) * C;
      for (int c = 0; c < C; ++c) {
        const float i00 = __ldg(p00 + c), i01 = __ldg(p01 + c);
        const float i10 = __ldg(p10 + c), i11 = __ldg(p11 + c);
        if (FUSED) {
          const Blended v = blend_vjp(i00, i01, i10, i11, q);
          st.out[j * C + c] = v.out;
          st.va[j * C + c] = v.va;
          st.vb[j * C + c] = v.vb;
        } else {
          st.out[j * C + c] = blend(i00, i01, i10, i11, q);
        }
      }
    }
  }
  __syncthreads();
  row_flush(st, row, Wo, C, out, FUSED ? va : nullptr, FUSED ? vb : nullptr,
            nullptr);
}

__global__ void __launch_bounds__(kThreads)
warp_grid_vec_kernel(const float4* __restrict__ image,
                     const float* __restrict__ grid, float4* __restrict__ out,
                     int M, int H, int W, int Q, int Ho, int Wo, int band,
                     int lanes_log2, int parts, int rows, bool nearest,
                     bool zeros) {
  const VecTask t = vec_task(parts);
  if (t.row >= rows) return;               // whole warps: tasks are warps
  const float* grow = grid + (size_t)t.row * Wo * 2;
  const int ymin = band_start_warp(grow, Wo, H, band, nearest, zeros);
  const int lane = threadIdx.x & 31, L = 1 << lanes_log2;
  const float4* src = image + (size_t)(t.row / Ho % M) * H * W * Q;
  float4* dst = out + (size_t)t.row * Wo * Q;
  const int groups = (Wo + (32 >> lanes_log2) - 1) >> (5 - lanes_log2);
  const int iters = (groups - t.part + parts - 1) / parts;
  for (int m = 0; m < iters; ++m) {
    const int j = vec_sample_index(m, t.part, parts, lanes_log2, lane);
    const Corners k =
        band_corners(grow, j, Wo, H, W, ymin, band, nearest, zeros);
    if (j >= Wo) continue;
    const float4* p00 = src + ((size_t)k.y0 * W + k.x0) * Q;
    const float4* p01 = src + ((size_t)k.y0 * W + k.x1) * Q;
    const float4* p10 = src + ((size_t)k.y1 * W + k.x0) * Q;
    const float4* p11 = src + ((size_t)k.y1 * W + k.x1) * Q;
    float4* o = dst + (size_t)j * Q;
    for (int q = lane & (L - 1); q < Q; q += L) {
      const float4 a = __ldg(p00 + q), b = __ldg(p01 + q);
      const float4 c = __ldg(p10 + q), d = __ldg(p11 + q);
      __stcs(o + q, make_float4(blend(a.x, b.x, c.x, d.x, k),
                                blend(a.y, b.y, c.y, d.y, k),
                                blend(a.z, b.z, c.z, d.z, k),
                                blend(a.w, b.w, c.w, d.w, k)));
    }
  }
}

int launch(bool fused, const void* image, const void* grid, void* out,
           void* va, void* vb, int M, int N, int H, int W, int C, int Ho,
           int Wo, int band, int nearest, int zeros, void* stream) {
  if (bad_dims(M, N, H, W, C, Ho, Wo, band) || N > 65535)
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

// the row route's staged row: out (E) or out, va, vb (F), Wo C floats each
inline long grid_row_smem(bool fused, int Wo, int C) {
  return (fused ? 12L : 4L) * Wo * C;
}

template <bool FUSED, int KC>
int launch_row_kc(const float* image, const float* grid, float* out,
                  float* va, float* vb, int M, int N, int H, int W, int C,
                  int Ho, int Wo, int band, bool nearest, bool zeros,
                  void* stream) {
  static unsigned smem_set = 0;
  return row_launch_bytes(warp_grid_row_kernel<FUSED, KC>, smem_set,
                          grid_row_smem(FUSED, Wo, C), N, Ho, Wo, stream,
                          image, reinterpret_cast<const float2*>(grid), out,
                          va, vb, M, H, W, C, Ho, Wo, band, nearest, zeros);
}

// The row route of kernel E (FUSED false) or F: refuses
// (cudaErrorInvalidValue) a row that row_fits_bytes does not take or a
// pointer that is not 16-byte aligned; compiled for C = 3 (the frames), 1
// (the masks) and C at run time.
template <bool FUSED>
int launch_row(const void* image, const void* grid, void* out, void* va,
               void* vb, int M, int N, int H, int W, int C, int Ho, int Wo,
               int band, int nearest, int zeros, void* stream) {
  if (bad_dims(M, N, H, W, C, Ho, Wo, band) || N > 65535 ||
      !row_fits_bytes(Wo, grid_row_smem(FUSED, Wo, C)) || !aligned16(image) ||
      !aligned16(grid) || !aligned16(out) ||
      (FUSED && (!aligned16(va) || !aligned16(vb))))
    return (int)cudaErrorInvalidValue;
  const float* im = static_cast<const float*>(image);
  const float* g = static_cast<const float*>(grid);
  float* o = static_cast<float*>(out);
  float* a = static_cast<float*>(va);
  float* b = static_cast<float*>(vb);
  const bool nr = nearest != 0, zr = zeros != 0;
  return C == 3   ? launch_row_kc<FUSED, 3>(im, g, o, a, b, M, N, H, W, C, Ho,
                                            Wo, band, nr, zr, stream)
         : C == 1 ? launch_row_kc<FUSED, 1>(im, g, o, a, b, M, N, H, W, C, Ho,
                                            Wo, band, nr, zr, stream)
                  : launch_row_kc<FUSED, 0>(im, g, o, a, b, M, N, H, W, C, Ho,
                                            Wo, band, nr, zr, stream);
}

}  // namespace

// Kernel E, the narrow route. image [M,H,W,C], grid [N,Ho,Wo,2] f32
// (N % M == 0); writes out [N,Ho,Wo,C] f32. nearest: 0 bilinear, 1
// nearest; zeros: 0 border, 1 zeros padding. All contiguous. Launches on
// `stream` and returns cudaGetLastError() (0 on success); never
// synchronises.
extern "C" int fsnet_warp_grid_fwd(const void* image, const void* grid,
                                   void* out, int M, int N, int H, int W,
                                   int C, int Ho, int Wo, int band,
                                   int nearest, int zeros, void* stream) {
  return launch(false, image, grid, out, nullptr, nullptr, M, N, H, W, C, Ho,
                Wo, band, nearest, zeros, stream);
}

// Kernel E, the channel-wide route: as fsnet_warp_grid_fwd, for C a
// multiple of 4 with image and out 16-byte aligned (else
// cudaErrorInvalidValue, nothing launched).
extern "C" int fsnet_warp_grid_fwd_vec(const void* image, const void* grid,
                                       void* out, int M, int N, int H, int W,
                                       int C, int Ho, int Wo, int band,
                                       int nearest, int zeros, void* stream) {
  if (bad_dims(M, N, H, W, C, Ho, Wo, band) || C % 4 ||
      !aligned16(image) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  VecLaunch v;
  if (!vec_launch(C, N, Ho, Wo, v)) return (int)cudaErrorInvalidValue;
  warp_grid_vec_kernel<<<v.blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(image), static_cast<const float*>(grid),
      static_cast<float4*>(out), M, H, W, C / 4, Ho, Wo, band, v.lanes_log2,
      v.parts, v.rows, nearest != 0, zeros != 0);
  return (int)cudaGetLastError();
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

// Kernel E, the row route: as fsnet_warp_grid_fwd, for Wo % 4 == 0,
// Wo <= 2048, the staged row (4 Wo C bytes) within shared memory and every
// pointer 16-byte aligned (else cudaErrorInvalidValue, nothing launched).
extern "C" int fsnet_warp_grid_fwd_row(const void* image, const void* grid,
                                       void* out, int M, int N, int H, int W,
                                       int C, int Ho, int Wo, int band,
                                       int nearest, int zeros, void* stream) {
  return launch_row<false>(image, grid, out, nullptr, nullptr, M, N, H, W, C,
                           Ho, Wo, band, nearest, zeros, stream);
}

// Kernel F, the row route: as fsnet_warp_grid_fused, for the rows of
// fsnet_warp_grid_fwd_row with a staged row of 12 Wo C bytes.
extern "C" int fsnet_warp_grid_fused_row(const void* image, const void* grid,
                                         void* out, void* va, void* vb, int M,
                                         int N, int H, int W, int C, int Ho,
                                         int Wo, int band, int zeros,
                                         void* stream) {
  return launch_row<true>(image, grid, out, va, vb, M, N, H, W, C, Ho, Wo,
                          band, 0, zeros, stream);
}
