// Depth-direct photometric warp for Hopper (sm_90a), bound through a plain C
// interface (ctypes): the forward (kernel A) and the depth cotangent
// (kernel B) of fsnet_tpu_torch.ops.warp_depth.warp_depth_fused.
//
// Layouts: image [F*B, H, W, C] NHWC f32 (the source frames), depth
// [S*B, H, W] f32 (per-scale depth at full resolution), arows [N, 16] f32
// with N = S*F*B in (s, f, b) order (cols 0-8 the row-major 3x3 A, 9-11 the
// constant term b). Warp n = (s*F + f)*B + b reads depth row s*B + b and
// source image f*B + b: the sources are indexed modulo the batch, never
// tiled S-fold.
//
// Projection, per pixel (column j, row i), exactly as the plain version in
// ops/warp_depth.py computes it, one rounding per operation:
//   c = A @ [j, i, 1],  inv = 1 / (d*cz + bz + 1e-7),
//   x = (d*cx + bx) * inv,  y = (d*cy + by) * inv.
// nvcc would contract a*b + c into one FMA, and floor() of a coordinate
// one ulp off picks another corner; so this arithmetic uses the _rn
// intrinsics, which are never contracted.
//
// Kernel A replaces fsnet_tpu/ops/pallas/prep_kernel.py warp_prep_pallas
// and fsnet_tpu/ops/pallas/warp_kernel.py warp_rows_pallas_dma_fused, fused
// into one pass. One block per (warp n, output row): it projects the row,
// takes the overlap bit (-0.5 <= x < W-0.5, -0.5 <= y < H-0.5) from the
// unclamped coordinates, clamps to the border, and reduces min floor(y)
// over the row; the band start ymin is that minimum clipped to [0, H-band]
// and rounded down to even, and each sample's two rows are clamped into
// [ymin, ymin+band). It then gathers the four bilinear corners and writes
// out, va = d out/d fx and vb = d out/d fy (NHWC f32) and overlap (uint8).
// The TPU kernel also clamped x0/x1 into a 3-tile window of 384 columns
// around each 128-lane output tile, an artifact of its lane tiling that
// only fires at W > 384; this kernel does not.
// What bounds it on an H100: bytes. It reads depth once and ~4 source rows
// per output row (L1/L2 resident), and writes three NHWC f32 tensors, ~12x
// the image bytes; about 40 operations per output value.
// Two routes, picked on the host (ops/warp_depth.py proj_route; an entry
// point refuses what its route does not take, never falls back):
// - narrow (warp_depth_fwd_kernel, any shape): 256 threads per row, each
//   pixel projected in both passes, each output value a scalar store;
// - vector (warp_depth_fwd_vec_kernel, W % 4 == 0, W <= 2048, the staged
//   row within shared memory, every pointer 16-byte aligned): W / 4
//   threads per row (160 at W = 640, no idle lane), each projecting its 4
//   pixels once and keeping (x, y) in registers for pass 2, the row staged
//   in shared memory and written as 16-byte streaming stores and 4-byte
//   overlap stores (csrc/warp_rows.cuh). Both routes round the same
//   operations in the same order, so their outputs are bitwise equal.
//
// Kernel B replaces fsnet_tpu/ops/pallas/prep_kernel.py
// warp_prep_bwd_pallas, with the channel contraction of warp_depth.py:114-121
// (gfx = sum_c g*va, gfy = sum_c g*vb) fused in. One thread per depth pixel
// (s*B + b, i, j): it recomputes x, y and dx/dd, dy/dd for each of the F
// frames, masks with the strict border test 0 < x < W-1, 0 < y < H-1, and
// sums the F frames into d depth in one pass, without atomics. Bound by
// bytes: it reads g, va and vb once. Its bfloat16 form (the bf16 step,
// whose fraction cotangents the JAX package forms in bf16,
// warp_depth.py:117-120) loads g, va and vb in bfloat16 and forms gfx and
// gfy as torch's bfloat16 ops do: each product g*va rounded to bfloat16,
// the channels summed in float32 in order, the sum rounded to bfloat16;
// the rest is the float32 kernel's arithmetic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <climits>
#include <cstddef>

#include "warp_rows.cuh"

namespace {

constexpr float kEps = 1e-7f;
constexpr int kThreadsA = 256;
constexpr int kThreadsB = 256;

struct Proj {
  float x, y, cx, cy, cz, inv;
};

// `a` points at the 16 floats of one arows row
__device__ __forceinline__ Proj project(const float* __restrict__ a, float d,
                                        float jj, float ii) {
  Proj p;
  p.cx = __fadd_rn(__fadd_rn(__fmul_rn(a[0], jj), __fmul_rn(a[1], ii)), a[2]);
  p.cy = __fadd_rn(__fadd_rn(__fmul_rn(a[3], jj), __fmul_rn(a[4], ii)), a[5]);
  p.cz = __fadd_rn(__fadd_rn(__fmul_rn(a[6], jj), __fmul_rn(a[7], ii)), a[8]);
  p.inv = __fdiv_rn(1.0f, __fadd_rn(__fadd_rn(__fmul_rn(d, p.cz), a[11]), kEps));
  p.x = __fmul_rn(__fadd_rn(__fmul_rn(d, p.cx), a[9]), p.inv);
  p.y = __fmul_rn(__fadd_rn(__fmul_rn(d, p.cy), a[10]), p.inv);
  return p;
}

__global__ void __launch_bounds__(kThreadsA)
warp_depth_fwd_kernel(const float* __restrict__ image,
                      const float* __restrict__ depth,
                      const float* __restrict__ arows, float* __restrict__ out,
                      float* __restrict__ va, float* __restrict__ vb,
                      uint8_t* __restrict__ overlap, int S, int F, int B,
                      int H, int W, int C, int band) {
  __shared__ int s_min[kThreadsA / 32];
  const int i = blockIdx.x;                // output row
  const int n = blockIdx.y;                // warp (s, f, b)
  const int b = n % B;
  const int f = (n / B) % F;
  const int s = n / (F * B);
  const float* a = arows + (size_t)n * 16;
  const float* drow = depth + ((size_t)(s * B + b) * H + i) * W;
  const float ii = (float)i;
  const float wmax = (float)(W - 1);
  const float hmax = (float)(H - 1);

  // pass 1: the row's band start, min floor(clamped y) over the row
  int lo = INT_MAX;
  for (int j = threadIdx.x; j < W; j += kThreadsA) {
    const Proj p = project(a, drow[j], (float)j, ii);
    lo = min(lo, (int)floorf(fminf(fmaxf(p.y, 0.f), hmax)));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
  if ((threadIdx.x & 31) == 0) s_min[threadIdx.x >> 5] = lo;
  __syncthreads();
  int ymin = s_min[0];
#pragma unroll
  for (int k = 1; k < kThreadsA / 32; ++k) ymin = min(ymin, s_min[k]);
  ymin = min(max(ymin, 0), max(H - band, 0));
  ymin -= ymin & 1;

  // pass 2: corners, fractions and the three outputs
  const float* src = image + (size_t)(f * B + b) * H * W * C;
  for (int j = threadIdx.x; j < W; j += kThreadsA) {
    const Proj p = project(a, drow[j], (float)j, ii);
    const size_t o = ((size_t)n * H + i) * W + j;
    overlap[o] = (p.x >= -0.5f) & (p.x < (float)W - 0.5f) & (p.y >= -0.5f) &
                 (p.y < (float)H - 0.5f);
    const float xb = fminf(fmaxf(p.x, 0.f), wmax);
    const float yb = fminf(fmaxf(p.y, 0.f), hmax);
    const float x0f = floorf(xb);
    const float y0f = floorf(yb);
    const float fx = __fsub_rn(xb, x0f);
    const float fy = __fsub_rn(yb, y0f);
    const int x0 = (int)x0f;
    const int y0 = (int)y0f;
    const int x1 = min(x0 + 1, W - 1);
    const int y1 = min(y0 + 1, H - 1);
    const int r0 = ymin + min(max(y0 - ymin, 0), band - 1);
    const int r1 = ymin + min(max(y1 - ymin, 0), band - 1);
    const float* p00 = src + ((size_t)r0 * W + x0) * C;
    const float* p01 = src + ((size_t)r0 * W + x1) * C;
    const float* p10 = src + ((size_t)r1 * W + x0) * C;
    const float* p11 = src + ((size_t)r1 * W + x1) * C;
    const float wx0 = __fsub_rn(1.f, fx);
    const float wy0 = __fsub_rn(1.f, fy);
    float* po = out + o * C;
    float* pa = va + o * C;
    float* pb = vb + o * C;
    for (int c = 0; c < C; ++c) {
      const float i00 = __ldg(p00 + c), i01 = __ldg(p01 + c);
      const float i10 = __ldg(p10 + c), i11 = __ldg(p11 + c);
      const float h0 = __fadd_rn(__fmul_rn(i00, wx0), __fmul_rn(i01, fx));
      const float h1 = __fadd_rn(__fmul_rn(i10, wx0), __fmul_rn(i11, fx));
      po[c] = __fadd_rn(__fmul_rn(h0, wy0), __fmul_rn(h1, fy));
      pa[c] = __fadd_rn(__fmul_rn(__fsub_rn(i01, i00), wy0),
                        __fmul_rn(__fsub_rn(i11, i10), fy));
      pb[c] = __fsub_rn(h1, h0);
    }
  }
}

// Kernel A, vector route: thread t of the row's block takes pixels
// t + k W/4, k = 0..3 (csrc/warp_rows.cuh); KC the channels where fixed at
// compile time (0: C at run time).
template <int KC>
__global__ void __launch_bounds__(kRowMaxThreads, kRowMinBlocks)
warp_depth_fwd_vec_kernel(const float* __restrict__ image,
                          const float* __restrict__ depth,
                          const float* __restrict__ arows,
                          float* __restrict__ out, float* __restrict__ va,
                          float* __restrict__ vb,
                          uint8_t* __restrict__ overlap, int S, int F, int B,
                          int H, int W, int C_, int band) {
  extern __shared__ float4 s_row[];
  const int C = KC > 0 ? KC : C_;
  const int i = blockIdx.x;                // output row
  const int n = blockIdx.y;                // warp (s, f, b)
  const int b = n % B;
  const int f = (n / B) % F;
  const int s = n / (F * B);
  const int T = W / kRowPix;
  const int t = threadIdx.x;
  const bool live = t < T;                 // lanes past W / 4 only reduce
  const float* a = arows + (size_t)n * 16;
  const float* drow = depth + ((size_t)(s * B + b) * H + i) * W;
  const float ii = (float)i;
  const float wmax = (float)(W - 1);
  const float hmax = (float)(H - 1);

  // pass 1: project each pixel once; the row's band start
  float px[kRowPix], py[kRowPix];
  int lo = INT_MAX;
#pragma unroll
  for (int k = 0; k < kRowPix; ++k) {
    const int j = live ? t + k * T : 0;
    const Proj p = project(a, drow[j], (float)j, ii);
    px[k] = p.x;
    py[k] = p.y;
    if (live) lo = min(lo, (int)floorf(fminf(fmaxf(p.y, 0.f), hmax)));
  }
  const int ymin = row_band_start(lo, H, band);

  // pass 2: corners, fractions and the three outputs, staged
  const RowStage st = row_stage(s_row, W, C);
  const float* src = image + (size_t)(f * B + b) * H * W * C;
  if (live) {
#pragma unroll
    for (int k = 0; k < kRowPix; ++k) {
      const int j = t + k * T;
      const float x = px[k], y = py[k];
      st.overlap[j] = (x >= -0.5f) & (x < (float)W - 0.5f) & (y >= -0.5f) &
                      (y < (float)H - 0.5f);
      const float xb = fminf(fmaxf(x, 0.f), wmax);
      const float yb = fminf(fmaxf(y, 0.f), hmax);
      const float x0f = floorf(xb);
      const float y0f = floorf(yb);
      const float fx = __fsub_rn(xb, x0f);
      const float fy = __fsub_rn(yb, y0f);
      const int x0 = (int)x0f;
      const int y0 = (int)y0f;
      const int x1 = min(x0 + 1, W - 1);
      const int y1 = min(y0 + 1, H - 1);
      const int r0 = ymin + min(max(y0 - ymin, 0), band - 1);
      const int r1 = ymin + min(max(y1 - ymin, 0), band - 1);
      const float* p00 = src + ((size_t)r0 * W + x0) * C;
      const float* p01 = src + ((size_t)r0 * W + x1) * C;
      const float* p10 = src + ((size_t)r1 * W + x0) * C;
      const float* p11 = src + ((size_t)r1 * W + x1) * C;
      const float wx0 = __fsub_rn(1.f, fx);
      const float wy0 = __fsub_rn(1.f, fy);
      for (int c = 0; c < C; ++c) {
        const float i00 = __ldg(p00 + c), i01 = __ldg(p01 + c);
        const float i10 = __ldg(p10 + c), i11 = __ldg(p11 + c);
        const float h0 = __fadd_rn(__fmul_rn(i00, wx0), __fmul_rn(i01, fx));
        const float h1 = __fadd_rn(__fmul_rn(i10, wx0), __fmul_rn(i11, fx));
        st.out[j * C + c] = __fadd_rn(__fmul_rn(h0, wy0), __fmul_rn(h1, fy));
        st.va[j * C + c] = __fadd_rn(__fmul_rn(__fsub_rn(i01, i00), wy0),
                                     __fmul_rn(__fsub_rn(i11, i10), fy));
        st.vb[j * C + c] = __fsub_rn(h1, h0);
      }
    }
  }
  __syncthreads();
  row_flush(st, (size_t)n * H + i, W, C, out, va, vb, overlap);
}

// kernel B's channel products and sums: product() and rounded() of
// csrc/warp_rows.cuh
template <typename Val>
__global__ void __launch_bounds__(kThreadsB)
warp_depth_bwd_kernel(const float* __restrict__ depth,
                      const Val* __restrict__ g, const Val* __restrict__ va,
                      const Val* __restrict__ vb,
                      const float* __restrict__ arows,
                      float* __restrict__ ddepth, int S, int F, int B, int H,
                      int W, int C) {
  const size_t idx = (size_t)blockIdx.x * kThreadsB + threadIdx.x;
  if (idx >= (size_t)S * B * H * W) return;
  const int j = (int)(idx % W);
  const int i = (int)((idx / W) % H);
  const int m = (int)(idx / ((size_t)W * H));      // s*B + b
  const int s = m / B;
  const int b = m % B;
  const float d = depth[idx];
  float acc = 0.f;
  for (int f = 0; f < F; ++f) {
    const int n = (s * F + f) * B + b;
    const float* a = arows + (size_t)n * 16;
    const Proj p = project(a, d, (float)j, (float)i);
    const float inv2 = __fmul_rn(p.inv, p.inv);
    const float bz = __fadd_rn(a[11], kEps);
    const float dxdd =
        __fmul_rn(__fsub_rn(__fmul_rn(p.cx, bz), __fmul_rn(a[9], p.cz)), inv2);
    const float dydd =
        __fmul_rn(__fsub_rn(__fmul_rn(p.cy, bz), __fmul_rn(a[10], p.cz)), inv2);
    const size_t o = (((size_t)n * H + i) * W + j) * C;
    float gx = 0.f, gy = 0.f;
    for (int c = 0; c < C; ++c) {
      gx = __fadd_rn(gx, product(g[o + c], va[o + c]));
      gy = __fadd_rn(gy, product(g[o + c], vb[o + c]));
    }
    gx = rounded<Val>(gx);
    gy = rounded<Val>(gy);
    const float mx = (p.x > 0.f && p.x < (float)(W - 1)) ? 1.f : 0.f;
    const float my = (p.y > 0.f && p.y < (float)(H - 1)) ? 1.f : 0.f;
    const float term = __fadd_rn(__fmul_rn(__fmul_rn(gx, mx), dxdd),
                                 __fmul_rn(__fmul_rn(gy, my), dydd));
    acc = __fadd_rn(acc, term);
  }
  ddepth[idx] = acc;
}

bool bad_dims(int S, int F, int B, int H, int W, int C) {
  return S <= 0 || F <= 0 || B <= 0 || H <= 0 || W <= 0 || C <= 0;
}

}  // namespace

// Kernel A. image [F*B,H,W,C], depth [S*B,H,W], arows [S*F*B,16] f32;
// writes out, va, vb [S*F*B,H,W,C] f32 and overlap [S*F*B,H,W] uint8. All
// contiguous. Launches on `stream` and returns cudaGetLastError() (0 on
// success); never synchronises.
extern "C" int fsnet_warp_depth_fwd(const void* image, const void* depth,
                                    const void* arows, void* out, void* va,
                                    void* vb, void* overlap, int S, int F,
                                    int B, int H, int W, int C, int band,
                                    void* stream) {
  if (bad_dims(S, F, B, H, W, C) || band <= 0 ||
      (long long)S * F * B > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)H, (unsigned)(S * F * B));
  warp_depth_fwd_kernel<<<grid, kThreadsA, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(image), static_cast<const float*>(depth),
      static_cast<const float*>(arows), static_cast<float*>(out),
      static_cast<float*>(va), static_cast<float*>(vb),
      static_cast<uint8_t*>(overlap), S, F, B, H, W, C, band);
  return (int)cudaGetLastError();
}

// Kernel A, vector route: the arguments of fsnet_warp_depth_fwd; refuses
// (cudaErrorInvalidValue) a row that row_fits does not take or a pointer
// that is not 16-byte aligned.
extern "C" int fsnet_warp_depth_fwd_vec(const void* image, const void* depth,
                                        const void* arows, void* out,
                                        void* va, void* vb, void* overlap,
                                        int S, int F, int B, int H, int W,
                                        int C, int band, void* stream) {
  if (bad_dims(S, F, B, H, W, C) || band <= 0 ||
      (long long)S * F * B > 65535 || !row_fits(W, C) || !aligned16(image) ||
      !aligned16(depth) || !aligned16(arows) || !aligned16(out) ||
      !aligned16(va) || !aligned16(vb) || !aligned16(overlap))
    return (int)cudaErrorInvalidValue;
  static unsigned set3 = 0, set0 = 0;
  const auto* im = static_cast<const float*>(image);
  const auto* dp = static_cast<const float*>(depth);
  const auto* ar = static_cast<const float*>(arows);
  auto* o = static_cast<float*>(out);
  auto* a = static_cast<float*>(va);
  auto* b = static_cast<float*>(vb);
  auto* ov = static_cast<uint8_t*>(overlap);
  const int N = S * F * B;
  return C == 3 ? row_launch(warp_depth_fwd_vec_kernel<3>, set3, N, H, W, C,
                             stream, im, dp, ar, o, a, b, ov, S, F, B, H, W, C,
                             band)
                : row_launch(warp_depth_fwd_vec_kernel<0>, set0, N, H, W, C,
                             stream, im, dp, ar, o, a, b, ov, S, F, B, H, W, C,
                             band);
}

template <typename Val>
void launch_bwd(const void* depth, const void* g, const void* va,
                const void* vb, const void* arows, void* ddepth, int S, int F,
                int B, int H, int W, int C, unsigned blocks,
                cudaStream_t stream) {
  warp_depth_bwd_kernel<Val><<<blocks, kThreadsB, 0, stream>>>(
      static_cast<const float*>(depth), static_cast<const Val*>(g),
      static_cast<const Val*>(va), static_cast<const Val*>(vb),
      static_cast<const float*>(arows), static_cast<float*>(ddepth), S, F, B,
      H, W, C);
}

// Kernel B. depth [S*B,H,W], arows [S*F*B,16] f32, g/va/vb [S*F*B,H,W,C]
// float32 (dtype 0) or bfloat16 (dtype 1); writes ddepth [S*B,H,W] f32.
// All contiguous. Launches on `stream` and returns cudaGetLastError();
// never synchronises.
extern "C" int fsnet_warp_depth_bwd(const void* depth, const void* g,
                                    const void* va, const void* vb,
                                    const void* arows, void* ddepth, int S,
                                    int F, int B, int H, int W, int C,
                                    int dtype, void* stream) {
  if (bad_dims(S, F, B, H, W, C) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)S * B * H * W;
  const long long blocks = (total + kThreadsB - 1) / kThreadsB;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  (dtype == 0 ? launch_bwd<float> : launch_bwd<__nv_bfloat16>)(
      depth, g, va, vb, arows, ddepth, S, F, B, H, W, C, (unsigned)blocks,
      static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
