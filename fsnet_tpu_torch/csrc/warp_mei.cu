// Norm-direct fisheye (Mei camera) photometric warp for Hopper (sm_90a),
// bound through a plain C interface (ctypes): the forward (kernel G) and
// the norm cotangent (kernel H) of
// fsnet_tpu_torch.ops.warp_mei.warp_mei_fused.
//
// Layouts: image [F*B, H, W, C] NHWC (the source frames), mask [B, H, W]
// f32 (source validity), norm [S*B, H, W] (per-scale norm at full
// resolution), rays [B, 3, H, W] f32 (channel-leading ray field), mrows
// [N, 24] f32 with N = S*F*B in (s, f, b) order (cols 0-8 the row-major R,
// 9-11 t, 12-14 xi, k1, k2, 15-18 gamma1, gamma2, u0, v0). Warp n =
// (s*F + f)*B + b reads norm row s*B + b, rays b, mrows row n, source image
// f*B + b and mask b: nothing is tiled S-fold.
//
// Types (the entry points' `dtype`): 0 float32 throughout; 1 a bfloat16
// image and norm (the bf16 train step); 2 a bfloat16 image with a float32
// norm. The bfloat16 forms are those of the JAX package's unpacked route
// (fsnet_tpu/ops/warp_mei.py:147-148, :186): G widens the image and the
// norm exactly, runs the float32 arithmetic below and rounds out, va and vb
// once to bfloat16 (the overlap is the float32 one); H loads bfloat16 g,
// va, vb, forms gfx and gfy as PyTorch's bfloat16 ops form them (each
// product rounded to bfloat16, the channels summed in float32 in order, the
// sum rounded: kernel B's bfloat16 form, csrc/warp_depth.cu), runs the
// float32 derivative and rounds d norm to the norm's type. Rays, mask and
// rows are float32 at every type.
//
// Projection, per pixel, in the order of the plain version in
// ops/warp_mei.py (fsnet_tpu/ops/pallas/mei_prep_kernel.py _mei_pix), one
// rounding per operation:
//   g = R r,  p = norm * g + t,  nn = sqrt(p.p),  inv_e = 1 / (nn + 1e-6),
//   (xh, yh, zh) = p * inv_e,  inv_d = 1 / (zh + xi + 1e-6),
//   a = xh * inv_d,  b = yh * inv_d,  rho2 = a*a + b*b,
//   fac = 1 + k1*rho2 + k2*rho2*rho2,  x = g1*a*fac + u0,  y = g2*b*fac + v0.
// nvcc would contract a*b + c into one FMA, and floor() of a coordinate
// one ulp off picks another corner; so this arithmetic uses the _rn
// intrinsics, which are never contracted.
//
// Kernel G replaces fsnet_tpu/ops/pallas/mei_prep_kernel.py mei_prep_pallas
// and both sweeps of fsnet_tpu/ops/pallas/warp_kernel.py
// warp_rows_pallas_dma_fused that fsnet_tpu/ops/warp_mei.py runs on its
// operands (the images and the validity mask), fused into one pass. One
// block per (warp n, output row): it projects the row, clamps the
// coordinates to the border (fminf/fmaxf: a NaN becomes 0, +-inf an edge;
// the corners are clamped again as integers, so no read leaves the image
// whatever the coordinate), and reduces min floor(y) over the row; the band
// start ymin is that minimum clipped to [0, H-band] and rounded down to
// even, and each sample's two rows are clamped into [ymin, ymin+band). It
// gathers the four corners and writes out, va = d out/d fx, vb = d out/d fy
// (NHWC, the image's type). With the mask it warps mask b at the same
// corners with the fractions rounded to {0, 1}, and writes overlap = (that
// value == 1) AND the in-bounds test -0.5 <= x < W-0.5, -0.5 <= y < H-0.5
// of the unclamped coordinates (uint8). The TPU kernels also clamped the
// corner columns into a 3-tile window of 384 columns around each 128-lane
// output tile, which can only fire at W > 384; this kernel does not.
// What bounds it on an H100: bytes. It reads norm and rays once per
// warp row and ~4 source rows per output row (L1/L2 resident), and writes
// three NHWC tensors and a byte mask, about 12x the image bytes (half the
// output bytes in bfloat16); about 80 operations per output pixel.
// Two routes, picked on the host (ops/warp_depth.py proj_route; an entry
// point refuses what its route does not take, never falls back):
// - narrow (warp_mei_fwd_kernel, any shape): 128 threads per row, each
//   pixel projected in both passes (two square roots, four divisions),
//   each output value a scalar store;
// - vector (warp_mei_fwd_vec_kernel, W % 4 == 0, W <= 2048, the staged
//   row within shared memory and a whole number of 16-byte stores (in
//   bfloat16 W C a multiple of 8), every pointer 16-byte aligned): W / 4
//   threads per row (96 at W = 384, no idle lane), each projecting its 4
//   pixels once and keeping the unclamped (x, y) in registers for the
//   corners and the in-bounds test, the row staged in shared memory and
//   written as 16-byte streaming stores and 4-byte overlap stores
//   (csrc/warp_rows.cuh). Both routes round the same operations in the
//   same order, so their outputs are bitwise equal. The vector route
//   reaches about half the bytes bound: instruction issue holds it (the
//   uncontracted Mei projection, 16 gathers a pixel; PERF.md).
//
// Kernel H replaces fsnet_tpu/ops/pallas/mei_prep_kernel.py
// mei_prep_bwd_pallas, with the channel contraction of warp_mei.py:176-183
// (gfx = sum_c g*va, gfy = sum_c g*vb) fused in. One thread per norm pixel
// (s*B + b, i, j): for each of the F frames it recomputes the projection
// and its closed-form derivative d(x, y)/d norm (guard max(nn, 1e-12)),
// masks with the strict border test 0 < x < W-1, 0 < y < H-1, and sums the
// F frames into d norm in registers, without atomics. Bound by bytes: it
// reads g, va and vb once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

#include "warp_rows.cuh"

namespace {

constexpr float kEps = 1e-6f;
constexpr int kThreadsG = 128;
constexpr int kThreadsH = 256;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

struct Mei {
  float x, y;
  // intermediates of the backward
  float gx, gy, gz, px, py, pz, nn, inv_e, xh, yh, zh, inv_d, a, b, rho2, fac;
};

// `m` points at the 24 floats of one mrows row; (n, rx, ry, rz) the norm
// and the ray of one pixel
__device__ __forceinline__ Mei mei_pix(const float* __restrict__ m, float n,
                                       float rx, float ry, float rz) {
  Mei q;
  q.gx = add(add(mul(m[0], rx), mul(m[1], ry)), mul(m[2], rz));
  q.gy = add(add(mul(m[3], rx), mul(m[4], ry)), mul(m[5], rz));
  q.gz = add(add(mul(m[6], rx), mul(m[7], ry)), mul(m[8], rz));
  q.px = add(mul(n, q.gx), m[9]);
  q.py = add(mul(n, q.gy), m[10]);
  q.pz = add(mul(n, q.gz), m[11]);
  q.nn = __fsqrt_rn(add(add(mul(q.px, q.px), mul(q.py, q.py)),
                        mul(q.pz, q.pz)));
  q.inv_e = __fdiv_rn(1.f, add(q.nn, kEps));
  q.xh = mul(q.px, q.inv_e);
  q.yh = mul(q.py, q.inv_e);
  q.zh = mul(q.pz, q.inv_e);
  q.inv_d = __fdiv_rn(1.f, add(add(q.zh, m[12]), kEps));
  q.a = mul(q.xh, q.inv_d);
  q.b = mul(q.yh, q.inv_d);
  q.rho2 = add(mul(q.a, q.a), mul(q.b, q.b));
  q.fac = add(add(1.f, mul(m[13], q.rho2)), mul(mul(m[14], q.rho2), q.rho2));
  q.x = add(mul(mul(m[15], q.a), q.fac), m[17]);
  q.y = add(mul(mul(m[16], q.b), q.fac), m[18]);
  return q;
}

__device__ __forceinline__ float clampf(float v, float hi) {
  return fminf(fmaxf(v, 0.f), hi);   // NaN -> 0
}

__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi);
}

// Img: the image's and the outputs' type, Nrm the norm's
template <typename Img, typename Nrm>
__global__ void __launch_bounds__(kThreadsG)
warp_mei_fwd_kernel(const Img* __restrict__ image,
                    const float* __restrict__ mask,
                    const Nrm* __restrict__ norm,
                    const float* __restrict__ rays,
                    const float* __restrict__ mrows, Img* __restrict__ out,
                    Img* __restrict__ va, Img* __restrict__ vb,
                    uint8_t* __restrict__ overlap, int S, int F, int B, int H,
                    int W, int C, int band, int with_mask) {
  __shared__ float s_m[24];
  __shared__ int s_min[kThreadsG / 32];
  const int i = blockIdx.x;                // output row
  const int n = blockIdx.y;                // warp (s, f, b)
  const int b = n % B;
  const int f = (n / B) % F;
  const int s = n / (F * B);
  if (threadIdx.x < 24) s_m[threadIdx.x] = mrows[(size_t)n * 24 + threadIdx.x];
  __syncthreads();
  const Nrm* nrow = norm + ((size_t)(s * B + b) * H + i) * W;
  const size_t plane = (size_t)H * W;
  const float* rrow = rays + (size_t)b * 3 * plane + (size_t)i * W;
  const float wmax = (float)(W - 1);
  const float hmax = (float)(H - 1);

  // pass 1: the row's band start, min floor(clamped y) over the row
  int lo = INT_MAX;
  for (int j = threadIdx.x; j < W; j += kThreadsG) {
    const Mei q = mei_pix(s_m, widen(nrow[j]), rrow[j], rrow[plane + j],
                          rrow[2 * plane + j]);
    lo = min(lo, clampi((int)floorf(clampf(q.y, hmax)), H - 1));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
  if ((threadIdx.x & 31) == 0) s_min[threadIdx.x >> 5] = lo;
  __syncthreads();
  int ymin = s_min[0];
#pragma unroll
  for (int k = 1; k < kThreadsG / 32; ++k) ymin = min(ymin, s_min[k]);
  ymin = min(max(ymin, 0), max(H - band, 0));
  ymin -= ymin & 1;

  // pass 2: corners, fractions, the three outputs and the overlap
  const Img* src = image + (size_t)(f * B + b) * plane * C;
  const float* msk = mask + (size_t)b * plane;
  for (int j = threadIdx.x; j < W; j += kThreadsG) {
    const Mei q = mei_pix(s_m, widen(nrow[j]), rrow[j], rrow[plane + j],
                          rrow[2 * plane + j]);
    const size_t o = ((size_t)n * H + i) * W + j;
    const float xb = clampf(q.x, wmax);
    const float yb = clampf(q.y, hmax);
    const float x0f = floorf(xb);
    const float y0f = floorf(yb);
    const float fx = sub(xb, x0f);
    const float fy = sub(yb, y0f);
    const int x0 = clampi((int)x0f, W - 1);
    const int y0 = clampi((int)y0f, H - 1);
    const int x1 = min(x0 + 1, W - 1);
    const int y1 = min(y0 + 1, H - 1);
    const int r0 = ymin + clampi(y0 - ymin, band - 1);
    const int r1 = ymin + clampi(y1 - ymin, band - 1);
    const size_t q00 = (size_t)r0 * W + x0, q01 = (size_t)r0 * W + x1;
    const size_t q10 = (size_t)r1 * W + x0, q11 = (size_t)r1 * W + x1;
    const float wx0 = sub(1.f, fx);
    const float wy0 = sub(1.f, fy);
    Img* po = out + o * C;
    Img* pa = va + o * C;
    Img* pb = vb + o * C;
    for (int c = 0; c < C; ++c) {
      const float i00 = widen(__ldg(src + q00 * C + c));
      const float i01 = widen(__ldg(src + q01 * C + c));
      const float i10 = widen(__ldg(src + q10 * C + c));
      const float i11 = widen(__ldg(src + q11 * C + c));
      const float h0 = add(mul(i00, wx0), mul(i01, fx));
      const float h1 = add(mul(i10, wx0), mul(i11, fx));
      po[c] = narrow<Img>(add(mul(h0, wy0), mul(h1, fy)));
      pa[c] = narrow<Img>(
          add(mul(sub(i01, i00), wy0), mul(sub(i11, i10), fy)));
      pb[c] = narrow<Img>(sub(h1, h0));
    }
    if (with_mask) {
      const float ex = fx >= 0.5f ? 1.f : 0.f;
      const float ey = fy >= 0.5f ? 1.f : 0.f;
      const float ex0 = sub(1.f, ex), ey0 = sub(1.f, ey);
      const float h0 = add(mul(__ldg(msk + q00), ex0), mul(__ldg(msk + q01), ex));
      const float h1 = add(mul(__ldg(msk + q10), ex0), mul(__ldg(msk + q11), ex));
      const float mv = add(mul(h0, ey0), mul(h1, ey));
      const bool inb = (q.x >= -0.5f) & (q.x < (float)W - 0.5f) &
                       (q.y >= -0.5f) & (q.y < (float)H - 0.5f);
      overlap[o] = (mv == 1.f) & inb;
    }
  }
}

// Kernel G, vector route: thread t of the row's block takes pixels
// t + k W/4, k = 0..3 (csrc/warp_rows.cuh); the row staged in Img, the
// outputs' type; KC the channels where fixed at compile time (0: C at run
// time).
template <typename Img, typename Nrm, int KC>
__global__ void __launch_bounds__(kRowMaxThreads, kRowMinBlocks)
warp_mei_fwd_vec_kernel(const Img* __restrict__ image,
                        const float* __restrict__ mask,
                        const Nrm* __restrict__ norm,
                        const float* __restrict__ rays,
                        const float* __restrict__ mrows,
                        Img* __restrict__ out, Img* __restrict__ va,
                        Img* __restrict__ vb, uint8_t* __restrict__ overlap,
                        int S, int F, int B, int H, int W, int C_, int band,
                        int with_mask) {
  extern __shared__ float4 s_row[];
  __shared__ float s_m[24];
  const int C = KC > 0 ? KC : C_;
  const int i = blockIdx.x;                // output row
  const int n = blockIdx.y;                // warp (s, f, b)
  const int b = n % B;
  const int f = (n / B) % F;
  const int s = n / (F * B);
  const int T = W / kRowPix;
  const int t = threadIdx.x;
  const bool live = t < T;                 // lanes past W / 4 only reduce
  if (t < 24) s_m[t] = mrows[(size_t)n * 24 + t];
  __syncthreads();
  const Nrm* nrow = norm + ((size_t)(s * B + b) * H + i) * W;
  const size_t plane = (size_t)H * W;
  const float* rrow = rays + (size_t)b * 3 * plane + (size_t)i * W;
  const float wmax = (float)(W - 1);
  const float hmax = (float)(H - 1);

  // pass 1: project each pixel once; the row's band start
  float px[kRowPix], py[kRowPix];
  int lo = INT_MAX;
#pragma unroll
  for (int k = 0; k < kRowPix; ++k) {
    const int j = live ? t + k * T : 0;
    const Mei q = mei_pix(s_m, widen(nrow[j]), rrow[j], rrow[plane + j],
                          rrow[2 * plane + j]);
    px[k] = q.x;
    py[k] = q.y;
    if (live) lo = min(lo, clampi((int)floorf(clampf(q.y, hmax)), H - 1));
  }
  const int ymin = row_band_start(lo, H, band);

  // pass 2: corners, fractions, the three outputs and the overlap, staged
  const RowStageOf<Img> st = row_stage<Img>(s_row, W, C);
  const Img* src = image + (size_t)(f * B + b) * plane * C;
  const float* msk = mask + (size_t)b * plane;
  if (live) {
#pragma unroll
    for (int k = 0; k < kRowPix; ++k) {
      const int j = t + k * T;
      const float x = px[k], y = py[k];
      const float xb = clampf(x, wmax);
      const float yb = clampf(y, hmax);
      const float x0f = floorf(xb);
      const float y0f = floorf(yb);
      const float fx = sub(xb, x0f);
      const float fy = sub(yb, y0f);
      const int x0 = clampi((int)x0f, W - 1);
      const int y0 = clampi((int)y0f, H - 1);
      const int x1 = min(x0 + 1, W - 1);
      const int y1 = min(y0 + 1, H - 1);
      const int r0 = ymin + clampi(y0 - ymin, band - 1);
      const int r1 = ymin + clampi(y1 - ymin, band - 1);
      const size_t q00 = (size_t)r0 * W + x0, q01 = (size_t)r0 * W + x1;
      const size_t q10 = (size_t)r1 * W + x0, q11 = (size_t)r1 * W + x1;
      const float wx0 = sub(1.f, fx);
      const float wy0 = sub(1.f, fy);
      for (int c = 0; c < C; ++c) {
        const float i00 = widen(__ldg(src + q00 * C + c));
        const float i01 = widen(__ldg(src + q01 * C + c));
        const float i10 = widen(__ldg(src + q10 * C + c));
        const float i11 = widen(__ldg(src + q11 * C + c));
        const float h0 = add(mul(i00, wx0), mul(i01, fx));
        const float h1 = add(mul(i10, wx0), mul(i11, fx));
        st.out[j * C + c] = narrow<Img>(add(mul(h0, wy0), mul(h1, fy)));
        st.va[j * C + c] =
            narrow<Img>(add(mul(sub(i01, i00), wy0), mul(sub(i11, i10), fy)));
        st.vb[j * C + c] = narrow<Img>(sub(h1, h0));
      }
      if (with_mask) {
        const float ex = fx >= 0.5f ? 1.f : 0.f;
        const float ey = fy >= 0.5f ? 1.f : 0.f;
        const float ex0 = sub(1.f, ex), ey0 = sub(1.f, ey);
        const float h0 =
            add(mul(__ldg(msk + q00), ex0), mul(__ldg(msk + q01), ex));
        const float h1 =
            add(mul(__ldg(msk + q10), ex0), mul(__ldg(msk + q11), ex));
        const float mv = add(mul(h0, ey0), mul(h1, ey));
        const bool inb = (x >= -0.5f) & (x < (float)W - 0.5f) &
                         (y >= -0.5f) & (y < (float)H - 0.5f);
        st.overlap[j] = (mv == 1.f) & inb;
      }
    }
  }
  __syncthreads();
  row_flush(st, (size_t)n * H + i, W, C, out, va, vb,
            with_mask ? overlap : nullptr);
}

// Val: the type of g, va and vb; Nrm the norm's and d norm's
template <typename Val, typename Nrm>
__global__ void __launch_bounds__(kThreadsH)
warp_mei_bwd_kernel(const Nrm* __restrict__ norm,
                    const float* __restrict__ rays,
                    const Val* __restrict__ g, const Val* __restrict__ va,
                    const Val* __restrict__ vb,
                    const float* __restrict__ mrows,
                    Nrm* __restrict__ dnorm, int S, int F, int B, int H,
                    int W, int C) {
  const size_t plane = (size_t)H * W;
  const size_t idx = (size_t)blockIdx.x * kThreadsH + threadIdx.x;
  if (idx >= (size_t)S * B * plane) return;
  const size_t pix = idx % plane;          // i * W + j
  const int j = (int)(pix % W);
  const int i = (int)(pix / W);
  const int mi = (int)(idx / plane);       // s*B + b
  const int s = mi / B;
  const int b = mi % B;
  const float nv = widen(norm[idx]);
  const float* r = rays + (size_t)b * 3 * plane + pix;
  const float rx = r[0], ry = r[plane], rz = r[2 * plane];
  float acc = 0.f;
  for (int f = 0; f < F; ++f) {
    const int n = (s * F + f) * B + b;
    const float* m = mrows + (size_t)n * 24;
    const Mei q = mei_pix(m, nv, rx, ry, rz);
    const float dnn =
        __fdiv_rn(add(add(mul(q.px, q.gx), mul(q.py, q.gy)), mul(q.pz, q.gz)),
                  fmaxf(q.nn, 1e-12f));
    const float dxh = mul(sub(q.gx, mul(q.xh, dnn)), q.inv_e);
    const float dyh = mul(sub(q.gy, mul(q.yh, dnn)), q.inv_e);
    const float dzh = mul(sub(q.gz, mul(q.zh, dnn)), q.inv_e);
    const float da = mul(sub(dxh, mul(q.a, dzh)), q.inv_d);
    const float db = mul(sub(dyh, mul(q.b, dzh)), q.inv_d);
    const float k = add(m[13], mul(mul(2.f, m[14]), q.rho2));
    const float common = mul(mul(2.f, k), add(mul(q.a, da), mul(q.b, db)));
    const float dux = mul(m[15], add(mul(q.fac, da), mul(q.a, common)));
    const float dvy = mul(m[16], add(mul(q.fac, db), mul(q.b, common)));
    const size_t o = ((size_t)n * plane + pix) * C;
    float gfx = 0.f, gfy = 0.f;
    for (int c = 0; c < C; ++c) {
      gfx = add(gfx, product(g[o + c], va[o + c]));
      gfy = add(gfy, product(g[o + c], vb[o + c]));
    }
    gfx = rounded<Val>(gfx);
    gfy = rounded<Val>(gfy);
    const float mx = (q.x > 0.f && q.x < (float)(W - 1)) ? 1.f : 0.f;
    const float my = (q.y > 0.f && q.y < (float)(H - 1)) ? 1.f : 0.f;
    acc = add(acc, add(mul(mul(gfx, mx), dux), mul(mul(gfy, my), dvy)));
  }
  dnorm[idx] = narrow<Nrm>(acc);
}

bool bad_dims(int S, int F, int B, int H, int W, int C) {
  return S <= 0 || F <= 0 || B <= 0 || H <= 0 || W <= 0 || C <= 0;
}

bool bad_dtype(int dtype) { return dtype < 0 || dtype > 2; }

// the bytes of an image (out, va, vb) element of `dtype`
int image_bytes(int dtype) { return dtype == 0 ? 4 : 2; }

using bf16 = __nv_bfloat16;

template <typename Img, typename Nrm>
int launch_fwd(const void* image, const void* mask, const void* norm,
               const void* rays, const void* mrows, void* out, void* va,
               void* vb, void* overlap, int S, int F, int B, int H, int W,
               int C, int band, int with_mask, void* stream) {
  const dim3 grid((unsigned)H, (unsigned)(S * F * B));
  warp_mei_fwd_kernel<Img, Nrm><<<grid, kThreadsG, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Img*>(image), static_cast<const float*>(mask),
      static_cast<const Nrm*>(norm), static_cast<const float*>(rays),
      static_cast<const float*>(mrows), static_cast<Img*>(out),
      static_cast<Img*>(va), static_cast<Img*>(vb),
      static_cast<uint8_t*>(overlap), S, F, B, H, W, C, band, with_mask);
  return (int)cudaGetLastError();
}

template <typename Img, typename Nrm>
int launch_fwd_vec(const void* image, const void* mask, const void* norm,
                   const void* rays, const void* mrows, void* out, void* va,
                   void* vb, void* overlap, int S, int F, int B, int H, int W,
                   int C, int band, int with_mask, void* stream) {
  static unsigned set3 = 0, set0 = 0;
  const auto* im = static_cast<const Img*>(image);
  const auto* mk = static_cast<const float*>(mask);
  const auto* nm = static_cast<const Nrm*>(norm);
  const auto* ry = static_cast<const float*>(rays);
  const auto* mr = static_cast<const float*>(mrows);
  auto* o = static_cast<Img*>(out);
  auto* a = static_cast<Img*>(va);
  auto* b = static_cast<Img*>(vb);
  auto* ov = static_cast<uint8_t*>(overlap);
  const int N = S * F * B;
  return C == 3 ? row_launch<Img>(warp_mei_fwd_vec_kernel<Img, Nrm, 3>, set3,
                                  N, H, W, C, stream, im, mk, nm, ry, mr, o,
                                  a, b, ov, S, F, B, H, W, C, band, with_mask)
                : row_launch<Img>(warp_mei_fwd_vec_kernel<Img, Nrm, 0>, set0,
                                  N, H, W, C, stream, im, mk, nm, ry, mr, o,
                                  a, b, ov, S, F, B, H, W, C, band,
                                  with_mask);
}

template <typename Val, typename Nrm>
int launch_bwd(const void* norm, const void* rays, const void* g,
               const void* va, const void* vb, const void* mrows,
               void* dnorm, int S, int F, int B, int H, int W, int C,
               void* stream) {
  const long long total = (long long)S * B * H * W;
  const long long blocks = (total + kThreadsH - 1) / kThreadsH;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  warp_mei_bwd_kernel<Val, Nrm><<<(unsigned)blocks, kThreadsH, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Nrm*>(norm), static_cast<const float*>(rays),
      static_cast<const Val*>(g), static_cast<const Val*>(va),
      static_cast<const Val*>(vb), static_cast<const float*>(mrows),
      static_cast<Nrm*>(dnorm), S, F, B, H, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel G. image [F*B,H,W,C], mask [B,H,W] f32, norm [S*B,H,W], rays
// [B,3,H,W] f32, mrows [S*F*B,24] f32; writes out, va, vb [S*F*B,H,W,C] in
// the image's type and, when with_mask, overlap [S*F*B,H,W] uint8 (may be
// null otherwise). `dtype`: 0 image and norm float32, 1 both bfloat16, 2 a
// bfloat16 image with a float32 norm. All contiguous. Launches on `stream`
// and returns cudaGetLastError() (0 on success); never synchronises.
extern "C" int fsnet_warp_mei_fwd(const void* image, const void* mask,
                                  const void* norm, const void* rays,
                                  const void* mrows, void* out, void* va,
                                  void* vb, void* overlap, int S, int F, int B,
                                  int H, int W, int C, int band, int with_mask,
                                  int dtype, void* stream) {
  if (bad_dims(S, F, B, H, W, C) || band <= 0 || bad_dtype(dtype) ||
      (long long)S * F * B > 65535 || (with_mask && overlap == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto launch = dtype == 0   ? launch_fwd<float, float>
                      : dtype == 1 ? launch_fwd<bf16, bf16>
                                   : launch_fwd<bf16, float>;
  return launch(image, mask, norm, rays, mrows, out, va, vb, overlap, S, F, B,
                H, W, C, band, with_mask, stream);
}

// Kernel G, vector route: the arguments of fsnet_warp_mei_fwd; refuses
// (cudaErrorInvalidValue) a row that row_fits does not take at the
// outputs' element size or a pointer that is not 16-byte aligned (overlap
// may be null without the mask).
extern "C" int fsnet_warp_mei_fwd_vec(const void* image, const void* mask,
                                      const void* norm, const void* rays,
                                      const void* mrows, void* out, void* va,
                                      void* vb, void* overlap, int S, int F,
                                      int B, int H, int W, int C, int band,
                                      int with_mask, int dtype, void* stream) {
  if (bad_dims(S, F, B, H, W, C) || band <= 0 || bad_dtype(dtype) ||
      (long long)S * F * B > 65535 || (with_mask && overlap == nullptr) ||
      !row_fits(W, C, image_bytes(dtype)) || !aligned16(image) ||
      !aligned16(mask) || !aligned16(norm) || !aligned16(rays) ||
      !aligned16(mrows) || !aligned16(out) || !aligned16(va) ||
      !aligned16(vb) || !aligned16(overlap))
    return (int)cudaErrorInvalidValue;
  const auto launch = dtype == 0   ? launch_fwd_vec<float, float>
                      : dtype == 1 ? launch_fwd_vec<bf16, bf16>
                                   : launch_fwd_vec<bf16, float>;
  return launch(image, mask, norm, rays, mrows, out, va, vb, overlap, S, F, B,
                H, W, C, band, with_mask, stream);
}

// Kernel H. norm [S*B,H,W], rays [B,3,H,W] f32, g/va/vb [S*F*B,H,W,C],
// mrows [S*F*B,24] f32; writes dnorm [S*B,H,W] in the norm's type.
// `dtype`: 0 g, va, vb and norm float32, 1 all bfloat16, 2 bfloat16 g, va,
// vb with a float32 norm. All contiguous. Launches on `stream` and returns
// cudaGetLastError(); never synchronises.
extern "C" int fsnet_warp_mei_bwd(const void* norm, const void* rays,
                                  const void* g, const void* va,
                                  const void* vb, const void* mrows,
                                  void* dnorm, int S, int F, int B, int H,
                                  int W, int C, int dtype, void* stream) {
  if (bad_dims(S, F, B, H, W, C) || bad_dtype(dtype))
    return (int)cudaErrorInvalidValue;
  const auto launch = dtype == 0   ? launch_bwd<float, float>
                      : dtype == 1 ? launch_bwd<bf16, bf16>
                                   : launch_bwd<bf16, float>;
  return launch(norm, rays, g, va, vb, mrows, dnorm, S, F, B, H, W, C,
                stream);
}
