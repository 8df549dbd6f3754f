// Photometric loss for Hopper (sm_90a), bound through a plain C interface
// (ctypes): the forward and the prediction cotangent of
// fsnet_tpu_torch.ops.photo_loss.reprojection_loss_fused.
//
// Layouts: pred [N, H, W, C], target, muy, sy [B, H, W, C] (NHWC, N a
// multiple of B), loss and g [N, H, W], dpred [N, H, W, C], all float32 or
// all bfloat16 (the bf16 train step; every entry point takes the dtype).
// Prediction n compares with target n mod B: the target and its pooled
// stats (muy, sy = ops.ssim.ssim_target_stats(target)) are never tiled.
// In bfloat16 the kernels load each value widened to float32 (exactly),
// compute exactly as in float32, and round the loss and the cotangent to
// bfloat16 as they store them (round to nearest even, as a cast of the
// float32 result would): TPU photo_loss_pallas writes the loss in the
// prediction's dtype (photo_kernel.py:238), and photo_loss_bwd_pallas's
// float32 cotangent is rounded to it by its caller (ops/photo_loss.py:110).
//
// The function, per pixel and channel (x = pred, y = target):
//   P(t) = the 3x3 mean pool over reflect-101 padding by 1 (row -1 -> row 1,
//          row H -> row H-2, the same for columns): the H pass first,
//          ((t[i-1] + t[i]) + t[i+1]) * f32(1/3), then the W pass the same
//          way on the H-pooled values, as ops/ssim.py avg_pool3;
//   u = P(x), v = P(x*x), w = P(x*y);  sx = max(v - u*u, 0),
//   sxy = w - u*muy,  n1 = 2u*muy + C1,  n2 = 2sxy + C2,
//   d1 = u*u + muy*muy + C1,  d2 = sx + sy + C2,
//   val = (1 - (n1*n2) / (d1*d2)) / 2,  dis = clip(val, 0, 1);
//   loss = w_ssim * (sum_c dis) * (1/C) + w_l1 * (sum_c |y - x|) * (1/C),
// channels summed in order. Every operation is rounded once, in the order of
// the plain version (ops/photo_loss.py): nvcc would contract a*b + c into
// one FMA, so the arithmetic uses the _rn intrinsics, which are never
// contracted, and the forward is bitwise equal to its plain version.
//
// The cotangent: with G = (g * k_ssim) * gclip (k_ssim = -w_ssim / (2C)),
//   dL/dx = P^T(G dr/du) + 2x P^T(G dr/dv) + y P^T(G dr/dw)
//           + (g * k_l1) * (y - x >= 0 ? -1 : 1)     (k_l1 = w_l1 / C),
// r = n1 n2 / (d1 d2). At a tie the gates split as autodiff of the JAX
// package's default route does (max and clip pass half the cotangent,
// d|y - x|/dx = -1 at y == x): gmax = 1, 0.5, 0 for sx_raw >, ==, < 0 and
// gclip = 1 inside (0, 1), 0.5 at val == 0 or 1, 0 outside. (The TPU
// kernel's strict gates give 0 at every tie.) P^T is the adjoint of the
// pool: per axis, s[p] = (a[p-1] + a[p]) + a[p+1] with a = 0 outside the
// image, then s[1] += a[0] and s[n-2] += a[n-1] (the reflected taps), times
// f32(1/3); the W axis first, then the H axis.
//
// Two routes, picked on the host (ops/photo_loss.photo_route), each with its
// own entry points; an entry point refuses a shape or pointer outside its
// route (cudaErrorInvalidValue) and never falls back.
//
// The vector route (C <= 4, W % 4 == 0, every operand 16-byte aligned: both
// train recipes, C = 3 at W = 640 and 384). Kernels photo_loss_fwd_vec_kernel
// (I) and photo_loss_bwd_vec_kernel (J) replace
// fsnet_tpu/ops/pallas/photo_kernel.py photo_loss_pallas (_fwd_kernel) and
// photo_loss_bwd_pallas (_bwd_kernel). What bounds them on an H100: I,
// bytes (each input read once, each output written once); J, the issue of
// its instructions (about 33.5 T a second: 132 SMs x 128 lanes x the SM
// clock), since it is _rn intrinsics that never contract, on 8 pooled rows
// for 6 output rows. The design does three things about the bytes:
//  - A block owns one target b and one tile of 128 pixels (32 lanes x 4) by
//    8 rows (I) or 6 rows (J). It stages y (with its halo) once, keeps muy
//    and sy of its pixels in registers, and walks the predictions n = b,
//    b + B, ... that compare with b; each prediction's x tile comes through
//    a ring of cp.async copies (3 stages in I, 2 in J, with g's tile), so
//    the next prediction's copy overlaps this one's arithmetic. HBM sees
//    each target byte once; the grid is tiles x B blocks.
//  - All channels at once: an NHWC row of the tile is 128 C contiguous
//    floats, copied as 16-byte chunks (a lane's 4 pixels are C float4s, read
//    back from shared memory as 128-bit loads without bank conflicts at
//    C = 3); the loss and dpred are stored as float4s. The reflect-101 halo
//    is fixed by the source address of each halo row and halo pixel (row -1
//    <- row 1, column W <- W - 2, the first column past a ragged tile's
//    last included), so no interior element computes a reflection.
//  - Separable pooling with each H sum formed once: one warp per row; a
//    lane forms x, x*x, x*y and their H sums for its 4 pixels, lanes 0 and
//    31 also at the halo columns, and the W pass takes its neighbours' H
//    sums by shuffles (the same rounding as avg_pool3: I stays bitwise).
//    J computes the partials G dr/du, G dr/dv, G dr/dw once per pooled
//    position of its tile and the 1-pixel ring (8 pooled rows, one per
//    warp; lanes 0 and 31 the ring columns), applies the W adjoint in
//    registers by shuffles, and the H adjoint from shared memory (6 output
//    rows, 4 pixels a thread). No atomics: deterministic.
// J rounds as the narrow route and the plain version do: sx_raw and val,
// which decide the tie gates, exactly as in I, and past the gates the
// partials (`partials`, shared by both routes: correctly rounded 1/d1 and
// 1/d2) and the cotangent's sums are _rn intrinsics in the plain version's
// order, never contracted.
//
// The narrow route (any C >= 1, H, W >= 2, any 4-byte alignment: the
// shapes the vector route refuses). photo_loss_fwd_kernel: one thread per
// output pixel (all C channels), one block per 8 x 32 pixel tile of one
// prediction; per channel the block stages x and y (at n mod B) with a
// 1-pixel halo, reflected at the image edge, in shared memory, and each
// thread pools its 3x3 window from there, recomputing the H sums its
// neighbours share. photo_loss_bwd_kernel: same tiles; per channel the
// block stages x and y with a 2-pixel halo, computes the three partials at
// the tile's pooled positions plus a 1-pixel ring into shared memory, and
// each thread gathers P^T of them at its pixel. Both re-read the target and
// its stats once per prediction.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "launch.cuh"

namespace {

using bf16 = __nv_bfloat16;

// one element as float32 (bfloat16 widens exactly), and back
__device__ __forceinline__ float f32(float v) { return v; }
__device__ __forceinline__ float f32(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int kTW = 32;                 // tile columns
constexpr int kTH = 8;                  // tile rows
constexpr int kThreads = kTW * kTH;
constexpr float kC1 = (float)(0.01 * 0.01);
constexpr float kC2 = (float)(0.03 * 0.03);
constexpr float kThird = (float)(1.0 / 3.0);

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// reflect-101 index into [0, n); anything further out (ragged tiles, halo
// positions whose pooled value is never used) is clamped into the image
__device__ __forceinline__ int refl(int k, int n) {
  k = k < 0 ? -k : k;
  k = k >= n ? 2 * n - 2 - k : k;
  return min(max(k, 0), n - 1);
}

// ((a + b) + c) * 1/3
__device__ __forceinline__ float tap3(float a, float b, float c) {
  return mul(add(add(a, b), c), kThird);
}

struct Pooled {
  float u, v, w;
};

// P(x), P(x*x), P(x*y) at the pooled position whose 3x3 window starts at
// tile row r, column q of the staged x and y tiles (row pitch `pitch`)
__device__ __forceinline__ Pooled pool3(const float* xs, const float* ys,
                                        int pitch, int r, int q) {
  float hu[3], hv[3], hw[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float* xc = xs + r * pitch + q + d;
    const float* yc = ys + r * pitch + q + d;
    const float a0 = xc[0], a1 = xc[pitch], a2 = xc[2 * pitch];
    const float b0 = yc[0], b1 = yc[pitch], b2 = yc[2 * pitch];
    hu[d] = tap3(a0, a1, a2);
    hv[d] = tap3(mul(a0, a0), mul(a1, a1), mul(a2, a2));
    hw[d] = tap3(mul(a0, b0), mul(a1, b1), mul(a2, b2));
  }
  return {tap3(hu[0], hu[1], hu[2]), tap3(hv[0], hv[1], hv[2]),
          tap3(hw[0], hw[1], hw[2])};
}

struct Ssim {
  float sx_raw, n1, n2, d1, d2, r, val;
};

__device__ __forceinline__ Ssim ssim_terms(const Pooled& p, float my,
                                           float s_y) {
  Ssim t;
  const float uu = mul(p.u, p.u);
  t.sx_raw = sub(p.v, uu);
  const float sxy = sub(p.w, mul(p.u, my));
  t.n1 = add(mul(mul(2.f, p.u), my), kC1);
  t.n2 = add(mul(2.f, sxy), kC2);
  t.d1 = add(add(uu, mul(my, my)), kC1);
  t.d2 = add(add(fmaxf(t.sx_raw, 0.f), s_y), kC2);
  t.r = dvd(mul(t.n1, t.n2), mul(t.d1, t.d2));
  t.val = mul(sub(1.f, t.r), 0.5f);
  return t;
}

// stage channel c of x (prediction n) and y (target n mod B) for the tile
// at (i0, j0) with a `halo`-pixel ring, reflected at the image edge
template <typename T>
__device__ __forceinline__ void stage(float* xs, float* ys, int rows, int cols,
                                      const T* __restrict__ xb,
                                      const T* __restrict__ yb, int i0,
                                      int j0, int halo, int H, int W, int C,
                                      int c) {
  for (int k = threadIdx.x; k < rows * cols; k += kThreads) {
    const int r = k / cols, q = k - r * cols;
    const size_t off =
        ((size_t)refl(i0 - halo + r, H) * W + refl(j0 - halo + q, W)) * C + c;
    xs[k] = f32(xb[off]);
    ys[k] = f32(yb[off]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
photo_loss_fwd_kernel(const T* __restrict__ pred,
                      const T* __restrict__ target,
                      const T* __restrict__ muy,
                      const T* __restrict__ sy, T* __restrict__ loss,
                      int B, int H, int W, int C, float w_ssim, float w_l1,
                      float inv_c) {
  constexpr int R = kTH + 2, Q = kTW + 2;
  __shared__ float xs[R * Q], ys[R * Q];
  const int n = blockIdx.z;
  const int b = n % B;
  const int i0 = blockIdx.y * kTH, j0 = blockIdx.x * kTW;
  const int ty = threadIdx.x / kTW, tx = threadIdx.x % kTW;
  const int i = i0 + ty, j = j0 + tx;
  const bool live = i < H && j < W;
  const size_t plane = (size_t)H * W * C;
  const T* xb = pred + (size_t)n * plane;
  const T* yb = target + (size_t)b * plane;
  const size_t pix = ((size_t)i * W + j) * C;
  float dsum = 0.f, lsum = 0.f;
  for (int c = 0; c < C; ++c) {
    stage(xs, ys, R, Q, xb, yb, i0, j0, 1, H, W, C, c);
    __syncthreads();
    if (live) {
      const Pooled p = pool3(xs, ys, Q, ty, tx);
      const size_t at = (size_t)b * plane + pix + c;
      const Ssim t = ssim_terms(p, f32(muy[at]), f32(sy[at]));
      const float dis = fminf(fmaxf(t.val, 0.f), 1.f);
      const float l1 =
          fabsf(sub(ys[(ty + 1) * Q + tx + 1], xs[(ty + 1) * Q + tx + 1]));
      dsum = c == 0 ? dis : add(dsum, dis);
      lsum = c == 0 ? l1 : add(lsum, l1);
    }
    __syncthreads();
  }
  if (live)
    loss[((size_t)n * H + i) * W + j] = from_f32<T>(
        add(mul(w_ssim, mul(dsum, inv_c)), mul(w_l1, mul(lsum, inv_c))));
}

// J's three partials G dr/du, G dr/dv, G dr/dw at one pooled position from
// its pooled values, the target stats and g there: the plain version's
// operations, each rounded once in its order (the reciprocals correctly
// rounded), with the gates split at a tie as the file's head says
__device__ __forceinline__ void partials(const Pooled& p, float my, float s_y,
                                         float g, float k_ssim, float& a_u,
                                         float& a_v, float& a_w) {
  const Ssim t = ssim_terms(p, my, s_y);
  const float gmax = t.sx_raw > 0.f ? 1.f : (t.sx_raw == 0.f ? 0.5f : 0.f);
  const float gclip = (t.val > 0.f && t.val < 1.f)
                          ? 1.f
                          : ((t.val == 0.f || t.val == 1.f) ? 0.5f : 0.f);
  const float G = mul(mul(g, k_ssim), gclip);
  const float inv1 = dvd(1.f, t.d1), inv2 = dvd(1.f, t.d2);
  const float dr_dsx = mul(-t.r, inv2);
  const float dr_dw = mul(mul(mul(2.f, t.n1), inv1), inv2);
  const float t1 = mul(mul(mul(mul(2.f, my), t.n2), inv1), inv2);
  const float t2 = mul(mul(mul(2.f, p.u), t.r), inv1);
  const float t3 = mul(mul(mul(2.f, p.u), gmax), dr_dsx);
  const float t4 = mul(my, dr_dw);
  const float dr_du = sub(sub(sub(t1, t2), t3), t4);
  a_u = mul(G, dr_du);
  a_v = mul(G, mul(dr_dsx, gmax));
  a_w = mul(G, dr_dw);
}

// one axis of P^T at index p of an axis of length n: a_m1, a_0, a_p1 the
// values at p-1, p, p+1 (0 outside the axis)
__device__ __forceinline__ float adj3(float a_m1, float a_0, float a_p1, int p,
                                      int n) {
  float s = add(add(a_m1, a_0), a_p1);
  if (p == 1) s = add(s, a_m1);          // row -1 reflects onto row 1
  if (p == n - 2) s = add(s, a_p1);      // row n reflects onto row n-2
  return mul(s, kThird);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
photo_loss_bwd_kernel(const T* __restrict__ pred,
                      const T* __restrict__ target,
                      const T* __restrict__ muy,
                      const T* __restrict__ sy,
                      const T* __restrict__ g, T* __restrict__ dpred,
                      int B, int H, int W, int C, float k_ssim, float k_l1) {
  constexpr int XR = kTH + 4, XQ = kTW + 4;   // x, y tiles: 2-pixel halo
  constexpr int PR = kTH + 2, PQ = kTW + 2;   // partials: 1-pixel ring
  __shared__ float xs[XR * XQ], ys[XR * XQ];
  __shared__ float au[PR * PQ], av[PR * PQ], aw[PR * PQ];
  const int n = blockIdx.z;
  const int b = n % B;
  const int i0 = blockIdx.y * kTH, j0 = blockIdx.x * kTW;
  const int ty = threadIdx.x / kTW, tx = threadIdx.x % kTW;
  const int i = i0 + ty, j = j0 + tx;
  const bool live = i < H && j < W;
  const size_t plane = (size_t)H * W * C;
  const T* xb = pred + (size_t)n * plane;
  const T* yb = target + (size_t)b * plane;
  const T* gn = g + (size_t)n * H * W;
  for (int c = 0; c < C; ++c) {
    stage(xs, ys, XR, XQ, xb, yb, i0, j0, 2, H, W, C, c);
    __syncthreads();
    // the partials at pooled positions (i0 - 1 + pr, j0 - 1 + pq)
    for (int k = threadIdx.x; k < PR * PQ; k += kThreads) {
      const int pr = k / PQ, pq = k - pr * PQ;
      const int pi = i0 - 1 + pr, pj = j0 - 1 + pq;
      float a_u = 0.f, a_v = 0.f, a_w = 0.f;
      if (pi >= 0 && pi < H && pj >= 0 && pj < W) {
        const size_t at = (size_t)b * plane + ((size_t)pi * W + pj) * C + c;
        partials(pool3(xs, ys, XQ, pr, pq), f32(muy[at]), f32(sy[at]),
                 f32(gn[(size_t)pi * W + pj]), k_ssim, a_u, a_v, a_w);
      }
      au[k] = a_u;
      av[k] = a_v;
      aw[k] = a_w;
    }
    __syncthreads();
    if (live) {
      // W adjoint on pooled rows i-1, i, i+1 (local ty .. ty+2) at column
      // j (local tx+1), then the H adjoint of those three at row i
      float bu[3], bv[3], bw[3];
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const int o = (ty + d) * PQ + tx + 1;
        bu[d] = adj3(au[o - 1], au[o], au[o + 1], j, W);
        bv[d] = adj3(av[o - 1], av[o], av[o + 1], j, W);
        bw[d] = adj3(aw[o - 1], aw[o], aw[o + 1], j, W);
      }
      const float hu = adj3(bu[0], bu[1], bu[2], i, H);
      const float hv = adj3(bv[0], bv[1], bv[2], i, H);
      const float hw = adj3(bw[0], bw[1], bw[2], i, H);
      const float xc = xs[(ty + 2) * XQ + tx + 2];
      const float yc = ys[(ty + 2) * XQ + tx + 2];
      const float dl1 = mul(mul(f32(gn[(size_t)i * W + j]), k_l1),
                            sub(yc, xc) >= 0.f ? -1.f : 1.f);
      dpred[(size_t)n * plane + ((size_t)i * W + j) * C + c] = from_f32<T>(
          add(add(add(hu, mul(mul(2.f, xc), hv)), mul(yc, hw)), dl1));
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------- vector route

constexpr int kVW = 128;              // tile pixels per row: 32 lanes x 4
constexpr int kVThreads = 256;        // 8 warps
constexpr int kFwdRows = 8;           // I: output rows per tile, one a warp
constexpr int kBwdRows = 6;           // J: output rows per tile
constexpr int kBwdPooled = kBwdRows + 2;   // J: pooled rows, one a warp
constexpr int kFwdStages = 3;         // I: x tiles in flight
constexpr int kBwdStages = 2;         // J: x (and g) tiles in flight
constexpr unsigned kFull = 0xffffffffu;

// A staged tile of an NHWC image in shared memory: rows of the tile's 128
// pixels and `HALO` pixels on each side; the interior starts kPad floats
// into a row, at a 16-byte boundary.
template <int C, int HALO>
struct Tile {
  static constexpr int kPad = 4 * ((HALO * C + 3) / 4);
  static constexpr int kPitch = 2 * kPad + kVW * C;
};

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage ROWS rows of the tile at (i0, j0) of the image `img` [H, W, C] into
// `dst`: tile row r holds image row i0 - HALO + r. The interior pixels j0 ..
// j0 + 127 that lie in the image go as chunks of 4 elements (W % 4 == 0, so
// a ragged tile ends on a whole chunk): in float32 16-byte cp.async copies;
// in bfloat16 8-byte loads widened to float32 and stored as a float4 (the
// tile stays float32 on chip, so everything past the staging is the
// float32 kernel's; the copy is synchronous). Then HALO pixels left of the interior
// and HALO pixels from q_r = min(128, W - j0) on, the first column past the
// tile's in-image part. Reflect-101 is applied to the source address of
// each row and of each halo pixel (row -1 <- 1, row H <- H - 2, column -1
// <- 1, column W <- W - 2; anything further out, which feeds only results
// that are never stored, is clamped into the image), so no interior element
// computes a reflection. Unstaged slots keep what they held.
template <int C, int HALO, int ROWS, typename Val>
__device__ __forceinline__ void stage_tile(float* dst,
                                           const Val* __restrict__ img,
                                           int i0, int j0, int H, int W) {
  using TL = Tile<C, HALO>;
  constexpr int kChunks = kVW * C / 4;       // chunks of an interior row
  const int qr = min(kVW, W - j0);
  const int chunks = qr * C / 4;
  for (int k = threadIdx.x; k < ROWS * kChunks; k += kVThreads) {
    const int r = k / kChunks, f = k - r * kChunks;
    if (f < chunks) {
      float* d = dst + r * TL::kPitch + TL::kPad + 4 * f;
      const Val* src =
          img + ((size_t)refl(i0 - HALO + r, H) * W + j0) * C + 4 * f;
      if constexpr (sizeof(Val) == 4) {
        cp_async16(d, src);
      } else {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(src));
        const float2 lo = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&v.x));
        const float2 hi = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&v.y));
        *reinterpret_cast<float4*>(d) = make_float4(lo.x, lo.y, hi.x, hi.y);
      }
    }
  }
  constexpr int kRing = 2 * HALO * C;        // halo elements of a row
  for (int k = threadIdx.x; k < ROWS * kRing; k += kVThreads) {
    const int r = k / kRing, e = k - r * kRing;
    const int side = e / (HALO * C), s = e - side * (HALO * C);
    const int qq = s / C, c = s - qq * C;
    const int q = side == 0 ? qq - HALO : qr + qq;
    float* d = dst + r * TL::kPitch + TL::kPad + q * C + c;
    const Val* src =
        img + ((size_t)refl(i0 - HALO + r, H) * W + refl(j0 + q, W)) * C + c;
    if constexpr (sizeof(Val) == 4)
      cp_async4(d, src);
    else
      *d = f32(*src);
  }
}

// E consecutive floats (E % 4 == 0) from a 16-byte aligned address
template <int E>
__device__ __forceinline__ void ld4(float (&out)[E], const float* src) {
#pragma unroll
  for (int f = 0; f < E / 4; ++f) {
    const float4 v = reinterpret_cast<const float4*>(src)[f];
    out[4 * f] = v.x, out[4 * f + 1] = v.y, out[4 * f + 2] = v.z,
    out[4 * f + 3] = v.w;
  }
}

template <int E>
__device__ __forceinline__ void ldg4(float (&out)[E], const float* src) {
#pragma unroll
  for (int f = 0; f < E / 4; ++f) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src) + f);
    out[4 * f] = v.x, out[4 * f + 1] = v.y, out[4 * f + 2] = v.z,
    out[4 * f + 3] = v.w;
  }
}

// the same from bfloat16 (8-byte aligned), widened
template <int E>
__device__ __forceinline__ void ldg4(float (&out)[E], const bf16* src) {
#pragma unroll
  for (int f = 0; f < E / 4; ++f) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(src) + f);
    const float2 lo =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.x));
    const float2 hi =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v.y));
    out[4 * f] = lo.x, out[4 * f + 1] = lo.y, out[4 * f + 2] = hi.x,
    out[4 * f + 3] = hi.y;
  }
}

template <int E>
__device__ __forceinline__ void st4(float* dst, const float (&v)[E]) {
#pragma unroll
  for (int f = 0; f < E / 4; ++f)
    reinterpret_cast<float4*>(dst)[f] =
        make_float4(v[4 * f], v[4 * f + 1], v[4 * f + 2], v[4 * f + 3]);
}

// the same into bfloat16 (8-byte aligned), each value rounded to nearest
template <int E>
__device__ __forceinline__ void st4(bf16* dst, const float (&v)[E]) {
#pragma unroll
  for (int f = 0; f < E / 4; ++f) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v[4 * f], v[4 * f + 1]);
    const __nv_bfloat162 hi =
        __floats2bfloat162_rn(v[4 * f + 2], v[4 * f + 3]);
    reinterpret_cast<uint2*>(dst)[f] =
        make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                   *reinterpret_cast<const unsigned*>(&hi));
  }
}

// H sums of x, x*x and x*y at E consecutive elements of the three staged
// rows (row pitch `pitch`) of x and y, read as float4s; with L1, also
// |y - x| on the middle row
template <int E, bool L1>
__device__ __forceinline__ void hsums4(const float* xt, const float* yt,
                                       int pitch, float (&hu)[E],
                                       float (&hv)[E], float (&hw)[E],
                                       float (&l1)[E]) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    float x[E], y[E];
    ld4<E>(x, xt + r * pitch);
    ld4<E>(y, yt + r * pitch);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const float xx = mul(x[e], x[e]), xy = mul(x[e], y[e]);
      if (r == 0) {
        hu[e] = x[e], hv[e] = xx, hw[e] = xy;
      } else if (r == 1) {
        hu[e] = add(hu[e], x[e]), hv[e] = add(hv[e], xx),
        hw[e] = add(hw[e], xy);
        if (L1) l1[e] = fabsf(sub(y[e], x[e]));
      } else {
        hu[e] = mul(add(hu[e], x[e]), kThird);
        hv[e] = mul(add(hv[e], xx), kThird);
        hw[e] = mul(add(hw[e], xy), kThird);
      }
    }
  }
}

// the same at one element of the three rows (a halo column)
__device__ __forceinline__ Pooled hsum1(const float* xt, const float* yt,
                                        int pitch) {
  const float a0 = xt[0], a1 = xt[pitch], a2 = xt[2 * pitch];
  const float b0 = yt[0], b1 = yt[pitch], b2 = yt[2 * pitch];
  return {tap3(a0, a1, a2), tap3(mul(a0, a0), mul(a1, a1), mul(a2, a2)),
          tap3(mul(a0, b0), mul(a1, b1), mul(a2, b2))};
}

// The W pass of channel c at a lane's 4 pixels from the H sums of its 4
// pixels (elements p * C + c) and of the columns beside them: the lanes
// left and right by shuffles, `edge` (the halo column's) at lanes 0 and 31.
template <int C>
__device__ __forceinline__ void wpool4(const float (&h)[4 * C], int c,
                                       float edge, int lane,
                                       float (&out)[4]) {
  float l = __shfl_up_sync(kFull, h[3 * C + c], 1);
  float r = __shfl_down_sync(kFull, h[c], 1);
  if (lane == 0) l = edge;
  if (lane == 31) r = edge;
#pragma unroll
  for (int p = 0; p < 4; ++p)
    out[p] = tap3(p == 0 ? l : h[(p - 1) * C + c], h[p * C + c],
                  p == 3 ? r : h[(p + 1) * C + c]);
}

constexpr int fwd_vec_smem_floats(int C) {
  return (1 + kFwdStages) * (kFwdRows + 2) *
         (2 * (4 * ((C + 3) / 4)) + kVW * C);
}

template <int C, typename Val>
__global__ void __launch_bounds__(kVThreads, 2)
photo_loss_fwd_vec_kernel(const Val* __restrict__ pred,
                          const Val* __restrict__ target,
                          const Val* __restrict__ muy,
                          const Val* __restrict__ sy,
                          Val* __restrict__ loss, int B, int R, int H,
                          int W, float w_ssim, float w_l1, float inv_c) {
  using T = Tile<C, 1>;
  constexpr int kRows = kFwdRows + 2, kSize = kRows * T::kPitch;
  constexpr int E = 4 * C;                  // a lane's 4 pixels x C
  extern __shared__ float4 smem4[];
  float* ys = reinterpret_cast<float*>(smem4);
  float* xs = ys + kSize;                   // kFwdStages tiles
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kFwdRows, j0 = blockIdx.x * kVW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i = i0 + warp, j = j0 + 4 * lane;
  const bool row_live = i < H;              // warp-uniform
  const bool live = row_live && j < W;
  const size_t plane = (size_t)H * W * C;

  stage_tile<C, 1, kRows, Val>(ys, target + b * plane, i0, j0, H, W);
  stage_tile<C, 1, kRows, Val>(xs, pred + b * plane, i0, j0, H, W);
  cp_async_commit();
  if (R > 1)
    stage_tile<C, 1, kRows, Val>(xs + kSize, pred + (size_t)(b + B) * plane,
                                 i0, j0, H, W);
  cp_async_commit();
  float my[E], s_y[E];
  if (live) {
    const size_t at = b * plane + ((size_t)i * W + j) * C;
    ldg4<E>(my, muy + at);
    ldg4<E>(s_y, sy + at);
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) my[e] = s_y[e] = 0.f;
  }
  // the halo column of lanes 0 and 31 (every lane pools one, the rest at
  // column 128 without using it, so the warp never diverges)
  const int qh = lane == 0 ? -1 : kVW;

  for (int k = 0; k < R; ++k) {
    cp_async_wait<1>();
    __syncthreads();          // tile k staged; tile k - 1 read by all
    if (k + 2 < R)
      stage_tile<C, 1, kRows, Val>(xs + ((k + 2) % kFwdStages) * kSize,
                                   pred + (size_t)(b + (k + 2) * B) * plane,
                                   i0, j0, H, W);
    cp_async_commit();
    if (!row_live) continue;
    // image rows i - 1 .. i + 1 are tile rows warp .. warp + 2
    const float* xt =
        xs + (k % kFwdStages) * kSize + warp * T::kPitch + T::kPad;
    const float* yt = ys + warp * T::kPitch + T::kPad;
    float hu[E], hv[E], hw[E], l1[E];
    hsums4<E, true>(xt + 4 * lane * C, yt + 4 * lane * C, T::kPitch, hu, hv,
                    hw, l1);
    float dsum[4], lsum[4];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const Pooled h = hsum1(xt + qh * C + c, yt + qh * C + c, T::kPitch);
      float u[4], v[4], w[4];
      wpool4<C>(hu, c, h.u, lane, u);
      wpool4<C>(hv, c, h.v, lane, v);
      wpool4<C>(hw, c, h.w, lane, w);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int e = p * C + c;
        const Ssim t = ssim_terms({u[p], v[p], w[p]}, my[e], s_y[e]);
        const float dis = fminf(fmaxf(t.val, 0.f), 1.f);
        dsum[p] = c == 0 ? dis : add(dsum[p], dis);
        lsum[p] = c == 0 ? l1[e] : add(lsum[p], l1[e]);
      }
    }
    if (live) {
      float out[4];
#pragma unroll
      for (int p = 0; p < 4; ++p)
        out[p] = add(mul(w_ssim, mul(dsum[p], inv_c)),
                     mul(w_l1, mul(lsum[p], inv_c)));
      st4<4>(loss + ((size_t)(b + k * B) * H + i) * W + j, out);
    }
  }
}

// J's partials where the pooled position lies in the image, else 0: a
// select, never a product, so stale shared memory cannot reach a result
__device__ __forceinline__ void partials_in(const Pooled& p, float my,
                                            float s_y, float g, float k_ssim,
                                            bool in, float& au, float& av,
                                            float& aw) {
  partials(p, my, s_y, g, k_ssim, au, av, aw);
  au = in ? au : 0.f, av = in ? av : 0.f, aw = in ? aw : 0.f;
}

// adj3 with its reflected taps as multiply-adds by lo = (p == 1) and hi =
// (p == n - 2), each 0 or 1: fma(1, a, s) rounds s + a once and fma(0, a,
// s) is s for a finite a, so the sums are adj3's, in its order, without a
// compare per tap
__device__ __forceinline__ float adj3f(float a_m1, float a_0, float a_p1,
                                       float lo, float hi) {
  const float s = add(add(a_m1, a_0), a_p1);
  return mul(__fmaf_rn(hi, a_p1, __fmaf_rn(lo, a_m1, s)), kThird);
}

// The W adjoint at a lane's 4 pixels from the partials there, the lanes
// beside by shuffles and `ring` (the ring column's, 0 outside the image) at
// lanes 0 and 31; lo, hi the reflected taps' factors of the 4 columns
__device__ __forceinline__ float4 wadj4(const float (&a)[4], float ring,
                                        int lane, const float (&lo)[4],
                                        const float (&hi)[4]) {
  float l = __shfl_up_sync(kFull, a[3], 1);
  float r = __shfl_down_sync(kFull, a[0], 1);
  if (lane == 0) l = ring;
  if (lane == 31) r = ring;
  return make_float4(adj3f(l, a[0], a[1], lo[0], hi[0]),
                     adj3f(a[0], a[1], a[2], lo[1], hi[1]),
                     adj3f(a[1], a[2], a[3], lo[2], hi[2]),
                     adj3f(a[2], a[3], r, lo[3], hi[3]));
}

constexpr int bwd_vec_smem_floats(int C) {
  return (1 + kBwdStages) * (kBwdRows + 4) *
             (2 * (4 * ((2 * C + 3) / 4)) + kVW * C) +
         kBwdStages * kBwdPooled * (2 * 4 + kVW) +
         3 * C * kBwdPooled * kVW;
}

template <int C, typename Val>
__global__ void __launch_bounds__(kVThreads, 2)
photo_loss_bwd_vec_kernel(const Val* __restrict__ pred,
                          const Val* __restrict__ target,
                          const Val* __restrict__ muy,
                          const Val* __restrict__ sy,
                          const Val* __restrict__ g,
                          Val* __restrict__ dpred, int B, int R, int H,
                          int W, float k_ssim, float k_l1) {
  using T = Tile<C, 2>;                     // x, y: 2-pixel halo
  using TG = Tile<1, 1>;                    // g: the 1-pixel ring
  constexpr int kX = (kBwdRows + 4) * T::kPitch;
  constexpr int kG = kBwdPooled * TG::kPitch;
  constexpr int kB = kBwdPooled * kVW;      // one plane of W adjoints
  constexpr int E = 4 * C;
  extern __shared__ float4 smem4[];
  float* ys = reinterpret_cast<float*>(smem4);
  float* xs = ys + kX;                      // kBwdStages x tiles
  float* gs = xs + kBwdStages * kX;         // kBwdStages g tiles
  float* bs = gs + kBwdStages * kG;         // W adjoints [u,v,w][c][row][px]
  const int b = blockIdx.z;
  const int i0 = blockIdx.y * kBwdRows, j0 = blockIdx.x * kVW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int pi = i0 - 1 + warp;             // this warp's pooled row
  const bool prow = pi >= 0 && pi < H;      // warp-uniform
  const int j = j0 + 4 * lane;
  // the ring column q1 of lanes 0 and 31 and the halo column q2 beyond it
  // (every lane computes them, the rest at columns 128, 129 without using
  // them, so the warp never diverges)
  const int q1 = lane == 0 ? -1 : kVW, q2 = lane == 0 ? -2 : kVW + 1;
  const bool ring_in = (lane == 0 && j0 > 0) || (lane == 31 && j0 + kVW < W);
  const size_t plane = (size_t)H * W * C, gplane = (size_t)H * W;
  // the reflected taps of the W adjoint at the lane's 4 columns
  float lo[4], hi[4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
    lo[p] = j + p == 1 ? 1.f : 0.f, hi[p] = j + p == W - 2 ? 1.f : 0.f;

  stage_tile<C, 2, kBwdRows + 4, Val>(ys, target + b * plane, i0, j0, H, W);
  stage_tile<C, 2, kBwdRows + 4, Val>(xs, pred + b * plane, i0, j0, H, W);
  stage_tile<1, 1, kBwdPooled, Val>(gs, g + b * gplane, i0, j0, H, W);
  cp_async_commit();
  float my[E], s_y[E], myr[C], syr[C];
#pragma unroll
  for (int e = 0; e < E; ++e) my[e] = s_y[e] = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) myr[c] = syr[c] = 0.f;
  if (prow) {
    const size_t row = b * plane + (size_t)pi * W * C;
    if (j < W) {
      ldg4<E>(my, muy + row + (size_t)j * C);
      ldg4<E>(s_y, sy + row + (size_t)j * C);
    }
    if (ring_in) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        myr[c] = f32(__ldg(muy + row + (size_t)(j0 + q1) * C + c));
        syr[c] = f32(__ldg(sy + row + (size_t)(j0 + q1) * C + c));
      }
    }
  }

  for (int k = 0; k < R; ++k) {
    const int n = b + k * B;
    if (k + 1 < R) {
      const int s = (k + 1) % kBwdStages;
      stage_tile<C, 2, kBwdRows + 4, Val>(
          xs + s * kX, pred + (size_t)(n + B) * plane, i0, j0, H, W);
      stage_tile<1, 1, kBwdPooled, Val>(
          gs + s * kG, g + (size_t)(n + B) * gplane, i0, j0, H, W);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();          // the tiles of prediction k staged
    const float* xk = xs + (k % kBwdStages) * kX;
    const float* gk = gs + (k % kBwdStages) * kG;

    // phase 1: warp `warp` at pooled row pi (x rows pi - 1 .. pi + 1 are
    // tile rows warp .. warp + 2): the partials at its 4 pixels and the
    // ring column, then the W adjoint at its 4 pixels into bs
    float* brow = bs + warp * kVW + 4 * lane;
    if (prow) {
      const float* xt = xk + warp * T::kPitch + T::kPad;
      const float* yt = ys + warp * T::kPitch + T::kPad;
      const float* gt = gk + warp * TG::kPitch + TG::kPad;
      float hu[E], hv[E], hw[E], unused[E];
      hsums4<E, false>(xt + 4 * lane * C, yt + 4 * lane * C, T::kPitch, hu,
                       hv, hw, unused);
      float gv[4];
      ld4<4>(gv, gt + 4 * lane);
      const float gr = gt[q1];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const Pooled h1 = hsum1(xt + q1 * C + c, yt + q1 * C + c, T::kPitch);
        const Pooled h2 = hsum1(xt + q2 * C + c, yt + q2 * C + c, T::kPitch);
        float u[4], v[4], w[4];
        wpool4<C>(hu, c, h1.u, lane, u);
        wpool4<C>(hv, c, h1.v, lane, v);
        wpool4<C>(hw, c, h1.w, lane, w);
        float au[4], av[4], aw[4], ru, rv, rw;
#pragma unroll
        for (int p = 0; p < 4; ++p)
          partials_in({u[p], v[p], w[p]}, my[p * C + c], s_y[p * C + c],
                      gv[p], k_ssim, j + p < W, au[p], av[p], aw[p]);
        {
          // the ring column: lane 0 pools tile columns -2, -1, 0, lane 31
          // columns 127, 128, 129
          const bool l0 = lane == 0;
          const int e0 = c, e3 = 3 * C + c;
          const Pooled q = {
              tap3(l0 ? h2.u : hu[e3], h1.u, l0 ? hu[e0] : h2.u),
              tap3(l0 ? h2.v : hv[e3], h1.v, l0 ? hv[e0] : h2.v),
              tap3(l0 ? h2.w : hw[e3], h1.w, l0 ? hw[e0] : h2.w)};
          partials_in(q, myr[c], syr[c], gr, k_ssim, ring_in, ru, rv, rw);
        }
        *reinterpret_cast<float4*>(brow + c * kB) =
            wadj4(au, ru, lane, lo, hi);
        *reinterpret_cast<float4*>(brow + (C + c) * kB) =
            wadj4(av, rv, lane, lo, hi);
        *reinterpret_cast<float4*>(brow + (2 * C + c) * kB) =
            wadj4(aw, rw, lane, lo, hi);
      }
    } else {
#pragma unroll
      for (int qc = 0; qc < 3 * C; ++qc)
        *reinterpret_cast<float4*>(brow + qc * kB) =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();          // bs complete

    // phase 2 (threads 0 .. 191): the H adjoint and the cotangent at output
    // row i0 + o, pixels j0 + 4l .. + 3; pooled rows i - 1 .. i + 1 are bs
    // rows o .. o + 2
    if (threadIdx.x < kBwdRows * 32) {
      const int o = threadIdx.x / 32, l = threadIdx.x % 32;
      const int i = i0 + o, jo = j0 + 4 * l;
      if (i < H && jo < W) {
        const float rlo = i == 1 ? 1.f : 0.f, rhi = i == H - 2 ? 1.f : 0.f;
        float xc[E], yc[E], gv[4], out[E];
        ld4<E>(xc, xk + (o + 2) * T::kPitch + T::kPad + 4 * l * C);
        ld4<E>(yc, ys + (o + 2) * T::kPitch + T::kPad + 4 * l * C);
        ld4<4>(gv, gk + (o + 1) * TG::kPitch + TG::kPad + 4 * l);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float h[3][4];
#pragma unroll
          for (int qn = 0; qn < 3; ++qn) {
            const float* col = bs + (qn * C + c) * kB + o * kVW + 4 * l;
            float b0[4], b1[4], b2[4];
            ld4<4>(b0, col);
            ld4<4>(b1, col + kVW);
            ld4<4>(b2, col + 2 * kVW);
#pragma unroll
            for (int p = 0; p < 4; ++p)
              h[qn][p] = adj3f(b0[p], b1[p], b2[p], rlo, rhi);
          }
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int e = p * C + c;
            const float dl1 =
                mul(mul(gv[p], k_l1), sub(yc[e], xc[e]) >= 0.f ? -1.f : 1.f);
            out[e] = add(add(add(h[0][p], mul(mul(2.f, xc[e]), h[1][p])),
                             mul(yc[e], h[2][p])),
                         dl1);
          }
        }
        st4<E>(dpred + ((size_t)n * H + i) * W * C + (size_t)jo * C, out);
      }
    }
    __syncthreads();          // bs and the tiles of prediction k read by all
  }
}

template <int C, typename Val>
int launch_fwd_vec(const Val* pred, const Val* target, const Val* muy,
                   const Val* sy, Val* loss, int N, int B, int H, int W,
                   float w_ssim, float w_l1, float inv_c,
                   cudaStream_t stream) {
  const int smem = fwd_vec_smem_floats(C) * (int)sizeof(float);
  static unsigned smem_set = 0;
  const cudaError_t err =
      allow_smem(photo_loss_fwd_vec_kernel<C, Val>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((W + kVW - 1) / kVW),
                  (unsigned)((H + kFwdRows - 1) / kFwdRows), (unsigned)B);
  photo_loss_fwd_vec_kernel<C, Val><<<grid, kVThreads, smem, stream>>>(
      pred, target, muy, sy, loss, B, N / B, H, W, w_ssim, w_l1, inv_c);
  return (int)cudaGetLastError();
}

template <int C, typename Val>
int launch_bwd_vec(const Val* pred, const Val* target, const Val* muy,
                   const Val* sy, const Val* g, Val* dpred, int N, int B,
                   int H, int W, float k_ssim, float k_l1,
                   cudaStream_t stream) {
  const int smem = bwd_vec_smem_floats(C) * (int)sizeof(float);
  static unsigned smem_set = 0;
  const cudaError_t err =
      allow_smem(photo_loss_bwd_vec_kernel<C, Val>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((W + kVW - 1) / kVW),
                  (unsigned)((H + kBwdRows - 1) / kBwdRows), (unsigned)B);
  photo_loss_bwd_vec_kernel<C, Val><<<grid, kVThreads, smem, stream>>>(
      pred, target, muy, sy, g, dpred, B, N / B, H, W, k_ssim, k_l1);
  return (int)cudaGetLastError();
}

// the dynamic shared memory (bytes) and resident blocks per SM of the
// vector route's forward or cotangent at C channels (the staged tiles are
// float32 whatever the element type)
template <int C, typename Val>
cudaError_t vec_occupancy(bool bwd, int* blocks, int* smem) {
  *smem = (bwd ? bwd_vec_smem_floats(C) : fwd_vec_smem_floats(C)) *
          (int)sizeof(float);
  static unsigned fwd_set = 0, bwd_set = 0;
  const cudaError_t err =
      bwd ? allow_smem(photo_loss_bwd_vec_kernel<C, Val>, *smem, bwd_set)
          : allow_smem(photo_loss_fwd_vec_kernel<C, Val>, *smem, fwd_set);
  if (err != cudaSuccess) return err;
  return bwd ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks, photo_loss_bwd_vec_kernel<C, Val>, kVThreads,
                   *smem)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   blocks, photo_loss_fwd_vec_kernel<C, Val>, kVThreads,
                   *smem);
}

// the vector route's shapes and pointers: tile rows `rows`
bool bad_vec(int N, int B, int H, int W, int C, int rows,
             std::initializer_list<const void*> ptrs) {
  if (N <= 0 || B <= 0 || N % B != 0 || B > 65535 || H < 2 || W < 4 ||
      W % 4 != 0 || C < 1 || C > 4 || (H + rows - 1) / rows > 65535)
    return true;
  for (const void* p : ptrs)
    if (!aligned16(p)) return true;
  return false;
}

bool bad_dims(int N, int B, int H, int W, int C) {
  return N <= 0 || B <= 0 || N % B != 0 || N > 65535 || H < 2 || W < 2 ||
         C < 1;
}

dim3 tiles(int N, int H, int W) {
  return dim3((unsigned)((W + kTW - 1) / kTW), (unsigned)((H + kTH - 1) / kTH),
              (unsigned)N);
}


template <typename Val>
int fwd_narrow(const void* pred, const void* target, const void* muy,
               const void* sy, void* loss, int N, int B, int H, int W, int C,
               float w_ssim, float w_l1, float inv_c, void* stream) {
  if (bad_dims(N, B, H, W, C) || (H + kTH - 1) / kTH > 65535)
    return (int)cudaErrorInvalidValue;
  photo_loss_fwd_kernel<Val><<<tiles(N, H, W), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Val*>(pred), static_cast<const Val*>(target),
      static_cast<const Val*>(muy), static_cast<const Val*>(sy),
      static_cast<Val*>(loss), B, H, W, C, w_ssim, w_l1, inv_c);
  return (int)cudaGetLastError();
}

template <typename Val>
int bwd_narrow(const void* pred, const void* target, const void* muy,
               const void* sy, const void* g, void* dpred, int N, int B,
               int H, int W, int C, float k_ssim, float k_l1, void* stream) {
  if (bad_dims(N, B, H, W, C) || (H + kTH - 1) / kTH > 65535)
    return (int)cudaErrorInvalidValue;
  photo_loss_bwd_kernel<Val><<<tiles(N, H, W), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Val*>(pred), static_cast<const Val*>(target),
      static_cast<const Val*>(muy), static_cast<const Val*>(sy),
      static_cast<const Val*>(g), static_cast<Val*>(dpred), B, H, W, C,
      k_ssim, k_l1);
  return (int)cudaGetLastError();
}

template <typename Val>
int fwd_vec(const void* pred, const void* target, const void* muy,
            const void* sy, void* loss, int N, int B, int H, int W, int C,
            float w_ssim, float w_l1, float inv_c, void* stream) {
  if (bad_vec(N, B, H, W, C, kFwdRows, {pred, target, muy, sy, loss}))
    return (int)cudaErrorInvalidValue;
  const auto* x = static_cast<const Val*>(pred);
  const auto* y = static_cast<const Val*>(target);
  const auto* m = static_cast<const Val*>(muy);
  const auto* s = static_cast<const Val*>(sy);
  auto* out = static_cast<Val*>(loss);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1:
      return launch_fwd_vec<1>(x, y, m, s, out, N, B, H, W, w_ssim, w_l1,
                               inv_c, st);
    case 2:
      return launch_fwd_vec<2>(x, y, m, s, out, N, B, H, W, w_ssim, w_l1,
                               inv_c, st);
    case 3:
      return launch_fwd_vec<3>(x, y, m, s, out, N, B, H, W, w_ssim, w_l1,
                               inv_c, st);
    default:
      return launch_fwd_vec<4>(x, y, m, s, out, N, B, H, W, w_ssim, w_l1,
                               inv_c, st);
  }
}

template <typename Val>
int bwd_vec(const void* pred, const void* target, const void* muy,
            const void* sy, const void* g, void* dpred, int N, int B, int H,
            int W, int C, float k_ssim, float k_l1, void* stream) {
  if (bad_vec(N, B, H, W, C, kBwdRows, {pred, target, muy, sy, g, dpred}))
    return (int)cudaErrorInvalidValue;
  const auto* x = static_cast<const Val*>(pred);
  const auto* y = static_cast<const Val*>(target);
  const auto* m = static_cast<const Val*>(muy);
  const auto* s = static_cast<const Val*>(sy);
  const auto* gg = static_cast<const Val*>(g);
  auto* out = static_cast<Val*>(dpred);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1:
      return launch_bwd_vec<1>(x, y, m, s, gg, out, N, B, H, W, k_ssim,
                               k_l1, st);
    case 2:
      return launch_bwd_vec<2>(x, y, m, s, gg, out, N, B, H, W, k_ssim,
                               k_l1, st);
    case 3:
      return launch_bwd_vec<3>(x, y, m, s, gg, out, N, B, H, W, k_ssim,
                               k_l1, st);
    default:
      return launch_bwd_vec<4>(x, y, m, s, gg, out, N, B, H, W, k_ssim,
                               k_l1, st);
  }
}

template <typename Val>
int occupancy(int bwd, int C, int* smem) {
  int blocks = 0;
  const cudaError_t err =
      C == 1   ? vec_occupancy<1, Val>(bwd != 0, &blocks, smem)
      : C == 2 ? vec_occupancy<2, Val>(bwd != 0, &blocks, smem)
      : C == 3 ? vec_occupancy<3, Val>(bwd != 0, &blocks, smem)
      : C == 4 ? vec_occupancy<4, Val>(bwd != 0, &blocks, smem)
               : cudaErrorInvalidValue;
  return err == cudaSuccess ? blocks : -(int)err;
}

}  // namespace

// Forward. pred [N,H,W,C], target/muy/sy [B,H,W,C]; writes loss [N,H,W];
// all of one dtype, float32 (dtype 0) or bfloat16 (dtype 1). All
// contiguous. Launches on `stream` and returns cudaGetLastError() (0 on
// success); never synchronises.
extern "C" int fsnet_photo_loss_fwd(const void* pred, const void* target,
                                    const void* muy, const void* sy,
                                    void* loss, int N, int B, int H, int W,
                                    int C, float w_ssim, float w_l1,
                                    float inv_c, int dtype, void* stream) {
  auto* fn = dtype == 0 ? fwd_narrow<float>
             : dtype == 1 ? fwd_narrow<bf16>
                          : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(pred, target, muy, sy, loss, N, B, H, W, C, w_ssim, w_l1, inv_c,
            stream);
}

// Prediction cotangent. pred [N,H,W,C], target/muy/sy [B,H,W,C], g [N,H,W];
// writes dpred [N,H,W,C]; all of one dtype (as the forward's). All
// contiguous. Launches on `stream` and returns cudaGetLastError(); never
// synchronises.
extern "C" int fsnet_photo_loss_bwd(const void* pred, const void* target,
                                    const void* muy, const void* sy,
                                    const void* g, void* dpred, int N, int B,
                                    int H, int W, int C, float k_ssim,
                                    float k_l1, int dtype, void* stream) {
  auto* fn = dtype == 0 ? bwd_narrow<float>
             : dtype == 1 ? bwd_narrow<bf16>
                          : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(pred, target, muy, sy, g, dpred, N, B, H, W, C, k_ssim, k_l1,
            stream);
}

// The vector route's forward: as fsnet_photo_loss_fwd, for C <= 4, W % 4 ==
// 0 and every pointer 16-byte aligned; anything else is refused with
// cudaErrorInvalidValue.
extern "C" int fsnet_photo_loss_fwd_vec(const void* pred, const void* target,
                                        const void* muy, const void* sy,
                                        void* loss, int N, int B, int H,
                                        int W, int C, float w_ssim,
                                        float w_l1, float inv_c, int dtype,
                                        void* stream) {
  auto* fn = dtype == 0 ? fwd_vec<float> : dtype == 1 ? fwd_vec<bf16>
                                                      : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(pred, target, muy, sy, loss, N, B, H, W, C, w_ssim, w_l1, inv_c,
            stream);
}

// The vector route's prediction cotangent: as fsnet_photo_loss_bwd, for C
// <= 4, W % 4 == 0 and every pointer 16-byte aligned; anything else is
// refused with cudaErrorInvalidValue.
extern "C" int fsnet_photo_loss_bwd_vec(const void* pred, const void* target,
                                        const void* muy, const void* sy,
                                        const void* g, void* dpred, int N,
                                        int B, int H, int W, int C,
                                        float k_ssim, float k_l1, int dtype,
                                        void* stream) {
  auto* fn = dtype == 0 ? bwd_vec<float> : dtype == 1 ? bwd_vec<bf16>
                                                      : nullptr;
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return fn(pred, target, muy, sy, g, dpred, N, B, H, W, C, k_ssim, k_l1,
            stream);
}

// The occupancy of the vector route's forward (bwd = 0) or cotangent (bwd =
// 1) at C <= 4 channels and `dtype` (as the entries'), for reports: writes
// its dynamic shared memory per block (bytes) to `smem` and returns its
// resident blocks per SM, or minus a CUDA error code.
extern "C" int fsnet_photo_loss_vec_occupancy(int bwd, int C, int dtype,
                                              int* smem) {
  return dtype == 0   ? occupancy<float>(bwd, C, smem)
         : dtype == 1 ? occupancy<bf16>(bwd, C, smem)
                      : -(int)cudaErrorInvalidValue;
}
