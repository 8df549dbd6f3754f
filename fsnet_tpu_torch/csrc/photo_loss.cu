// Photometric loss for Hopper (sm_90a), bound through a plain C interface
// (ctypes): the forward and the prediction cotangent of
// fsnet_tpu_torch.ops.photo_loss.reprojection_loss_fused.
//
// Layouts: pred [N, H, W, C], target, muy, sy [B, H, W, C] (NHWC f32, N a
// multiple of B), loss and g [N, H, W] f32, dpred [N, H, W, C] f32.
// Prediction n compares with target n mod B: the target and its pooled
// stats (muy, sy = ops.ssim.ssim_target_stats(target)) are never tiled.
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
// photo_loss_fwd_kernel replaces fsnet_tpu/ops/pallas/photo_kernel.py
// photo_loss_pallas (_fwd_kernel). One thread per output pixel (all C
// channels), one block per 8 x 32 pixel tile of one prediction; per channel
// the block stages x and y (at n mod B) with a 1-pixel halo, reflected at
// the image edge, in shared memory, and each thread pools its 3x3 window
// from there. The H-pass sums are recomputed by the three threads that
// share them rather than staged: about 80 operations per pixel-channel.
// What bounds it on an H100: bytes (pred, target and the two stats read,
// the loss written; ~20 operations per byte would be needed to be bound by
// operations at the float32 peak).
//
// photo_loss_bwd_kernel replaces photo_kernel.py photo_loss_bwd_pallas
// (_bwd_kernel). Same tiles; per channel the block stages x and y with a
// 2-pixel halo, computes the three partials G dr/du, G dr/dv, G dr/dw at the
// tile's pooled positions plus a 1-pixel ring (0 outside the image) into
// shared memory, from the target stats the forward used, and then each
// thread gathers P^T of them at its pixel. No atomics: deterministic. Bound
// by bytes (pred, target, stats and g read, dpred written).
#include <cuda_runtime.h>

#include <cstddef>

namespace {

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
__device__ __forceinline__ void stage(float* xs, float* ys, int rows, int cols,
                                      const float* __restrict__ xb,
                                      const float* __restrict__ yb, int i0,
                                      int j0, int halo, int H, int W, int C,
                                      int c) {
  for (int k = threadIdx.x; k < rows * cols; k += kThreads) {
    const int r = k / cols, q = k - r * cols;
    const size_t off =
        ((size_t)refl(i0 - halo + r, H) * W + refl(j0 - halo + q, W)) * C + c;
    xs[k] = xb[off];
    ys[k] = yb[off];
  }
}

__global__ void __launch_bounds__(kThreads)
photo_loss_fwd_kernel(const float* __restrict__ pred,
                      const float* __restrict__ target,
                      const float* __restrict__ muy,
                      const float* __restrict__ sy, float* __restrict__ loss,
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
  const float* xb = pred + (size_t)n * plane;
  const float* yb = target + (size_t)b * plane;
  const size_t pix = ((size_t)i * W + j) * C;
  float dsum = 0.f, lsum = 0.f;
  for (int c = 0; c < C; ++c) {
    stage(xs, ys, R, Q, xb, yb, i0, j0, 1, H, W, C, c);
    __syncthreads();
    if (live) {
      const Pooled p = pool3(xs, ys, Q, ty, tx);
      const size_t at = (size_t)b * plane + pix + c;
      const Ssim t = ssim_terms(p, muy[at], sy[at]);
      const float dis = fminf(fmaxf(t.val, 0.f), 1.f);
      const float l1 =
          fabsf(sub(ys[(ty + 1) * Q + tx + 1], xs[(ty + 1) * Q + tx + 1]));
      dsum = c == 0 ? dis : add(dsum, dis);
      lsum = c == 0 ? l1 : add(lsum, l1);
    }
    __syncthreads();
  }
  if (live)
    loss[((size_t)n * H + i) * W + j] =
        add(mul(w_ssim, mul(dsum, inv_c)), mul(w_l1, mul(lsum, inv_c)));
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

__global__ void __launch_bounds__(kThreads)
photo_loss_bwd_kernel(const float* __restrict__ pred,
                      const float* __restrict__ target,
                      const float* __restrict__ muy,
                      const float* __restrict__ sy,
                      const float* __restrict__ g, float* __restrict__ dpred,
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
  const float* xb = pred + (size_t)n * plane;
  const float* yb = target + (size_t)b * plane;
  const float* gn = g + (size_t)n * H * W;
  for (int c = 0; c < C; ++c) {
    stage(xs, ys, XR, XQ, xb, yb, i0, j0, 2, H, W, C, c);
    __syncthreads();
    // the partials at pooled positions (i0 - 1 + pr, j0 - 1 + pq)
    for (int k = threadIdx.x; k < PR * PQ; k += kThreads) {
      const int pr = k / PQ, pq = k - pr * PQ;
      const int pi = i0 - 1 + pr, pj = j0 - 1 + pq;
      float a_u = 0.f, a_v = 0.f, a_w = 0.f;
      if (pi >= 0 && pi < H && pj >= 0 && pj < W) {
        const Pooled p = pool3(xs, ys, XQ, pr, pq);
        const size_t at = (size_t)b * plane + ((size_t)pi * W + pj) * C + c;
        const float my = muy[at];
        const Ssim t = ssim_terms(p, my, sy[at]);
        const float gmax = t.sx_raw > 0.f ? 1.f : (t.sx_raw == 0.f ? 0.5f : 0.f);
        const float gclip = (t.val > 0.f && t.val < 1.f)
                                ? 1.f
                                : ((t.val == 0.f || t.val == 1.f) ? 0.5f : 0.f);
        const float G = mul(mul(gn[(size_t)pi * W + pj], k_ssim), gclip);
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
      const float dl1 = mul(mul(gn[(size_t)i * W + j], k_l1),
                            sub(yc, xc) >= 0.f ? -1.f : 1.f);
      dpred[(size_t)n * plane + ((size_t)i * W + j) * C + c] =
          add(add(add(hu, mul(mul(2.f, xc), hv)), mul(yc, hw)), dl1);
    }
    __syncthreads();
  }
}

bool bad_dims(int N, int B, int H, int W, int C) {
  return N <= 0 || B <= 0 || N % B != 0 || N > 65535 || H < 2 || W < 2 ||
         C < 1;
}

dim3 tiles(int N, int H, int W) {
  return dim3((unsigned)((W + kTW - 1) / kTW), (unsigned)((H + kTH - 1) / kTH),
              (unsigned)N);
}

}  // namespace

// Forward. pred [N,H,W,C], target/muy/sy [B,H,W,C] f32; writes loss
// [N,H,W] f32. All contiguous. Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int fsnet_photo_loss_fwd(const void* pred, const void* target,
                                    const void* muy, const void* sy,
                                    void* loss, int N, int B, int H, int W,
                                    int C, float w_ssim, float w_l1,
                                    float inv_c, void* stream) {
  if (bad_dims(N, B, H, W, C) || (H + kTH - 1) / kTH > 65535)
    return (int)cudaErrorInvalidValue;
  photo_loss_fwd_kernel<<<tiles(N, H, W), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pred), static_cast<const float*>(target),
      static_cast<const float*>(muy), static_cast<const float*>(sy),
      static_cast<float*>(loss), B, H, W, C, w_ssim, w_l1, inv_c);
  return (int)cudaGetLastError();
}

// Prediction cotangent. pred [N,H,W,C], target/muy/sy [B,H,W,C], g [N,H,W]
// f32; writes dpred [N,H,W,C] f32. All contiguous. Launches on `stream` and
// returns cudaGetLastError(); never synchronises.
extern "C" int fsnet_photo_loss_bwd(const void* pred, const void* target,
                                    const void* muy, const void* sy,
                                    const void* g, void* dpred, int N, int B,
                                    int H, int W, int C, float k_ssim,
                                    float k_l1, void* stream) {
  if (bad_dims(N, B, H, W, C) || (H + kTH - 1) / kTH > 65535)
    return (int)cudaErrorInvalidValue;
  photo_loss_bwd_kernel<<<tiles(N, H, W), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pred), static_cast<const float*>(target),
      static_cast<const float*>(muy), static_cast<const float*>(sy),
      static_cast<const float*>(g), static_cast<float*>(dpred), B, H, W, C,
      k_ssim, k_l1);
  return (int)cudaGetLastError();
}
