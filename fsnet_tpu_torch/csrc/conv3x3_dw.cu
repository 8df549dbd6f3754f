// Weight cotangent of the 3x3 stride-1 "same" convolution on NHWC tensors
// with one or two input parts, for Hopper (sm_90a), as a split-K GEMM on the
// tensor cores, bound through a plain C interface (ctypes):
//
//   dW[dy,dx,ci,co] = sum_{b,h,w} pad(x)[b,h+dy,w+dx,ci] * g[b,h,w,co]
//
// with pad = zeros or replicate, as in the forward (csrc/conv3x3.cu); a
// two-part input is the channel concat of its parts, never materialised.
//
// Replaces: fsnet_tpu/ops/pallas/conv_kernel.py conv3x3_fused_dw (:351,
// with the fold_dw of its banded-matrix accumulators). On the TPU one kernel
// walks a sequential grid and carries the sum in VMEM; blocks on Hopper run
// in parallel, so the pixel reduction is split over blocks.
//
// What bounds it on an H100: 2*9*Cin*Co operations per pixel against one
// read of x and g, so operations at the decoder's shapes; in float32 the
// products run as 3xTF32 on the tensor cores (csrc/mma_tf32.cuh), 3 x ops at
// 495 TFLOP/s. The operands may instead be bfloat16 (the bf16 train step,
// TPU conv3x3_fused_dw on bf16 operands): a bfloat16 value is exact in
// TF32, so each product is one exact MMA, summed as the float32 form sums;
// the cotangent is float32 either way. The decoder's two regimes are far apart: 16->16 over 1.47 M
// pixels (a tiny output, a huge reduction) and 512->256 over 1,440 (1.18 M
// weights, a short reduction).
//
// Design: the GEMM M = 9 taps x CI_T input channels of one channel tile,
// N = CO_T output channels (CI_T, CO_T = 16 or 32, chosen per shape from
// the host for the fewest padded channels; a channel tile never straddles
// the two parts), K = pixels, taken as 64-pixel tiles (TH x TW, TW = 8, 16
// or 32 by the least padded area). A block owns one channel tile and a
// strided share of the pixel tiles; the share (the split over pixels) is
// sized from the grid per shape, so that channel tiles x split fills one
// wave of resident blocks: 264 blocks of one channel tile at 16->16, 2 per
// channel tile at 512->256. Per pixel tile the block stages the (TH+2) x
// (TW+2) x CI_T input halo (padding applied at load) and the TH x TW x CO_T
// cotangent tile through a ring of NS = 3 stages filled with 16-byte
// cp.async copies along channels (4 float32 or 8 bfloat16 channels a copy,
// so the channel counts must be multiples of 4 or of 8, else the copies
// are one element each), so the next tiles' copies overlap this tile's
// MMAs. Neither operand is K-major in NHWC: the mma.sync.m16n8k8
// fragments are gathered from shared memory (A[ci][pixel] from the halo,
// B[pixel][co] from the cotangent tile; row strides of 8 or 24 mod 32 words
// keep both free of bank conflicts), not transposed while staging. Six
// warps: warp (dy, ci fragment, pixel half) holds the three dx taps of its
// row against all CO_T channels. At the end the pixel halves are summed
// through shared memory in a fixed order and the block adds its tile into
// dW with one global atomicAdd per weight: the order of those atomics
// varies, so dW is not bitwise run-to-run deterministic (f32 rounding of
// the partial sums only). Ragged tiles and channel counts are masked by
// zero fill.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "launch.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int TPX = 64;        // pixels per tile (TH x TW): 8 k8 steps
constexpr int NS = 3;          // cp.async ring stages
constexpr int MAX_HALO = 136;  // (TH+2) x (TW+2) for TW = 8, 16, 32

template <typename T, int CI_T, int CO_T>
struct DwCfg {
  static constexpr int SZ = (int)sizeof(T);
  static constexpr int MI = CI_T / 16;        // m16 fragments of channels
  static constexpr int KG = 2 / MI;           // warps splitting the pixels
  static constexpr int NT = 32 * 3 * MI * KG; // six warps
  static constexpr int NF = CO_T / 8;         // n8 fragments
  static constexpr int SX = CI_T + 8;         // elements per halo pixel
  static constexpr int SG = CO_T + 8;         // elements per cotangent pixel
  static constexpr int X_BYTES = MAX_HALO * SX * SZ;
  static constexpr int G_BYTES = TPX * SG * SZ;
  static constexpr int STAGE = X_BYTES + G_BYTES;
  static constexpr int ACC = 3 * NF * 4;      // accumulators per thread
  static constexpr int RED = 3 * MI * 32 * ACC * 4;
  static constexpr int SMEM = NS * STAGE > RED ? NS * STAGE : RED;
};

template <typename T>
struct DwArgs {
  const T* x0;
  const T* x1;
  int C0, C1;
  const T* g;
  float* dw;
  int B, H, W, Co;
  int TW, TH, tiles_w, tiles_h;
  int cit0;       // input channel tiles of part 0
  int co_tiles;
  int tw_shift;    // log2(TW)
  int hw_magic;    // px / (TW + 2) == (px * hw_magic) >> 16
  int replicate;
  int vec;        // 16-byte copies allowed (host only)
};

// one copy unit: a 16-byte cp.async (VEC) or one element by a plain load
// and store; zeros where !ok
template <typename T, bool VEC>
__device__ __forceinline__ void copy_unit(char* dst, const T* base,
                                          size_t off, bool ok) {
  if constexpr (VEC)
    cp_async16(dst, ok ? base + off : base, ok);
  else
    *reinterpret_cast<T*>(dst) = ok ? base[off] : from_f32<T>(0.f);
}

template <typename T, int CI_T, int CO_T, bool VEC>
__device__ __forceinline__ void load_tile(const DwArgs<T>& p, char* stage,
                                          int t, const T* x, int Cp, int ci0,
                                          int co0, int tid) {
  using C = DwCfg<T, CI_T, CO_T>;
  constexpr int UE = VEC ? 16 / C::SZ : 1;  // elements per copy unit
  const int tw_i = t % p.tiles_w;
  t /= p.tiles_w;
  const int th_i = t % p.tiles_h;
  const int b = t / p.tiles_h;
  const int h0 = th_i * p.TH;
  const int w0 = tw_i * p.TW;
  const int hw = p.TW + 2;
  const int npx = (p.TH + 2) * hw;
  char* sx = stage;
  char* sg = stage + C::X_BYTES;

  // input halo: rows h0-1 .. h0+TH, columns w0-1 .. w0+TW
  constexpr int XU = CI_T / UE;
  for (int i = tid; i < npx * XU; i += C::NT) {
    const int e = i % XU;
    const int px = i / XU;
    const int yy = (px * p.hw_magic) >> 16;   // px / hw
    int gy = h0 - 1 + yy;
    int gx = w0 - 1 + px - yy * hw;
    if (p.replicate) {
      gy = min(max(gy, 0), p.H - 1);
      gx = min(max(gx, 0), p.W - 1);
    }
    const int c = ci0 + e * UE;
    copy_unit<T, VEC>(sx + (px * C::SX + e * UE) * C::SZ, x,
                   (((size_t)b * p.H + gy) * p.W + gx) * Cp + c,
                   c < Cp && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W);
  }
  // cotangent tile; pixels outside the image contribute nothing
  constexpr int GU = CO_T / UE;
  for (int i = tid; i < TPX * GU; i += C::NT) {
    const int e = i % GU;
    const int px = i / GU;
    const int gy = h0 + (px >> p.tw_shift);
    const int gx = w0 + (px & (p.TW - 1));
    const int c = co0 + e * UE;
    copy_unit<T, VEC>(sg + (px * C::SG + e * UE) * C::SZ, p.g,
                   (((size_t)b * p.H + gy) * p.W + gx) * p.Co + c,
                   c < p.Co && gy < p.H && gx < p.W);
  }
}

template <typename T, int CI_T, int CO_T, bool VEC>
__global__ void __launch_bounds__(DwCfg<T, CI_T, CO_T>::NT, 2)
conv3x3_dw_kernel(const DwArgs<T> p) {
  using C = DwCfg<T, CI_T, CO_T>;
  extern __shared__ __align__(16) char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int dy = warp % 3;                  // kernel row of this warp
  const int mi = (warp / 3) % C::MI;        // its 16 input channels
  const int kg = warp / (3 * C::MI);        // its share of the pixels

  const int ct = blockIdx.y / p.co_tiles;
  const int co0 = (blockIdx.y % p.co_tiles) * CO_T;
  const int part = ct < p.cit0 ? 0 : 1;
  const int ci0 = (ct - (part ? p.cit0 : 0)) * CI_T;
  const T* x = part ? p.x1 : p.x0;
  const int Cp = part ? p.C1 : p.C0;
  const int ntiles = p.B * p.tiles_h * p.tiles_w;
  const int mine = (int)blockIdx.x < ntiles
                       ? (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;

  float acc[3][C::NF][4];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int j = 0; j < C::NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][j][e] = 0.f;

  auto fetch = [&](int j) {
    if (j < mine)
      load_tile<T, CI_T, CO_T, VEC>(p, smem + (j % NS) * C::STAGE,
                                 (int)blockIdx.x + j * (int)gridDim.x, x, Cp,
                                 ci0, co0, tid);
    cp_async_commit();                // empty groups keep the count even
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) fetch(s);

  const int spr_shift = p.tw_shift - 3;  // log2(k8 steps per tile row)
  for (int j = 0; j < mine; ++j) {
    cp_async_wait<NS - 2>();
    __syncthreads();
    fetch(j + NS - 1);
    const T* sx = reinterpret_cast<const T*>(smem + (j % NS) * C::STAGE);
    const T* sg =
        reinterpret_cast<const T*>(smem + (j % NS) * C::STAGE + C::X_BYTES);
    // this tile's products summed on the tensor cores from zero, then added
    // to acc in float32 (csrc/mma_tf32.cuh)
    float tacc[3][C::NF][4];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int n = 0; n < C::NF; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) tacc[a][n][e] = 0.f;
#pragma unroll 2
    for (int s = kg; s < TPX / 8; s += C::KG) {
      const int ty = s >> spr_shift;
      const int tx0 = (s & ((1 << spr_shift) - 1)) * 8;
      // B[k = pixel][n = co] from the cotangent tile
      const T* gp = sg + (ty * p.TW + tx0 + tig) * C::SG + gid;
      unsigned bh[C::NF][2], bl[C::NF][2];
#pragma unroll
      for (int n = 0; n < C::NF; ++n) {
        frag<T>(to_f32(gp[n * 8]), bh[n][0], bl[n][0]);
        frag<T>(to_f32(gp[4 * C::SG + n * 8]), bh[n][1], bl[n][1]);
      }
      // A[m = ci][k = pixel] from the halo, shifted by the tap
      const T* xp =
          sx + ((ty + dy) * (p.TW + 2) + tx0 + tig) * C::SX + mi * 16 + gid;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const T* q = xp + dx * C::SX;
        unsigned ah[4], al[4];
        frag<T>(to_f32(q[0]), ah[0], al[0]);
        frag<T>(to_f32(q[8]), ah[1], al[1]);
        frag<T>(to_f32(q[4 * C::SX]), ah[2], al[2]);
        frag<T>(to_f32(q[4 * C::SX + 8]), ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < C::NF; ++n) {
          if constexpr (C::SZ == 4)
            mma_3xtf32(tacc[dx][n], ah, al, bh[n], bl[n]);
          else
            mma_tf32(tacc[dx][n], ah, bh[n]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int n = 0; n < C::NF; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][n][e] += tacc[a][n][e];
  }

  cp_async_wait<0>();
  if (C::KG > 1) {
    // the second pixel half adds into the first, in a fixed order
    __syncthreads();                  // every warp is done with the stages
    float* red = reinterpret_cast<float*>(smem);
    const int slot = (warp - 3 * C::MI * kg) * 32 + lane;
    if (kg == 1) {
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int n = 0; n < C::NF; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            red[slot * C::ACC + (a * C::NF + n) * 4 + e] = acc[a][n][e];
    }
    __syncthreads();
    if (kg == 0) {
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int n = 0; n < C::NF; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[a][n][e] += red[slot * C::ACC + (a * C::NF + n) * 4 + e];
    }
  }
  if (kg == 0) {
    const int Cin = p.C0 + p.C1;
    const int coff = part ? p.C0 : 0;
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int n = 0; n < C::NF; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ci = ci0 + mi * 16 + gid + (e >> 1) * 8;
          const int co = co0 + n * 8 + 2 * tig + (e & 1);
          if (ci < Cp && co < p.Co)
            atomicAdd(&p.dw[((size_t)(dy * 3 + a) * Cin + coff + ci) * p.Co +
                            co],
                      acc[a][n][e]);
        }
  }
}

// ------------------------------------------------------------------- host

int cdiv(int a, int b) { return (a + b - 1) / b; }

// the channel tile (16 or 32) of the fewest padded channels, a tile costing
// T + 8; ties go to 32
int pick_ct(int Ca, int Cb) {
  int best = 32;
  long long cost = LLONG_MAX;
  for (int t : {32, 16}) {
    const long long c = (long long)(cdiv(Ca, t) + cdiv(Cb, t)) * (t + 8);
    if (c < cost) {
      cost = c;
      best = t;
    }
  }
  return best;
}

template <typename T, int CI_T, int CO_T, bool VEC>
int launch(const DwArgs<T>& a, dim3 grid, cudaStream_t s) {
  using C = DwCfg<T, CI_T, CO_T>;
  static unsigned smem_set = 0;
  const cudaError_t e =
      allow_smem(conv3x3_dw_kernel<T, CI_T, CO_T, VEC>, C::SMEM, smem_set);
  if (e != cudaSuccess) return (int)e;
  conv3x3_dw_kernel<T, CI_T, CO_T, VEC><<<grid, C::NT, C::SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dw_run(const void* x0, int C0, const void* x1, int C1, const void* g,
           void* dw, int B, int H, int W, int Co, int replicate,
           cudaStream_t s) {
  constexpr int V = 16 / (int)sizeof(T);     // elements per 16-byte copy
  DwArgs<T> a{};
  a.x0 = static_cast<const T*>(x0);
  a.x1 = static_cast<const T*>(x1);
  a.C0 = C0;
  a.C1 = C1;
  a.g = static_cast<const T*>(g);
  a.dw = static_cast<float*>(dw);
  a.B = B;
  a.H = H;
  a.W = W;
  a.Co = Co;
  a.replicate = replicate;
  a.vec = C0 % V == 0 && C1 % V == 0 && Co % V == 0 && aligned16(x0) &&
          (C1 == 0 || aligned16(x1)) && aligned16(g);
  // the pixel tile of least padded area
  long long best = LLONG_MAX;
  for (int tw : {32, 16, 8}) {
    const int th = TPX / tw;
    const int nh = cdiv(H, th), nw = cdiv(W, tw);
    const long long cells = (long long)nh * th * nw * tw;
    if (cells < best) {
      best = cells;
      a.TW = tw;
      a.TH = th;
      a.tiles_h = nh;
      a.tiles_w = nw;
    }
  }
  a.tw_shift = a.TW == 32 ? 5 : a.TW == 16 ? 4 : 3;
  a.hw_magic = (65536 + a.TW + 1) / (a.TW + 2);   // exact for px < 4096
  const int ci_t = pick_ct(C0, C1);
  const int co_t = pick_ct(Co, 0);
  a.cit0 = cdiv(C0, ci_t);
  a.co_tiles = cdiv(Co, co_t);
  const long long ntiles = (long long)B * a.tiles_h * a.tiles_w;
  const long long nct = (long long)(a.cit0 + cdiv(C1, ci_t)) * a.co_tiles;
  if (ntiles > INT_MAX || nct > 65535) return (int)cudaErrorInvalidValue;
  // the split over pixels: channel tiles x split fills whole waves of
  // resident blocks (two per SM)
  const long long resident = 2LL * sm_count();
  const long long waves = (nct + resident - 1) / resident;
  long long split = waves * resident / nct;
  if (split < 1) split = 1;
  if (split > ntiles) split = ntiles;
  const dim3 grid((unsigned)split, (unsigned)nct);
  if (a.vec) {
    if (ci_t == 16)
      return co_t == 16 ? launch<T, 16, 16, true>(a, grid, s)
                        : launch<T, 16, 32, true>(a, grid, s);
    return co_t == 16 ? launch<T, 32, 16, true>(a, grid, s)
                      : launch<T, 32, 32, true>(a, grid, s);
  }
  if (ci_t == 16)
    return co_t == 16 ? launch<T, 16, 16, false>(a, grid, s)
                      : launch<T, 16, 32, false>(a, grid, s);
  return co_t == 16 ? launch<T, 32, 16, false>(a, grid, s)
                    : launch<T, 32, 32, false>(a, grid, s);
}

}  // namespace

// x0 [B,H,W,C0], x1 [B,H,W,C1] or null with C1 = 0, g [B,H,W,Co], all of
// one dtype (0 = float32, 1 = bfloat16); dw [3,3,C0+C1,Co] float32, zeroed
// by the caller, receives the weight cotangent. All contiguous. Launches on
// `stream` and returns cudaGetLastError() (0 on success); never
// synchronises.
extern "C" int fsnet_conv3x3_dw_nhwc(const void* x0, int C0, const void* x1,
                                     int C1, const void* g, void* dw, int B,
                                     int H, int W, int Co, int replicate,
                                     int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Co <= 0 || C0 <= 0 || C1 < 0 ||
      (C1 > 0 && x1 == nullptr) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dw_run<__nv_bfloat16>(x0, C0, x1, C1, g, dw, B, H, W, Co,
                                 replicate, s);
  return dw_run<float>(x0, C0, x1, C1, g, dw, B, H, W, Co, replicate, s);
}
