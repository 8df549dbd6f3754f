// Weight cotangent of the 3x3 stride-1 "same" convolution on NHWC tensors
// with one or two input parts, for Hopper (sm_90a), bound through a plain C
// interface (ctypes):
//
//   dW[dy,dx,ci,co] = sum_{b,h,w} pad(x)[b,h+dy,w+dx,ci] * g[b,h,w,co]
//
// with pad = zeros or replicate, as in the forward (csrc/conv3x3.cu); a
// two-part input is the channel concat of its parts, never materialised.
//
// Replaces: fsnet_tpu/ops/pallas/conv_kernel.py conv3x3_fused_dw (+ the
// fold_dw of its banded-matrix accumulators). On the TPU one kernel walks a
// sequential grid and carries the sum in VMEM; blocks on Hopper run in
// parallel, so the pixel reduction is split over blocks and combined with
// atomics.
//
// What bounds it on an H100: 2*9*Cin*Co operations per pixel against one
// read of x and g, so the f32 FMA rate (67 TFLOP/s) at the decoder's shapes.
// The two regimes of the decoder are far apart: 16->16 over 1.47 M pixels
// (a tiny output, a huge reduction) and 512->256 over 1,440 pixels (1.18 M
// weights, a short reduction). One design covers both: a block owns a
// 16-input x 16-output channel tile for all nine taps, and walks a strided
// share of the 4x32-pixel tiles of the batch; the number of blocks per
// channel tile (the pixel split) grows as the channel tiles get fewer.
//
// Per pixel tile the block stages the (4+2) x (32+2) input halo (padding
// applied at load) and the 4x32 cotangent tile in shared memory. A thread
// owns 2 input x 4 output channels x 9 taps = 72 f32 accumulators; a warp
// owns one row and half the columns of the tile, taken 4 pixels at a time,
// so each step reads 18 float2 of x and 4 float4 of g for 288 FMAs. At the
// end the block's eight warps reduce through shared-memory atomics and the
// block adds its tile into dW with one global atomicAdd per weight. The
// order of the atomics varies, so dW is not bitwise run-to-run
// deterministic (f32 rounding of the partial sums only). Ragged tiles and
// channel counts are masked by loading zeros. Simple first kernel: no
// tensor cores, no TMA, no double buffering.
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int TH = 4;               // pixel tile rows
constexpr int TW = 32;              // pixel tile columns
constexpr int CI_T = 16;            // input channels per block
constexpr int CO_T = 16;            // output channels per block
constexpr int PX = 4;               // pixels per thread step
constexpr int NT = 256;             // threads per block (8 warps)
constexpr int HALO_H = TH + 2;
constexpr int HALO_W = TW + 2;

__global__ void __launch_bounds__(NT)
conv3x3_dw_kernel(const float* __restrict__ x0, int C0,
                  const float* __restrict__ x1, int C1,
                  const float* __restrict__ g, float* __restrict__ dw, int B,
                  int H, int W, int Co, int tiles_w, int tiles_h,
                  int co_tiles, int replicate) {
  __shared__ __align__(16) float s_x[HALO_H][HALO_W][CI_T];
  __shared__ __align__(16) float s_g[TH][TW][CO_T];
  __shared__ float s_red[9][CI_T][CO_T];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cp = lane & 7;          // input channel pair 2cp, 2cp+1
  const int cq = lane >> 3;         // output channel quad 4cq..4cq+3
  const int row = warp & 3;         // tile row of this warp
  const int col_base = (warp >> 2) * (TW / 2);

  const int ci0 = (blockIdx.y / co_tiles) * CI_T;
  const int co0 = (blockIdx.y % co_tiles) * CO_T;
  const int Cin = C0 + C1;
  const int ntiles = B * tiles_h * tiles_w;

  for (int i = tid; i < 9 * CI_T * CO_T; i += NT) (&s_red[0][0][0])[i] = 0.f;

  float acc[2][4][9];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int o = 0; o < 4; ++o)
#pragma unroll
      for (int t = 0; t < 9; ++t) acc[a][o][t] = 0.f;

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int tw_i = t % tiles_w;
    const int th_i = (t / tiles_w) % tiles_h;
    const int b = t / (tiles_w * tiles_h);
    const int h0 = th_i * TH;
    const int w0 = tw_i * TW;

    __syncthreads();                // the previous tile's reads are done
    for (int i = tid; i < HALO_H * HALO_W * CI_T; i += NT) {
      const int ci = i % CI_T;
      const int r = i / CI_T;
      const int xx = r % HALO_W;
      const int yy = r / HALO_W;
      int gy = h0 + yy - 1;
      int gx = w0 + xx - 1;
      if (replicate) {
        gy = min(max(gy, 0), H - 1);
        gx = min(max(gx, 0), W - 1);
      }
      const int c = ci0 + ci;
      float v = 0.f;
      if (c < Cin && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const size_t pix = ((size_t)b * H + gy) * W + gx;
        v = c < C0 ? x0[pix * C0 + c] : x1[pix * C1 + (c - C0)];
      }
      s_x[yy][xx][ci] = v;
    }
    for (int i = tid; i < TH * TW * CO_T; i += NT) {
      const int co = i % CO_T;
      const int r = i / CO_T;
      const int cc = r % TW;
      const int rr = r / TW;
      const int gy = h0 + rr;
      const int gx = w0 + cc;
      float v = 0.f;                // masked pixels contribute nothing
      if (gy < H && gx < W && co0 + co < Co)
        v = g[(((size_t)b * H + gy) * W + gx) * Co + co0 + co];
      s_g[rr][cc][co] = v;
    }
    __syncthreads();

#pragma unroll 1
    for (int step = 0; step < TW / 2 / PX; ++step) {
      const int c0 = col_base + step * PX;
      float gv[PX][4];
#pragma unroll
      for (int k = 0; k < PX; ++k) {
        const float4 q =
            *reinterpret_cast<const float4*>(&s_g[row][c0 + k][cq * 4]);
        gv[k][0] = q.x;
        gv[k][1] = q.y;
        gv[k][2] = q.z;
        gv[k][3] = q.w;
      }
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float xv[PX + 2][2];
#pragma unroll
        for (int j = 0; j < PX + 2; ++j) {
          const float2 p =
              *reinterpret_cast<const float2*>(&s_x[row + dy][c0 + j][cp * 2]);
          xv[j][0] = p.x;
          xv[j][1] = p.y;
        }
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int k = 0; k < PX; ++k)
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
              for (int o = 0; o < 4; ++o)
                acc[a][o][dy * 3 + dx] =
                    fmaf(xv[k + dx][a], gv[k][o], acc[a][o][dy * 3 + dx]);
      }
    }
  }

  // block reduction over the eight warps, then one global add per weight
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int o = 0; o < 4; ++o)
#pragma unroll
      for (int t = 0; t < 9; ++t)
        atomicAdd(&s_red[t][cp * 2 + a][cq * 4 + o], acc[a][o][t]);
  __syncthreads();
  for (int i = tid; i < 9 * CI_T * CO_T; i += NT) {
    const int co = i % CO_T;
    const int ci = (i / CO_T) % CI_T;
    const int tap = i / (CO_T * CI_T);
    if (ci0 + ci < Cin && co0 + co < Co)
      atomicAdd(&dw[((size_t)tap * Cin + ci0 + ci) * Co + co0 + co],
                s_red[tap][ci][co]);
  }
}

}  // namespace

// x0 [B,H,W,C0], x1 [B,H,W,C1] or null with C1 = 0, g [B,H,W,Co] float32;
// dw [3,3,C0+C1,Co] float32, zeroed by the caller, receives the weight
// cotangent. All contiguous. Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int fsnet_conv3x3_dw_nhwc(const void* x0, int C0, const void* x1,
                                     int C1, const void* g, void* dw, int B,
                                     int H, int W, int Co, int replicate,
                                     void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Co <= 0 || C0 <= 0 || C1 < 0 ||
      (C1 > 0 && x1 == nullptr))
    return (int)cudaErrorInvalidValue;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const long long ntiles = (long long)B * tiles_h * tiles_w;
  const int ci_tiles = (C0 + C1 + CI_T - 1) / CI_T;
  const int co_tiles = (Co + CO_T - 1) / CO_T;
  const long long nct = (long long)ci_tiles * co_tiles;
  if (ntiles > INT_MAX || nct > 65535) return (int)cudaErrorInvalidValue;
  // about 2048 blocks in all: few channel tiles get a wide pixel split
  long long split = (2048 + nct - 1) / nct;
  if (split > ntiles) split = ntiles;
  const dim3 grid((unsigned)split, (unsigned)nct);
  conv3x3_dw_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x0), C0, static_cast<const float*>(x1), C1,
      static_cast<const float*>(g), static_cast<float*>(dw), B, H, W, Co,
      tiles_w, tiles_h, co_tiles, replicate);
  return (int)cudaGetLastError();
}
