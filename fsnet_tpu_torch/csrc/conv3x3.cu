// 3x3 stride-1 "same" convolution on NHWC tensors with one or two input
// parts, for Hopper (sm_90a), bound through a plain C interface (ctypes).
//
//   out[b,h,w,co] = bias[co] + sum_parts sum_{dy,dx,ci}
//                   pad(x_part)[b,h+dy,w+dx,ci] * W[dy,dx,off_part+ci,co]
//
// Replaces: fsnet_tpu/ops/pallas/conv_kernel.py conv3x3_fused_mats (the
// decoder's 3x3 conv on the TPU, reached through fast_conv.conv3x3_packed).
// The TPU kernel works on a width-packed layout with banded "Toeplitz"
// matrices so that small channel counts fill the 128-lane MXU; none of that
// carries over. This kernel reads plain NHWC, takes the weight as HWIO
// [3,3,sum(C),Co] and handles the two-part input (the decoder's skip concat,
// [x, skip]) without materialising the concat: the loop over input channels
// runs over part 0 and then part 1, so both parts accumulate into the same
// f32 registers.
//
// What bounds it on an H100: the decoder's convs do 2*9*Cin*Co operations
// for every output pixel and read each input value once, so at the shapes of
// the main path the f32 FMA rate (67 TFLOP/s outside the tensor cores) is
// the bound, not the 3.35 TB/s of memory; only the 16->16 convs at full
// resolution come near the memory bound.
//
// Design: a block owns a TH x TW tile of output pixels and a TCO-wide slice
// of output channels. For each chunk of CI input channels it stages the
// (TH+2) x (TW+2) input halo (padding applied at load: zeros, or clamped
// coordinates for replicate) and the 3x3xCIxTCO weight slice in shared
// memory, converted to f32. Each thread then keeps a PX-pixel x CO_T-channel
// tile of f32 accumulators in registers: per input channel and kernel row it
// reads PX+2 input values and, per tap, CO_T weights (two 16-byte shared
// loads, the same address for the whole warp), and issues PX*CO_T FMAs, so
// shared-memory traffic stays well below the FMA issue rate. Ragged tiles
// (H=6, W=20, Cin=96, Co=16) are masked at load and store. This is the
// simple first kernel: no tensor cores (wgmma), no TMA, no double buffering.
//
// The same kernel computes the input cotangent of the conv (the caller
// passes the zero-padded output cotangent and the spatially flipped,
// io-transposed weight), as the TPU kernel does with transposed mats.
//
// BN-moments epilogue (MOM, float32 only). Replaces conv_kernel.py
// conv3x3_fused_mats_m: besides the output, the kernel returns the
// per-channel sum and sum of squares of the STORED output in f32, so
// train-mode BatchNorm never re-reads the activation. Each thread sums its
// PX pixels, a warp (all pixel groups of one channel group) reduces with
// shuffles, and lane 0 adds the block's partial into the [2, Co] buffer with
// atomicAdd. The order of those atomics varies, so the moments are not
// bitwise run-to-run deterministic (f32 rounding of the block partials only).
// The two-part input of the TPU kernel's `prev` operand is already summed
// in-kernel here.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int TH = 4;                   // output rows per block
constexpr int TW = 32;                  // output columns per block
constexpr int PX = 4;                   // output columns per thread
constexpr int CO_T = 8;                 // output channels per thread
constexpr int CI = 8;                   // input channels staged per step
constexpr int NPG = TH * TW / PX;       // pixel groups per block (32)
constexpr int HALO_H = TH + 2;
constexpr int HALO_W = TW + 2;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int TCO, bool MOM>
__global__ void __launch_bounds__(NPG * (TCO / CO_T))
conv3x3_nhwc_kernel(const T* __restrict__ x0, int C0,
                    const T* __restrict__ x1, int C1,
                    const T* __restrict__ w, const T* __restrict__ bias,
                    T* __restrict__ out, float* __restrict__ mom, int H,
                    int W, int Co, int tiles_w, int tiles_h, int replicate) {
  constexpr int NCG = TCO / CO_T;       // channel groups per block
  constexpr int NT = NPG * NCG;         // threads per block
  __shared__ float s_in[CI][HALO_H][HALO_W];
  __shared__ __align__(16) float s_w[CI][9][TCO];

  const int tid = threadIdx.x;
  const int pg = tid % NPG;             // one warp = all pixel groups
  const int cg = tid / NPG;             // of one channel group
  const int ty = pg / (TW / PX);
  const int tx = (pg % (TW / PX)) * PX;

  int t = blockIdx.x;
  const int tw_i = t % tiles_w;
  t /= tiles_w;
  const int th_i = t % tiles_h;
  const int b = t / tiles_h;
  const int h0 = th_i * TH;
  const int w0 = tw_i * TW;
  const int co0 = blockIdx.y * TCO;
  const int Cin = C0 + C1;

  float acc[PX][CO_T];
#pragma unroll
  for (int k = 0; k < PX; ++k)
#pragma unroll
    for (int c = 0; c < CO_T; ++c) acc[k][c] = 0.f;

  for (int part = 0; part < 2; ++part) {
    const T* x = part == 0 ? x0 : x1;
    const int C = part == 0 ? C0 : C1;
    const int coff = part == 0 ? 0 : C0;
    if (C == 0) continue;               // uniform over the block
    const T* xb = x + (size_t)b * H * W * C;

    for (int c0 = 0; c0 < C; c0 += CI) {
      // input halo, channel fastest so neighbouring threads read
      // neighbouring addresses
      for (int i = tid; i < CI * HALO_H * HALO_W; i += NT) {
        const int ci = i % CI;
        const int r = i / CI;
        const int xx = r % HALO_W;
        const int yy = r / HALO_W;
        int gy = h0 + yy - 1;
        int gx = w0 + xx - 1;
        if (replicate) {
          gy = min(max(gy, 0), H - 1);
          gx = min(max(gx, 0), W - 1);
        }
        float v = 0.f;
        if (c0 + ci < C && gy >= 0 && gy < H && gx >= 0 && gx < W)
          v = to_f32(xb[((size_t)gy * W + gx) * C + c0 + ci]);
        s_in[ci][yy][xx] = v;
      }
      // weight slice s_w[ci][tap][co] = W[tap][coff+c0+ci][co0+co]
      for (int i = tid; i < CI * 9 * TCO; i += NT) {
        const int co = i % TCO;
        const int r = i / TCO;
        const int tap = r % 9;
        const int ci = r / 9;
        float v = 0.f;
        if (c0 + ci < C && co0 + co < Co)
          v = to_f32(w[((size_t)tap * Cin + coff + c0 + ci) * Co + co0 + co]);
        s_w[ci][tap][co] = v;
      }
      __syncthreads();

#pragma unroll
      for (int ci = 0; ci < CI; ++ci) {
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
          float xin[PX + 2];
#pragma unroll
          for (int j = 0; j < PX + 2; ++j) xin[j] = s_in[ci][ty + dy][tx + j];
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const float4* wp =
                reinterpret_cast<const float4*>(&s_w[ci][dy * 3 + dx][cg * CO_T]);
            const float4 wa = wp[0];
            const float4 wb = wp[1];
            const float wv[CO_T] = {wa.x, wa.y, wa.z, wa.w,
                                    wb.x, wb.y, wb.z, wb.w};
#pragma unroll
            for (int k = 0; k < PX; ++k)
#pragma unroll
              for (int c = 0; c < CO_T; ++c)
                acc[k][c] = fmaf(xin[k + dx], wv[c], acc[k][c]);
          }
        }
      }
      __syncthreads();
    }
  }

  const int gy = h0 + ty;
  float s1[CO_T], s2[CO_T];
#pragma unroll
  for (int c = 0; c < CO_T; ++c) s1[c] = s2[c] = 0.f;
  if (gy < H) {
#pragma unroll
    for (int k = 0; k < PX; ++k) {
      const int gx = w0 + tx + k;
      if (gx >= W) continue;
      T* o = out + (((size_t)b * H + gy) * W + gx) * Co;
#pragma unroll
      for (int c = 0; c < CO_T; ++c) {
        const int co = co0 + cg * CO_T + c;
        if (co >= Co) continue;
        const float bv = bias != nullptr ? to_f32(bias[co]) : 0.f;
        const T v = from_f32<T>(acc[k][c] + bv);
        o[co] = v;
        if (MOM) {
          const float vs = to_f32(v);       // moments of the stored value
          s1[c] += vs;
          s2[c] += vs * vs;
        }
      }
    }
  }
  if (MOM) {
    // the warp holds all NPG pixel groups of channel group cg
#pragma unroll
    for (int c = 0; c < CO_T; ++c) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s1[c] += __shfl_xor_sync(0xffffffffu, s1[c], off);
        s2[c] += __shfl_xor_sync(0xffffffffu, s2[c], off);
      }
    }
    if (pg == 0) {
#pragma unroll
      for (int c = 0; c < CO_T; ++c) {
        const int co = co0 + cg * CO_T + c;
        if (co < Co) {
          atomicAdd(&mom[co], s1[c]);
          atomicAdd(&mom[Co + co], s2[c]);
        }
      }
    }
  }
}

template <typename T, bool MOM>
void launch(int tco, dim3 grid, cudaStream_t stream, const void* x0, int C0,
            const void* x1, int C1, const void* w, const void* bias, void* out,
            float* mom, int H, int W, int Co, int tiles_w, int tiles_h,
            int replicate) {
  const T* px0 = static_cast<const T*>(x0);
  const T* px1 = static_cast<const T*>(x1);
  const T* pw = static_cast<const T*>(w);
  const T* pb = static_cast<const T*>(bias);
  T* po = static_cast<T*>(out);
  switch (tco) {
    case 16:
      conv3x3_nhwc_kernel<T, 16, MOM><<<grid, NPG * 2, 0, stream>>>(
          px0, C0, px1, C1, pw, pb, po, mom, H, W, Co, tiles_w, tiles_h,
          replicate);
      break;
    case 32:
      conv3x3_nhwc_kernel<T, 32, MOM><<<grid, NPG * 4, 0, stream>>>(
          px0, C0, px1, C1, pw, pb, po, mom, H, W, Co, tiles_w, tiles_h,
          replicate);
      break;
    default:
      conv3x3_nhwc_kernel<T, 64, MOM><<<grid, NPG * 8, 0, stream>>>(
          px0, C0, px1, C1, pw, pb, po, mom, H, W, Co, tiles_w, tiles_h,
          replicate);
      break;
  }
}

int conv_launch(const void* x0, int C0, const void* x1, int C1,
                const void* w, const void* bias, void* out, void* mom, int B,
                int H, int W, int Co, int replicate, int dtype,
                void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Co <= 0 || C0 <= 0 || C1 < 0 ||
      (C1 > 0 && x1 == nullptr) || (dtype != 0 && dtype != 1) ||
      (mom != nullptr && dtype != 0))
    return (int)cudaErrorInvalidValue;
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const long long nblk = (long long)B * tiles_h * tiles_w;
  const int tco = Co <= 16 ? 16 : (Co <= 32 ? 32 : 64);
  const int co_tiles = (Co + tco - 1) / tco;
  if (nblk > INT_MAX || co_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nblk, (unsigned)co_tiles);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mom);
  if (m != nullptr)
    launch<float, true>(tco, grid, s, x0, C0, x1, C1, w, bias, out, m, H, W,
                        Co, tiles_w, tiles_h, replicate);
  else if (dtype == 0)
    launch<float, false>(tco, grid, s, x0, C0, x1, C1, w, bias, out, m, H, W,
                         Co, tiles_w, tiles_h, replicate);
  else
    launch<__nv_bfloat16, false>(tco, grid, s, x0, C0, x1, C1, w, bias, out,
                                 m, H, W, Co, tiles_w, tiles_h, replicate);
  return (int)cudaGetLastError();
}

}  // namespace

// x0 [B,H,W,C0], x1 [B,H,W,C1] or null with C1 = 0, w [3,3,C0+C1,Co],
// bias [Co] or null, out [B,H,W,Co]; all contiguous, all of one dtype
// (0 = float32, 1 = bfloat16). Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int fsnet_conv3x3_nhwc(const void* x0, int C0, const void* x1,
                                  int C1, const void* w, const void* bias,
                                  void* out, int B, int H, int W, int Co,
                                  int replicate, int dtype, void* stream) {
  return conv_launch(x0, C0, x1, C1, w, bias, out, nullptr, B, H, W, Co,
                     replicate, dtype, stream);
}

// The same with the moments epilogue, float32 only: `mom` is a zeroed
// [2, Co] f32 buffer that receives the per-channel sum and sum of squares
// of the stored `out`.
extern "C" int fsnet_conv3x3_bn_nhwc(const void* x0, int C0, const void* x1,
                                     int C1, const void* w, const void* bias,
                                     void* out, void* mom, int B, int H, int W,
                                     int Co, int replicate, void* stream) {
  if (mom == nullptr) return (int)cudaErrorInvalidValue;
  return conv_launch(x0, C0, x1, C1, w, bias, out, mom, B, H, W, Co,
                     replicate, 0, stream);
}
