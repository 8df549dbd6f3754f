// 3x3 stride-1 "same" convolution on NHWC tensors with one or two input
// parts, its BN-moments variant and its input cotangent, for Hopper
// (sm_90a), as one implicit GEMM on the tensor cores, bound through a plain
// C interface (ctypes).
//
//   out[b,h,w,co] = bias[co] + sum_parts sum_{dy,dx,ci}
//                   pad(x_part)[b,h+dy,w+dx,ci] * W[dy,dx,off_part+ci,co]
//
// Replaces: fsnet_tpu/ops/pallas/conv_kernel.py conv3x3_fused_mats (:210,
// the forward, and on transposed mats the input cotangent) and
// conv3x3_fused_mats_m (:258, the BN-moments epilogue), reached through
// fast_conv.conv3x3_packed. The TPU kernels work on a width-packed layout
// with banded "Toeplitz" matrices so that small channel counts fill the
// 128-lane MXU; none of that carries over. This kernel reads plain NHWC,
// takes the weight as HWIO [3,3,sum(C),Co] and handles the two-part input
// (the decoder's skip concat) without materialising it.
//
// What bounds it on an H100: 2*9*Cin*Co operations per output pixel
// against one read of the input, so operations at every decoder shape. In
// float32 the products run as 3xTF32 (csrc/mma_tf32.cuh: three TF32
// products of split operands, float32 accumulation, as accurate as float32
// FMA): 3 x ops at 495 TFLOP/s, against 67 TFLOP/s for float32 FMA on the
// CUDA cores. A bfloat16 operand is exact in TF32 and takes one product.
//
// Design: the GEMM M = output pixels of a TH x TW tile (TM = 128; TW = 8,
// 16 or 32, chosen per shape from the host to waste the fewest pixels),
// N = output channels (TN = 16, 32 or 64, chosen per shape: the fewest
// padded channels, then halved while the grid has fewer blocks than SMs,
// which keeps the card busy at Co = 16 and at the 6x20 and 12x40 shapes at
// batch 1), K = 9 taps x input channels, running over part 0 and then part
// 1 in chunks of KC = 8 channels. Each chunk stages the (TH+2) x (TW+2)
// input halo (padding applied at load: zero fill, or clamped coordinates
// for replicate) and the 9 x KC x TN weight slice in shared memory, through
// a ring of NS = 3 stages filled with 16-byte cp.async copies along
// channels: the next chunks' copies are in flight while this chunk's MMAs
// run. Channel counts that are not a multiple of 8 (3, 40) are zero-filled
// at load; ragged pixel tiles are masked at the store. The instruction is
// mma.sync.aligned.m16n8k8 (TF32), not wgmma: its A fragment is loaded from
// any shared-memory address, which the nine shifted windows of one halo
// need (wgmma's A comes from a descriptor of a fixed K-major layout, so each
// tap would need its own copy of the window). Each warp holds a 32-pixel x
// 16- or 32-channel tile of f32 accumulators (2 x 2 or 2 x 4 fragments).
// Within a k8 step the kernel takes k = tig and k = tig + 4 to be the
// adjacent channels 2 tig and 2 tig + 1, so one 8-byte load gives a row's
// two A elements; with a halo row of exactly 8 channels and weight rows
// 16 mod 32 bytes apart the fragment loads are free of bank conflicts.
// Float32 operands are split into TF32 hi and lo as they are loaded, so
// each k8 step costs 3 MMAs, a bfloat16 operand one; for both types the
// tensor cores' partial of each chunk is added to float32 accumulators
// (csrc/mma_tf32.cuh), so a bfloat16 output is the rounding of a sum as
// accurate as float32 FMA, and its moments miss no gate by the tensor
// cores' truncation.
//
// Epilogue through shared memory: the accumulators go to a TM x TN tile,
// and each thread then owns one output channel over a strided set of
// pixels, so stores run along channels. Moments (MODE MOM, float32 or
// bfloat16 operands; TPU conv3x3_fused_mats_m, conv_kernel.py:196-200):
// the per-channel float32 sum and sum of squares of the STORED value (in
// bfloat16, of each output after its rounding), summed per block in a
// fixed order and added into [2, Co] with one atomicAdd per channel and
// block; the order of those atomics varies, so the moments are not bitwise
// run-to-run deterministic.
//
// Input cotangent (MODE DX): the same GEMM on the output cotangent g with
// the weight flipped and io-transposed: the caller passes w.transpose(2, 3)
// ([3,3,Co,Cin], one copy of the small weight) and the loader reads tap
// 8 - t; g's zero halo is applied at load. Both parts' cotangents come from
// one launch: the N tiles of part 0 write dx0 and those of part 1 dx1.
// Under replicate padding the kernel computes the cotangent of the padded
// input, (H+2) x (W+2), whose halo rows and columns fold into the edge rows
// and columns of the input they were copied from; the pixel tiles are laid
// on rows -1..H and columns -1..W, shifted by one where needed so that no
// tile boundary separates row -1 from row 0 or row H-1 from row H (the same
// for columns), and the epilogue sums each edge pixel's halo neighbours
// from the shared tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>
#include <initializer_list>

#include "launch.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int TM = 128;           // output pixels per block (TH x TW)
constexpr int KC = 8;             // input channels per stage: one k8 step
constexpr int NS = 3;             // cp.async ring stages
constexpr int MAX_HALO_PX = 204;  // (TH+2) x (TW+2) for TW = 8, 16, 32

enum { FWD = 0, MOM = 1, DX = 2 };

template <typename T, int TN>
struct Cfg {
  static constexpr int SZ = (int)sizeof(T);
  static constexpr int WN_F = TN == 16 ? 2 : 4;   // n8 fragments per warp
  static constexpr int WARPS_M = TM / 32;         // 2 m16 fragments per warp
  static constexpr int WARPS_N = TN / (8 * WN_F);
  static constexpr int NT = 32 * WARPS_M * WARPS_N;
  static constexpr int MINB = NT == 256 ? 2 : 4;  // resident blocks per SM
  // bytes per halo pixel (KC channels) and per weight row (TN channels)
  static constexpr int A_ROW = KC * SZ;           // 32 or 16 bytes
  static constexpr int B_ROW = TN * SZ + 16;      // 16 mod 32 bytes
  static constexpr int A_BYTES = MAX_HALO_PX * A_ROW;
  static constexpr int B_BYTES = 9 * KC * B_ROW;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int C_LD = TN + 8;             // floats per epilogue row
  static constexpr int EPI = (TM * C_LD + 2 * NT) * 4;
  static constexpr int SMEM = NS * STAGE > EPI ? NS * STAGE : EPI;
};

template <typename T>
struct ConvArgs {
  const T* a0;        // GEMM A parts: x0, x1 (forward) or g (DX)
  const T* a1;
  int C0, C1;         // their channels (C1 = 0: one part)
  const T* w;         // [9][C0 + C1][Nb]: HWIO, or w.transpose(2, 3) (DX)
  int Nb;             // its row length: N0 + N1
  const T* bias;      // [N0] or null (forward only)
  T* o0;              // outputs: out (forward) or dx0, dx1 (DX)
  T* o1;
  int N0, N1;         // their channels (N1 = 0: one output)
  float* mom;         // [2, N0] (MOM)
  int H, W;
  int TW, TH, tiles_w, tiles_h;
  int r_start, c_start;  // first row and column of tile 0
  int nt0;               // N tiles of output 0
  int tw_shift;          // log2(TW)
  int hw_magic;          // px / (TW + 2) == (px * hw_magic) >> 16
  int replicate;         // forward: clamp the halo instead of zero fill
  int fold;              // DX under replicate padding: fold the halo
  int vec;               // 16-byte copies for A and the weight (host only)
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

template <typename T, int TN, int MODE, bool VEC>
__device__ __forceinline__ void load_stage(const ConvArgs<T>& p, char* stage,
                                           int ap, int cb, int b, int r0,
                                           int c0, int wcol, int nrem,
                                           int tid) {
  using C = Cfg<T, TN>;
  constexpr int UE = VEC ? 16 / C::SZ : 1;   // elements per copy unit
  constexpr int AU = KC / UE;                // units per halo pixel
  constexpr int BU = TN / UE;                // units per weight row
  const T* x = ap == 0 ? p.a0 : p.a1;
  const int Cp = ap == 0 ? p.C0 : p.C1;
  const int hw = p.TW + 2;
  const int npx = (p.TH + 2) * hw;
  char* sa = stage;
  char* sb = stage + C::A_BYTES;

  // the input halo: rows r0-1 .. r0+TH, columns c0-1 .. c0+TW, channels
  // cb .. cb+KC-1 of part ap
  for (int i = tid; i < npx * AU; i += C::NT) {
    const int e = i % AU;
    const int px = i / AU;
    const int yy = (px * p.hw_magic) >> 16;   // px / hw
    int gy = r0 - 1 + yy;
    int gx = c0 - 1 + px - yy * hw;
    if (MODE != DX && p.replicate) {
      gy = min(max(gy, 0), p.H - 1);
      gx = min(max(gx, 0), p.W - 1);
    }
    const int c = cb + e * UE;
    const bool ok = c < Cp && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
    copy_unit<T, VEC>(sa + px * C::A_ROW + e * UE * C::SZ, x,
                      (((size_t)b * p.H + gy) * p.W + gx) * Cp + c, ok);
  }

  // the weight slice: 9 taps x KC input channels x TN output channels
  const int Ka = p.C0 + p.C1;
  const int krow = (ap == 0 ? 0 : p.C0) + cb;
  for (int i = tid; i < 9 * KC * BU; i += C::NT) {
    const int e = i % BU;
    const int r = i / BU;               // tap * KC + k
    const int k = r % KC;
    const int t = r / KC;
    const int n = e * UE;
    copy_unit<T, VEC>(sb + r * C::B_ROW + n * C::SZ, p.w,
                      ((size_t)t * Ka + krow + k) * p.Nb + wcol + n,
                      cb + k < Cp && n < nrem);
  }
}

template <typename T, int TN, int MODE, bool VEC>
__global__ void __launch_bounds__(Cfg<T, TN>::NT, Cfg<T, TN>::MINB)
conv3x3_mma_kernel(const ConvArgs<T> p) {
  using C = Cfg<T, TN>;
  constexpr bool F32 = C::SZ == 4;
  extern __shared__ __align__(16) char smem[];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int wm = warp % C::WARPS_M;
  const int wn = warp / C::WARPS_M;

  int t = blockIdx.x;
  const int tw_i = t % p.tiles_w;
  t /= p.tiles_w;
  const int th_i = t % p.tiles_h;
  const int b = t / p.tiles_h;
  const int r0 = p.r_start + th_i * p.TH;
  const int c0 = p.c_start + tw_i * p.TW;
  const int op = (int)blockIdx.y < p.nt0 ? 0 : 1;   // output part
  const int n0 = ((int)blockIdx.y - (op ? p.nt0 : 0)) * TN;
  const int No = op ? p.N1 : p.N0;
  const int wcol = (op ? p.N0 : 0) + n0;             // weight column
  const int nrem = No - n0;

  // halo pixel of each of this thread's fragment rows at tap (0, 0)
  const int hw = p.TW + 2;
  int hp[2][2];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = wm * 32 + f * 16 + h * 8 + gid;
      hp[f][h] = (m >> p.tw_shift) * hw + (m & (p.TW - 1));
    }

  float acc[2][C::WN_F][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < C::WN_F; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[f][j][e] = 0.f;

  const int nch0 = (p.C0 + KC - 1) / KC;
  const int nch = nch0 + (p.C1 + KC - 1) / KC;
  auto fetch = [&](int ch) {
    if (ch < nch) {
      const int ap = ch < nch0 ? 0 : 1;
      load_stage<T, TN, MODE, VEC>(p, smem + (ch % NS) * C::STAGE, ap,
                                   (ap ? ch - nch0 : ch) * KC, b, r0, c0,
                                   wcol, nrem, tid);
    }
    cp_async_commit();                 // empty groups keep the count even
  };
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) fetch(s);

  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait<NS - 2>();           // chunk ch has landed (this thread)
    __syncthreads();                   // ... for every thread; chunk ch-1
    fetch(ch + NS - 1);                // is done, so its stage is free
    // this chunk's 9 x KC products summed on the tensor cores from zero,
    // then added to acc in float32 (csrc/mma_tf32.cuh)
    float cacc[2][C::WN_F][4];
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int j = 0; j < C::WN_F; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) cacc[f][j][e] = 0.f;
    const char* sa = smem + (ch % NS) * C::STAGE;
    const char* sb = sa + C::A_BYTES;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int sh = (tap / 3) * hw + tap % 3;
      const int wt = MODE == DX ? 8 - tap : tap;
      // k = tig and k = tig + 4 of the k8 step are channels 2 tig and
      // 2 tig + 1 of the chunk, for A and B alike (a permutation of K, so
      // the sum is unchanged): one 8-byte (bf16: 4-byte) load gives both
      unsigned ah[2][4], al[2][4];
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const T* q = reinterpret_cast<const T*>(
                           sa + (hp[f][h] + sh) * C::A_ROW) + 2 * tig;
          float v0, v1;
          ld_pair(q, v0, v1);
          frag<T>(v0, ah[f][h], al[f][h]);
          frag<T>(v1, ah[f][h + 2], al[f][h + 2]);
        }
      constexpr int RW = C::B_ROW / C::SZ;   // elements per weight row
      const T* qb = reinterpret_cast<const T*>(
                        sb + (wt * KC + 2 * tig) * C::B_ROW)
                    + wn * C::WN_F * 8 + gid;
      unsigned bh[C::WN_F][2], bl[C::WN_F][2];
#pragma unroll
      for (int j = 0; j < C::WN_F; ++j) {
        frag<T>(to_f32(qb[j * 8]), bh[j][0], bl[j][0]);
        frag<T>(to_f32(qb[j * 8 + RW]), bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int j = 0; j < C::WN_F; ++j) {
          if constexpr (F32)
            mma_3xtf32(cacc[f][j], ah[f], al[f], bh[j], bl[j]);
          else
            mma_tf32(cacc[f][j], ah[f], bh[j]);
        }
    }
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int j = 0; j < C::WN_F; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[f][j][e] += cacc[f][j][e];
  }

  // epilogue: the accumulators through a shared TM x TN tile
  cp_async_wait<0>();
  __syncthreads();
  float* sc = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < C::WN_F; ++j) {
      const int m = wm * 32 + f * 16 + gid;
      const int n = wn * C::WN_F * 8 + j * 8 + 2 * tig;
      *reinterpret_cast<float2*>(sc + m * C::C_LD + n) =
          make_float2(acc[f][j][0], acc[f][j][1]);
      *reinterpret_cast<float2*>(sc + (m + 8) * C::C_LD + n) =
          make_float2(acc[f][j][2], acc[f][j][3]);
    }
  __syncthreads();

  const int n = tid % TN;              // NT is a multiple of TN
  const bool nok = n < nrem;
  T* o = op ? p.o1 : p.o0;
  const float bv = MODE != DX && p.bias != nullptr && nok
                       ? to_f32(p.bias[n0 + n]) : 0.f;
  // only tiles that hold an edge row or column fold a halo into it
  const bool fold = MODE == DX && p.fold &&
                    (r0 <= 0 || r0 + p.TH >= p.H || c0 <= 0 ||
                     c0 + p.TW >= p.W);
  float s1 = 0.f, s2 = 0.f;
  if (nok) {
    for (int m = tid / TN; m < TM; m += C::NT / TN) {
      const int r = r0 + (m >> p.tw_shift);
      const int c = c0 + (m & (p.TW - 1));
      if (r < 0 || r >= p.H || c < 0 || c >= p.W) continue;
      float v = sc[m * C::C_LD + n];
      if (fold) {
        // the padded input's halo rows/columns land on the edge pixel they
        // were copied from; they lie in this tile by construction
        const int ylo = r == 0 ? -1 : 0, yhi = r == p.H - 1 ? 1 : 0;
        const int xlo = c == 0 ? -1 : 0, xhi = c == p.W - 1 ? 1 : 0;
        v = 0.f;
        for (int sy = ylo; sy <= yhi; ++sy)
          for (int sx = xlo; sx <= xhi; ++sx)
            v += sc[(m + sy * p.TW + sx) * C::C_LD + n];
      }
      const T sv = from_f32<T>(v + bv);
      o[(((size_t)b * p.H + r) * p.W + c) * No + n0 + n] = sv;
      if (MODE == MOM) {
        const float q = to_f32(sv);     // moments of the stored value
        s1 += q;
        s2 += q * q;
      }
    }
  }
  if (MODE == MOM) {
    float* red = sc + TM * C::C_LD;
    red[tid] = s1;
    red[C::NT + tid] = s2;
    __syncthreads();
    if (tid < TN && nok) {
      float a = 0.f, q = 0.f;
      for (int j = tid; j < C::NT; j += TN) {
        a += red[j];
        q += red[C::NT + j];
      }
      atomicAdd(&p.mom[n0 + n], a);
      atomicAdd(&p.mom[No + n0 + n], q);
    }
  }
}

// ------------------------------------------------------------------- host

int cdiv(int a, int b) { return (a + b - 1) / b; }

// the pixel tile of least padded area; under the fold the tiles cover rows
// -1..H and columns -1..W, started one earlier where a boundary would split
// a halo row or column from the edge it folds into
template <typename T>
void pick_tile(ConvArgs<T>& a, bool fold) {
  long long best = LLONG_MAX;
  for (int tw : {32, 16, 8}) {
    const int th = TM / tw;
    int rs = 0, cs = 0, rows = a.H, cols = a.W;
    if (fold) {
      rs = (a.H + 1) % th == 0 ? -2 : -1;
      cs = (a.W + 1) % tw == 0 ? -2 : -1;
      rows = a.H + 1 - rs;
      cols = a.W + 1 - cs;
    }
    const int nh = cdiv(rows, th), nw = cdiv(cols, tw);
    const long long cells = (long long)nh * th * nw * tw;
    if (cells < best) {
      best = cells;
      a.TW = tw;
      a.TH = th;
      a.tiles_h = nh;
      a.tiles_w = nw;
      a.r_start = rs;
      a.c_start = cs;
    }
  }
}

// the fewest padded output channels (a tile costs TN + 16), then narrower
// while the grid has fewer blocks than the card has SMs
int pick_tn(int N0, int N1, long long mtiles) {
  int tn = 64;
  long long best = LLONG_MAX;
  for (int c : {64, 32, 16}) {
    const long long cost = (long long)(cdiv(N0, c) + cdiv(N1, c)) * (c + 16);
    if (cost < best) {
      best = cost;
      tn = c;
    }
  }
  const int sms = sm_count();
  while (tn > 16 && mtiles * (cdiv(N0, tn) + cdiv(N1, tn)) < sms) tn /= 2;
  return tn;
}

template <typename T, int TN, int MODE, bool VEC>
int launch_tn(const ConvArgs<T>& a, dim3 grid, cudaStream_t s) {
  using C = Cfg<T, TN>;
  static unsigned smem_set = 0;
  const cudaError_t e =
      allow_smem(conv3x3_mma_kernel<T, TN, MODE, VEC>, C::SMEM, smem_set);
  if (e != cudaSuccess) return (int)e;
  conv3x3_mma_kernel<T, TN, MODE, VEC><<<grid, C::NT, C::SMEM, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int MODE>
int run(ConvArgs<T> a, int B, cudaStream_t s) {
  constexpr int V = 16 / (int)sizeof(T);
  a.vec = a.C0 % V == 0 && a.C1 % V == 0 && aligned16(a.a0) &&
          (a.C1 == 0 || aligned16(a.a1)) && a.Nb % V == 0 &&
          a.N0 % V == 0 && aligned16(a.w);
  pick_tile(a, MODE == DX && a.fold);
  a.tw_shift = a.TW == 32 ? 5 : a.TW == 16 ? 4 : 3;
  a.hw_magic = (65536 + a.TW + 1) / (a.TW + 2);   // exact for px < 4096
  const long long mt = (long long)B * a.tiles_h * a.tiles_w;
  const int tn = pick_tn(a.N0, a.N1, mt);
  a.nt0 = cdiv(a.N0, tn);
  const int nt = a.nt0 + cdiv(a.N1, tn);
  if (mt > INT_MAX || nt > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)mt, (unsigned)nt);
  if (a.vec) {
    switch (tn) {
      case 16: return launch_tn<T, 16, MODE, true>(a, grid, s);
      case 32: return launch_tn<T, 32, MODE, true>(a, grid, s);
      default: return launch_tn<T, 64, MODE, true>(a, grid, s);
    }
  }
  switch (tn) {
    case 16: return launch_tn<T, 16, MODE, false>(a, grid, s);
    case 32: return launch_tn<T, 32, MODE, false>(a, grid, s);
    default: return launch_tn<T, 64, MODE, false>(a, grid, s);
  }
}

template <typename T>
ConvArgs<T> forward_args(const void* x0, int C0, const void* x1, int C1,
                         const void* w, const void* bias, void* out,
                         void* mom, int H, int W, int Co, int replicate) {
  ConvArgs<T> a{};
  a.a0 = static_cast<const T*>(x0);
  a.a1 = static_cast<const T*>(x1);
  a.C0 = C0;
  a.C1 = C1;
  a.w = static_cast<const T*>(w);
  a.Nb = Co;
  a.bias = static_cast<const T*>(bias);
  a.o0 = static_cast<T*>(out);
  a.N0 = Co;
  a.mom = static_cast<float*>(mom);
  a.H = H;
  a.W = W;
  a.replicate = replicate;
  return a;
}

int conv_forward(const void* x0, int C0, const void* x1, int C1,
                 const void* w, const void* bias, void* out, void* mom,
                 int B, int H, int W, int Co, int replicate, int dtype,
                 void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Co <= 0 || C0 <= 0 || C1 < 0 ||
      (C1 > 0 && x1 == nullptr) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const ConvArgs<__nv_bfloat16> a = forward_args<__nv_bfloat16>(
        x0, C0, x1, C1, w, bias, out, mom, H, W, Co, replicate);
    return mom != nullptr ? run<__nv_bfloat16, MOM>(a, B, s)
                          : run<__nv_bfloat16, FWD>(a, B, s);
  }
  const ConvArgs<float> a = forward_args<float>(x0, C0, x1, C1, w, bias, out,
                                                mom, H, W, Co, replicate);
  return mom != nullptr ? run<float, MOM>(a, B, s) : run<float, FWD>(a, B, s);
}

template <typename T>
int dx_run(const void* g, int Co, const void* wt, void* dx0, int C0,
           void* dx1, int C1, int B, int H, int W, int replicate,
           cudaStream_t s) {
  ConvArgs<T> a{};
  a.a0 = static_cast<const T*>(g);
  a.C0 = Co;
  a.w = static_cast<const T*>(wt);
  a.Nb = C0 + C1;
  a.o0 = static_cast<T*>(dx0);
  a.o1 = static_cast<T*>(dx1);
  a.N0 = C0;
  a.N1 = C1;
  a.H = H;
  a.W = W;
  a.fold = replicate;
  return run<T, DX>(a, B, s);
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
  return conv_forward(x0, C0, x1, C1, w, bias, out, nullptr, B, H, W, Co,
                      replicate, dtype, stream);
}

// The same with the moments epilogue: `mom` is a zeroed [2, Co] f32 buffer
// that receives the per-channel sum and sum of squares of the stored `out`
// (dtype 1: of each bfloat16 output after its rounding), in float32.
extern "C" int fsnet_conv3x3_bn_nhwc(const void* x0, int C0, const void* x1,
                                     int C1, const void* w, const void* bias,
                                     void* out, void* mom, int B, int H, int W,
                                     int Co, int replicate, int dtype,
                                     void* stream) {
  if (mom == nullptr) return (int)cudaErrorInvalidValue;
  return conv_forward(x0, C0, x1, C1, w, bias, out, mom, B, H, W, Co,
                      replicate, dtype, stream);
}

// Input cotangents of the conv of a two-part (or one-part, C1 = 0) input:
// g [B,H,W,Co] the output cotangent, wt [3,3,Co,C0+C1] the weight with its
// channel axes swapped (w.transpose(2, 3), not flipped), dx0 [B,H,W,C0] and
// dx1 [B,H,W,C1] (or null with C1 = 0) receive the cotangents of the parts;
// `replicate` names the forward's padding. One launch; all contiguous, of
// one dtype (0 = float32, 1 = bfloat16); never synchronises.
extern "C" int fsnet_conv3x3_dx_nhwc(const void* g, int Co, const void* wt,
                                     void* dx0, int C0, void* dx1, int C1,
                                     int B, int H, int W, int replicate,
                                     int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Co <= 0 || C0 <= 0 || C1 < 0 ||
      (C1 > 0 && dx1 == nullptr) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dx_run<__nv_bfloat16>(g, Co, wt, dx0, C0, dx1, C1, B, H, W,
                                 replicate, s);
  return dx_run<float>(g, Co, wt, dx0, C0, dx1, C1, B, H, W, replicate, s);
}
