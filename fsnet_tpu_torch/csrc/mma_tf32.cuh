// Shared by the decoder's conv kernels (conv3x3.cu: forward, moments, input
// cotangent; conv3x3_dw.cu: weight cotangent): asynchronous global->shared
// copies (cp.async, 16 bytes, zero fill) and the TF32 tensor-core product
// mma.sync.aligned.m16n8k8 with the 3xTF32 split that keeps float32
// accuracy:
//
//   a*b ~= a_hi*b_hi + a_hi*b_lo + a_lo*b_hi,
//   x_hi = cvt.rna.tf32(x), x_lo = cvt.rna.tf32(x - x_hi),
//
// the dropped a_lo*b_lo being below 2^-22 of the product. The tensor cores
// add into their float32 accumulator with truncation (round toward zero),
// a bias that over a K of thousands grows to about 1e-4 of the result, so
// the kernels sum a short stretch of K (one staged chunk) on the tensor
// cores from zero and add each stretch's partial to the running sum with a
// float32 add (round to nearest): float32 FMA accuracy, as the decoder's
// gates need. A bfloat16 value is exact in TF32, so bfloat16 operands take
// one exact product, summed the same way.
//
// Fragment layout of m16n8k8 (PTX ISA, gid = lane / 4, tig = lane % 4):
//   A (16x8, row):  a0 (gid, tig)  a1 (gid+8, tig)  a2 (gid, tig+4)
//                   a3 (gid+8, tig+4)
//   B (8x8, col):   b0 (k=tig, n=gid)  b1 (k=tig+4, n=gid)
//   C (16x8):       c0 (gid, 2tig)  c1 (gid, 2tig+1)  c2 (gid+8, 2tig)
//                   c3 (gid+8, 2tig+1)
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// 16 bytes global -> shared, bypassing L1; zero-filled when !pred (then no
// byte of gmem is read, but it must still be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// cvt.rna.tf32.f32 of a finite x, in two integer operations instead of
// that instruction's four (it adds a guard for Inf and NaN): round to
// nearest, ties away from zero, on the 13 dropped mantissa bits; a carry
// into the exponent is the correct rounding
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, each a TF32 value in a 32-bit register
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a * b, one m16n8k8 TF32 product with float32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b in 3xTF32: the two small cross terms first, then the large one
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const unsigned (&ah)[4],
                                           const unsigned (&al)[4],
                                           const unsigned (&bh)[2],
                                           const unsigned (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

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

// an operand element of a T tensor as TF32 register(s): float32 splits into
// hi and lo, a bfloat16 value is exact (lo unused)
template <typename T>
__device__ __forceinline__ void frag(float v, unsigned& hi, unsigned& lo) {
  if constexpr (sizeof(T) == 4) {
    split_tf32(v, hi, lo);
  } else {
    hi = __float_as_uint(v);
    lo = 0u;
  }
}

// two adjacent elements as float32, in one load
__device__ __forceinline__ void ld_pair(const float* q, float& a, float& b) {
  const float2 v = *reinterpret_cast<const float2*>(q);
  a = v.x;
  b = v.y;
}
__device__ __forceinline__ void ld_pair(const __nv_bfloat16* q, float& a,
                                        float& b) {
  const float2 v = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(q));
  a = v.x;
  b = v.y;
}

}  // namespace
