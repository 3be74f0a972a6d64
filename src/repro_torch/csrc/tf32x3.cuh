// The 3xTF32 building blocks of the f32-accurate tensor-core kernels
// (flash_attention.cu, flash_attention_bwd.cu and the MLA decode kernel's
// f32 instance in mla_decode_attention.cu): the split of an f32 operand
// into two TF32 parts, mma.sync's m16n8k8 TF32 product, the SFU's exp2,
// 16-byte cp.async copies and the f32 / bf16 conversions.
//
// The split. Each f32 operand x becomes hi = x rounded to TF32 (nearest,
// ties away from zero: what cvt.rna.tf32.f32 computes, done here by two
// integer operations on the bits, which issue beside the products) and
// lo = x - hi, exact in f32, which the tensor core reads truncated to TF32
// (it ignores a TF32 operand's 13 low bits), as CUTLASS's 3xTF32 rounds its
// small part. A product is taken as lo_a*hi_b + hi_a*lo_b + hi_a*hi_b; the
// dropped lo_a*lo_b is below 2^-22 of it. bf16 values are exact in TF32.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// Shared row padding, in elements: 16 bytes either way.
template <typename T>
constexpr int kPad = 16 / sizeof(T);

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// hi: x rounded to TF32, as f32 bits with the 13 low mantissa bits clear;
// lo: the rest, x - hi.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// 2^x by the SFU's ex2.approx: a relative error below 2^-22; results
// below 2^-126 flush to 0 (a row's largest p is 1).
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d += a (16x8, row) . b (8x8, col), TF32 in, f32 accumulators. Fragments
// (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g+8, t), a2 (g, t+4),
// a3 (g+8, t+4); b0 (k t, n g), b1 (k t+4, n g); d0, d1 (g, 2t), (g, 2t+1),
// d2, d3 (g+8, 2t), (g+8, 2t+1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16 bytes from global to shared memory, or 16 zero bytes where !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes from global to shared memory (cached in L1), or 4 zero bytes
// where !ok.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
