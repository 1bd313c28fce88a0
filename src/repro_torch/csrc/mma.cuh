// Tensor-core and copy helpers shared by the port's kernels (sm_90a):
// cp.async staging into shared memory, ldmatrix fragment loads, the
// mma.sync m16n8k16 bf16 product and the m16n8k8 TF32 product (with the
// hi/lo split of fp32 operands), each with an fp32 accumulator.
//
// Fragment layout of mma.sync m16n8k16 (lane = 4 * group + tig):
//   A (16 x 16, row major), 4 registers of two bf16: a0 = (row group,
//     k 2 tig .. +1), a1 = (row group + 8, same k), a2 = (row group,
//     k 2 tig + 8 .. +9), a3 = (row group + 8, k 2 tig + 8 .. +9);
//   B (16 x 8, column major), 2 registers: b0 = (k 2 tig .. +1, n group),
//     b1 = (k 2 tig + 8 .. +9, n group);
//   C / D (16 x 8 fp32), 4 registers: (row group, n 2 tig .. +1) and
//     (row group + 8, n 2 tig .. +1).
// So the C fragments of two neighbouring n8 tiles are, register for
// register, the A fragment of a product whose k runs over those 16
// columns once packed two by two into bf16 (the flash kernels' P and dS).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 zero-fills the 16 bytes without reading src
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0));
}

// 4-byte form (a row's scalar: position, lse, delta); zero-fills the same
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
                   "r"(smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [row0, row0 + R) of a row-major [rows, D] bf16 matrix into
// dst[R][D + 8] by cp.async, 16 bytes a copy, spread over the block's NTH
// threads; rows >= `rows` are zero-filled.  The 16-byte pad makes a row
// stride an odd number of 16-byte units, so ldmatrix reads no bank twice.
template <int R, int D, int NTH>
__device__ __forceinline__ void cp_async_rows(__nv_bfloat16* dst,
                                              const __nv_bfloat16* src,
                                              int row0, int rows) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  static_assert(R * CH % NTH == 0, "the chunks split evenly over the block");
#pragma unroll
  for (int l = 0; l < R * CH / NTH; ++l) {
    const int i = threadIdx.x + l * NTH;
    const int r = i / CH, c = (i % CH) * 8;
    const bool ok = row0 + r < rows;
    cp_async16(dst + r * (D + 8) + c,
               ok ? src + (size_t)(row0 + r) * D + c : src, ok);
  }
}

// Two fp32 values as bf16x2 registers, the first in the low half (the lower
// column of an A fragment).  split_bf16x2: hi = bf16(x) and lo = bf16(x -
// hi), so hi + lo carries x to ~2^-17 of |x| and hi.B + lo.B, summed in
// fp32, is x.B to that precision.  split3_bf16x2 cuts three parts of 8
// significant bits each, so hi + mid + lo == x exactly (short of
// underflow) and only the fp32 sums of the product round.
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi,
                                             uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __low2float(h),
                                                 x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ void split3_bf16x2(float x0, float x1,
                                              uint32_t& hi, uint32_t& mid,
                                              uint32_t& lo) {
  // cut by masks rather than conversions: each part is the top 8
  // significant bits of what remains, so every subtraction is exact
  constexpr uint32_t kTop = 0xffff0000u;
  const float h0 = __uint_as_float(__float_as_uint(x0) & kTop);
  const float h1 = __uint_as_float(__float_as_uint(x1) & kTop);
  const float r0 = x0 - h0, r1 = x1 - h1;
  const float m0 = __uint_as_float(__float_as_uint(r0) & kTop);
  const float m1 = __uint_as_float(__float_as_uint(r1) & kTop);
  // the high halves of (first, second) into (low, high) of one register
  hi = __byte_perm(__float_as_uint(h0), __float_as_uint(h1), 0x7632);
  mid = __byte_perm(__float_as_uint(m0), __float_as_uint(m1), 0x7632);
  lo = __byte_perm(__float_as_uint(r0 - m0), __float_as_uint(r1 - m1),
                   0x7632);
}

// TF32 (fp32 kernels on the tensor cores).  Fragment layout of mma.sync
// m16n8k8 .tf32 (lane = 4 * group + tig), one fp32 value a register:
//   A (16 x 8, row major): a0 = (row group, k tig), a1 = (row group + 8,
//     k tig), a2 = (row group, k tig + 4), a3 = (row group + 8, k tig + 4);
//   B (8 x 8, column major): b0 = (k tig, n group), b1 = (k tig + 4, n group);
//   C / D: as m16n8k16 above.
// split_tf32: hi = v rounded to TF32 (10 stored mantissa bits, to nearest,
// ties away from zero: the bits cvt.rna.tf32.f32 gives for every non-NaN
// v, by two integer operations where the cvt's SASS adds a NaN test and a
// select) and lo = v - hi (exact) cut to TF32, so hi + lo carries v to
// ~2^-22 of |v|, and hi.hi + hi.lo + lo.hi (mma_tf32x3; lo.lo is dropped)
// gives an fp32-accurate product from three TF32 passes.  A NaN v gives
// hi = +-0 and a NaN lo, so its products stay NaN.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  constexpr uint32_t kTf32 = 0xffffe000u;
  hi = (__float_as_uint(v) + 0x1000u) & kTf32;
  lo = __float_as_uint(v - __uint_as_float(hi)) & kTf32;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a.b in three TF32 passes, the small terms first
__device__ __forceinline__ void mma_tf32x3(float (&d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const uint32_t (&b_hi)[2],
                                           const uint32_t (&b_lo)[2]) {
  mma_tf32(d, a_lo, b_hi[0], b_hi[1]);
  mma_tf32(d, a_hi, b_lo[0], b_lo[1]);
  mma_tf32(d, a_hi, b_hi[0], b_hi[1]);
}

// 2^x on the special-function unit (ex2.approx.ftz: -1e30 gives +0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace repro
