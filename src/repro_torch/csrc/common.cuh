// Shared helpers of the port's hand-written Hopper kernels (sm_90a).
//
// The kernels take fp32 or bf16 tensors and do all arithmetic in fp32, with
// the masking constants of the JAX package's Pallas kernels
// (src/repro/kernels/flash_attention.py:47-50): a masked score is NEG_INF
// and the running max is floored at M_FLOOR before it is subtracted, so
// exp(NEG_INF - M_FLOOR) == 0 exactly and a fully masked row keeps l == 0,
// which gives an exact-zero output row.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

constexpr float kNegInf = -1e30f;
constexpr float kMFloor = -1e25f;

// dtype codes passed from the Python wrappers
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

}  // namespace repro
