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

// floor(a / b) for b > 0 (C's / truncates toward zero)
__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// [lo, hi) of the BK-column KV tiles that some row of a q tile can see,
// from the smallest and largest position of its rows (padding included):
// causal keeps the tiles whose first column is <= qmax, a window those
// whose last column is > qmin - window, and every tile starts below Tk.
// Every tile outside the range is masked for every row of the q tile.
// The flash kernels' bf16 routes walk it;
// kernels/flash_attention.py::flash_kv_tiles is its plain mirror.
template <int BK>
__device__ __forceinline__ void kv_tile_range(int Tk, int causal, int window,
                                              int qmin, int qmax, int& lo,
                                              int& hi) {
  lo = 0;
  hi = (Tk + BK - 1) / BK;
  if (causal) hi = min(hi, max(floor_div(qmax, BK) + 1, 0));
  if (window > 0) lo = max(lo, floor_div(qmin - window + 1, BK));
}

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
