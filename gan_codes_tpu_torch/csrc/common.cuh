// Device helpers shared by the DFBlock kernels (fused_affine.cu, K1 forward
// and backward, and fused_modconv.cu, K2): dtype conversion and the double
// affine modulation.
//
// Both kernels round every modulation op to the working dtype T with
// round-to-nearest intrinsics and no FMA contraction, as the plain PyTorch
// version does one op at a time. That is what makes K1 equal its plain
// version bit for bit, and what K2's halo-tile modulation relies on, so the
// chain lives here once.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace gct {

constexpr float kSlope = 0.2f;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round a float to T and back: an op "in T's precision".
template <typename T> __device__ __forceinline__ float rt(float v) {
  return to_f<T>(from_f<T>(v));
}

// a * b rounded to T, never contracted into an FMA.
template <typename T> __device__ __forceinline__ float mul_t(float a, float b) {
  return rt<T>(__fmul_rn(a, b));
}

template <typename T>
__device__ __forceinline__ float lrelu_t(float y) {
  return y >= 0.f ? y : mul_t<T>(y, kSlope);
}

// lrelu(g2 * lrelu(g1 * x + b1) + b2), each op rounded to T.
template <typename T>
__device__ __forceinline__ float mod_chain(float x, float g1, float b1,
                                           float g2, float b2) {
  float y = rt<T>(__fadd_rn(mul_t<T>(g1, x), b1));
  y = lrelu_t<T>(y);
  float z = rt<T>(__fadd_rn(mul_t<T>(g2, y), b2));
  return lrelu_t<T>(z);
}

}  // namespace gct
