// Device helpers shared by the generator kernels (fused_affine.cu, K1
// forward and backward; fused_modconv.cu, K2; fused_resblock.cu, K3): dtype
// conversion, the double affine modulation, and its bf16-pair form.
//
// The kernels round every modulation op to the working dtype T with
// round-to-nearest intrinsics and no FMA contraction, as the plain PyTorch
// version does one op at a time. That is what makes K1 equal its plain
// version bit for bit, and what K2's halo-tile modulation relies on, so the
// chain lives here once.
#pragma once

#include <stdint.h>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace gct {

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

// The LeakyReLU slope, 0.2 rounded to T as JAX rounds its weak-typed
// scalar: 0.2f in fp32, bf16(0.2) = 0.2001953125 in bf16. A bf16 value
// times it is exact in fp32 (8 + 8 significant bits), so mul_t rounds once,
// to JAX's bf16 product.
template <typename T> constexpr float kSlope = 0.2f;
template <> constexpr float kSlope<__nv_bfloat16> = 0.2001953125f;

template <typename T>
__device__ __forceinline__ float lrelu_t(float y) {
  return y >= 0.f ? y : mul_t<T>(y, kSlope<T>);
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

// bf16 pairs (K1, and K3's A chunks): the 16-byte vector of 8 bf16
// channels as 4 words of two, channel 2j in the low half of word j. mul and
// add are Hopper's native bf16x2 ops, rounded to nearest: a bf16 product or
// sum computed in fp32 and rounded to bf16 (mul_t above, and the plain
// version) is the same number, as fp32 has more than 2 * 8 + 2 significant
// bits. The slope is kSlope<bf16> in both halves, multiplied natively. Half
// the instructions of the fp32 emulation, and no unpacked copies of g and b.
namespace bf2 {

// the 16-byte vector path of bf16 takes these helpers
template <typename T, int VEC>
constexpr bool kPacked = sizeof(T) == 2 && VEC == 8;

__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ float lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// {lo, hi} rounded to nearest into one word, lo in the low half
__device__ __forceinline__ uint32_t pack(float l, float h) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(h), "f"(l));
  return d;
}

// bf16(0.2) = 0x3E4D in both halves
__device__ __forceinline__ uint32_t slope(uint32_t y) {
  return mul(y, 0x3E4D3E4Du);
}

// 0xffff in each half where y < 0 (not -0): the slope applies there, as
// the y >= 0 test leaves it
__device__ __forceinline__ uint32_t neg_mask(uint32_t y) {
  const uint32_t nonzero = (y & 0x7fff7fffu) + 0x7fff7fffu;
  return ((y & nonzero & 0x80008000u) >> 15) * 0xffffu;
}

__device__ __forceinline__ uint32_t select(uint32_t pos, uint32_t neg,
                                           uint32_t m) {
  return (pos & ~m) | (neg & m);
}

__device__ __forceinline__ const uint32_t* words(const void* p) {
  return reinterpret_cast<const uint32_t*>(p);
}

}  // namespace bf2

}  // namespace gct
