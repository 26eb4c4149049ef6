// Fused double affine modulation + LeakyReLU (kernel K1, forward), sm_90a.
//
//   out = lrelu(g2 * lrelu(g1 * x + b1) + b2),  slope 0.2
//   x, out [B, H, W, C] (NHWC, contiguous); g1, b1, g2, b2 [B, C].
//
// Replaces: the Pallas TPU kernel gan_codes_tpu/ops/pallas/fused_affine.py
// (`_fwd_kernel` via `_fwd`, public `fused_double_affine_leaky`).
//
// Bound on the H100: bytes. Each element is read once and written once and
// costs a handful of flops, far below the ~20 flop/byte the card needs
// before its fp32 units, let alone its tensor cores, become the limit. The
// least time is 2 * B*H*W*C * sizeof(T) over the 3.35 TB/s of HBM3.
//
// Design: one grid-stride pass, each thread moving 16 bytes per access
// (4 fp32 or 8 bf16 values along C, one 128-bit load and one 128-bit store),
// so a warp touches 512 contiguous bytes. The per-(b, c) scale/shift
// vectors are tiny (B*C) and stay in L1/L2 through read-only loads. When C
// is not a multiple of the vector width, or a pointer is not 16-byte
// aligned, the scalar instantiation (VEC = 1) runs instead.
//
// Numerics: the math follows x's dtype like the TPU kernel and the plain
// PyTorch version: every multiply and add is rounded to T (`mod_chain` in
// common.cuh). There is no reduction to reorder, so the result is expected
// to equal the plain version of the same dtype.

#include <stdint.h>

#include "common.cuh"

namespace {

using gct::from_f;
using gct::mod_chain;
using gct::to_f;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(256)
fused_affine_fwd_kernel(const T* __restrict__ x, const T* __restrict__ g1,
                        const T* __restrict__ b1, const T* __restrict__ g2,
                        const T* __restrict__ b2, T* __restrict__ out,
                        long long n_vec, long long hwc, int c) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       v < n_vec; v += stride) {
    const long long e = v * VEC;
    const long long b = e / hwc;
    // c % VEC == 0, so the VEC elements share one sample and run along C.
    const long long gb = b * c + (int)(e % c);
    Pack<T, VEC> in = reinterpret_cast<const Pack<T, VEC>*>(x)[v];
    Pack<T, VEC> res;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float r = mod_chain<T>(to_f<T>(in.v[k]),
                                   to_f<T>(__ldg(g1 + gb + k)),
                                   to_f<T>(__ldg(b1 + gb + k)),
                                   to_f<T>(__ldg(g2 + gb + k)),
                                   to_f<T>(__ldg(b2 + gb + k)));
      res.v[k] = from_f<T>(r);
    }
    reinterpret_cast<Pack<T, VEC>*>(out)[v] = res;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int launch(const void* x, const void* g1, const void* b1, const void* g2,
           const void* b2, void* out, long long batch, long long hw, int c,
           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long n = batch * hw * c;
  const int threads = 256;
  const long long max_blocks = 132LL * 16;  // 16 blocks per SM, grid-stride
  const bool vec_ok = (c % kVec == 0) && aligned16(x) && aligned16(out);
  const long long n_vec = vec_ok ? n / kVec : n;
  long long blocks = (n_vec + threads - 1) / threads;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (vec_ok) {
    fused_affine_fwd_kernel<T, kVec><<<(unsigned)blocks, threads, 0, stream>>>(
        xp, static_cast<const T*>(g1), static_cast<const T*>(b1),
        static_cast<const T*>(g2), static_cast<const T*>(b2), op, n_vec,
        hw * c, c);
  } else {
    fused_affine_fwd_kernel<T, 1><<<(unsigned)blocks, threads, 0, stream>>>(
        xp, static_cast<const T*>(g1), static_cast<const T*>(b1),
        static_cast<const T*>(g2), static_cast<const T*>(b2), op, n_vec,
        hw * c, c);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success); launches nothing for an empty tensor.
extern "C" int gct_fused_affine_fwd(const void* x, const void* g1,
                                    const void* b1, const void* g2,
                                    const void* b2, void* out,
                                    long long batch, long long hw, int c,
                                    int dtype, void* stream) {
  if (batch * hw * c == 0) return 0;
  if (c <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, g1, b1, g2, b2, out, batch, hw, c, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, g1, b1, g2, b2, out, batch, hw, c, s);
  return (int)cudaErrorInvalidValue;
}
