// Fused double affine modulation + LeakyReLU (kernel K1), forward and
// backward, sm_90a.
//
//   out = lrelu(g2 * lrelu(g1 * x + b1) + b2),  slope 0.2
//   x, out [B, H, W, C] (NHWC, contiguous); g1, b1, g2, b2 [B, C].
//
// Replaces: the Pallas TPU kernels of gan_codes_tpu/ops/pallas/fused_affine.py
// (forward: `_fwd_kernel` via `_fwd`; backward: `_bwd_kernel` via `_bwd_call`,
// the custom VJP of the public `fused_double_affine_leaky`).
//
// Bound on the H100: bytes, in both directions. The forward reads x and
// writes out; the backward reads x and dy and writes dx (the four [B, C]
// gradients are negligible). Each element costs a handful of flops, far
// below the ~20 flop/byte the card needs before its fp32 units, let alone
// its tensor cores, become the limit. The least times are 2 (forward) and
// 3 (backward) * B*H*W*C * sizeof(T) over the 3.35 TB/s of HBM3.
//
// Forward design: one grid-stride pass, each thread moving 16 bytes per
// access (4 fp32 or 8 bf16 values along C, one 128-bit load and one 128-bit
// store), so a warp touches 512 contiguous bytes. The per-(b, c) scale/shift
// vectors are tiny (B*C) and stay in L1/L2 through read-only loads. When C
// is not a multiple of the vector width, or a pointer is not 16-byte
// aligned, the scalar instantiation (VEC = 1) runs instead.
//
// Backward design: the TPU kernel walks the H*W tiles of a sample in order
// and accumulates dg1/db1/dg2/db2 in its resident output block. Hopper runs
// blocks in no order, so the sum over H*W is split in two passes:
//   1. one block per (sample, tile of pixels): threads lie along C with
//      16-byte loads of x and dy and a 16-byte store of dx; each thread
//      keeps fp32 partial sums of its channels over its pixels, the block
//      adds its rows in a fixed order in shared memory and writes one fp32
//      partial per (sample, tile, gradient, channel) to scratch the wrapper
//      allocated;
//   2. one thread per (sample, gradient, channel) adds the tiles' partials
//      in tile order and rounds once to T.
// No atomics: the result repeats bit for bit from run to run.
//
// Numerics: the math follows x's dtype like the TPU kernel and the plain
// PyTorch version: every elementwise multiply and add is rounded to T
// (`mod_chain` and `mul_t` in common.cuh), the masks are taken as y >= 0
// (slope 1 at exactly 0, as the TPU kernel takes it). The forward and dx
// are therefore expected to equal the plain version of the same dtype. The
// four per-sample gradients add the products (each rounded to T) in fp32
// and round once at the end, as the plain version does; the TPU kernel adds
// its tile sums in T. Only the order of the fp32 additions differs from the
// plain version.

#include <stdint.h>

#include "common.cuh"

namespace {

using gct::from_f;
using gct::kSlope;
using gct::mod_chain;
using gct::mul_t;
using gct::rt;
using gct::to_f;

constexpr int kThreads = 256;
// Pixels per backward tile: about this many elements of x per block.
constexpr int kBwdTileElems = 16384;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
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

// Pass 1 of the backward. Block `blockIdx.x` = sample * n_tiles + tile.
// Thread t handles channel vector `lane = t % lanes` (VEC channels) of the
// pixels p0 + row, p0 + row + rows, ... (row = t / lanes), so a warp reads
// consecutive 16-byte chunks of consecutive pixels. When C / VEC exceeds
// the block, the channels are walked in chunks of `lanes` vectors.
// partial [B, n_tiles, 4, C] fp32: gradients in the order g1, b1, g2, b2.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
fused_affine_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g1,
                        const T* __restrict__ b1, const T* __restrict__ g2,
                        const T* __restrict__ b2, const T* __restrict__ dy,
                        T* __restrict__ dx, float* __restrict__ partial,
                        long long hw, int c, int tile_p, int n_tiles) {
  __shared__ float red[kThreads * 4 * VEC];
  const long long b = blockIdx.x / n_tiles;
  const int tile = (int)(blockIdx.x % n_tiles);
  const int nvc = c / VEC;
  const int lanes = nvc < kThreads ? nvc : kThreads;
  const int rows = kThreads / lanes;
  const int lane = threadIdx.x % lanes;
  const int row = threadIdx.x / lanes;
  const long long p0 = (long long)tile * tile_p;
  const long long p1 = p0 + tile_p < hw ? p0 + tile_p : hw;

  for (int cv0 = 0; cv0 < nvc; cv0 += lanes) {
    const int cv = cv0 + lane;
    float acc[4][VEC];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[j][k] = 0.f;

    if (row < rows && cv < nvc) {
      const long long gb = b * c + (long long)cv * VEC;
      float vg1[VEC], vb1[VEC], vg2[VEC], vb2[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        vg1[k] = to_f<T>(__ldg(g1 + gb + k));
        vb1[k] = to_f<T>(__ldg(b1 + gb + k));
        vg2[k] = to_f<T>(__ldg(g2 + gb + k));
        vb2[k] = to_f<T>(__ldg(b2 + gb + k));
      }
      for (long long p = p0 + row; p < p1; p += rows) {
        const long long off = ((b * hw + p) * c) / VEC + cv;  // in Packs
        const Pack<T, VEC> xin = reinterpret_cast<const Pack<T, VEC>*>(x)[off];
        const Pack<T, VEC> din = reinterpret_cast<const Pack<T, VEC>*>(dy)[off];
        Pack<T, VEC> dxo;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float xv = to_f<T>(xin.v[k]);
          const float dv = to_f<T>(din.v[k]);
          // recompute the forward exactly as mod_chain rounds it
          const float y1 = rt<T>(__fadd_rn(mul_t<T>(vg1[k], xv), vb1[k]));
          const bool pos1 = y1 >= 0.f;
          const float h = pos1 ? y1 : mul_t<T>(y1, kSlope);
          const float y2 = rt<T>(__fadd_rn(mul_t<T>(vg2[k], h), vb2[k]));
          const float dy2 = y2 >= 0.f ? dv : mul_t<T>(dv, kSlope);
          const float dh = mul_t<T>(dy2, vg2[k]);
          const float dy1 = pos1 ? dh : mul_t<T>(dh, kSlope);
          dxo.v[k] = from_f<T>(mul_t<T>(dy1, vg1[k]));
          acc[0][k] += mul_t<T>(dy1, xv);
          acc[1][k] += dy1;
          acc[2][k] += mul_t<T>(dy2, h);
          acc[3][k] += dy2;
        }
        reinterpret_cast<Pack<T, VEC>*>(dx)[off] = dxo;
      }
    }

    // Block reduction over rows, in row order.
    __syncthreads();  // the previous chunk's readers are done with `red`
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        red[(threadIdx.x * 4 + j) * VEC + k] = acc[j][k];
    __syncthreads();
    for (int o = threadIdx.x; o < lanes * 4 * VEC; o += kThreads) {
      const int l = o / (4 * VEC);
      const int jk = o % (4 * VEC);
      if (cv0 + l >= nvc) continue;
      float s = 0.f;
      for (int r = 0; r < rows; ++r) s += red[(r * lanes + l) * 4 * VEC + jk];
      const int j = jk / VEC;
      const int ch = (cv0 + l) * VEC + jk % VEC;
      partial[((b * n_tiles + tile) * 4 + j) * (long long)c + ch] = s;
    }
  }
}

// Pass 2 of the backward: one thread per (sample, gradient, channel) adds
// the tiles' partials in tile order, rounds once to T.
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_affine_bwd_reduce_kernel(const float* __restrict__ partial,
                               T* __restrict__ dg1, T* __restrict__ db1,
                               T* __restrict__ dg2, T* __restrict__ db2,
                               long long batch, int c, int n_tiles) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * 4 * c) return;
  const long long b = i / (4LL * c);
  const int j = (int)((i / c) % 4);
  const int ch = (int)(i % c);
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t)
    s += partial[((b * n_tiles + t) * 4 + j) * (long long)c + ch];
  T* out = j == 0 ? dg1 : j == 1 ? db1 : j == 2 ? dg2 : db2;
  out[b * c + ch] = from_f<T>(s);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int launch_fwd(const void* x, const void* g1, const void* b1, const void* g2,
               const void* b2, void* out, long long batch, long long hw, int c,
               cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long n = batch * hw * c;
  const long long max_blocks = 132LL * 16;  // 16 blocks per SM, grid-stride
  const bool vec_ok = (c % kVec == 0) && aligned16(x) && aligned16(out);
  const long long n_vec = vec_ok ? n / kVec : n;
  long long blocks = (n_vec + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  const T* xp = static_cast<const T*>(x);
  T* op = static_cast<T*>(out);
  if (vec_ok) {
    fused_affine_fwd_kernel<T, kVec><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xp, static_cast<const T*>(g1), static_cast<const T*>(b1),
        static_cast<const T*>(g2), static_cast<const T*>(b2), op, n_vec,
        hw * c, c);
  } else {
    fused_affine_fwd_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xp, static_cast<const T*>(g1), static_cast<const T*>(b1),
        static_cast<const T*>(g2), static_cast<const T*>(b2), op, n_vec,
        hw * c, c);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, const void* g1, const void* b1, const void* g2,
               const void* b2, const void* dy, void* dx, void* dg1, void* db1,
               void* dg2, void* db2, float* partial, long long batch,
               long long hw, int c, int tile_p, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const int n_tiles = (int)((hw + tile_p - 1) / tile_p);
  const long long blocks = batch * n_tiles;
  const bool vec_ok = (c % kVec == 0) && aligned16(x) && aligned16(dy) &&
                      aligned16(dx);
  const T* xp = static_cast<const T*>(x);
  const T* g1p = static_cast<const T*>(g1);
  const T* b1p = static_cast<const T*>(b1);
  const T* g2p = static_cast<const T*>(g2);
  const T* b2p = static_cast<const T*>(b2);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  if (vec_ok) {
    fused_affine_bwd_kernel<T, kVec><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xp, g1p, b1p, g2p, b2p, dyp, dxp, partial, hw, c, tile_p, n_tiles);
  } else {
    fused_affine_bwd_kernel<T, 1><<<(unsigned)blocks, kThreads, 0, stream>>>(
        xp, g1p, b1p, g2p, b2p, dyp, dxp, partial, hw, c, tile_p, n_tiles);
  }
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const long long n_out = batch * 4 * c;
  fused_affine_bwd_reduce_kernel<T>
      <<<(unsigned)((n_out + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
          partial, static_cast<T*>(dg1), static_cast<T*>(db1),
          static_cast<T*>(dg2), static_cast<T*>(db2), batch, c, n_tiles);
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
  if (dtype == 0)
    return launch_fwd<float>(x, g1, b1, g2, b2, out, batch, hw, c, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, g1, b1, g2, b2, out, batch, hw, c, s);
  return (int)cudaErrorInvalidValue;
}

// Pixels per backward tile for C channels; the wrapper sizes `partial` as
// [batch, ceil(hw / tile), 4, c] fp32 from it.
extern "C" int gct_fused_affine_bwd_tile(int c) {
  const int t = c > 0 ? kBwdTileElems / c : 1;
  return t > 0 ? t : 1;
}

// Backward of gct_fused_affine_fwd: dx [B, H*W, C] and the per-sample
// dg1, db1, dg2, db2 [B, C] (sums over H*W), all in x's dtype, from x, the
// four vectors and dy. `partial` is fp32 scratch of
// batch * ceil(hw / tile_p) * 4 * c floats. Two launches; returns
// cudaGetLastError() after them (0 on success). The caller handles
// hw == 0 (no pixels: the sums are zeros).
extern "C" int gct_fused_affine_bwd(const void* x, const void* g1,
                                    const void* b1, const void* g2,
                                    const void* b2, const void* dy, void* dx,
                                    void* dg1, void* db1, void* dg2,
                                    void* db2, void* partial,
                                    long long batch, long long hw, int c,
                                    int tile_p, int dtype, void* stream) {
  if (batch * hw * c == 0) return 0;
  if (c <= 0 || tile_p <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  if (dtype == 0)
    return launch_bwd<float>(x, g1, b1, g2, b2, dy, dx, dg1, db1, dg2, db2,
                             part, batch, hw, c, tile_p, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, g1, b1, g2, b2, dy, dx, dg1, db1, dg2,
                                     db2, part, batch, hw, c, tile_p, s);
  return (int)cudaErrorInvalidValue;
}
