// Fused double affine modulation + LeakyReLU -> SAME 3x3 conv (kernel K2,
// forward), sm_90a.
//
//   h   = lrelu(g2 * lrelu(g1 * x + b1) + b2)           (slope 0.2)
//   out = conv3x3_same(h, w) + bias                     (fp32 accumulation)
//   x [B, H, W, Cin] NHWC; g*, b* [B, Cin]; w [3, 3, Cin, Cout] HWIO;
//   bias [Cout]; out [B, H, W, Cout]. All contiguous, one dtype.
//
// Replaces: the Pallas TPU kernel gan_codes_tpu/ops/pallas/fused_modconv.py
// (`_kernel` via `_fused_forward`, public `fused_modconv3x3`).
//
// Bound on the H100: operations. A DFBlock conv does 2 * 9 * Cin * Cout
// flops per output pixel against (Cin + Cout) * sizeof(T) bytes of
// activations, i.e. hundreds of flops per byte at Cin, Cout >= 32. This
// first version runs on the fp32 CUDA cores (67 TFLOP/s peak), not the
// tensor cores, so its bound is flops over that rate in fp32 and over the
// bf16 tensor-core rate in bf16, where it is far from the bound.
//
// Design: a direct convolution, one block per (8 x 16 output pixels,
// 64 output channels, sample). For each chunk of 8 input channels the block
//   1. loads the 10 x 18 x 8 halo tile of x into shared memory and applies
//      the double modulation there, to in-bounds pixels only: the SAME
//      padding stays exactly 0 (g * 0 + b != 0, the trap the TPU kernel
//      masks out after the fact);
//   2. loads the 3 x 3 x 8 x 64 weight slice into shared memory;
//   3. accumulates the 9 taps x 8 channels into fp32 registers: each thread
//      owns 4 neighbouring pixels of one row x 8 output channels (32
//      accumulators), reusing 6 loaded inputs across the 3 horizontal taps
//      and two 128-bit weight loads across its 4 pixels.
// h never goes to device memory, which is what the fusion is for. 24 KB of
// static shared memory per block lets several blocks share an SM and hide
// each other's load phases. Limits (checked by the host wrapper and here):
// Cout % 64 == 0; any batch, H, W and Cin (edges are masked; the grid is
// 1-D, with room for 2^31 - 1 blocks).
//
// Numerics: the modulation rounds every op to T as the plain PyTorch
// version does; the conv multiplies T-valued h and w in fp32 and sums in
// fp32, in another order than cuDNN. In bf16 the sum is rounded to bf16
// before the bias add, as a bf16 cuDNN conv followed by `+ bias` rounds it.

#include <stdint.h>

#include "common.cuh"

namespace {

using gct::from_f;
using gct::mod_chain;
using gct::rt;
using gct::to_f;

constexpr int TH = 8;      // output rows per block
constexpr int TW = 16;     // output columns per block
constexpr int CI = 8;      // input channels per shared-memory chunk
constexpr int CO = 64;     // output channels per block
constexpr int kThreads = 256;
constexpr int kHaloH = TH + 2;
constexpr int kHaloW = TW + 2;

template <typename T>
struct alignas(sizeof(T) * 4) Pack4 {
  T v[4];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_modconv3x3_kernel(const T* __restrict__ x, const T* __restrict__ g1,
                        const T* __restrict__ b1, const T* __restrict__ g2,
                        const T* __restrict__ b2, const T* __restrict__ w,
                        const T* __restrict__ bias, T* __restrict__ out,
                        int H, int W, int Cin, int Cout, int tiles_w,
                        int tiles) {
  __shared__ float s_in[CI][kHaloH][kHaloW];
  __shared__ __align__(16) float s_w[9][CI][CO];

  const int tid = threadIdx.x;
  // A 1-D grid over (sample, Cout tile, pixel tile), pixel tile fastest:
  // no 65535 cap on the batch, and all Cout tiles of one sample run close
  // together, so its x tile is still in L2 when the next Cout tile reads it.
  const int n_co = Cout / CO;
  const int tile = blockIdx.x % tiles;
  const int co0 = (blockIdx.x / tiles % n_co) * CO;
  const int b = blockIdx.x / tiles / n_co;
  const int th0 = (tile / tiles_w) * TH;
  const int tw0 = (tile % tiles_w) * TW;

  // Thread -> (4 pixels of one row) x (output channels cg*4..+3 and
  // 32+cg*4..+3). A warp covers one row's 16 pixels x all 64 channels.
  const int cg = tid & 7;
  const int pg = tid >> 3;
  const int py = pg >> 2;
  const int px = (pg & 3) * 4;

  const T* xb = x + (size_t)b * H * W * Cin;
  const T* g1b = g1 + (size_t)b * Cin;
  const T* b1b = b1 + (size_t)b * Cin;
  const T* g2b = g2 + (size_t)b * Cin;
  const T* b2b = b2 + (size_t)b * Cin;

  float acc[4][8];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[p][j] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += CI) {
    // 1. halo tile, modulated in place; padding and channel tail stay 0
    for (int i = tid; i < CI * kHaloH * kHaloW; i += kThreads) {
      const int c = i % CI;
      const int pix = i / CI;
      const int col = pix % kHaloW;
      const int row = pix / kHaloW;
      const int hh = th0 + row - 1;
      const int ww = tw0 + col - 1;
      const int ci = ci0 + c;
      float v = 0.f;
      if (hh >= 0 && hh < H && ww >= 0 && ww < W && ci < Cin) {
        v = mod_chain<T>(to_f<T>(xb[((size_t)hh * W + ww) * Cin + ci]),
                         to_f<T>(__ldg(g1b + ci)), to_f<T>(__ldg(b1b + ci)),
                         to_f<T>(__ldg(g2b + ci)), to_f<T>(__ldg(b2b + ci)));
      }
      s_in[c][row][col] = v;
    }
    // 2. weight slice w[:, :, ci0:ci0+CI, co0:co0+CO]
    for (int i = tid; i < 9 * CI * CO; i += kThreads) {
      const int co = i % CO;
      const int r = i / CO;
      const int c = r % CI;
      const int tap = r / CI;
      const int ci = ci0 + c;
      float v = 0.f;
      if (ci < Cin) v = to_f<T>(w[((size_t)tap * Cin + ci) * Cout + co0 + co]);
      s_w[tap][c][co] = v;
    }
    __syncthreads();

    // 3. 9 taps x CI channels into the register tile
#pragma unroll
    for (int c = 0; c < CI; ++c) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        float xin[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) xin[k] = s_in[c][py + dy][px + k];
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float4 wa =
              *reinterpret_cast<const float4*>(&s_w[dy * 3 + dx][c][cg * 4]);
          const float4 wb = *reinterpret_cast<const float4*>(
              &s_w[dy * 3 + dx][c][32 + cg * 4]);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const float xv = xin[p + dx];
            acc[p][0] = fmaf(xv, wa.x, acc[p][0]);
            acc[p][1] = fmaf(xv, wa.y, acc[p][1]);
            acc[p][2] = fmaf(xv, wa.z, acc[p][2]);
            acc[p][3] = fmaf(xv, wa.w, acc[p][3]);
            acc[p][4] = fmaf(xv, wb.x, acc[p][4]);
            acc[p][5] = fmaf(xv, wb.y, acc[p][5]);
            acc[p][6] = fmaf(xv, wb.z, acc[p][6]);
            acc[p][7] = fmaf(xv, wb.w, acc[p][7]);
          }
        }
      }
    }
    __syncthreads();
  }

  // epilogue: + bias in T, 4-wide stores
  float bv[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bv[j] = to_f<T>(__ldg(bias + co0 + cg * 4 + j));
    bv[4 + j] = to_f<T>(__ldg(bias + co0 + 32 + cg * 4 + j));
  }
  const int hh = th0 + py;
  if (hh >= H) return;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int ww = tw0 + px + p;
    if (ww >= W) continue;
    T* o = out + (((size_t)b * H + hh) * W + ww) * Cout + co0;
    Pack4<T> lo, hi;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo.v[j] = from_f<T>(__fadd_rn(rt<T>(acc[p][j]), bv[j]));
      hi.v[j] = from_f<T>(__fadd_rn(rt<T>(acc[p][4 + j]), bv[4 + j]));
    }
    *reinterpret_cast<Pack4<T>*>(o + cg * 4) = lo;
    *reinterpret_cast<Pack4<T>*>(o + 32 + cg * 4) = hi;
  }
}

template <typename T>
int launch(const void* x, const void* g1, const void* b1, const void* g2,
           const void* b2, const void* w, const void* bias, void* out,
           int batch, int H, int W, int Cin, int Cout, cudaStream_t stream) {
  const int tiles_w = (W + TW - 1) / TW;
  const long long tiles = (long long)((H + TH - 1) / TH) * tiles_w;
  // grid.x holds up to 2^31 - 1 blocks: more blocks than the output of any
  // batch that fits in device memory needs, so this is no limit in practice
  const long long blocks = tiles * (Cout / CO) * batch;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fused_modconv3x3_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g1),
      static_cast<const T*>(b1), static_cast<const T*>(g2),
      static_cast<const T*>(b2), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<T*>(out), H, W, Cin, Cout,
      tiles_w, (int)tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for a shape the kernel
// does not take (Cout % 64 != 0, an empty grid, more than 2^31 - 1 blocks).
extern "C" int gct_fused_modconv3x3_fwd(const void* x, const void* g1,
                                        const void* b1, const void* g2,
                                        const void* b2, const void* w,
                                        const void* bias, void* out,
                                        int batch, int H, int W, int Cin,
                                        int Cout, int dtype, void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 ||
      Cout % CO != 0)
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(out) & 15u) != 0)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, g1, b1, g2, b2, w, bias, out, batch, H, W, Cin,
                         Cout, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, g1, b1, g2, b2, w, bias, out, batch, H,
                                 W, Cin, Cout, s);
  return (int)cudaErrorInvalidValue;
}
