// The whole generator residual block in one pass (kernel K3, forward),
// sm_90a.
//
//   h1  = conv3x3_same(lrelu(g2 * lrelu(g1 * x + b1) + b2), w1) + c1
//   h2  = conv3x3_same(lrelu(g4 * lrelu(g3 * h1 + b3) + b4), w2) + c2
//   out = shortcut + gamma * h2,   shortcut = x, or conv1x1(x, ws) + cs
//   x [B, H, W, Cin] NHWC; g1, b1, g2, b2 [B, Cin]; w1 [3, 3, Cin, Cout]
//   HWIO; c1 [Cout]; g3, b3, g4, b4 [B, Cout]; w2 [3, 3, Cout, Cout];
//   c2 [Cout]; gamma [1]; ws [Cin, Cout] (the 1x1 kernel) and cs [Cout], or
//   both null (identity, Cin == Cout); out [B, H, W, Cout]. All contiguous,
//   one dtype (float32 or bfloat16).
//
// Replaces: the Pallas TPU kernel gan_codes_tpu/ops/pallas/fused_resblock.py
// (`_kernel` via `_fused_forward`, public `fused_resblock_g`).
//
// Bound on the H100: operations. The two 3x3 convs do 2 * 9 * (Cin + Cout)
// * Cout flops per output pixel against (Cin + Cout) * sizeof(T) bytes of
// activations in and out. This first version runs on the fp32 CUDA cores
// (67 TFLOP/s peak), so its bound is the flops over that rate in fp32 and
// over the bf16 tensor-core rate in bf16, where it is far from the bound.
//
// Design: one block of 256 threads per (sample, 8 x 16 output tile), all
// Cout channels. h1 never goes to device memory:
//   1. Stage 1, for each chunk of CO output channels: stream the 12 x 22
//      halo of x in chunks of 8 input channels, modulated in shared memory
//      (in-bounds pixels only: the SAME padding stays exactly 0), with the
//      matching w1 slice, and accumulate h1 over the tile plus a 1-pixel
//      halo (10 x 18 pixels; the 1.56x conv1 recompute at the tile seams is
//      the price of keeping h1 on chip). The epilogue rounds h1 to T as the
//      plain version does, applies the second modulation, and stores it in
//      shared memory as fp32; h1 pixels outside the image are stored as 0,
//      the padding of conv2, never modulated.
//   2. Stage 2, for each chunk of CO output channels: conv2 from the
//      resident modulated h1 (all Cout input channels), then the 1x1
//      shortcut (raw x re-read from L2 in chunks of 8 channels), then
//      out = shortcut + gamma * h2, rounded where the plain version rounds.
// Each thread owns 4 neighbouring pixels of a row x 8 output channels per
// pixel group (K2's register tile): stage 1 has 50 groups of 4 (a 10 x 20
// region, of which 18 columns are kept), stage 2 has 32. CO is 64 where
// Cout allows it, else 32 (the Cout-32 block of the 256px generator).
// Shared memory: Cout * 10 * 18 floats of h1 (180 KB at Cout 256) + the x
// chunk (8.3 KB) + the weight chunk (18 KB at CO 64): 206 KB at Cout 256,
// one block per SM, above 48 KB through the opt-in attribute. Limits
// (checked by the host wrapper and here): Cout % 32 == 0 and Cout <= 256;
// any batch, H, W and Cin.
//
// Numerics: every modulation op is rounded to T (common.cuh's mod_chain);
// each conv multiplies T-valued inputs and weights in fp32 and sums in
// fp32, in another order than cuDNN; conv outputs are rounded to T before
// the bias add, gamma * h2 and the residual sum are rounded to T, as the
// plain PyTorch version computes them one op at a time.

#include <stdint.h>

#include "common.cuh"

namespace {

using gct::from_f;
using gct::mod_chain;
using gct::rt;
using gct::to_f;

constexpr int TH = 8;        // output rows per block
constexpr int TW = 16;       // output columns per block
constexpr int CI = 8;        // input channels per shared-memory chunk
constexpr int kThreads = 256;
constexpr int H1_ROWS = TH + 2;                    // h1 rows a tile needs
constexpr int H1_COLS = TW + 2;                    // h1 columns kept
constexpr int H1_GPR = (H1_COLS + 3) / 4;          // 4-pixel groups per row
constexpr int H1_GROUPS = H1_ROWS * H1_GPR;        // 50
constexpr int X_ROWS = H1_ROWS + 2;                // x halo rows
constexpr int X_COLS = H1_GPR * 4 + 2;             // x halo columns read
constexpr int OUT_GPR = TW / 4;
constexpr int OUT_GROUPS = TH * OUT_GPR;           // 32
constexpr int X_CHUNK = CI * X_ROWS * X_COLS;      // floats
constexpr int H1_PLANE = H1_ROWS * H1_COLS;        // floats per channel

template <typename T>
struct alignas(sizeof(T) * 4) Pack4 {
  T v[4];
};

// Threads -> (CG channel groups of 8) x (PG pixel groups), CO = 8 * CG.
template <int CO>
struct Tiling {
  static constexpr int CG = CO / 8;
  static constexpr int PG = kThreads / CG;
  static constexpr int NG1 = (H1_GROUPS + PG - 1) / PG;
  static constexpr int NG2 = (OUT_GROUPS + PG - 1) / PG;
};

// The two output channels j and 4 + j of a thread's 8: cg * 4 + j and
// CO / 2 + cg * 4 + j of the chunk.
template <int CO>
__device__ __forceinline__ int chan(int cg, int j) {
  return j < 4 ? cg * 4 + j : CO / 2 + cg * 4 + (j - 4);
}

// acc[p][j] += sum over CI channels and 9 taps of
//   src[c][row + dy][col + p + dx] * w[dy * 3 + dx][c][chan(j)]
// src is [CI][SR][SC] fp32, w is [9][CI][CO] fp32, both in shared memory.
template <int CO, int SR, int SC>
__device__ __forceinline__ void conv_taps(float (&acc)[4][8],
                                          const float* src, const float* w,
                                          int row, int col, int cg) {
#pragma unroll
  for (int c = 0; c < CI; ++c) {
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      float xin[6];
      const float* s = src + (c * SR + row + dy) * SC + col;
#pragma unroll
      for (int k = 0; k < 6; ++k) xin[k] = s[k];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) {
        const float* wt = w + ((dy * 3 + dx) * CI + c) * CO;
        const float4 wa = *reinterpret_cast<const float4*>(wt + cg * 4);
        const float4 wb =
            *reinterpret_cast<const float4*>(wt + CO / 2 + cg * 4);
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
}

// w[tap][c][co] = wsrc[tap][ci0 + c][co0 + co] (0 past Cin_w), for a
// [taps, Cin_w, Cout] weight.
template <typename T, int CO>
__device__ __forceinline__ void load_weights(float* s_w, const T* wsrc,
                                             int taps, int ci0, int cin_w,
                                             int Cout, int co0, int tid) {
  for (int i = tid; i < taps * CI * CO; i += kThreads) {
    const int co = i % CO;
    const int r = i / CO;
    const int c = r % CI;
    const int tap = r / CI;
    const int ci = ci0 + c;
    s_w[i] = ci < cin_w
                 ? to_f<T>(wsrc[((size_t)tap * cin_w + ci) * Cout + co0 + co])
                 : 0.f;
  }
}

template <typename T, int CO>
__global__ void __launch_bounds__(kThreads)
fused_resblock_g_kernel(const T* __restrict__ x, const T* __restrict__ g1,
                        const T* __restrict__ b1, const T* __restrict__ g2,
                        const T* __restrict__ b2, const T* __restrict__ w1,
                        const T* __restrict__ c1, const T* __restrict__ g3,
                        const T* __restrict__ b3, const T* __restrict__ g4,
                        const T* __restrict__ b4, const T* __restrict__ w2,
                        const T* __restrict__ c2, const T* __restrict__ gamma,
                        const T* __restrict__ ws, const T* __restrict__ cs,
                        T* __restrict__ out, int H, int W, int Cin, int Cout,
                        int tiles_w, int tiles) {
  using Tl = Tiling<CO>;
  extern __shared__ __align__(16) float smem[];
  float* s_w = smem;                    // [9][CI][CO]
  float* s_x = s_w + 9 * CI * CO;       // [CI][X_ROWS][X_COLS]
  float* s_h1 = s_x + X_CHUNK;          // [Cout][H1_ROWS][H1_COLS]

  const int tid = threadIdx.x;
  const int cg = tid % Tl::CG;
  const int pg = tid / Tl::CG;
  // 1-D grid over (sample, pixel tile), pixel tile fastest
  const int tile = blockIdx.x % tiles;
  const int b = blockIdx.x / tiles;
  const int th0 = (tile / tiles_w) * TH;
  const int tw0 = (tile % tiles_w) * TW;

  const T* xb = x + (size_t)b * H * W * Cin;
  const T* g1b = g1 + (size_t)b * Cin;
  const T* b1b = b1 + (size_t)b * Cin;
  const T* g2b = g2 + (size_t)b * Cin;
  const T* b2b = b2 + (size_t)b * Cin;
  const T* g3b = g3 + (size_t)b * Cout;
  const T* b3b = b3 + (size_t)b * Cout;
  const T* g4b = g4 + (size_t)b * Cout;
  const T* b4b = b4 + (size_t)b * Cout;

  // ---- stage 1: modulated h1 over the tile + halo, into s_h1 ----
  for (int co0 = 0; co0 < Cout; co0 += CO) {
    float acc[Tl::NG1][4][8];
#pragma unroll
    for (int g = 0; g < Tl::NG1; ++g)
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[g][p][j] = 0.f;

    for (int ci0 = 0; ci0 < Cin; ci0 += CI) {
      // x halo rows th0-2.., columns tw0-2..; modulated where in bounds
      for (int i = tid; i < X_CHUNK; i += kThreads) {
        const int c = i % CI;
        const int pix = i / CI;
        const int col = pix % X_COLS;
        const int row = pix / X_COLS;
        const int hh = th0 + row - 2;
        const int ww = tw0 + col - 2;
        const int ci = ci0 + c;
        float v = 0.f;
        if (hh >= 0 && hh < H && ww >= 0 && ww < W && ci < Cin) {
          v = mod_chain<T>(to_f<T>(xb[((size_t)hh * W + ww) * Cin + ci]),
                           to_f<T>(__ldg(g1b + ci)), to_f<T>(__ldg(b1b + ci)),
                           to_f<T>(__ldg(g2b + ci)),
                           to_f<T>(__ldg(b2b + ci)));
        }
        s_x[(c * X_ROWS + row) * X_COLS + col] = v;
      }
      load_weights<T, CO>(s_w, w1, 9, ci0, Cin, Cout, co0, tid);
      __syncthreads();
#pragma unroll
      for (int g = 0; g < Tl::NG1; ++g) {
        const int gi = pg + g * Tl::PG;
        if (gi < H1_GROUPS)
          conv_taps<CO, X_ROWS, X_COLS>(acc[g], s_x, s_w, gi / H1_GPR,
                                        (gi % H1_GPR) * 4, cg);
      }
      __syncthreads();
    }

    // h1 = rt(conv) + c1 in T; then the second modulation, or 0 outside
    // the image (conv2's SAME padding)
#pragma unroll
    for (int g = 0; g < Tl::NG1; ++g) {
      const int gi = pg + g * Tl::PG;
      if (gi >= H1_GROUPS) continue;
      const int r = gi / H1_GPR;
      const int c0 = (gi % H1_GPR) * 4;
      const int hh = th0 + r - 1;
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int col = c0 + p;
        if (col >= H1_COLS) continue;
        const int ww = tw0 + col - 1;
        const bool inside = hh >= 0 && hh < H && ww >= 0 && ww < W;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int co = co0 + chan<CO>(cg, j);
          float v = 0.f;
          if (inside) {
            const float h = rt<T>(
                __fadd_rn(rt<T>(acc[g][p][j]), to_f<T>(__ldg(c1 + co))));
            v = mod_chain<T>(h, to_f<T>(__ldg(g3b + co)),
                             to_f<T>(__ldg(b3b + co)),
                             to_f<T>(__ldg(g4b + co)),
                             to_f<T>(__ldg(b4b + co)));
          }
          s_h1[co * H1_PLANE + r * H1_COLS + col] = v;
        }
      }
    }
  }
  __syncthreads();

  // ---- stage 2: conv2 from s_h1, shortcut, residual ----
  const float gam = to_f<T>(__ldg(gamma));
  for (int co0 = 0; co0 < Cout; co0 += CO) {
    float acc[Tl::NG2][4][8];
    float sacc[Tl::NG2][4][8];
#pragma unroll
    for (int g = 0; g < Tl::NG2; ++g)
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[g][p][j] = sacc[g][p][j] = 0.f;

    for (int ci0 = 0; ci0 < Cout; ci0 += CI) {
      load_weights<T, CO>(s_w, w2, 9, ci0, Cout, Cout, co0, tid);
      __syncthreads();
#pragma unroll
      for (int g = 0; g < Tl::NG2; ++g) {
        const int gi = pg + g * Tl::PG;
        if (gi < OUT_GROUPS)
          conv_taps<CO, H1_ROWS, H1_COLS>(acc[g], s_h1 + ci0 * H1_PLANE,
                                          s_w, gi / OUT_GPR,
                                          (gi % OUT_GPR) * 4, cg);
      }
      __syncthreads();
    }

    if (ws != nullptr) {
      // 1x1 shortcut over the raw x tile, [CI][TH][TW] in s_x
      for (int ci0 = 0; ci0 < Cin; ci0 += CI) {
        for (int i = tid; i < CI * TH * TW; i += kThreads) {
          const int c = i % CI;
          const int pix = i / CI;
          const int col = pix % TW;
          const int row = pix / TW;
          const int hh = th0 + row;
          const int ww = tw0 + col;
          const int ci = ci0 + c;
          float v = 0.f;
          if (hh < H && ww < W && ci < Cin)
            v = to_f<T>(xb[((size_t)hh * W + ww) * Cin + ci]);
          s_x[(c * TH + row) * TW + col] = v;
        }
        load_weights<T, CO>(s_w, ws, 1, ci0, Cin, Cout, co0, tid);
        __syncthreads();
#pragma unroll
        for (int g = 0; g < Tl::NG2; ++g) {
          const int gi = pg + g * Tl::PG;
          if (gi >= OUT_GROUPS) continue;
          const int py = gi / OUT_GPR;
          const int px = (gi % OUT_GPR) * 4;
#pragma unroll
          for (int c = 0; c < CI; ++c) {
            const float4 wa =
                *reinterpret_cast<const float4*>(s_w + c * CO + cg * 4);
            const float4 wb = *reinterpret_cast<const float4*>(
                s_w + c * CO + CO / 2 + cg * 4);
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              const float xv = s_x[(c * TH + py) * TW + px + p];
              sacc[g][p][0] = fmaf(xv, wa.x, sacc[g][p][0]);
              sacc[g][p][1] = fmaf(xv, wa.y, sacc[g][p][1]);
              sacc[g][p][2] = fmaf(xv, wa.z, sacc[g][p][2]);
              sacc[g][p][3] = fmaf(xv, wa.w, sacc[g][p][3]);
              sacc[g][p][4] = fmaf(xv, wb.x, sacc[g][p][4]);
              sacc[g][p][5] = fmaf(xv, wb.y, sacc[g][p][5]);
              sacc[g][p][6] = fmaf(xv, wb.z, sacc[g][p][6]);
              sacc[g][p][7] = fmaf(xv, wb.w, sacc[g][p][7]);
            }
          }
        }
        __syncthreads();
      }
    }

    // out = shortcut + rt(gamma * h2), each op rounded to T
#pragma unroll
    for (int g = 0; g < Tl::NG2; ++g) {
      const int gi = pg + g * Tl::PG;
      if (gi >= OUT_GROUPS) continue;
      const int hh = th0 + gi / OUT_GPR;
      if (hh >= H) continue;
      float c2v[8], csv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = co0 + chan<CO>(cg, j);
        c2v[j] = to_f<T>(__ldg(c2 + co));
        csv[j] = ws != nullptr ? to_f<T>(__ldg(cs + co)) : 0.f;
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int ww = tw0 + (gi % OUT_GPR) * 4 + p;
        if (ww >= W) continue;
        const size_t pix = ((size_t)hh * W + ww);
        Pack4<T> lo, hi;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int co = co0 + chan<CO>(cg, j);
          const float h2 = rt<T>(__fadd_rn(rt<T>(acc[g][p][j]), c2v[j]));
          const float gh = rt<T>(__fmul_rn(gam, h2));
          const float sc = ws != nullptr
                               ? rt<T>(__fadd_rn(rt<T>(sacc[g][p][j]), csv[j]))
                               : to_f<T>(xb[pix * Cin + co]);
          const T o = from_f<T>(__fadd_rn(sc, gh));
          if (j < 4)
            lo.v[j] = o;
          else
            hi.v[j - 4] = o;
        }
        T* op = out + ((size_t)b * H * W + pix) * Cout + co0;
        *reinterpret_cast<Pack4<T>*>(op + cg * 4) = lo;
        *reinterpret_cast<Pack4<T>*>(op + CO / 2 + cg * 4) = hi;
      }
    }
  }
}

template <int CO>
size_t smem_bytes(int Cout) {
  return (size_t)(9 * CI * CO + X_CHUNK + (size_t)Cout * H1_PLANE) *
         sizeof(float);
}

template <typename T, int CO>
int launch(const void* const* p, void* out, int batch, int H, int W, int Cin,
           int Cout, cudaStream_t stream) {
  const int tiles_w = (W + TW - 1) / TW;
  const long long tiles = (long long)((H + TH - 1) / TH) * tiles_w;
  const long long blocks = tiles * batch;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<CO>(Cout);
  cudaError_t e = cudaFuncSetAttribute(
      fused_resblock_g_kernel<T, CO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  auto t = [&](int i) { return static_cast<const T*>(p[i]); };
  fused_resblock_g_kernel<T, CO><<<(unsigned)blocks, kThreads, smem,
                                    stream>>>(
      t(0), t(1), t(2), t(3), t(4), t(5), t(6), t(7), t(8), t(9), t(10),
      t(11), t(12), t(13), t(14), t(15), static_cast<T*>(out), H, W, Cin,
      Cout, tiles_w, (int)tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* const* p, void* out, int batch, int H, int W,
             int Cin, int Cout, cudaStream_t s) {
  if (Cout % 64 == 0)
    return launch<T, 64>(p, out, batch, H, W, Cin, Cout, s);
  return launch<T, 32>(p, out, batch, H, W, Cin, Cout, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. ws and cs both null: identity shortcut
// (Cin == Cout). Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for a shape the kernel does not take
// (Cout % 32 != 0, Cout > 256, an identity shortcut with Cin != Cout, an
// empty grid, more than 2^31 - 1 blocks).
extern "C" int gct_fused_resblock_g_fwd(
    const void* x, const void* g1, const void* b1, const void* g2,
    const void* b2, const void* w1, const void* c1, const void* g3,
    const void* b3, const void* g4, const void* b4, const void* w2,
    const void* c2, const void* gamma, const void* ws, const void* cs,
    void* out, int batch, int H, int W, int Cin, int Cout, int dtype,
    void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 ||
      Cout % 32 != 0 || Cout > 256)
    return (int)cudaErrorInvalidValue;
  if ((ws == nullptr) != (cs == nullptr) || (ws == nullptr && Cin != Cout))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(out) & 15u) != 0)
    return (int)cudaErrorMisalignedAddress;
  const void* p[16] = {x, g1, b1, g2, b2, w1, c1, g3,
                       b3, g4, b4, w2, c2, gamma, ws, cs};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(p, out, batch, H, W, Cin, Cout, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(p, out, batch, H, W, Cin, Cout, s);
  return (int)cudaErrorInvalidValue;
}
