// Fused double affine modulation + LeakyReLU -> SAME 3x3 conv (kernel K2,
// forward), sm_90a: an implicit GEMM on the tensor cores through wgmma.
//
//   h   = lrelu(g2 * lrelu(g1 * x + b1) + b2)    (slope 0.2 rounded to T)
//   out = conv3x3_same(h, w) + bias                     (fp32 accumulation)
//   x [B, H, W, Cin] NHWC; g*, b* [B, Cin]; w [3, 3, Cin, Cout] HWIO at any
//   strides; bias [Cout]; out [B, H, W, Cout]; one dtype, all but w
//   contiguous.
//
// Replaces: the Pallas TPU kernel gan_codes_tpu/ops/pallas/fused_modconv.py
// (`_kernel` via `_fused_forward`, public `fused_modconv3x3`).
//
// Bound on the H100: operations, in both dtypes. The conv does 2 * 9 * Cin
// * Cout flops per output pixel against (Cin + Cout) * sizeof(T) bytes of
// activations, hundreds of flops per byte at Cin, Cout >= 32. bf16: the
// flops over the 989 TFLOP/s of the bf16 tensor cores (the 14 DFBlocks of
// the 256px generator at batch 8: 112.6 GFLOP, 0.114 ms). fp32: 3xTF32
// (below) runs three TF32 products per product, so 3 x the flops over the
// 495 TFLOP/s of the TF32 tensor cores (0.68 ms; over the 67 TFLOP/s of
// the fp32 CUDA cores, the basis of the direct conv this file held
// before, 1.68 ms); one-pass TF32 a third of that (0.23 ms).
//
// Design, M = output pixels, N = Cout, K = 9 taps x Cin; a block computes
// one 64 x N output tile over a range of K (the PTX wrappers, operand
// chunking and A-chunk stores are in wgmma.cuh, shared with K3):
//   * wgmma, fp32 sums in registers, one instruction as wide as the N tile
//     (32-256). bf16: m64nNk16.f32.bf16.bf16. fp32: 3xTF32, m64nNk8.f32.
//     tf32.tf32 on split operands v = hi + lo, hi = cvt.rna.tf32(v), lo =
//     cvt.rna.tf32(v - hi), three products a step (lo*hi + hi*lo + hi*hi):
//     about 2^-22 relative, fp32's accuracy without TF32's rounding. With
//     one_pass (the process's fp32 precision below "highest", chosen by
//     the host wrapper at each launch: ONE) one product a step, hi*hi, on
//     operands rounded to TF32 (2^-11 relative), and hi alone is stored
//     and packed. The tensor cores' adder truncates, so in fp32 each K chunk is summed
//     apart and added into a second set of registers on the CUDA cores;
//     the N tile of fp32 stops at 128 to make room for it.
//   * M spans a stacked image: the batch's samples one under another, one
//     zero row between neighbours, cut into 8 x 8 output tiles, so a 4x4
//     or 8x8 map fills the 64 wgmma rows with several samples, each with
//     its own g/b vectors and its own zero padding.
//   * Modulation once per pixel and channel per block: for each K chunk
//     (1-4 wgmma k steps of 16 bf16 / 8 fp32 channels) the consumer
//     warpgroup loads the raw x halo (10 x 10 pixels, prefetched into L2 a
//     chunk ahead) and g/b, modulates it with common.cuh's mod_chain (h
//     equals K1's bit for bit) and stores it as 8-row core-matrix columns,
//     16 bytes a pixel, over a 10-pixel pitch, while the previous chunk's
//     products run. Pixels outside the image and channels past Cin are
//     stored as 0: the SAME padding stays exactly 0 (g * 0 + b != 0). Each
//     3x3 tap is that buffer shifted by dy * 10 + dx pixels: one no-swizzle
//     wgmma descriptor (8-row stride 160 bytes), no im2col.
//   * Weights streamed ahead of use: a ring of 9-16 stages in shared
//     memory (one tap of one chunk each), filled by a producer warp with
//     cp.async.bulk and mbarriers while the consumer warpgroup runs a
//     chunk's 9 taps as one wgmma group (a fence and a commit are
//     warpgroup-wide synchronisations: one per chunk, not per tap). The
//     forward first packs w (fused_modconv3x3_pack_kernel, one launch) into
//     the stages' order and layout, [n tile][chunk][tap][k step][hi, lo]
//     [N / 8][2][8 rows][16 bytes], so each stage is one contiguous copy.
//   * Split K: where the M x N tiles are fewer than two per SM, the chunks
//     are split between blocks, each writing fp32 partial sums that a
//     second pass adds in split order (no atomics: the result repeats bit
//     for bit).
//   * The epilogue stages the tile in shared memory and writes 16-byte
//     vectors: bf16 rounds the fp32 sum to bf16, then adds the bias in
//     bf16; fp32 adds the bias.
// Limits (checked by the host wrapper and here): Cout % 32 == 0; any batch
// (1-D grid of up to 2^31 - 1 blocks), H, W and Cin (the Cin tail is
// zero-filled; 16-byte loads where Cin allows them, else element loads).

#include <stdint.h>

#include <algorithm>

#include "wgmma.cuh"

namespace {

using namespace gct;

constexpr int TILE_W = 8;                 // output tile columns
constexpr int HALO = TILE_W + 2;          // halo pitch (pixels)
constexpr int TILE_H = 8;                 // output tile rows (64 pixels)
constexpr int HALO_PX = (TILE_H + 2) * HALO;
constexpr int ITEMS = 2 * HALO_PX;        // 16-byte halo vectors per part
constexpr int A_COL = HALO_PX * 16;       // one K core-matrix column
constexpr int A_PART = 2 * A_COL;         // one operand part of a chunk
constexpr int kWG = 128;                  // the consumer warpgroup
constexpr int kThreads = kWG + 32;        // + the producer warp
constexpr int kMaxStages = 16;
constexpr int kRingBytes = 48 * 1024;
constexpr int kBarBytes = 2 * kMaxStages * 8;

__device__ __forceinline__ void wg_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kWG) : "memory");
}

// ---- the halo --------------------------------------------------------------

// Halo pixel px of the tile at stacked row R0, column C0 -> its
// sample and global pixel index, or s = -1 in the padding, the rows
// between samples and past the stacked image.
__device__ __forceinline__ void halo_pixel(int px, int R0, int C0, int H,
                                           int W, int RS, int& s,
                                           long long& pix) {
  const int R = R0 - 1 + px / HALO;
  const int C = C0 - 1 + px % HALO;
  s = -1;
  pix = 0;
  if (R < 0 || R >= RS || C < 0 || C >= W) return;
  const int smp = R / (H + 1);
  const int h = R - smp * (H + 1);
  if (h == H) return;
  s = smp;
  pix = ((long long)smp * H + h) * W + C;
}

// The epilogue rounding: the fp32 sum rounded to T, then + bias in T.
template <typename T>
__device__ __forceinline__ T epilogue(float acc, float bias) {
  return from_f<T>(__fadd_rn(rt<T>(acc), bias));
}

// ---- the kernel ------------------------------------------------------------

template <typename T, int NT, bool ONE>
__global__ void __launch_bounds__(kThreads, NT == 8 ? 1 : 2)
fused_modconv3x3_kernel(const T* __restrict__ x, const T* __restrict__ g1,
                        const T* __restrict__ b1, const T* __restrict__ g2,
                        const T* __restrict__ b2,
                        const unsigned char* __restrict__ wpack,
                        const T* __restrict__ bias, T* __restrict__ out,
                        float* __restrict__ ws, int H, int W, int Cin,
                        int Cout, int RS, int tiles_w, int m_tiles,
                        int n_tiles, int n_chunks, int cps, int stages,
                        int vec_ok_i, long long P) {
  constexpr int KC = Op<T>::KC;
  constexpr int PARTS = Op<T>::PARTS;
  constexpr int KS = ks_of(PARTS, NT);          // k steps per chunk
  constexpr int CK = KS * KC;                   // channels per chunk
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NTILE = NT * 32;
  constexpr int PART_BYTES = NTILE * 32;        // one part of one k step
  constexpr int STEP_BYTES = PARTS * PART_BYTES;
  constexpr int STAGE_BYTES = KS * STEP_BYTES;  // one tap of a chunk
  constexpr int A_STEP = PARTS * A_PART;        // one k step of a chunk's A
  constexpr int C_ITEMS = KS * ITEMS;           // halo vectors of a chunk
  constexpr int IPT = (C_ITEMS + kWG - 1) / kWG;
  constexpr int LD = NTILE + 8;                 // staged tile row (floats)

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  unsigned char* ring = smem + kBarBytes;
  unsigned char* abuf = ring + stages * STAGE_BYTES;  // 2 chunk buffers

  const int tid = threadIdx.x;
  const int mt = blockIdx.x % m_tiles;
  const int rest = blockIdx.x / m_tiles;
  const int ntile = rest % n_tiles;
  const int split = rest / n_tiles;
  const int R0 = (mt / tiles_w) * TILE_H;
  const int C0 = (mt % tiles_w) * TILE_W;
  const int n0 = ntile * NTILE;
  const int c_first = split * cps;
  const int nch = min(n_chunks, c_first + cps) - c_first;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kWG) {
    // producer warp: one lane streams this block's weight stages
    if (tid == kWG) {
      const unsigned char* src =
          wpack + ((size_t)ntile * n_chunks + c_first) * 9 * STAGE_BYTES;
      for (int k = 0; k < nch * 9; ++k) {
        const int s = k % stages;
        const uint32_t ph = (uint32_t)(k / stages) & 1u;
        mbar_wait(smem_u32(empty + s), ph ^ 1u);
        mbar_expect_tx(smem_u32(full + s), STAGE_BYTES);
        bulk_load(smem_u32(ring + s * STAGE_BYTES),
                  src + (size_t)k * STAGE_BYTES, STAGE_BYTES,
                  smem_u32(full + s));
      }
    }
    return;
  }

  // consumer warpgroup. Halo items i = tid + j * 128 of a chunk: k step
  // i / 200, then (r = i % 200) pixel r / 2 and K column r % 2, i.e.
  // channels c0 + (i / 200) * KC + (r % 2) * VEC ...; located once.
  const bool vec_ok = vec_ok_i != 0;
  int item_s[IPT];
  long long item_pix[IPT];
#pragma unroll
  for (int j = 0; j < IPT; ++j) {
    const int i = tid + j * kWG;
    item_s[j] = -1;
    item_pix[j] = -1;
    if (i < C_ITEMS) {
      int s;
      long long pix;
      halo_pixel((i % ITEMS) >> 1, R0, C0, H, W, RS, s, pix);
      item_s[j] = s;
      item_pix[j] = s >= 0 ? pix : -1;
    }
  }
  // channel offset in a chunk, and shared-memory offset in a chunk's A
  auto item_c = [&](int j) {
    const int i = tid + j * kWG;
    return (i / ITEMS) * KC + (i & 1) * VEC;
  };
  auto item_dst = [&](int j) {
    const int i = tid + j * kWG;
    const int r = i % ITEMS;
    return (i / ITEMS) * A_STEP + (r & 1) * A_COL + (r >> 1) * 16;
  };
  const T* const xs[1] = {x};
  const T* const gb[4] = {g1, b1, g2, b2};

  // A chunk's x is prefetched into L2 a chunk ahead, not into registers:
  // wgmma.fence would wait for loads in flight to registers. Then all of
  // a chunk's loads (x, g1, b1, g2, b2) before any use, the modulation and
  // the store.
  auto prefetch_chunk = [&](int chunk) {
#pragma unroll
    for (int j = 0; j < IPT; ++j)
      if (item_pix[j] >= 0 && chunk * CK + item_c(j) < Cin)
        asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
            x + item_pix[j] * Cin + chunk * CK + item_c(j)));
  };
  auto store_chunk = [&](int chunk, int buf) {
    unsigned char* a = abuf + buf * KS * A_STEP;
    V16<T> raw[IPT][1];
#pragma unroll
    for (int j = 0; j < IPT; ++j)
      if (tid + j * kWG < C_ITEMS)
        load16<T, 1>(xs, item_pix[j], chunk * CK + item_c(j), Cin, vec_ok,
                     raw[j]);
#pragma unroll
    for (int j = 0; j < IPT; ++j) {
      if (tid + j * kWG < C_ITEMS) {
        V16<T> mv[4];  // g1, b1, g2, b2: few rows, from L1
        load16<T, 4>(gb, item_s[j], chunk * CK + item_c(j), Cin, vec_ok, mv);
        mod_store<T, ONE>(raw[j][0], mv, item_s[j], chunk * CK + item_c(j),
                          Cin, a + item_dst(j), A_PART);
      }
    }
    fence_proxy_async();
  };

  // fp32: the tensor cores sum each chunk's products into acc from 0, and
  // acc is then added into sum on the CUDA cores (rounded to nearest). The
  // tensor cores' adder truncates: summed in acc over the whole K range of
  // a layer (hundreds of wgmma), the fp32 result drifted several times
  // further from a float64 reference than cuDNN's fp32 conv (kernel_ab.py
  // prints both drifts). bf16 sums in acc alone.
  constexpr bool PROMOTE = PARTS == 2;
  float acc[NTILE / 2];  // wgmma's accumulator layout, 64 x NTILE
  float sum[PROMOTE ? NTILE / 2 : 1];
#pragma unroll
  for (int i = 0; i < NTILE / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (PROMOTE ? NTILE / 2 : 1); ++i) sum[i] = 0.f;
  fence_acc(acc);

  store_chunk(c_first, 0);
  wg_sync();

  const uint32_t abase = smem_u32(abuf);
  const uint32_t rbase = smem_u32(ring);
  for (int ci = 0; ci < nch; ++ci) {
    const int buf = ci & 1;
    const bool more = ci + 1 < nch;
    if (more) prefetch_chunk(c_first + ci + 1);
    // the chunk's 9 weight stages, then its 9 taps' products as one group
    // (one fence, one commit: each is a warpgroup-wide synchronisation)
    const int k0 = ci * 9;
    for (int tap = 0; tap < 9; ++tap)
      mbar_wait(smem_u32(full + (k0 + tap) % stages),
                (uint32_t)((k0 + tap) / stages) & 1u);
    const uint32_t a0 = abase + buf * KS * A_STEP;
    wgmma_fence();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
#pragma unroll
      for (int q = 0; q < KS; ++q) {
        const uint32_t a = a0 + q * A_STEP + ((tap / 3) * HALO + tap % 3) * 16;
        const uint32_t b =
            rbase + ((k0 + tap) % stages) * STAGE_BYTES + q * STEP_BYTES;
        const uint64_t da = desc(a, A_COL, HALO * 16);
        const uint64_t db = desc(b, 128, 256);
        if constexpr (PARTS == 1) {
          mma_bf16<NTILE>(acc, da, db);
        } else if constexpr (ONE) {
          mma_tf32<NTILE>(acc, da, db);
        } else {
          mma_tf32<NTILE>(acc, desc(a + A_PART, A_COL, HALO * 16), db);
          mma_tf32<NTILE>(acc, da, desc(b + PART_BYTES, 128, 256));
          mma_tf32<NTILE>(acc, da, db);
        }
      }
    }
    wgmma_commit();
    // the next chunk's A goes to the other buffer (its readers, chunk
    // ci - 1, have finished) while this chunk's products run
    if (more) store_chunk(c_first + ci + 1, buf ^ 1);
    wgmma_wait<0>();
    if (tid == 0)
      for (int tap = 0; tap < 9; ++tap)
        mbar_arrive(smem_u32(empty + (k0 + tap) % stages));
    if constexpr (PROMOTE) {
      fence_acc(acc);
#pragma unroll
      for (int i = 0; i < NTILE / 2; ++i) {
        sum[i] = __fadd_rn(sum[i], acc[i]);
        acc[i] = 0.f;
      }
      fence_acc(acc);
    }
    if (more) wg_sync();
  }
  wgmma_wait<0>();
  fence_acc(acc);
  auto result = [&](int i) {
    if constexpr (PROMOTE) return sum[i];
    else return acc[i];
  };

  // epilogue: stage the 64 x NTILE tile in shared memory (over the ring
  // and the A buffers, all consumed), then 16-byte stores. Staged row q is
  // output pixel (R0 + q / 8, C0 + q % 8).
  wg_sync();
  float* tile = reinterpret_cast<float*>(ring);
  {
    const int warp = tid >> 5, lane = tid & 31;
    const int r0 = warp * 16 + (lane >> 2);
    const int cq = (lane & 3) * 2;
#pragma unroll
    for (int j = 0; j < NTILE / 8; ++j) {  // n8 block j: acc[4j .. 4j + 3]
      const int col = j * 8 + cq;
      *reinterpret_cast<float2*>(tile + r0 * LD + col) =
          make_float2(result(4 * j), result(4 * j + 1));
      *reinterpret_cast<float2*>(tile + (r0 + 8) * LD + col) =
          make_float2(result(4 * j + 2), result(4 * j + 3));
    }
  }
  wg_sync();
  const int ncols = min(NTILE, Cout - n0);
  constexpr int ROWS = TILE_H * TILE_W;
  if (ws != nullptr) {
    const int vpr = ncols / 4;
    float* dst = ws + (size_t)split * P * Cout;
    for (int i = tid; i < ROWS * vpr; i += kWG) {
      const int q = i / vpr, cv = i - q * vpr;
      int s;
      long long pix;
      halo_pixel((q / TILE_W + 1) * HALO + q % TILE_W + 1, R0, C0, H, W, RS,
                 s, pix);
      if (s < 0) continue;
      *reinterpret_cast<float4*>(dst + pix * Cout + n0 + cv * 4) =
          *reinterpret_cast<const float4*>(tile + q * LD + cv * 4);
    }
    return;
  }
  constexpr int VO = 16 / sizeof(T);
  const int vpr = ncols / VO;
  for (int i = tid; i < ROWS * vpr; i += kWG) {
    const int q = i / vpr, cv = i - q * vpr;
    int s;
    long long pix;
    halo_pixel((q / TILE_W + 1) * HALO + q % TILE_W + 1, R0, C0, H, W, RS, s,
               pix);
    if (s < 0) continue;
    const int col = n0 + cv * VO;
    V16<T> o;
#pragma unroll
    for (int e = 0; e < VO; ++e)
      o.v[e] = epilogue<T>(tile[q * LD + cv * VO + e],
                           to_f<T>(__ldg(bias + col + e)));
    *reinterpret_cast<V16<T>*>(out + pix * Cout + col) = o;
  }
}

// Split K, second pass: out = epilogue(sum over splits, in split order).
template <typename T>
__global__ void __launch_bounds__(256)
fused_modconv3x3_splitk_reduce_kernel(const float* __restrict__ ws,
                                      const T* __restrict__ bias,
                                      T* __restrict__ out, long long n_vec,
                                      long long plane, int Cout,
                                      int splits) {
  constexpr int VO = 16 / sizeof(T);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_vec; i += (long long)gridDim.x * blockDim.x) {
    const long long e0 = i * VO;
    float acc[VO];
#pragma unroll
    for (int q = 0; q < VO / 4; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(ws + e0 + q * 4);
      acc[q * 4] = v.x;
      acc[q * 4 + 1] = v.y;
      acc[q * 4 + 2] = v.z;
      acc[q * 4 + 3] = v.w;
    }
    for (int s = 1; s < splits; ++s) {
#pragma unroll
      for (int q = 0; q < VO / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(
            ws + s * plane + e0 + q * 4);
        acc[q * 4] += v.x;
        acc[q * 4 + 1] += v.y;
        acc[q * 4 + 2] += v.z;
        acc[q * 4 + 3] += v.w;
      }
    }
    const int col = (int)(e0 % Cout);
    V16<T> o;
#pragma unroll
    for (int e = 0; e < VO; ++e)
      o.v[e] = epilogue<T>(acc[e], to_f<T>(__ldg(bias + col + e)));
    *reinterpret_cast<V16<T>*>(out + e0) = o;
  }
}

// The weight pack: w [kh, kw, Cin, Cout] (3 x 3, or 1 x 1: taps = kh * kw;
// element strides s0..s3, any layout: the HWIO view of a torch OIHW weight
// needs no copy) -> the stages the kernels stream, [n tile][chunk][tap]
// [k step][part][N / 8][2][8][KC / 2], zero past Cin and Cout; part = (w,)
// in bf16, (hi, lo) = the tf32 split in fp32 (one_pass: hi alone, the lo
// plane left unwritten and unread). One block per (n tile, chunk,
// tap, k step), its threads writing the step's N x KC elements of each part
// in order.
template <typename T>
__global__ void __launch_bounds__(256)
fused_modconv3x3_pack_kernel(const T* __restrict__ w, long long s0,
                             long long s1, long long s2, long long s3,
                             int taps, int Cin, int Cout, int n_chunks,
                             int ks, int ntile, int one_pass,
                             T* __restrict__ packed) {
  constexpr int KC = Op<T>::KC;
  constexpr int KT = KC / 2;
  constexpr int PARTS = Op<T>::PARTS;
  const int step = blockIdx.x;  // ((n tile * n_chunks + chunk) * taps +
                                // tap) * ks + k step
  const int kq = step % ks;
  const int tap = (step / ks) % taps;
  const int chunk = (step / ks / taps) % n_chunks;
  const int nt = step / ks / taps / n_chunks;
  const int ci0 = (chunk * ks + kq) * KC;
  const int co0 = nt * ntile;
  const T* src = w + (tap / 3) * s0 + (tap % 3) * s1;
  const int part = ntile * KC;  // elements of one part of one step
  T* dst = packed + (size_t)step * PARTS * part;
  for (int i = threadIdx.x; i < part; i += blockDim.x) {
    const int kt = i % KT;
    const int r = (i / KT) % 8;
    const int kb = (i / (8 * KT)) % 2;
    const int nb = i / (16 * KT);
    const int ci = ci0 + kb * KT + kt;
    const int co = co0 + nb * 8 + r;
    const T v = (ci < Cin && co < Cout) ? src[ci * s2 + co * s3]
                                        : from_f<T>(0.f);
    if constexpr (PARTS == 1) {
      dst[i] = v;
    } else {
      const uint32_t hi = tf32_rna(v);
      dst[i] = __uint_as_float(hi);
      if (!one_pass)
        dst[part + i] = __uint_as_float(tf32_rna(v - __uint_as_float(hi)));
    }
  }
}

template <typename T, int NT, bool ONE>
int launch(const void* x, const void* g1, const void* b1, const void* g2,
           const void* b2, const void* wpack, const void* bias, void* out,
           float* ws, int batch, int H, int W, int Cin, int Cout, int n_tiles,
           int cps, int splits, bool vec_ok, cudaStream_t stream) {
  constexpr int PARTS = Op<T>::PARTS;
  constexpr int KS = ks_of(PARTS, NT);
  constexpr int STAGE_BYTES = KS * PARTS * NT * 32 * 32;
  // at least one chunk's 9 taps: a chunk's products are one wgmma group
  const int stages =
      std::min(kMaxStages, std::max(9, kRingBytes / STAGE_BYTES));
  const int tile_bytes = TILE_H * TILE_W * (NT * 32 + 8) * 4;
  const int smem = kBarBytes + std::max(stages * STAGE_BYTES +
                                            2 * KS * PARTS * A_PART,
                                        tile_bytes);
  const long long rs = (long long)batch * (H + 1) - 1;
  if (rs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int tiles_w = (W + TILE_W - 1) / TILE_W;
  const long long m_tiles = (rs + TILE_H - 1) / TILE_H * tiles_w;
  const long long blocks = m_tiles * n_tiles * splits;
  if (m_tiles > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (Cin + KS * Op<T>::KC - 1) / (KS * Op<T>::KC);
  const long long P = (long long)batch * H * W;
  auto kernel = fused_modconv3x3_kernel<T, NT, ONE>;
  // the shared-memory size is a constant of the instantiation: set it once
  // per device, not on every call
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_set[dev] = true;
  }
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g1),
      static_cast<const T*>(b1), static_cast<const T*>(g2),
      static_cast<const T*>(b2), static_cast<const unsigned char*>(wpack),
      static_cast<const T*>(bias), static_cast<T*>(out),
      splits > 1 ? ws : nullptr, H, W, Cin, Cout, (int)rs, tiles_w,
      (int)m_tiles, n_tiles, n_chunks, cps, stages, vec_ok ? 1 : 0, P);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  constexpr int VO = 16 / sizeof(T);
  const long long n_vec = P * Cout / VO;
  const long long grid = std::min((n_vec + 255) / 256, 132LL * 16);
  fused_modconv3x3_splitk_reduce_kernel<T><<<(unsigned)grid, 256, 0, stream>>>(
      ws, static_cast<const T*>(bias), static_cast<T*>(out), n_vec,
      P * Cout, Cout, splits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_nt(int nt, bool one, const void* x, const void* g1,
              const void* b1, const void* g2, const void* b2,
              const void* wpack, const void* bias, void* out, float* ws,
              int batch, int H, int W, int Cin, int Cout, int n_tiles,
              int cps, int splits, bool vec_ok, cudaStream_t s) {
#define GCT_LAUNCH(N, O)                                                  \
  if (nt == N && one == O)                                                \
    return launch<T, N, O>(x, g1, b1, g2, b2, wpack, bias, out, ws, batch, \
                           H, W, Cin, Cout, n_tiles, cps, splits, vec_ok, s);
  GCT_LAUNCH(1, false)
  GCT_LAUNCH(2, false)
  GCT_LAUNCH(4, false)
  if constexpr (Op<T>::PARTS == 1) {  // fp32 stops at N = 128 (sum above)
    GCT_LAUNCH(8, false)
  } else {  // one TF32 pass: fp32 only
    GCT_LAUNCH(1, true)
    GCT_LAUNCH(2, true)
    GCT_LAUNCH(4, true)
  }
#undef GCT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

template <typename T>
int pack(const void* w, const long long* st, void* packed, int taps,
         int Cin, int Cout, int nt, int ks, int n_tiles, int one_pass,
         cudaStream_t stream) {
  const int n_chunks = (Cin + ks * Op<T>::KC - 1) / (ks * Op<T>::KC);
  const long long steps = (long long)n_tiles * n_chunks * taps * ks;
  if (steps > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  fused_modconv3x3_pack_kernel<T><<<(unsigned)steps, 256, 0, stream>>>(
      static_cast<const T*>(w), st[0], st[1], st[2], st[3], taps, Cin, Cout,
      n_chunks, ks, nt * 32, one_pass, static_cast<T*>(packed));
  return (int)cudaGetLastError();
}

}  // namespace

// The weight pack (dtype 0 = float32, 1 = bfloat16): w [kh, kw, Cin,
// Cout], taps = kh * kw = 9 (3 x 3) or 1 (1 x 1), at element strides
// w_strides[0..4) -> packed, the n_tiles N tiles of nt * 32 channels, the
// Cin chunks of ks k steps of 16 (bf16) or 8 (fp32) channels and the taps
// of the kernels' weight stages (ops/kernels/fused_modconv.py:
// _pack_weights is its plain version). one_pass (fp32; 0 or 1): the hi
// plane alone, for one TF32 pass. Returns cudaGetLastError().
extern "C" int gct_fused_modconv3x3_pack(const void* w,
                                         const long long* w_strides,
                                         void* packed, int taps, int Cin,
                                         int Cout, int nt, int ks,
                                         int n_tiles, int dtype,
                                         int one_pass, void* stream) {
  if (Cin <= 0 || Cout <= 0 || n_tiles <= 0 || (taps != 9 && taps != 1) ||
      (nt != 1 && nt != 2 && nt != 4 && nt != 8) || ks < 1 || ks > 4 ||
      (long long)n_tiles * nt * 32 < Cout || (one_pass != 0 && one_pass != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return pack<float>(w, w_strides, packed, taps, Cin, Cout, nt, ks,
                       n_tiles, one_pass, s);
  if (dtype == 1)
    return pack<__nv_bfloat16>(w, w_strides, packed, taps, Cin, Cout, nt,
                               ks, n_tiles, 0, s);
  return (int)cudaErrorInvalidValue;
}

// The forward (dtype 0 = float32, 1 = bfloat16): the weight pack of w
// (element strides w_strides[0..4)) into scratch, then the kernel and, for
// splits > 1, the split-K pass; n_tiles N tiles of nt * 32 channels, each
// split taking cps chunks. scratch is 16-byte aligned and holds the packed
// weights (n_tiles x chunks x 9 x a chunk's channels x nt * 32 elements,
// twice in fp32) rounded up to 256 bytes, then for splits > 1 the fp32
// partial sums, splits x B*H*W x Cout. one_pass (0 or 1; 1 only with
// fp32): one TF32 product per product in place of 3xTF32. Returns
// cudaGetLastError() after the launches (0 on success), or
// cudaErrorInvalidValue for a shape or plan the kernel does not take.
extern "C" int gct_fused_modconv3x3_fwd(
    const void* x, const void* g1, const void* b1, const void* g2,
    const void* b2, const void* w, const long long* w_strides,
    const void* bias, void* out, void* scratch, int batch, int H, int W,
    int Cin, int Cout, int nt, int n_tiles, int cps, int splits, int dtype,
    int one_pass, void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 ||
      Cout % 32 != 0 || (dtype == 0 && nt > 4) || n_tiles <= 0 ||
      (one_pass != 0 && (one_pass != 1 || dtype != 0)) ||
      (long long)n_tiles * nt * 32 < Cout ||
      (long long)(n_tiles - 1) * nt * 32 >= Cout || cps <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  const int kc = dtype == 0 ? Op<float>::KC * ks_of(Op<float>::PARTS, nt)
                            : Op<__nv_bfloat16>::KC *
                                  ks_of(Op<__nv_bfloat16>::PARTS, nt);
  const int n_chunks = (Cin + kc - 1) / kc;
  if ((long long)splits * cps < n_chunks || (splits - 1) * cps >= n_chunks)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(out) || !aligned16(scratch))
    return (int)cudaErrorMisalignedAddress;
  const int ks = ks_of(dtype == 0 ? Op<float>::PARTS
                                  : Op<__nv_bfloat16>::PARTS, nt);
  int rc = gct_fused_modconv3x3_pack(w, w_strides, scratch, 9, Cin, Cout,
                                     nt, ks, n_tiles, dtype, one_pass,
                                     stream);
  if (rc != 0) return rc;
  // the packed weights: n_tiles x chunks x 9 taps x kc x nt * 32, x2 fp32
  const long long pack_bytes =
      (long long)n_tiles * n_chunks * 9 * kc * nt * 32 * (dtype == 0 ? 8 : 2);
  unsigned char* sc = static_cast<unsigned char*>(scratch);
  float* ws = reinterpret_cast<float*>(sc + (pack_bytes + 255) / 256 * 256);
  const int vec = dtype == 0 ? 4 : 8;
  const bool vec_ok = Cin % vec == 0 && aligned16(x) && aligned16(g1) &&
                      aligned16(b1) && aligned16(g2) && aligned16(b2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_nt<float>(nt, one_pass == 1, x, g1, b1, g2, b2, sc, bias,
                            out, ws, batch, H, W, Cin, Cout, n_tiles, cps,
                            splits, vec_ok, s);
  return launch_nt<__nv_bfloat16>(nt, false, x, g1, b1, g2, b2, sc, bias,
                                  out, ws, batch, H, W, Cin, Cout, n_tiles,
                                  cps, splits, vec_ok, s);
}
