// The whole generator residual block in one pass (kernel K3, forward),
// sm_90a: both 3x3 convs and the 1x1 shortcut as implicit GEMMs on the
// tensor cores through wgmma, h1 kept in shared memory.
//
//   h1  = conv3x3_same(lrelu(g2 * lrelu(g1 * x + b1) + b2), w1) + c1
//   h2  = conv3x3_same(lrelu(g4 * lrelu(g3 * h1 + b3) + b4), w2) + c2
//   out = shortcut + gamma * h2,   shortcut = x, or conv1x1(x, ws) + cs
//   x [B, H, W, Cin] NHWC; g1, b1, g2, b2 [B, Cin]; w1 [3, 3, Cin, Cout];
//   c1 [Cout]; g3, b3, g4, b4 [B, Cout]; w2 [3, 3, Cout, Cout]; c2 [Cout];
//   gamma [1]; ws [1, 1, Cin, Cout] and cs [Cout], or both null (identity,
//   Cin == Cout); out [B, H, W, Cout]. One dtype (float32 or bfloat16);
//   all contiguous but the weights, which are read at their strides.
//
// Replaces: the Pallas TPU kernel gan_codes_tpu/ops/pallas/fused_resblock.py
// (`_kernel` via `_fused_forward`, public `fused_resblock_g`). Unlike it,
// gamma is not folded into w2: the port's plain version rounds gamma * h2.
//
// Bound on the H100: operations. The block does 2 * (9 * Cin + 9 * Cout
// [+ Cin]) * Cout flops per output pixel against (Cin + Cout) * sizeof(T)
// bytes of activations. bf16: those flops over the 989 TFLOP/s of the bf16
// tensor cores (the 7 blocks of the 256px generator at batch 8: 119.08
// GFLOP, 0.120 ms); fp32: 3xTF32 runs three TF32 products per product, so
// 3 x the flops over 495 TFLOP/s (0.722 ms); one-pass TF32 a third of that
// (0.241 ms).
//
// Design. A block owns one output tile of TH x TW pixels of the stacked
// image (the batch's samples one under another, one zero row between
// neighbours, as in K2), all Cout channels; 2 consumer warpgroups and a
// producer warpgroup, one lane of which streams the weights (setmaxnreg
// moves its registers to the consumers). The host's `_plan`
// (ops/kernels/fused_resblock.py) picks TH, TW, the N tile and the ring
// depth per shape from a time model fitted to runs on an H100.
//   * Geometry: flattened rows. wgmma takes A as 8-row core matrices of 16
//     bytes; K2 puts 8 pixels of one output row in one, which ties a tile
//     to widths of 8 and h1's halo (10 x 10 for 8 x 8) to ragged M tiles.
//     Here a buffer of pitch P holds a (rows x P) region row after row, and
//     M row m is buffer pixel m itself: every 8 consecutive buffer pixels
//     are one core matrix (8-row stride 128 bytes) and each 3x3 tap is the
//     buffer shifted by dy * P + dx. Output (r, c) of a pitch-P grid reads
//     (r + dy, c + dx); the last 2 columns of each row are computed and
//     dropped. Conv1 runs on the x halo ((TH + 4) x (TW + 4), pitch P1 = TW
//     + 4) and gives h1 on (TH + 2) x (TW + 2): M1 = (TH + 1) * P1 + TW + 2
//     rows, ceil(M1 / 64) m64 tiles. Conv2 runs on h1 (pitch P2 = TW + 2):
//     M2 = (TH - 1) * P2 + TW rows. Any TH and TW: the tile fits the map and
//     the shared memory, and no width has to be a multiple of 8.
//   * Conv1's recompute: h1 on the 1-pixel halo of a tile is computed by
//     its neighbours too. `_plan` counts conv1's M rows over the output
//     pixels (`conv1_share`) and, among tilings it estimates within 25% of
//     the fastest, keeps that at or below 1.5625 (the direct-conv K3 it
//     replaced: 10 x 20 computed for 8 x 16) where the shared memory
//     allows it. The 256px generator at batch 8 (kernel_ab.py prints each
//     plan): 1.26-1.56 at the 64-256px blocks (Cout <= 128; tiles such as
//     8 x 32, 8 x 43, 16 x 52 in bf16, 13 x 13, 16 x 22, 28 x 16 in fp32);
//     at Cout 256 (1 KB of h1 a pixel in fp32, 512 B in bf16) raw h1 and
//     the ring leave room for about 10 x 18 pixels of h1, and the 4-32px
//     maps take 1-4-row tiles (2.06 at 32px, far more at 4-16px, where
//     most M rows are padding), as the time model finds more blocks
//     faster there than fewer passes.
//   * h1 stays on chip, raw: conv1's epilogue rounds h1 = T(T(sum) + c1) as
//     the plain version does and stores it as T, [conv2 chunk][pixel][chunk
//     channels], not yet modulated. Conv2's A chunk is then built from it as
//     K2 builds its A from x: read the raw chunk, mod_chain with g3, b3, g4,
//     b4 of the pixel's sample, 0 for h1 pixels outside the image (conv2's
//     SAME padding stays exactly 0), the tf32 hi/lo split in fp32, stored
//     as the A operand. h1 costs Cout * sizeof(T) bytes a pixel, half of
//     what the split planes would.
//   * Both convs are K2's chunk loop (wgmma.cuh): a chunk of 1-4 wgmma k
//     steps of 16 bf16 / 8 fp32 channels (ks3_of: longer than K2's, as
//     each chunk pays fixed barrier and load-latency costs), its A built by
//     all 256 consumer threads (only the pixels the pass reads: its 128
//     rows and the largest tap shift) into one of two buffers while the
//     other's products run, bf16 on bf16 pairs (mod_store_bf2); the
//     weights packed per call by K2's pack kernel (w1, w2, and ws as a
//     pack of one tap) into one scratch buffer and streamed with
//     cp.async.bulk through a ring of 9-18 stages (one tap of one chunk
//     each). The two warpgroups take two m64 tiles of a pass and share
//     every weight stage (its empty barrier counts 2 arrivals).
//   * bf16: m64nNk16.f32.bf16.bf16, N up to 256. fp32: 3xTF32 (m64nNk8 on
//     hi/lo splits, three products a step), each K chunk summed apart and
//     added into a second register set on the CUDA cores (the tensor
//     cores' adder truncates), so N stops at 128 and Cout 256 takes two N
//     passes, each rebuilding its A chunks. With one_pass (the process's
//     fp32 precision below "highest", chosen by the host wrapper at each
//     launch: ONE) one product a step, hi*hi, on operands rounded to TF32;
//     the A builds and the packs store hi alone.
//   * The 1x1 shortcut (Cin != Cout) is a one-tap GEMM over raw x on the
//     h1 grid (tap offset P2 + 1), after conv2, into its own sums (a second
//     accumulator set; the N tile stops at 128 in bf16 and 64 in fp32 to
//     leave it registers), so that its rounding, T(T(sum) + cs), is the
//     plain version's. The identity shortcut reads x in the epilogue.
//   * Fill: the stacked image makes a 4x4 map at batch 8 one image of 39 x
//     4 pixels. K2's split K does not carry over (conv2 needs all of h1),
//     so fill comes from small tiles: `_plan` estimates each tiling's time
//     from its waves of blocks (one a SM) and, per block, its chunks (the
//     larger of products and A build) and epilogues, and takes the
//     fastest: 52-132 blocks at the 4-32px maps, one wave. Every block
//     streams all of w1 and w2 from L2; on an H100 that cost was hidden
//     (the same time with the weight copies left out).
//   * Epilogues: the wgmma accumulator layout gives a thread 2 channels of
//     a row; 4 lanes exchange them with shuffles so that each holds 8
//     consecutive channels of one row, which it rounds where the plain
//     version rounds and stores as 16-byte vectors (h1 into shared memory,
//     out to device memory).
// Limits (checked by the host wrapper and here): Cout % 32 == 0 and Cout <=
// 256; any batch, H, W and Cin (the Cin tail is zero-filled; 16-byte loads
// where Cin and the pointers allow them, else element loads).
//
// Numerics: every modulation op is rounded to T (common.cuh's mod_chain);
// each conv multiplies T-valued operands (fp32: split into tf32 hi + lo,
// about 2^-22 relative; one pass: hi alone, 2^-11) and sums in fp32 in another order than cuDNN; conv
// outputs are rounded to T before the bias add, gamma * h2 and the
// residual sum are rounded to T, as the plain PyTorch version computes
// them one op at a time.

#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "wgmma.cuh"

// K2's weight pack (fused_modconv.cu), shared by K3
extern "C" int gct_fused_modconv3x3_pack(const void* w,
                                         const long long* w_strides,
                                         void* packed, int taps, int Cin,
                                         int Cout, int nt, int ks,
                                         int n_tiles, int dtype,
                                         int one_pass, void* stream);

namespace {

using namespace gct;

constexpr int kWG = 128;                  // one consumer warpgroup
constexpr int kNWG = 2;                   // consumer warpgroups
constexpr int kConsumers = kNWG * kWG;
constexpr int kThreads = kConsumers + kWG;  // + the producer warpgroup
// registers a thread after setmaxnreg: the consumers' accumulators (up to
// 128 a thread) want more than the 168 that 384 threads get at launch;
// 2 x 128 x 232 + 128 x 40 = 64,512 of the SM's 65,536. ptxas still
// reports 168 and spills up to 364 bytes at N 256 (nvcc -Xptxas -v).
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kMaxStages = 18;           // two chunks of 9 taps
constexpr int kBarBytes = 512;            // 2 x kMaxStages mbarriers
constexpr int kSmemLimit = 232448;        // the H100's opt-in maximum

// what a chunk's A operand is built from
enum Src { kConv1 = 0, kConv2 = 1, kShortcut = 2 };

template <typename T>
struct Args {
  const T *x, *g1, *b1, *g2, *b2, *c1, *g3, *b3, *g4, *b4, *c2, *gamma, *cs;
  const unsigned char *w1p, *w2p, *wsp;  // packed weight stages
  T* out;
  int H, W, Cin, Cout, RS;               // RS: rows of the stacked image
  int th, tw, tiles_w;
  int n_tiles, ch1, ch2, m1, m2, stages;
  int apix;                              // pixels of an A buffer: a
                                         // pass's 128 rows + tap shifts
  int vec_ok;
};

__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Pixel p of a pitch-`pitch` grid whose row 0, column 0 is stacked pixel
// (R0, C0), `rows` rows high -> its sample and global pixel index, or
// s = -1 outside the grid, the image, or on a row between samples.
__device__ __forceinline__ void grid_pixel(int p, int pitch, int rows, int R0,
                                           int C0, int H, int W, int RS,
                                           int& s, long long& pix) {
  const int r = p / pitch;
  const int R = R0 + r;
  const int C = C0 + p - r * pitch;
  s = -1;
  pix = 0;
  if (r >= rows || R < 0 || R >= RS || C < 0 || C >= W) return;
  const int smp = R / (H + 1);
  const int h = R - smp * (H + 1);
  if (h == H) return;
  s = smp;
  pix = ((long long)smp * H + h) * W + C;
}

__device__ __forceinline__ float sel4(float a0, float a1, float a2, float a3,
                                      int t) {
  return t == 0 ? a0 : t == 1 ? a1 : t == 2 ? a2 : a3;
}

// The wgmma accumulator layout gives lane (4 * g + q) of a warp columns
// 2q, 2q + 1 of each n8 block j, rows g and g + 8 of the warp's 16: d[4j],
// d[4j + 1] (row g), d[4j + 2], d[4j + 3] (row g + 8). gather8 exchanges
// blocks 4jj .. 4jj + 3 of row g + 8 * half between the 4 lanes of a quad,
// so that lane q holds all 8 columns of block 4jj + q in o. Every lane of
// the warp must call it.
template <int N>
__device__ __forceinline__ void gather8(const float (&d)[N], int jj, int half,
                                        int q, float (&o)[8]) {
  float rx[4], ry[4];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    const int t = q ^ s;  // the partner wants block 4jj + t
    const int b = 4 * (4 * jj) + 2 * half;
    float sx = sel4(d[b], d[b + 4], d[b + 8], d[b + 12], t);
    float sy = sel4(d[b + 1], d[b + 5], d[b + 9], d[b + 13], t);
    if (s != 0) {
      sx = __shfl_xor_sync(0xffffffffu, sx, s);
      sy = __shfl_xor_sync(0xffffffffu, sy, s);
    }
    rx[s] = sx;  // columns 2 (q ^ s), 2 (q ^ s) + 1 of block 4jj + q
    ry[s] = sy;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    o[2 * k] = sel4(rx[0], rx[1], rx[2], rx[3], k ^ q);
    o[2 * k + 1] = sel4(ry[0], ry[1], ry[2], ry[3], k ^ q);
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* dst, const float (&v)[8]) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int h = 0; h < 8 / VEC; ++h) {
    V16<T> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) o.v[e] = from_f<T>(v[h * VEC + e]);
    *reinterpret_cast<V16<T>*>(dst + h * VEC) = o;
  }
}

template <typename T, int NT, bool SC, bool ONE>
__global__ void __launch_bounds__(kThreads, 1)
fused_resblock_g_kernel(const Args<T> a) {
  constexpr int KC = Op<T>::KC;
  constexpr int PARTS = Op<T>::PARTS;
  constexpr int KS = ks3_of(PARTS, NT);         // k steps per chunk
  constexpr int CK = KS * KC;                   // channels per chunk
  constexpr int VEC = 16 / sizeof(T);
  constexpr int NTILE = NT * 32;
  constexpr int PART_BYTES = NTILE * 32;        // one part of one k step
  constexpr int STEP_BYTES = PARTS * PART_BYTES;
  constexpr int STAGE_BYTES = KS * STEP_BYTES;  // one tap of a chunk
  constexpr bool PROMOTE = PARTS == 2;
  constexpr int NACC = NTILE / 2;

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  unsigned char* ring = smem + kBarBytes;
  unsigned char* abuf = ring + a.stages * STAGE_BYTES;
  const int A_COL = a.apix * 16;                // one K core-matrix column
  const int A_PART = 2 * A_COL;                 // one operand part
  const int A_STEP = PARTS * A_PART;            // one k step of a chunk
  const int A_BYTES = KS * A_STEP;              // one chunk buffer
  T* h1s = reinterpret_cast<T*>(abuf + 2 * A_BYTES);

  const int tid = threadIdx.x;
  const int P1 = a.tw + 4, P2 = a.tw + 2;
  const int hpix = (a.th + 2) * P2;             // raw h1 pixels
  const int R0 = (blockIdx.x / a.tiles_w) * a.th;
  const int C0 = (blockIdx.x % a.tiles_w) * a.tw;
  const int pass1 = (a.m1 + kNWG - 1) / kNWG;
  const int pass2 = (a.m2 + kNWG - 1) / kNWG;

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), kNWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, warp-uniform as the compiler sees it (a shuffle
  // of lane 0's), so that each role's setmaxnreg applies to its code
  const int wg = __shfl_sync(0xffffffffu, tid / kWG, 0);
  if (wg == kNWG) {
    // producer warpgroup: one lane streams the weight stages in the order
    // the consumers take them
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (tid == kConsumers) {
      int k = 0;
      auto stream = [&](const unsigned char* src, int count) {
        for (int i = 0; i < count; ++i, ++k) {
          const int s = k % a.stages;
          mbar_wait(smem_u32(empty + s),
                    ((uint32_t)(k / a.stages) & 1u) ^ 1u);
          mbar_expect_tx(smem_u32(full + s), STAGE_BYTES);
          bulk_load(smem_u32(ring + s * STAGE_BYTES),
                    src + (size_t)i * STAGE_BYTES, STAGE_BYTES,
                    smem_u32(full + s));
        }
      };
      for (int mp = 0; mp < pass1; ++mp)
        for (int nt = 0; nt < a.n_tiles; ++nt)
          stream(a.w1p + (size_t)nt * a.ch1 * 9 * STAGE_BYTES, a.ch1 * 9);
      for (int mp = 0; mp < pass2; ++mp)
        for (int nt = 0; nt < a.n_tiles; ++nt) {
          stream(a.w2p + (size_t)nt * a.ch2 * 9 * STAGE_BYTES, a.ch2 * 9);
          if (SC) stream(a.wsp + (size_t)nt * a.ch1 * STAGE_BYTES, a.ch1);
        }
    }
    return;
  }

  // ---- consumers: 2 warpgroups --------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      kConsumerRegs));
  const int wtid = tid % kWG;
  const int lane = tid & 31;
  const int q = lane & 3;
  const int row0 = (wtid >> 5) * 16 + (lane >> 2);  // accumulator rows
  const bool vec_ok = a.vec_ok != 0;
  const T* const xs[1] = {a.x};
  const T* const gb1[4] = {a.g1, a.b1, a.g2, a.b2};
  const T* const gb2[4] = {a.g3, a.b3, a.g4, a.b4};

  // A chunk `chunk` of pass mp from source SRC into buffer `buf`: the n
  // grid pixels from lo = mp * 128 that the pass's two m64 tiles read,
  // stored from the buffer's pixel 0. Item i is the 16 bytes of k step
  // i / (2 n), pixel lo + (i % 2n) / 2, K column i % 2. U items a thread
  // in flight: all their loads (x or raw h1, and g, b) before any use.
  constexpr int U = NACC >= 128 ? 2 : 4;
  auto build = [&](auto src_c, int mp, int chunk, int buf) {
    constexpr int SRC = decltype(src_c)::value;
    unsigned char* dst0 = abuf + buf * A_BYTES;
    const int pitch = SRC == kConv1 ? P1 : P2;
    const int lo = mp * kNWG * 64;
    const int n = kNWG * 64 + 2 * pitch + 2;
    const int rows = SRC == kConv1 ? a.th + 4 : a.th + 2;
    const int org = SRC == kConv1 ? 2 : 1;
    const int lim = SRC == kConv2 ? a.Cout : a.Cin;  // channels
    const int items = KS * 2 * n;
    for (int i0 = tid; i0 < items; i0 += U * kConsumers) {
      V16<T> raw[U][1];
      V16<T> mv[U][SRC == kShortcut ? 1 : 4];  // g, b of the sample
      int sm[U], cc[U], off[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u * kConsumers;
        sm[u] = -1;
        cc[u] = 0;
        off[u] = -1;
        if (i >= items) continue;
        const int kq = i / (2 * n);
        const int r = i - kq * 2 * n;
        const int p = r >> 1;
        const int c = kq * KC + (r & 1) * VEC;  // channel in the chunk
        long long pix;
        grid_pixel(lo + p, pitch, rows, R0 - org, C0 - org, a.H, a.W, a.RS,
                   sm[u], pix);
        cc[u] = chunk * CK + c;
        off[u] = kq * A_STEP + (r & 1) * A_COL + p * 16;
        if constexpr (SRC == kConv2) {
          if (sm[u] >= 0)
            raw[u][0] = *reinterpret_cast<const V16<T>*>(
                h1s + ((size_t)chunk * hpix + lo + p) * CK + c);
        } else {
          load16<T, 1>(xs, sm[u] >= 0 ? pix : -1, cc[u], a.Cin, vec_ok,
                       raw[u]);
        }
        if constexpr (SRC != kShortcut)
          load16<T, 4>(SRC == kConv1 ? gb1 : gb2, sm[u], cc[u], lim, vec_ok,
                       mv[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (off[u] < 0) continue;
        unsigned char* d = dst0 + off[u];
        if constexpr (SRC == kShortcut)
          raw_store<T, ONE>(raw[u][0], sm[u], cc[u], lim, d, A_PART);
        else if constexpr (PARTS == 1)
          mod_store_bf2(raw[u][0], mv[u], sm[u], cc[u], lim, d);
        else
          mod_store<T, ONE>(raw[u][0], mv[u], sm[u], cc[u], lim, d, A_PART);
      }
    }
    fence_proxy_async();
  };

  // x of chunk `chunk` of pass mp into L2 ahead of its build (conv1 and
  // the shortcut; conv2 reads h1 from shared memory): one prefetch a
  // pixel, which covers a chunk's CK * sizeof(T) <= 128 bytes.
  auto prefetch = [&](auto src_c, int mp, int chunk) {
    constexpr int SRC = decltype(src_c)::value;
    if constexpr (SRC != kConv2) {
      const int pitch = SRC == kConv1 ? P1 : P2;
      const int n = kNWG * 64 + 2 * pitch + 2;
      const int org = SRC == kConv1 ? 2 : 1;
      const int c = chunk * CK;
      if (c >= a.Cin) return;
      for (int p = tid; p < n; p += kConsumers) {
        int smp;
        long long pix;
        grid_pixel(mp * kNWG * 64 + p, pitch,
                   SRC == kConv1 ? a.th + 4 : a.th + 2, R0 - org, C0 - org,
                   a.H, a.W, a.RS, smp, pix);
        if (smp >= 0)
          asm volatile("prefetch.global.L2 [%0];\n" ::"l"(
              a.x + pix * a.Cin + c));
      }
    }
  };

  const uint32_t abase = smem_u32(abuf);
  const uint32_t rbase = smem_u32(ring);
  int k = 0;  // weight stages taken so far

  // One GEMM over nch chunks of TAPS taps from SRC into d (and, in fp32,
  // each chunk's sums added into sum): pass mp, whose m64 tile mp * 2 + wg
  // of the source grid is this warpgroup's, none where !active.
  auto gemm = [&](auto src_c, auto taps_c, int nch, int mp, bool active,
                  auto& d, auto& sum) {
    constexpr int SRC = decltype(src_c)::value;
    constexpr int TAPS = decltype(taps_c)::value;
    const int pitch = SRC == kConv1 ? P1 : P2;
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      d[i] = 0.f;
      if constexpr (PROMOTE) sum[i] = 0.f;
    }
    fence_acc(d);
    prefetch(src_c, mp, 1);
    consumer_sync();  // the buffers' last readers are done; h1 is written
    build(src_c, mp, 0, 0);
    consumer_sync();
    for (int ci = 0; ci < nch; ++ci) {
      const int buf = ci & 1;
      const bool more = ci + 1 < nch;
      if (ci + 2 < nch) prefetch(src_c, mp, ci + 2);
      for (int t = 0; t < TAPS; ++t)
        mbar_wait(smem_u32(full + (k + t) % a.stages),
                  (uint32_t)((k + t) / a.stages) & 1u);
      if (active) {
        const uint32_t a0 = abase + buf * A_BYTES + wg * 64 * 16;
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < TAPS; ++t) {
          const int shift =
              TAPS == 1 ? pitch + 1 : (t / 3) * pitch + t % 3;
#pragma unroll
          for (int kq = 0; kq < KS; ++kq) {
            const uint32_t ad = a0 + kq * A_STEP + shift * 16;
            const uint32_t bd = rbase + ((k + t) % a.stages) * STAGE_BYTES +
                                kq * STEP_BYTES;
            const uint64_t da = desc(ad, A_COL, 128);
            const uint64_t db = desc(bd, 128, 256);
            if constexpr (PARTS == 1) {
              mma_bf16<NTILE>(d, da, db);
            } else if constexpr (ONE) {
              mma_tf32<NTILE>(d, da, db);
            } else {
              mma_tf32<NTILE>(d, desc(ad + A_PART, A_COL, 128), db);
              mma_tf32<NTILE>(d, da, desc(bd + PART_BYTES, 128, 256));
              mma_tf32<NTILE>(d, da, db);
            }
          }
        }
        wgmma_commit();
      }
      // the next chunk's A goes to the other buffer (its readers, chunk
      // ci - 1, have finished) while this chunk's products run
      if (more) build(src_c, mp, ci + 1, buf ^ 1);
      if (active) wgmma_wait<0>();
      if (wtid == 0)
        for (int t = 0; t < TAPS; ++t)
          mbar_arrive(smem_u32(empty + (k + t) % a.stages));
      if constexpr (PROMOTE) {
        if (active) {
          fence_acc(d);
#pragma unroll
          for (int i = 0; i < NACC; ++i) {
            sum[i] = __fadd_rn(sum[i], d[i]);
            d[i] = 0.f;
          }
          fence_acc(d);
        }
      }
      k += TAPS;
      if (more) consumer_sync();
    }
    fence_acc(d);
  };

  using C1 = std::integral_constant<int, kConv1>;
  using C2 = std::integral_constant<int, kConv2>;
  using CS = std::integral_constant<int, kShortcut>;
  using Taps9 = std::integral_constant<int, 9>;
  using Taps1 = std::integral_constant<int, 1>;

  float acc[NACC];
  float sum[NACC];                         // fp32: conv1's, conv2's sums
  float acc_s[SC && !PROMOTE ? NACC : 1];  // bf16: the shortcut's sums
  float sum_s[SC && PROMOTE ? NACC : 1];   // fp32: the shortcut's sums

  // ---- conv1 -> raw h1 in shared memory ----
  for (int mp = 0; mp < pass1; ++mp) {
    const int mt = mp * kNWG + wg;
    const bool active = mt < a.m1;
    for (int nt = 0; nt < a.n_tiles; ++nt) {
      gemm(C1{}, Taps9{}, a.ch1, mp, active, acc, sum);
      if (!active) continue;
      const float(&res)[NACC] = PROMOTE ? sum : acc;
#pragma unroll
      for (int jj = 0; jj < NT; ++jj) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v[8];
          gather8(res, jj, half, q, v);
          const int m = mt * 64 + row0 + 8 * half;  // conv1 grid pixel
          const int r = m / P1, c = m - r * P1;
          if (r >= a.th + 2 || c >= a.tw + 2) continue;
          const int ch = nt * NTILE + (4 * jj + q) * 8;
#pragma unroll
          for (int e = 0; e < 8; ++e)
            v[e] = rt<T>(
                __fadd_rn(rt<T>(v[e]), to_f<T>(__ldg(a.c1 + ch + e))));
          store8<T>(h1s + ((size_t)(ch / CK) * hpix + r * P2 + c) * CK +
                        ch % CK,
                    v);
        }
      }
    }
  }

  // ---- conv2, the shortcut, out ----
  const float gam = to_f<T>(__ldg(a.gamma));
  for (int mp = 0; mp < pass2; ++mp) {
    const int mt = mp * kNWG + wg;
    const bool active = mt < a.m2;
    for (int nt = 0; nt < a.n_tiles; ++nt) {
      gemm(C2{}, Taps9{}, a.ch2, mp, active, acc, sum);
      if constexpr (SC) {
        // fp32: conv2's result is in sum and acc is free for the chunks
        if constexpr (PROMOTE)
          gemm(CS{}, Taps1{}, a.ch1, mp, active, acc, sum_s);
        else
          gemm(CS{}, Taps1{}, a.ch1, mp, active, acc_s, sum_s);
      }
      if (!active) continue;
      const float(&res)[NACC] = PROMOTE ? sum : acc;
#pragma unroll
      for (int jj = 0; jj < NT; ++jj) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float v[8], s8[8];
          gather8(res, jj, half, q, v);
          if constexpr (SC) {
            if constexpr (PROMOTE) gather8(sum_s, jj, half, q, s8);
            else gather8(acc_s, jj, half, q, s8);
          }
          const int m = mt * 64 + row0 + 8 * half;  // conv2 grid pixel
          const int r = m / P2, c = m - r * P2;
          if (r >= a.th || c >= a.tw) continue;
          int smp;
          long long pix;
          grid_pixel(r * P2 + c, P2, a.th, R0, C0, a.H, a.W, a.RS, smp, pix);
          if (smp < 0) continue;
          const int ch = nt * NTILE + (4 * jj + q) * 8;
          if constexpr (!SC) {
            V16<T> xv[8 / VEC][1];
#pragma unroll
            for (int h = 0; h < 8 / VEC; ++h)
              load16<T, 1>(xs, pix, ch + h * VEC, a.Cin, vec_ok, xv[h]);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              s8[e] = to_f<T>(xv[e / VEC][0].v[e % VEC]);
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float h2 =
                rt<T>(__fadd_rn(rt<T>(v[e]), to_f<T>(__ldg(a.c2 + ch + e))));
            const float gh = rt<T>(__fmul_rn(gam, h2));
            float sc = s8[e];
            if constexpr (SC)
              sc = rt<T>(__fadd_rn(rt<T>(sc), to_f<T>(__ldg(a.cs + ch + e))));
            v[e] = __fadd_rn(sc, gh);
          }
          store8<T>(a.out + pix * a.Cout + ch, v);
        }
      }
    }
  }
}

// The shared memory of a launch: the barriers, the ring, two A buffers, raw
// h1 (ops/kernels/fused_resblock.py: Plan.smem is the same sum).
template <typename T, int NT>
long long smem_bytes(int stages, int apix, int hpix, int ch2) {
  constexpr int PARTS = Op<T>::PARTS;
  constexpr int KS = ks3_of(PARTS, NT);
  const long long stage = (long long)KS * PARTS * NT * 32 * 32;
  const long long abuf = (long long)KS * PARTS * 32 * apix;
  return kBarBytes + stages * stage + 2 * abuf +
         (long long)hpix * ch2 * KS * Op<T>::KC * sizeof(T);
}

struct Shape {
  int batch, H, W, Cin, Cout, th, tw, stages;
};

template <typename T, int NT, bool SC, bool ONE>
int launch(Args<T> a, const Shape& sh, cudaStream_t stream) {
  constexpr int CK = ks3_of(Op<T>::PARTS, NT) * Op<T>::KC;
  const long long rs = (long long)sh.batch * (sh.H + 1) - 1;
  if (rs > 0x7fffffffLL || sh.th <= 0 || sh.tw <= 0 || sh.stages < 9 ||
      sh.stages > kMaxStages)
    return (int)cudaErrorInvalidValue;
  const int p1 = sh.tw + 4, p2 = sh.tw + 2;
  a.RS = (int)rs;
  a.th = sh.th;
  a.tw = sh.tw;
  a.tiles_w = (sh.W + sh.tw - 1) / sh.tw;
  const long long tiles = (rs + sh.th - 1) / sh.th * a.tiles_w;
  a.n_tiles = sh.Cout / (NT * 32);
  a.ch1 = (sh.Cin + CK - 1) / CK;
  a.ch2 = (sh.Cout + CK - 1) / CK;
  a.m1 = ((sh.th + 1) * p1 + sh.tw + 2 + 63) / 64;
  a.m2 = ((sh.th - 1) * p2 + sh.tw + 63) / 64;
  a.stages = sh.stages;
  a.apix = kNWG * 64 + 2 * p1 + 2;  // p1 > p2
  const long long smem =
      smem_bytes<T, NT>(sh.stages, a.apix, (sh.th + 2) * p2, a.ch2);
  if (tiles > 0x7fffffffLL || smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  auto kernel = fused_resblock_g_kernel<T, NT, SC, ONE>;
  // the opt-in maximum, set once per device: any plan's smem fits under it
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !smem_set[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) smem_set[dev] = true;
  }
  kernel<<<(unsigned)tiles, kThreads, (size_t)smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_nt(int nt, bool sc, bool one, const Args<T>& a, const Shape& sh,
              cudaStream_t s) {
#define GCT_LAUNCH(N, S, O) \
  if (nt == N && sc == S && one == O) return launch<T, N, S, O>(a, sh, s);
  GCT_LAUNCH(1, false, false)
  GCT_LAUNCH(2, false, false)
  GCT_LAUNCH(4, false, false)
  GCT_LAUNCH(1, true, false)
  GCT_LAUNCH(2, true, false)
  if constexpr (Op<T>::PARTS == 1) {  // fp32: N <= 128, <= 64 with sc
    GCT_LAUNCH(8, false, false)
    GCT_LAUNCH(4, true, false)
  } else {  // one TF32 pass: fp32 only
    GCT_LAUNCH(1, false, true)
    GCT_LAUNCH(2, false, true)
    GCT_LAUNCH(4, false, true)
    GCT_LAUNCH(1, true, true)
    GCT_LAUNCH(2, true, true)
  }
#undef GCT_LAUNCH
  return (int)cudaErrorInvalidValue;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// The forward (dtype 0 = float32, 1 = bfloat16). ws and cs both null: the
// identity shortcut (Cin == Cout). w1, w2, ws are read at their element
// strides (w*_strides[0..4)). The plan (ops/kernels/fused_resblock.py:
// _plan): N tiles of nt * 32 channels, output tiles of th x tw pixels of the
// stacked image, a ring of `stages` weight stages. scratch is 16-byte
// aligned and holds the packed w1, w2 and ws, each rounded up to 256 bytes
// (Plan.scratch_bytes). one_pass (0 or 1; 1 only with fp32): one TF32
// product per product in place of 3xTF32. Packs the weights (K2's pack
// kernel, three launches), then launches the kernel once. Returns
// cudaGetLastError()
// after the launches (0 on success), or cudaErrorInvalidValue for a shape
// or plan the kernel does not take.
extern "C" int gct_fused_resblock_g_fwd(
    const void* x, const void* g1, const void* b1, const void* g2,
    const void* b2, const void* w1, const long long* w1_strides,
    const void* c1, const void* g3, const void* b3, const void* g4,
    const void* b4, const void* w2, const long long* w2_strides,
    const void* c2, const void* gamma, const void* ws,
    const long long* ws_strides, const void* cs, void* out, void* scratch,
    int batch, int H, int W, int Cin, int Cout, int nt, int th, int tw,
    int stages, int dtype, int one_pass, void* stream) {
  if (batch <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 ||
      Cout % 32 != 0 || Cout > 256 || (nt != 1 && nt != 2 && nt != 4 &&
                                        nt != 8) ||
      Cout % (nt * 32) != 0 || (dtype != 0 && dtype != 1) ||
      (one_pass != 0 && (one_pass != 1 || dtype != 0)))
    return (int)cudaErrorInvalidValue;
  const bool sc = ws != nullptr;
  if (sc != (cs != nullptr) || (!sc && Cin != Cout))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(out) || !aligned16(scratch))
    return (int)cudaErrorMisalignedAddress;
  const int parts = dtype == 0 ? 2 : 1;
  const int kc = dtype == 0 ? 8 : 16;
  const int ks = ks3_of(parts, nt);
  const int ck = ks * kc;
  const int n_tiles = Cout / (nt * 32);
  const long long esz = dtype == 0 ? 8 : 2;  // bytes a weight, x parts
  auto rounded = [](long long b) { return (b + 255) / 256 * 256; };
  const long long ch1 = (Cin + ck - 1) / ck, ch2 = (Cout + ck - 1) / ck;
  const long long p1 = rounded(n_tiles * ch1 * 9 * ck * nt * 32 * esz);
  const long long p2 = rounded(n_tiles * ch2 * 9 * ck * nt * 32 * esz);
  unsigned char* sc0 = static_cast<unsigned char*>(scratch);
  unsigned char *w1p = sc0, *w2p = sc0 + p1, *wsp = sc0 + p1 + p2;
  int rc = gct_fused_modconv3x3_pack(w1, w1_strides, w1p, 9, Cin, Cout, nt,
                                     ks, n_tiles, dtype, one_pass, stream);
  if (rc == 0)
    rc = gct_fused_modconv3x3_pack(w2, w2_strides, w2p, 9, Cout, Cout, nt,
                                   ks, n_tiles, dtype, one_pass, stream);
  if (rc == 0 && sc)
    rc = gct_fused_modconv3x3_pack(ws, ws_strides, wsp, 1, Cin, Cout, nt,
                                   ks, n_tiles, dtype, one_pass, stream);
  if (rc != 0) return rc;
  const int vec = dtype == 0 ? 4 : 8;
  const bool vec_ok = Cin % vec == 0 && aligned16(x) && aligned16(g1) &&
                      aligned16(b1) && aligned16(g2) && aligned16(b2) &&
                      aligned16(g3) && aligned16(b3) && aligned16(g4) &&
                      aligned16(b4);
  const Shape sh{batch, H, W, Cin, Cout, th, tw, stages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto fill = [&](auto a) {
    using T = std::remove_cv_t<std::remove_pointer_t<decltype(a.x)>>;
    auto p = [](const void* v) { return static_cast<const T*>(v); };
    a.x = p(x); a.g1 = p(g1); a.b1 = p(b1); a.g2 = p(g2); a.b2 = p(b2);
    a.c1 = p(c1); a.g3 = p(g3); a.b3 = p(b3); a.g4 = p(g4); a.b4 = p(b4);
    a.c2 = p(c2); a.gamma = p(gamma); a.cs = p(cs);
    a.w1p = w1p; a.w2p = w2p; a.wsp = sc ? wsp : nullptr;
    a.out = static_cast<T*>(out);
    a.H = H; a.W = W; a.Cin = Cin; a.Cout = Cout;
    a.vec_ok = vec_ok ? 1 : 0;
    return launch_nt<T>(nt, sc, one_pass == 1, a, sh, s);
  };
  if (dtype == 0) return fill(Args<float>{});
  return fill(Args<__nv_bfloat16>{});
}
