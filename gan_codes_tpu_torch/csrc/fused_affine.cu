// Fused double affine modulation + LeakyReLU (kernel K1), forward and
// backward, sm_90a.
//
//   out = lrelu(g2 * lrelu(g1 * x + b1) + b2),  slope 0.2 rounded to T
//   x, out [B, H, W, C] (NHWC, contiguous); g1, b1, g2, b2 [B, C].
//
// Replaces: the Pallas TPU kernels of gan_codes_tpu/ops/pallas/fused_affine.py
// (forward: `_fwd_kernel` via `_fwd`; backward: `_bwd_kernel` via `_bwd_call`,
// the custom VJP of the public `fused_double_affine_leaky`).
//
// Bound on the H100: bytes, in both directions. The forward reads x and
// writes out (2N bytes, N = B*H*W*C * sizeof(T)); the backward reads x and
// dy and writes dx (3N), and 4N where it also writes z = the forward's
// output, which K2's backward takes for its weight gradient instead of a
// forward launch of its own. The [B, C] vectors are negligible. Each element
// costs a handful of flops, far below the ~20 flop/byte the card needs
// before its fp32 units become the limit.
//
// One streaming layout for both directions (the plan, chosen on the host by
// `_plan` in ops/kernels/fused_affine.py and checked here):
//   * Each thread owns one 16-byte channel vector (VEC = 4 fp32 or 8 bf16
//     channels), loads that vector of g1, b1, g2 and b2 once, as 16-byte
//     loads, into registers, and walks pixels of one sample: row, row +
//     rows, ... of its block's pixel range, two pixels an iteration, so
//     each input tensor has two independent 16-byte loads in flight. The
//     walk is a pointer increment: no divide or modulo in the loop.
//   * A block is `lanes` channel vectors (a power of two <= 16: a warp
//     reads runs of 128-256 contiguous bytes) times `rows` pixels, 32 to
//     kMaxThreads threads, two blocks an SM. The grid is (sample x channel
//     chunk) x pixel split: blockIdx.x = (sample * chunks + chunk) * split
//     + s, each of the `split` blocks taking `ppb` consecutive pixels.
//     Measured on the H100: fewer threads each walking more pixels beat
//     1024-thread blocks; a cluster's blocks share one GPC, so the card
//     holds 14 clusters of 16 blocks of 512 threads at once (112 SMs).
//   * bf16 computes on bf16x2 pairs (the `bf2` helpers below), fp32 as
//     floats.
//   * Where C is not a multiple of VEC, or a pointer is not 16-byte
//     aligned, the plan has vec = 1 and the scalar instantiation runs.
//
// Backward, in one launch with no scratch and no atomics on data. The
// `split` blocks of one (sample, chunk) form one thread-block cluster (up
// to 16 blocks, the non-portable size; 8 would leave half the card idle at
// batch 8). Each thread adds its pixels' four gradient terms two pixels at
// a time in fp32 (one rounding) and then into its own fp64 sums in shared
// memory; the block adds its rows in a fixed order (a halving tree in
// shared memory); after cluster.sync() rank 0 reads the other ranks' block
// sums through distributed shared memory in rank order, adds them in fp64
// and rounds once to T. The result repeats bit for bit. fp64 because an
// fp32 sum over a thread's 128 pixels (a 256x256 map, batch 24) drifted
// past allclose(1e-4) of a gradient whose terms cancel, on the card.
//
// Numerics: the math follows x's dtype like the TPU kernel and the plain
// PyTorch version: every elementwise multiply and add is rounded to T
// (`mod_chain` and `mul_t` in common.cuh), the masks are taken as y >= 0
// (slope 1 at exactly 0, as the TPU kernel takes it). The forward, dx and
// z therefore equal the plain version of the same dtype, and z equals the
// forward's output bit for bit. The four per-sample gradients add the
// products (each rounded to T) and round once at the end, as the plain
// version does; the order of the additions differs, and all but the first
// (a pixel pair, fp32) are fp64.

#include <stdint.h>

#include <initializer_list>

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using gct::from_f;
using gct::kSlope;
using gct::mod_chain;
using gct::mul_t;
using gct::rt;
using gct::to_f;

// Threads of a block, two blocks an SM: fp32 512 (64 registers a thread,
// 1024 threads an SM); bf16 256, as the 32 gradient terms of a thread's 8
// channels and its g and b take up to 128 registers (held to 64 they
// spilled, and the backward ran far slower on the H100).
template <typename T>
constexpr int kMaxThreads = sizeof(T) == 4 ? 512 : 256;
constexpr int kMinBlocks = 2;
constexpr int kMaxSplit = 16;  // the non-portable cluster size

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// Where one thread's pixels lie: the first pack offset (in packs of VEC
// channels), the stride between its pixels and how many it has.
struct Walk {
  long long off;
  long long step;
  int n;
  int b;
  int chunk;
  int cv;
};

__device__ __forceinline__ Walk plan_walk(long long hw, int nvc, int lanes,
                                          int rows, int chunks, int split,
                                          int ppb) {
  Walk w;
  const int s = (int)(blockIdx.x % (unsigned)split);
  const int grp = (int)(blockIdx.x / (unsigned)split);
  w.b = grp / chunks;
  w.chunk = grp - w.b * chunks;
  const int lane = (int)threadIdx.x & (lanes - 1);
  const int row = (int)threadIdx.x / lanes;
  w.cv = w.chunk * lanes + lane;
  const long long p0 = (long long)s * ppb + row;
  const long long p1 = min((long long)(s + 1) * ppb, hw);
  w.n = (w.cv < nvc && p0 < p1) ? (int)((p1 - p0 + rows - 1) / rows) : 0;
  w.off = ((long long)w.b * hw + p0) * nvc + w.cv;
  w.step = (long long)rows * nvc;
  return w;
}

template <typename T, int VEC>
struct Vecs {
  Pack<T, VEC> g1, b1, g2, b2;
};

template <typename T, int VEC>
__device__ __forceinline__ Vecs<T, VEC> load_vecs(
    const T* g1, const T* b1, const T* g2, const T* b2, long long base,
    int cv) {
  using P = Pack<T, VEC>;
  Vecs<T, VEC> v;
  v.g1 = reinterpret_cast<const P*>(g1 + base)[cv];
  v.b1 = reinterpret_cast<const P*>(b1 + base)[cv];
  v.g2 = reinterpret_cast<const P*>(g2 + base)[cv];
  v.b2 = reinterpret_cast<const P*>(b2 + base)[cv];
  return v;
}

// bf16 pairs: common.cuh's gct::bf2, Hopper's native bf16x2 ops on the
// 16-byte vector of 8 bf16 channels as 4 words of two.
namespace bf2 = gct::bf2;

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> fwd_pack(const Pack<T, VEC>& in,
                                                 const Vecs<T, VEC>& p) {
  Pack<T, VEC> res;
  if constexpr (bf2::kPacked<T, VEC>) {
    const uint32_t *x = bf2::words(&in), *g1 = bf2::words(&p.g1),
                   *b1 = bf2::words(&p.b1), *g2 = bf2::words(&p.g2),
                   *b2 = bf2::words(&p.b2);
    uint32_t* o = reinterpret_cast<uint32_t*>(&res);
#pragma unroll
    for (int j = 0; j < VEC / 2; ++j) {
      const uint32_t y1 = bf2::add(bf2::mul(g1[j], x[j]), b1[j]);
      const uint32_t h =
          bf2::select(y1, bf2::slope(y1), bf2::neg_mask(y1));
      const uint32_t y2 = bf2::add(bf2::mul(g2[j], h), b2[j]);
      o[j] = bf2::select(y2, bf2::slope(y2), bf2::neg_mask(y2));
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      res.v[k] = from_f<T>(mod_chain<T>(
          to_f<T>(in.v[k]), to_f<T>(p.g1.v[k]), to_f<T>(p.b1.v[k]),
          to_f<T>(p.g2.v[k]), to_f<T>(p.b2.v[k])));
  }
  return res;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads<T>, kMinBlocks)
fused_affine_fwd_kernel(const T* __restrict__ x, const T* __restrict__ g1,
                        const T* __restrict__ b1, const T* __restrict__ g2,
                        const T* __restrict__ b2, T* __restrict__ out,
                        long long hw, int c, int lanes, int rows, int chunks,
                        int split, int ppb) {
  using P = Pack<T, VEC>;
  const int nvc = c / VEC;
  const Walk w = plan_walk(hw, nvc, lanes, rows, chunks, split, ppb);
  if (w.n == 0) return;
  const Vecs<T, VEC> p =
      load_vecs<T, VEC>(g1, b1, g2, b2, (long long)w.b * c, w.cv);
  const P* xp = reinterpret_cast<const P*>(x) + w.off;
  P* op = reinterpret_cast<P*>(out) + w.off;
  int i = 0;
  for (; i + 2 <= w.n; i += 2) {
    const P xa = xp[0];
    const P xb = xp[w.step];
    op[0] = fwd_pack<T, VEC>(xa, p);
    op[w.step] = fwd_pack<T, VEC>(xb, p);
    xp += 2 * w.step;
    op += 2 * w.step;
  }
  if (i < w.n) op[0] = fwd_pack<T, VEC>(xp[0], p);
}

// One pixel of the backward: dx (and z) for its VEC channels, and the four
// gradient terms added into acc[j * VEC + k] (g1, b1, g2, b2).
template <typename T, int VEC, bool WANT_Z>
__device__ __forceinline__ void bwd_pack(const Pack<T, VEC>& xin,
                                         const Pack<T, VEC>& din,
                                         const Vecs<T, VEC>& p,
                                         Pack<T, VEC>* dxo, Pack<T, VEC>* zo,
                                         float* acc) {
  Pack<T, VEC> d, zr;
  if constexpr (bf2::kPacked<T, VEC>) {
    const uint32_t *x = bf2::words(&xin), *dy = bf2::words(&din),
                   *g1 = bf2::words(&p.g1), *b1 = bf2::words(&p.b1),
                   *g2 = bf2::words(&p.g2), *b2 = bf2::words(&p.b2);
    uint32_t* dw = reinterpret_cast<uint32_t*>(&d);
    uint32_t* zw = reinterpret_cast<uint32_t*>(&zr);
#pragma unroll
    for (int j = 0; j < VEC / 2; ++j) {
      const uint32_t y1 = bf2::add(bf2::mul(g1[j], x[j]), b1[j]);
      const uint32_t m1 = bf2::neg_mask(y1);
      const uint32_t h = bf2::select(y1, bf2::slope(y1), m1);
      const uint32_t y2 = bf2::add(bf2::mul(g2[j], h), b2[j]);
      const uint32_t m2 = bf2::neg_mask(y2);
      if (WANT_Z) zw[j] = bf2::select(y2, bf2::slope(y2), m2);
      const uint32_t dy2 = bf2::select(dy[j], bf2::slope(dy[j]), m2);
      const uint32_t dh = bf2::mul(dy2, g2[j]);
      const uint32_t dy1 = bf2::select(dh, bf2::slope(dh), m1);
      dw[j] = bf2::mul(dy1, g1[j]);
      const uint32_t t1 = bf2::mul(dy1, x[j]);
      const uint32_t t2 = bf2::mul(dy2, h);
      acc[2 * j] += bf2::lo(t1);
      acc[2 * j + 1] += bf2::hi(t1);
      acc[VEC + 2 * j] += bf2::lo(dy1);
      acc[VEC + 2 * j + 1] += bf2::hi(dy1);
      acc[2 * VEC + 2 * j] += bf2::lo(t2);
      acc[2 * VEC + 2 * j + 1] += bf2::hi(t2);
      acc[3 * VEC + 2 * j] += bf2::lo(dy2);
      acc[3 * VEC + 2 * j + 1] += bf2::hi(dy2);
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float xv = to_f<T>(xin.v[k]);
      const float dv = to_f<T>(din.v[k]);
      const float g1 = to_f<T>(p.g1.v[k]);
      const float g2 = to_f<T>(p.g2.v[k]);
      // the forward exactly as mod_chain rounds it
      const float y1 =
          rt<T>(__fadd_rn(mul_t<T>(g1, xv), to_f<T>(p.b1.v[k])));
      const bool pos1 = y1 >= 0.f;
      const float h = pos1 ? y1 : mul_t<T>(y1, kSlope<T>);
      const float y2 =
          rt<T>(__fadd_rn(mul_t<T>(g2, h), to_f<T>(p.b2.v[k])));
      const bool pos2 = y2 >= 0.f;
      if (WANT_Z)
        zr.v[k] = from_f<T>(pos2 ? y2 : mul_t<T>(y2, kSlope<T>));
      const float dy2 = pos2 ? dv : mul_t<T>(dv, kSlope<T>);
      const float dh = mul_t<T>(dy2, g2);
      const float dy1 = pos1 ? dh : mul_t<T>(dh, kSlope<T>);
      d.v[k] = from_f<T>(mul_t<T>(dy1, g1));
      acc[k] += mul_t<T>(dy1, xv);
      acc[VEC + k] += dy1;
      acc[2 * VEC + k] += mul_t<T>(dy2, h);
      acc[3 * VEC + k] += dy2;
    }
  }
  *dxo = d;
  if (WANT_Z) *zo = zr;
}

// Dynamic shared memory of the backward for a block of `threads` threads:
// one fp64 sum per (gradient term, thread), [4 * vec][threads].
__host__ __device__ inline int bwd_smem_bytes(int threads, int vec) {
  return 4 * vec * threads * (int)sizeof(double);
}

template <typename T, int VEC, bool WANT_Z>
__global__ void __launch_bounds__(kMaxThreads<T>, kMinBlocks)
fused_affine_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g1,
                        const T* __restrict__ b1, const T* __restrict__ g2,
                        const T* __restrict__ b2, const T* __restrict__ dy,
                        T* __restrict__ dx, T* __restrict__ z,
                        T* __restrict__ dgb, int batch, long long hw, int c,
                        int lanes, int rows, int chunks, int split, int ppb) {
  using P = Pack<T, VEC>;
  constexpr int NQ = 4 * VEC;
  // tot[q * threads + t]: thread t's sum of gradient term q (j * VEC + k:
  // g1, b1, g2, b2 of its channel k), in fp64
  extern __shared__ double tot[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nvc = c / VEC;
  const int nt = (int)blockDim.x;
  const int tid = (int)threadIdx.x;
  const Walk w = plan_walk(hw, nvc, lanes, rows, chunks, split, ppb);
#pragma unroll
  for (int q = 0; q < NQ; ++q) tot[q * nt + tid] = 0.0;

  if (w.n > 0) {
    const Vecs<T, VEC> p =
        load_vecs<T, VEC>(g1, b1, g2, b2, (long long)w.b * c, w.cv);
    // one offset for the four tensors: fewer live registers than four
    // pointers
    const P* xp = reinterpret_cast<const P*>(x);
    const P* dp = reinterpret_cast<const P*>(dy);
    P* dxp = reinterpret_cast<P*>(dx);
    P* zp = reinterpret_cast<P*>(z);
    long long off = w.off;
    // the terms of one or two pixels, added in fp32 (one rounding), then
    // into the thread's fp64 sums: so no fp32 sum runs over many pixels
    float acc[NQ];
    auto flush = [&]() {
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        tot[q * nt + tid] += (double)acc[q];
        acc[q] = 0.f;
      }
    };
#pragma unroll
    for (int q = 0; q < NQ; ++q) acc[q] = 0.f;
    int i = 0;
    for (; i + 2 <= w.n; i += 2) {
      const P xa = xp[off];
      const P xb = xp[off + w.step];
      const P da = dp[off];
      const P db = dp[off + w.step];
      bwd_pack<T, VEC, WANT_Z>(xa, da, p, dxp + off, zp + off, acc);
      bwd_pack<T, VEC, WANT_Z>(xb, db, p, dxp + off + w.step,
                               zp + off + w.step, acc);
      flush();
      off += 2 * w.step;
    }
    if (i < w.n) {
      bwd_pack<T, VEC, WANT_Z>(xp[off], dp[off], p, dxp + off, zp + off,
                               acc);
      flush();
    }
  }

  // the block's rows, a halving tree in a fixed order: row r adds row
  // r + half, so thread `lane` (row 0) ends with the block's sums
  const int row = tid / lanes;
  for (int half = rows >> 1; half >= 1; half >>= 1) {
    __syncthreads();
    if (row < half) {
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        tot[q * nt + tid] += tot[q * nt + tid + half * lanes];
    }
  }
  cluster.sync();
  // rank 0 adds the cluster's block sums in rank order, through
  // distributed shared memory, and rounds once to T
  if (cluster.block_rank() == 0) {
    for (int o = tid; o < NQ * lanes; o += nt) {
      const int q = o / lanes;
      const int l = o - q * lanes;
      const int cv = w.chunk * lanes + l;
      if (cv >= nvc) continue;
      double s = 0.0;
      for (int r = 0; r < split; ++r)
        s += cluster.map_shared_rank(tot, r)[q * nt + l];
      const int j = q / VEC;
      const int k = q - j * VEC;
      dgb[((long long)j * batch + w.b) * c + (long long)cv * VEC + k] =
          from_f<T>((float)s);
    }
  }
  cluster.sync();  // the other ranks' shared memory stays until it is read
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// The plan as the wrapper passes it; what the kernels rely on is checked
// here, so a wrong plan is refused instead of reading out of bounds.
struct PlanArgs {
  int vec, lanes, rows, chunks, split, ppb;
};

bool pow2(int v) { return v > 0 && (v & (v - 1)) == 0; }

template <typename T>
cudaError_t check_plan(const PlanArgs& pl, long long batch, long long hw,
                       int c) {
  const int threads = pl.lanes * pl.rows;
  const bool ok =
      (pl.vec == 1 || pl.vec == (int)(16 / sizeof(T))) && c % pl.vec == 0 &&
      pow2(pl.lanes) && pl.lanes <= 32 && pow2(pl.rows) && threads >= 32 &&
      threads <= kMaxThreads<T> && pl.chunks >= 1 &&
      (long long)pl.chunks * pl.lanes * pl.vec >= c &&
      (long long)(pl.chunks - 1) * pl.lanes * pl.vec < c && pl.split >= 1 &&
      pl.split <= kMaxSplit && pl.ppb >= 1 &&
      (long long)pl.split * pl.ppb >= hw &&
      (long long)(pl.split - 1) * pl.ppb < hw &&
      batch * pl.chunks * pl.split <= 0x7fffffffLL;
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

template <typename T, int VEC>
int launch_fwd(const void* x, const void* g1, const void* b1, const void* g2,
               const void* b2, void* out, long long batch, long long hw, int c,
               const PlanArgs& pl, cudaStream_t stream) {
  const unsigned blocks = (unsigned)(batch * pl.chunks * pl.split);
  fused_affine_fwd_kernel<T, VEC><<<blocks, pl.lanes * pl.rows, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g1),
      static_cast<const T*>(b1), static_cast<const T*>(g2),
      static_cast<const T*>(b2), static_cast<T*>(out), hw, c, pl.lanes,
      pl.rows, pl.chunks, pl.split, pl.ppb);
  return (int)cudaGetLastError();
}

// The backward's function attributes, set once per device: 64 KB of
// dynamic shared memory (its fp64 sums at kMaxThreads) and clusters of up
// to 16 blocks.
template <typename T, int VEC, bool WANT_Z>
cudaError_t bwd_attributes() {
  static bool set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && set[dev])) return err;
  auto kernel = fused_affine_bwd_kernel<T, VEC, WANT_Z>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bwd_smem_bytes(kMaxThreads<T>, VEC));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && dev < 64) set[dev] = true;
  return err;
}

cudaLaunchConfig_t cluster_config(unsigned blocks, int threads, int smem,
                                  int split, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)split;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int VEC, bool WANT_Z>
int launch_bwd(const void* x, const void* g1, const void* b1, const void* g2,
               const void* b2, const void* dy, void* dx, void* z, void* dgb,
               long long batch, long long hw, int c, const PlanArgs& pl,
               cudaStream_t stream) {
  cudaError_t err = bwd_attributes<T, VEC, WANT_Z>();
  if (err != cudaSuccess) return (int)err;
  const int threads = pl.lanes * pl.rows;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      (unsigned)(batch * pl.chunks * pl.split), threads,
      bwd_smem_bytes(threads, VEC), pl.split, stream, &attr);
  err = cudaLaunchKernelEx(
      &cfg, fused_affine_bwd_kernel<T, VEC, WANT_Z>,
      static_cast<const T*>(x), static_cast<const T*>(g1),
      static_cast<const T*>(b1), static_cast<const T*>(g2),
      static_cast<const T*>(b2), static_cast<const T*>(dy),
      static_cast<T*>(dx), static_cast<T*>(z), static_cast<T*>(dgb),
      (int)batch, hw, c, pl.lanes, pl.rows, pl.chunks, pl.split, pl.ppb);
  if (err != cudaSuccess) {
    (void)cudaGetLastError();
    return (int)err;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_fwd(const void* x, const void* g1, const void* b1,
                 const void* g2, const void* b2, void* out, long long batch,
                 long long hw, int c, const PlanArgs& pl,
                 cudaStream_t stream) {
  cudaError_t err = check_plan<T>(pl, batch, hw, c);
  if (err != cudaSuccess) return (int)err;
  if (pl.vec == 1)
    return launch_fwd<T, 1>(x, g1, b1, g2, b2, out, batch, hw, c, pl, stream);
  for (const void* ptr : {x, g1, b1, g2, b2, (const void*)out})
    if (!aligned16(ptr)) return (int)cudaErrorMisalignedAddress;
  return launch_fwd<T, 16 / sizeof(T)>(x, g1, b1, g2, b2, out, batch, hw, c,
                                       pl, stream);
}

template <typename T>
int dispatch_bwd(const void* x, const void* g1, const void* b1,
                 const void* g2, const void* b2, const void* dy, void* dx,
                 void* z, void* dgb, long long batch, long long hw, int c,
                 const PlanArgs& pl, cudaStream_t stream) {
  cudaError_t err = check_plan<T>(pl, batch, hw, c);
  if (err != cudaSuccess) return (int)err;
  if (batch > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  constexpr int kVec = 16 / sizeof(T);
  if (pl.vec == 1) {
    return z ? launch_bwd<T, 1, true>(x, g1, b1, g2, b2, dy, dx, z, dgb,
                                      batch, hw, c, pl, stream)
             : launch_bwd<T, 1, false>(x, g1, b1, g2, b2, dy, dx, z, dgb,
                                       batch, hw, c, pl, stream);
  }
  for (const void* ptr : {x, g1, b1, g2, b2, dy, (const void*)dx})
    if (!aligned16(ptr)) return (int)cudaErrorMisalignedAddress;
  if (z && !aligned16(z)) return (int)cudaErrorMisalignedAddress;
  return z ? launch_bwd<T, kVec, true>(x, g1, b1, g2, b2, dy, dx, z, dgb,
                                       batch, hw, c, pl, stream)
           : launch_bwd<T, kVec, false>(x, g1, b1, g2, b2, dy, dx, z, dgb,
                                        batch, hw, c, pl, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. The plan (vec, lanes, rows, chunks,
// split, ppb) is `_plan`'s in ops/kernels/fused_affine.py. Returns
// cudaGetLastError() after the launch (0 on success), or the reason the
// plan or a pointer was refused; launches nothing for an empty tensor.
extern "C" int gct_fused_affine_fwd(const void* x, const void* g1,
                                    const void* b1, const void* g2,
                                    const void* b2, void* out,
                                    long long batch, long long hw, int c,
                                    int vec, int lanes, int rows, int chunks,
                                    int split, int ppb, int dtype,
                                    void* stream) {
  if (batch * hw * c == 0) return 0;
  if (c <= 0) return (int)cudaErrorInvalidValue;
  const PlanArgs pl{vec, lanes, rows, chunks, split, ppb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_fwd<float>(x, g1, b1, g2, b2, out, batch, hw, c, pl, s);
  if (dtype == 1)
    return dispatch_fwd<__nv_bfloat16>(x, g1, b1, g2, b2, out, batch, hw, c,
                                       pl, s);
  return (int)cudaErrorInvalidValue;
}

// Backward of gct_fused_affine_fwd, one launch: dx [B, H*W, C], and where
// z is not null the forward's output z [B, H*W, C], and dgb [4, B, C], the
// per-sample sums over H*W of the gradients of g1, b1, g2 and b2, all in
// x's dtype. Returns cudaGetLastError() after the launch (0 on success).
// The caller handles hw == 0 (no pixels: the sums are zeros).
extern "C" int gct_fused_affine_bwd(const void* x, const void* g1,
                                    const void* b1, const void* g2,
                                    const void* b2, const void* dy, void* dx,
                                    void* z, void* dgb, long long batch,
                                    long long hw, int c, int vec, int lanes,
                                    int rows, int chunks, int split, int ppb,
                                    int dtype, void* stream) {
  if (batch * hw * c == 0) return 0;
  if (c <= 0) return (int)cudaErrorInvalidValue;
  const PlanArgs pl{vec, lanes, rows, chunks, split, ppb};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_bwd<float>(x, g1, b1, g2, b2, dy, dx, z, dgb, batch, hw,
                               c, pl, s);
  if (dtype == 1)
    return dispatch_bwd<__nv_bfloat16>(x, g1, b1, g2, b2, dy, dx, z, dgb,
                                       batch, hw, c, pl, s);
  return (int)cudaErrorInvalidValue;
}

namespace {

template <typename T>
int max_clusters(int split, int threads, int* out) {
  constexpr int kVec = 16 / sizeof(T);
  cudaError_t err = bwd_attributes<T, kVec, true>();
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      (unsigned)split, threads, bwd_smem_bytes(threads, kVec),
      split, nullptr, &attr);
  return (int)cudaOccupancyMaxActiveClusters(
      out, fused_affine_bwd_kernel<T, kVec, true>, &cfg);
}

}  // namespace

// How many clusters of `split` backward blocks (with z) of `threads`
// threads the card can hold at once
// (cudaOccupancyMaxActiveClusters), into *out. dtype as above, vector
// path. Returns the CUDA error (0 on success).
extern "C" int gct_fused_affine_bwd_max_clusters(int split, int threads,
                                                 int dtype, int* out) {
  if (dtype == 0) return max_clusters<float>(split, threads, out);
  if (dtype == 1) return max_clusters<__nv_bfloat16>(split, threads, out);
  return (int)cudaErrorInvalidValue;
}
