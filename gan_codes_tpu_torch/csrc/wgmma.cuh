// The wgmma machinery of the implicit-GEMM kernels, shared by K2
// (fused_modconv.cu) and K3 (fused_resblock.cu), sm_90a: the operand
// chunking (Op, ks_of), the PTX wrappers (mbarriers, cp.async.bulk, the
// no-swizzle shared-memory descriptors, wgmma fence / commit / wait and the
// m64nNk16 bf16 and m64nNk8 tf32 products), the tf32 hi/lo split (hi alone
// for one TF32 pass), and the loads and stores that build an A operand
// chunk from raw activations.
#pragma once

#include <stdint.h>

#include "common.cuh"

namespace gct {

template <typename T> struct Op;
template <> struct Op<__nv_bfloat16> {
  static constexpr int KC = 16;     // channels per wgmma k step (k16)
  static constexpr int PARTS = 1;   // operand planes
};
template <> struct Op<float> {
  static constexpr int KC = 8;      // wgmma k8 (tf32)
  static constexpr int PARTS = 2;   // hi, lo
};

// k steps per K chunk. Longer chunks mean fewer synchronisations per
// product: as many as keep a chunk's modulated halo within 12.8 KB and one
// tap's weight stage within 8 KB, one at least, and one for N = 32, whose
// Cin of 32-64 then still spans several chunks, so that each chunk's
// modulation overlaps the previous chunk's products (measured faster)
__host__ __device__ constexpr int ks_of(int parts, int nt) {
  return nt == 1 ? 1
         : 4 / parts < 8 / (parts * nt)
             ? 4 / parts
             : (8 / (parts * nt) < 1 ? 1 : 8 / (parts * nt));
}

// K3's k steps per K chunk: a weight stage (one tap) of at most 8 KB, at
// most 4 k steps (a chunk's channels fill one 128-byte line of a pixel).
// Longer chunks than K2's: K3's 128 M rows a pass pay the chunk loop's
// fixed costs (barriers, the A build's load latency) once per chunk.
__host__ __device__ constexpr int ks3_of(int parts, int nt) {
  return 8 / (parts * nt) < 1 ? 1 : (8 / (parts * nt) > 4 ? 4
                                                          : 8 / (parts * nt));
}

template <typename T>
struct alignas(16) V16 {
  T v[16 / sizeof(T)];
};

// ---- PTX wrappers --------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins the accumulators at this point of the program: the compiler may not
// move their reads or writes across it (wgmma writes them asynchronously).
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor, no swizzle: start address, the byte
// offset between the two core-matrix columns along K (lbo) and between
// 8-row core-matrix groups along M or N (sbo), all in 16-byte units.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

#define GCT_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),            \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define GCT_D16(i) GCT_D8(i), GCT_D8(i + 8)
#define GCT_D32(i) GCT_D16(i), GCT_D16(i + 16)
#define GCT_D64(i) GCT_D32(i), GCT_D32(i + 32)
#define GCT_D128(i) GCT_D64(i), GCT_D64(i + 64)

// d[64 x N] += A[64 x 16] * B[16 x N], bf16, both K-major in shared memory
// (da, db), fp32 sums in registers in wgmma's accumulator layout
template <int N>
__device__ void mma_bf16(float (&d)[N / 2], uint64_t da, uint64_t db);
// d[64 x N] += A[64 x 8] * B[8 x N], tf32, both K-major in shared memory
// (N up to 128: the fp32 N tile)
template <int N>
__device__ void mma_tf32(float (&d)[N / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void mma_bf16<32>(float (&d)[16], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : GCT_D16(0)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_tf32<32>(float (&d)[16], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : GCT_D16(0)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_bf16<64>(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : GCT_D32(0)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_tf32<64>(float (&d)[32], uint64_t da,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : GCT_D32(0)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_bf16<128>(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : GCT_D64(0)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_tf32<128>(float (&d)[64], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : GCT_D64(0)
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void mma_bf16<256>(float (&d)[128], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : GCT_D128(0)
      : "l"(da), "l"(db), "r"(1));
}

#undef GCT_D8
#undef GCT_D16
#undef GCT_D32
#undef GCT_D64
#undef GCT_D128

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// ---- A operand chunks: raw loads, modulation ----------------------------

// The element-by-element path of load16 (a Cin that is not a multiple of
// the vector width, or a misaligned array), out of line: it is rare, and
// inlined in every unrolled item it would bloat the kernel's code.
template <typename T>
__device__ __noinline__ V16<T> load_elements(const T* __restrict__ a,
                                             long long row, int c, int Cin) {
  V16<T> r;
  for (int e = 0; e < 16 / (int)sizeof(T); ++e)
    r.v[e] = (row >= 0 && c + e < Cin) ? a[row * Cin + c + e]
                                       : from_f<T>(0.f);
  return r;
}

// 16 bytes of channels [c, c + VEC) of row `row` of each of the N [rows,
// Cin] arrays a[0..N): 0 past Cin and for row < 0. The 16-byte path issues
// all N loads before any use (one memory latency) from an address that is
// always valid, and zeroes the result after.
template <typename T, int N>
__device__ __forceinline__ void load16(const T* const (&a)[N], long long row,
                                       int c, int Cin, bool vec_ok,
                                       V16<T> (&r)[N]) {
  if (vec_ok) {
    const bool ok = row >= 0 && c < Cin;
    const long long off = ok ? row * Cin + c : 0;
    uint4 u[N];
#pragma unroll
    for (int i = 0; i < N; ++i)
      u[i] = __ldg(reinterpret_cast<const uint4*>(a[i] + off));
#pragma unroll
    for (int i = 0; i < N; ++i)
      *reinterpret_cast<uint4*>(&r[i]) = ok ? u[i] : make_uint4(0, 0, 0, 0);
    return;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = load_elements(a[i], row, c, Cin);
}

// Modulate one 16-byte vector of the halo (x, and g1, b1, g2, b2 of its
// sample s) and store it as the wgmma operand: T for bf16; tf32 hi and lo
// planes, lo_off bytes apart, for fp32 (HI_ONLY: the hi plane alone, the
// operand of one TF32 pass).
template <typename T, bool HI_ONLY = false>
__device__ __forceinline__ void mod_store(const V16<T>& raw,
                                          const V16<T> (&m)[4], int s, int c,
                                          int Cin, unsigned char* dst,
                                          int lo_off) {
  constexpr int VEC = 16 / sizeof(T);
  float v[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    v[e] = (s >= 0 && c + e < Cin)
               ? mod_chain<T>(to_f<T>(raw.v[e]), to_f<T>(m[0].v[e]),
                              to_f<T>(m[1].v[e]), to_f<T>(m[2].v[e]),
                              to_f<T>(m[3].v[e]))
               : 0.f;
  if constexpr (Op<T>::PARTS == 1) {
    V16<T> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) o.v[e] = from_f<T>(v[e]);
    *reinterpret_cast<V16<T>*>(dst) = o;
  } else {
    uint4 hi, lo;
    uint32_t* h = reinterpret_cast<uint32_t*>(&hi);
    uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      h[e] = tf32_rna(v[e]);
      if constexpr (!HI_ONLY) l[e] = tf32_rna(v[e] - __uint_as_float(h[e]));
    }
    *reinterpret_cast<uint4*>(dst) = hi;
    if constexpr (!HI_ONLY) *reinterpret_cast<uint4*>(dst + lo_off) = lo;
  }
}


// mod_store of bf16 on bf16 pairs (common.cuh's bf2, equal to mod_chain op
// for op, as K1's forward computes it): a quarter of the instructions of
// the fp32 emulation, for K3, whose A chunks are built from 128 M rows a
// pass and whose chunk loop the build bounds.
__device__ __forceinline__ void mod_store_bf2(
    const V16<__nv_bfloat16>& raw, const V16<__nv_bfloat16> (&m)[4], int s,
    int c, int Cin, unsigned char* dst) {
  const uint32_t *x = bf2::words(&raw), *g1 = bf2::words(&m[0]),
                 *b1 = bf2::words(&m[1]), *g2 = bf2::words(&m[2]),
                 *b2 = bf2::words(&m[3]);
  uint4 o = make_uint4(0, 0, 0, 0);
  if (s >= 0) {
    uint32_t* w = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t y1 = bf2::add(bf2::mul(g1[j], x[j]), b1[j]);
      const uint32_t h = bf2::select(y1, bf2::slope(y1), bf2::neg_mask(y1));
      const uint32_t y2 = bf2::add(bf2::mul(g2[j], h), b2[j]);
      w[j] = bf2::select(y2, bf2::slope(y2), bf2::neg_mask(y2));
      // channels past Cin (a tail vector) stay 0
      if (c + 2 * j >= Cin) w[j] = 0;
      else if (c + 2 * j + 1 >= Cin) w[j] &= 0xffffu;
    }
  }
  *reinterpret_cast<uint4*>(dst) = o;
}

// A raw 16-byte vector (0 for s < 0 and past Cin) stored as the wgmma
// operand, as mod_store stores a modulated one: the A operand of a conv of
// the unmodulated input (K3's 1x1 shortcut).
template <typename T, bool HI_ONLY = false>
__device__ __forceinline__ void raw_store(const V16<T>& raw, int s, int c,
                                          int Cin, unsigned char* dst,
                                          int lo_off) {
  constexpr int VEC = 16 / sizeof(T);
  float v[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e)
    v[e] = (s >= 0 && c + e < Cin) ? to_f<T>(raw.v[e]) : 0.f;
  if constexpr (Op<T>::PARTS == 1) {
    V16<T> o;
#pragma unroll
    for (int e = 0; e < VEC; ++e) o.v[e] = from_f<T>(v[e]);
    *reinterpret_cast<V16<T>*>(dst) = o;
  } else {
    uint4 hi, lo;
    uint32_t* h = reinterpret_cast<uint32_t*>(&hi);
    uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      h[e] = tf32_rna(v[e]);
      if constexpr (!HI_ONLY) l[e] = tf32_rna(v[e] - __uint_as_float(h[e]));
    }
    *reinterpret_cast<uint4*>(dst) = hi;
    if constexpr (!HI_ONLY) *reinterpret_cast<uint4*>(dst + lo_off) = lo;
  }
}

}  // namespace gct
