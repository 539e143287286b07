// Hopper (sm_90a) building blocks shared by the tensor-core kernels (K6's
// bf16 route in attention.cu, K7's bf16 route in ssd.cu): 16-byte cp.async
// copies into the 128-byte-swizzled shared-memory layout, wgmma matrix
// descriptors, the fences and groups around wgmma, and the wgmma products
// themselves as inline PTX.
//
// The layout: a tile of R rows by DP bf16 columns is stored as DP / 64
// slabs of R rows of 128 bytes; in row r the 16-byte chunk c of the slab
// sits at chunk c ^ (r % 8).  Read as a K-major operand (the K dim
// contiguous), a descriptor points at the first row and at 16 bf16 of the
// slab; read as an MN-major operand (transposed), at the first of 16 rows,
// with the slab size as the leading offset.  The base must be aligned to
// 1024 bytes, the swizzle pattern's repeat.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace ripple {
namespace hopper {

constexpr int kRowBytes = 128;  // one swizzled row: 64 bf16

__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, asynchronously; bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies R rows of DP bf16 (rows >= nvalid and columns >= d zero-filled) into
// DP / 64 slabs of R swizzled 128-byte rows at dst, with THREADS threads.
template <int R, int DP, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          int64_t stride, int nvalid, int d) {
  constexpr int kChunks = R * DP / 8;  // 16-byte chunks
  static_assert(kChunks % THREADS == 0, "whole rounds of chunks");
#pragma unroll
  for (int it = 0; it < kChunks / THREADS; ++it) {
    const int idx = it * THREADS + threadIdx.x;
    const int r = idx / (DP / 8), c = idx % (DP / 8);
    const uint32_t to = dst + (c >> 3) * (R * kRowBytes) + r * kRowBytes +
                        (((c & 7) ^ (r & 7)) << 4);
    const bool in = r < nvalid && c * 8 < d;
    cp_async16(to, in ? src + r * stride + c * 8 : src, in ? 16 : 0);
  }
}

// The cp.async copies are generic-proxy writes; wgmma reads through the
// async proxy, so this orders them before the next wgmma (after a barrier).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory matrix descriptor: 128-byte swizzle, offsets in bytes.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads and writes across the
// asynchronous wgmma that owns them
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define RIPPLE_D32                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31}"
#define RIPPLE_D64                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
  "%58, %59, %60, %61, %62, %63}"
#define RIPPLE_D32_OUT(d)                                                    \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

// Accumulator fragments (m64nN, float32): for i < N / 2, d[i] of thread t of
// the warpgroup is row 16 (t / 32) + (t % 32) / 4 + 8 ((i >> 1) & 1), column
// 8 (i >> 2) + 2 (t % 4) + (i & 1); an n128 accumulator is two n64 ones side
// by side.  A register A fragment (m64k16) holds the same positions of 16
// columns as four bf16 pairs.

// d (64 x 64, float32) (+)= A (64 x 16) B (16 x 64), both from shared
// memory, both K-major
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RIPPLE_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : RIPPLE_D32_OUT(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// the same over 128 columns into (d0 | d1)
__device__ __forceinline__ void wgmma_ss2(float (&d0)[32], float (&d1)[32],
                                          uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " RIPPLE_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : RIPPLE_D32_OUT(d0), RIPPLE_D32_OUT(d1)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, float32) += A (64 x 16, bf16 pairs in registers) B (16 x 64
// from shared memory, MN-major: read transposed)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " RIPPLE_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : RIPPLE_D32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// the same over 128 columns: (d0 | d1) is the n128 accumulator
__device__ __forceinline__ void wgmma_rs2(float (&d0)[32], float (&d1)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " RIPPLE_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : RIPPLE_D32_OUT(d0), RIPPLE_D32_OUT(d1)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace hopper
}  // namespace ripple
