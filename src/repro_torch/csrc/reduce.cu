// NaN-ignoring max and min for Hopper: the local reduction of the
// MaxReducer and the MinReducer (src/repro_torch/core/graph.py,
// _nan_ignoring), over a float32 view as it lies in memory.
//
// Replaces no Pallas kernel: the JAX package reduces with jnp.max and
// jnp.nanmax in XLA (src/repro/core/graph.py:186).  It was added because
// the same semantics in PyTorch ops took five passes: a copy of the view
// (masked_fill clones it; over a record's field, a strided copy), the NaN
// test, the fill, the reduction and the all-NaN test.
//
// Bound on the card: bytes, those of the view's span.  The view is merged
// by the wrapper into `rows` rows of `cols` contiguous elements,
// `row_stride` apart.  Where a row's elements outside the view add up to
// less than a 32-byte sector (an AoS field: the ions' v, 12 of each
// 24-byte record, with x's 12 bytes between), every sector of the span is
// fetched whichever elements a kernel asks for, so the bound is the span:
// 6.44 GB, 1.923 ms at 3.35 TB/s for the ions' v at 2^28 records, and
// 268 MB, 0.080 ms for the eikonal change at 8192^2.
//
// Design, a streaming read of data used once:
// - The span read (`extremum_span_kernel`): every 16-byte vector of the
//   span from its 16-byte aligned start, read through the read-only path
//   without L1 allocation (ld.global.nc.L1::no_allocate), kUnroll vectors
//   in flight per thread, neighbouring threads on neighbouring vectors.
//   A lane is the view's when its position from the view's first element,
//   modulo row_stride, is below cols: each thread keeps that phase per
//   vector in flight and advances it by a constant a round, so no
//   division runs in the loop.  The first and last vectors also test the
//   span's ends.  One row (a contiguous view) skips the phase.
// - The row read (`extremum_rows_kernel`), where the gaps are a sector or
//   more: each warp takes 32 * kUnroll columns of one row at a time.
// - The grid: as many 256-thread blocks as fit on the SMs at once (the
//   occupancy calculator's count, capped by the wrapper's scratch), each
//   striding over the span; every index 64-bit (the ions' span is
//   1.61e9 elements).
// - NaN: the accumulator starts at NaN and folds with fmaxf/fminf, which
//   return the other operand when one is NaN.  So NaN is the fold's
//   identity and the accumulator holds NaN exactly while no non-NaN
//   element has been seen: the all-NaN view reduces to NaN, as the torch
//   route's all-NaN test makes it.
// - The fold: warp shuffles, then shared memory, give one partial a block
//   in the wrapper's scratch; a second launch of one block folds the
//   partials into `out`.  Nothing is allocated or synchronised here, so
//   the pair is captured into a CUDA graph like any launch.  Max and min
//   are exact, so the order of the fold does not change the result.
#include <cuda_runtime.h>

#include <cstdint>

#include "record_index.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;           // 16-byte vectors in flight a thread
constexpr int kFoldThreads = 1024;

__device__ __forceinline__ float nan_identity() {
  return __int_as_float(0x7fffffff);
}

template <bool kMax>
__device__ __forceinline__ float pick(float a, float b) {
  return kMax ? fmaxf(a, b) : fminf(a, b);
}

__device__ __forceinline__ float4 load_stream(const float4* p) {
  float4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

// The block's fold of every thread's `acc`, valid in thread 0.
template <bool kMax>
__device__ __forceinline__ float block_fold(float acc) {
  __shared__ float warps[32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    acc = pick<kMax>(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warps[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < (blockDim.x >> 5) ? warps[lane] : nan_identity();
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc = pick<kMax>(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  }
  return acc;
}

// (e mod m) in [0, m) for a possibly negative e
__device__ __forceinline__ int phase_of(int64_t e, int m) {
  const int64_t r = e % m;
  return static_cast<int>(r < 0 ? r + m : r);
}

// The span read: `nvec` vectors from `vec` (the span's 16-byte aligned
// start); element j of the span (j = 4 * vector + lane - lead) is the
// view's when 0 <= j < len and, kPeriodic, j mod row_stride < cols.
// `step` is (4 * kUnroll * threads in the grid) mod row_stride.
template <bool kMax, bool kPeriodic>
__global__ void __launch_bounds__(kThreads)
    extremum_span_kernel(const float4* __restrict__ vec, int64_t nvec,
                         int lead, int64_t len, int cols, int row_stride,
                         int step, float* __restrict__ partials) {
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  float acc = nan_identity();
  int q[kUnroll];  // phase of lane 0 of each vector in flight
  if (kPeriodic) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      q[u] = phase_of(4 * (tid + u * nthreads) - lead, row_stride);
  }
  for (int64_t v0 = tid; v0 < nvec; v0 += kUnroll * nthreads) {
    float4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v = v0 + u * nthreads;
      if (v < nvec) r[u] = load_stream(vec + v);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t v = v0 + u * nthreads;
      if (v < nvec) {
        const float e[4] = {r[u].x, r[u].y, r[u].z, r[u].w};
        const bool edge = v == 0 || v == nvec - 1;
        int p = kPeriodic ? q[u] : 0;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          bool keep = true;
          if (kPeriodic) {
            keep = p < cols;
            p = p + 1 == row_stride ? 0 : p + 1;
          }
          if (edge) {
            const int64_t j = 4 * v + k - lead;
            keep = keep && j >= 0 && j < len;
          }
          if (keep) acc = pick<kMax>(acc, e[k]);
        }
      }
      if (kPeriodic) {
        q[u] += step;
        if (q[u] >= row_stride) q[u] -= row_stride;
      }
    }
  }
  acc = block_fold<kMax>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

// The row read: `rows` rows of `cols` elements, `row_stride` apart; a
// unit of work is 32 * kUnroll columns of one row, one warp's.
template <bool kMax>
__global__ void __launch_bounds__(kThreads)
    extremum_rows_kernel(const float* __restrict__ base, int64_t rows,
                         int64_t cols, int64_t row_stride,
                         float* __restrict__ partials) {
  constexpr int kChunk = 32 * kUnroll;
  const int64_t chunks = (cols + kChunk - 1) / kChunk;
  const int64_t units = rows * chunks;
  const int lane = threadIdx.x & 31;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t nwarps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  float acc = nan_identity();
  for (int64_t w = warp; w < units; w += nwarps) {
    const int64_t row = w / chunks;
    const int64_t c0 = (w - row * chunks) * kChunk + lane;
    const float* p = base + row * row_stride;
    float x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t c = c0 + 32 * u;
      x[u] = c < cols ? __ldg(p + c) : nan_identity();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = pick<kMax>(acc, x[u]);
  }
  acc = block_fold<kMax>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

template <bool kMax>
__global__ void __launch_bounds__(kFoldThreads)
    extremum_fold_kernel(const float* __restrict__ partials, int n,
                         float* __restrict__ out) {
  float acc = nan_identity();
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    acc = pick<kMax>(acc, partials[i]);
  acc = block_fold<kMax>(acc);
  if (threadIdx.x == 0) *out = acc;
}

// Blocks of `kernel` resident at once on the card, capped by `capacity`
// (the wrapper's scratch) and by `needed`.
template <typename K>
cudaError_t grid_of(K kernel, int64_t needed, int capacity, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
  if (err != cudaSuccess) return err;
  int64_t g = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (g > capacity) g = capacity;
  if (g > needed) g = needed;
  *grid = static_cast<int>(g < 1 ? 1 : g);
  return cudaSuccess;
}

template <bool kMax>
int launch_extremum(const void* base, int64_t rows, int64_t cols,
                    int64_t row_stride, int span, void* partials,
                    int capacity, void* out, void* stream) {
  if (rows < 1 || cols < 1 || capacity < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto part = static_cast<float*>(partials);
  int grid = 1;
  cudaError_t err = cudaSuccess;
  if (span) {
    const bool periodic = rows > 1;
    if (periodic && (row_stride < cols || row_stride > INT32_MAX))
      return static_cast<int>(cudaErrorInvalidValue);
    const auto addr = reinterpret_cast<uintptr_t>(base);
    const auto start = addr & ~static_cast<uintptr_t>(15);
    const int lead = static_cast<int>((addr - start) / sizeof(float));
    const int64_t len = (rows - 1) * row_stride + cols;
    const int64_t nvec = (lead + len + 3) / 4;
    const int64_t per_block = static_cast<int64_t>(kThreads) * kUnroll;
    const int64_t needed = (nvec + per_block - 1) / per_block;
    auto vec = reinterpret_cast<const float4*>(start);
    if (periodic) {
      err = grid_of(extremum_span_kernel<kMax, true>, needed, capacity,
                    &grid);
      if (err != cudaSuccess) return static_cast<int>(err);
      const int rs = static_cast<int>(row_stride);
      const int step = static_cast<int>(
          (4 * per_block * static_cast<int64_t>(grid)) % rs);
      extremum_span_kernel<kMax, true><<<grid, kThreads, 0, s>>>(
          vec, nvec, lead, len, static_cast<int>(cols), rs, step, part);
    } else {
      err = grid_of(extremum_span_kernel<kMax, false>, needed, capacity,
                    &grid);
      if (err != cudaSuccess) return static_cast<int>(err);
      extremum_span_kernel<kMax, false><<<grid, kThreads, 0, s>>>(
          vec, nvec, lead, len, 1, 1, 0, part);
    }
  } else {
    constexpr int64_t kChunk = 32 * kUnroll;
    const int64_t units = rows * ((cols + kChunk - 1) / kChunk);
    const int64_t needed = (units * 32 + kThreads - 1) / kThreads;
    err = grid_of(extremum_rows_kernel<kMax>, needed, capacity, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    extremum_rows_kernel<kMax><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(base), rows, cols, row_stride, part);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  extremum_fold_kernel<kMax><<<1, kFoldThreads, 0, s>>>(
      part, grid, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The NaN-ignoring max (largest != 0) or min of the float32 view at
// `base`: `rows` rows of `cols` contiguous elements, `row_stride`
// elements apart, read as one span (span != 0) or row by row; the result
// into the float32 at `out`.  `partials` is scratch of `capacity` floats.
extern "C" int nan_ignoring_extremum_f32(const void* base, int64_t rows,
                                         int64_t cols, int64_t row_stride,
                                         int span, int largest,
                                         void* partials, int capacity,
                                         void* out, void* stream) {
  if (largest)
    return launch_extremum<true>(base, rows, cols, row_stride, span,
                                 partials, capacity, out, stream);
  return launch_extremum<false>(base, rows, cols, row_stride, span, partials,
                                capacity, out, stream);
}

RIPPLE_ERROR_STRING_FN
