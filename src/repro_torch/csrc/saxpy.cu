// SAXPY kernels for Hopper (paper §7.1, Table 2): K1 flat, K2 record form.
//
// K1 replaces saxpy_pallas (src/repro/kernels/saxpy/kernel.py:61): out =
// a*x + y over a flat array.  K2 replaces saxpy_record_pallas (same file,
// :112): y <- a*x + y on the two-field record SAXPY_SPEC (x, y) in AoS, SoA
// or AoSoA, x copied through.
//
// Bound on the card: bytes.  Both read each input once and write each
// output once with two flops per element, far below the H100's ~20 flops
// per byte of float32 ridge, so the time is device-memory traffic.
//
// K1 design: 16-byte loads and stores (4 float32 or 8 bf16 as one uint4),
// each thread keeping kUnroll 16-byte loads of x and of y in flight per
// round of a grid-stride loop.  The grid is sized to the work and capped at
// kBlocksPerSM blocks of 256 threads per SM: one round at the main path's
// n = 2^24 (8,192 blocks): on the H100 that ran faster than a grid of 8
// blocks per SM walking the array in rounds of 4 vectors.  The
// vector body needs x, y and out 16-byte aligned (the wrapper allocates
// out aligned); a scalar tail runs past the last whole vector, and a call
// with x or y off the 16-byte grid (a view such as x[1:]) runs the scalar
// loop whole, in the same kernel.  The bounds-checked (BC) variant tests
// every vector of the body against its end and every element of the tail
// (the paper's iterator validity check); the unchecked (NBC) variant runs
// the body's whole rounds without the test and only the last, partial
// round with it.  The reference's `block` argument is validated by the
// wrapper and sets no grid here.
//
// In place: `out` may be `y` (K1) and `o` may be `p` (K2), as under the
// executor's regions, where a node writes its key's static buffer.  Each
// thread reads an element before it writes that element and no other
// thread touches it, so the result equals the out-of-place one; those
// pointers carry no __restrict__, which would promise that they never
// alias, and y is read through the coherent path (x, which never aliases
// out, keeps __ldg).  Without the promise the compiler keeps every load
// and store in source order, so each body issues its loads before its
// stores; K2 in place leaves x where it is.
//
// K2 design: one CTA covers `block` consecutive cells (the reference's
// block argument) with up to 256 threads striding through them, so
// neighbouring threads touch neighbouring cells (coalesced for SoA and
// within AoSoA tiles; AoS reads component-strided records through the K0
// accessor).  Arithmetic is float32 for both storage types.
#include <cuda_runtime.h>

#include <cstdint>

#include "record_index.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kBlocksPerSM = 64;
constexpr int kUnroll = 2;

// a*x + y on one 16-byte vector of 4 float32 or 8 bf16, in float32
__device__ __forceinline__ uint4 saxpy_vec(float a, uint4 x, uint4 y,
                                           float) {
  float4 xf = *reinterpret_cast<float4*>(&x);
  const float4 yf = *reinterpret_cast<float4*>(&y);
  xf.x = a * xf.x + yf.x;
  xf.y = a * xf.y + yf.y;
  xf.z = a * xf.z + yf.z;
  xf.w = a * xf.w + yf.w;
  return *reinterpret_cast<uint4*>(&xf);
}

__device__ __forceinline__ uint4 saxpy_vec(float a, uint4 x, uint4 y,
                                           __nv_bfloat16) {
  auto xs = reinterpret_cast<__nv_bfloat162*>(&x);
  auto ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 xf = __bfloat1622float2(xs[k]);
    const float2 yf = __bfloat1622float2(ys[k]);
    xs[k] = __floats2bfloat162_rn(a * xf.x + yf.x, a * xf.y + yf.y);
  }
  return x;
}

template <typename T, bool kCheck>
__global__ void __launch_bounds__(kMaxThreads)
    saxpy_kernel(const T* __restrict__ x, const T* y, T* out, float a,
                 int64_t n, int64_t nvec,
                 int64_t whole) {
  constexpr int W = 16 / sizeof(T);  // elements per vector
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  const int64_t nthreads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const uint4* yv = reinterpret_cast<const uint4*>(y);
  uint4* ov = reinterpret_cast<uint4*>(out);
  const int64_t round = kUnroll * nthreads;
  int64_t v = tid;
  if (!kCheck) {  // whole rounds: every thread's kUnroll vectors exist
    for (; v < whole; v += round) {
      uint4 xr[kUnroll], yr[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        xr[u] = __ldg(xv + v + u * nthreads);
        yr[u] = yv[v + u * nthreads];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        ov[v + u * nthreads] = saxpy_vec(a, xr[u], yr[u], T());
    }
  }
  for (; v < nvec; v += round) {  // every vector tested against the end
    uint4 xr[kUnroll], yr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v + u * nthreads < nvec) {
        xr[u] = __ldg(xv + v + u * nthreads);
        yr[u] = yv[v + u * nthreads];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (v + u * nthreads < nvec)
        ov[v + u * nthreads] = saxpy_vec(a, xr[u], yr[u], T());
  }
  // scalar tail past the last whole vector (the per-element test); all of
  // a call whose x or y is off the 16-byte grid (nvec == 0)
  for (int64_t i = nvec * W + tid; i < n; i += nthreads)
    ripple::store_f(out + i, a * ripple::load_f(x + i) + ripple::load_f(y + i));
}

template <typename T>
int launch_saxpy(const void* x, const void* y, void* out, float a, int64_t n,
                 int bounds_check, void* stream) {
  constexpr int W = 16 / sizeof(T);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) |
                        reinterpret_cast<uintptr_t>(y) |
                        reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const int64_t nvec = aligned ? n / W : 0;
  // threads enough for kUnroll vectors or one scalar each, up to the SM
  // count times kBlocksPerSM blocks
  const int64_t scalar = n - nvec * W;
  int64_t work = (nvec + kUnroll - 1) / kUnroll;
  if (scalar > work) work = scalar;
  int64_t grid = (work + kMaxThreads - 1) / kMaxThreads;
  const int64_t cap = static_cast<int64_t>(sms) * kBlocksPerSM;
  if (grid > cap) grid = cap;
  // the vectors of the whole rounds, which NBC runs without the test
  const int64_t round = grid * kMaxThreads * kUnroll;
  const int64_t whole = nvec / round * round;
  auto s = static_cast<cudaStream_t>(stream);
  auto px = static_cast<const T*>(x);
  auto py = static_cast<const T*>(y);
  auto po = static_cast<T*>(out);
  if (bounds_check)
    saxpy_kernel<T, true><<<grid, kMaxThreads, 0, s>>>(px, py, po, a, n, nvec,
                                                       whole);
  else
    saxpy_kernel<T, false><<<grid, kMaxThreads, 0, s>>>(px, py, po, a, n,
                                                        nvec, whole);
  return static_cast<int>(cudaGetLastError());
}

// SAXPY_SPEC = (x, y): component 0 is x, component 1 is y.
template <typename T, int L>
__global__ void saxpy_record_kernel(const T* p, T* o, float a, int64_t n,
                                    int tile, int block) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * block;
  for (int k = threadIdx.x; k < block; k += blockDim.x) {
    const int64_t i = base + k;
    const int64_t ox = ripple::record_offset<L>(i, 0, n, 2, tile);
    const int64_t oy = ripple::record_offset<L>(i, 1, n, 2, tile);
    // both loads before any store: p and o may be one record
    const T xv = p[ox];
    const T yv = p[oy];
    if (o != p) o[ox] = xv;  // in place, x is there already
    ripple::store_f(o + oy, a * ripple::load_f(&xv) + ripple::load_f(&yv));
  }
}

template <typename T>
int launch_saxpy_record(const void* p, void* o, float a, int64_t n,
                        int layout, int tile, int block, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int threads = block < kMaxThreads ? block : kMaxThreads;
  const int64_t grid = n / block;  // the wrapper checks n % block == 0
  auto pp = static_cast<const T*>(p);
  auto po = static_cast<T*>(o);
  if (grid > 0) {
    switch (layout) {
      case ripple::kAoS:
        saxpy_record_kernel<T, ripple::kAoS>
            <<<grid, threads, 0, s>>>(pp, po, a, n, tile, block);
        break;
      case ripple::kSoA:
        saxpy_record_kernel<T, ripple::kSoA>
            <<<grid, threads, 0, s>>>(pp, po, a, n, tile, block);
        break;
      case ripple::kAoSoA:
        saxpy_record_kernel<T, ripple::kAoSoA>
            <<<grid, threads, 0, s>>>(pp, po, a, n, tile, block);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int saxpy_f32(const void* x, const void* y, void* out, float a,
                         int64_t n, int bounds_check, void* stream) {
  return launch_saxpy<float>(x, y, out, a, n, bounds_check, stream);
}

extern "C" int saxpy_bf16(const void* x, const void* y, void* out, float a,
                          int64_t n, int bounds_check, void* stream) {
  return launch_saxpy<__nv_bfloat16>(x, y, out, a, n, bounds_check, stream);
}

extern "C" int saxpy_record_f32(const void* p, void* o, float a, int64_t n,
                                int layout, int tile, int block,
                                void* stream) {
  return launch_saxpy_record<float>(p, o, a, n, layout, tile, block, stream);
}

extern "C" int saxpy_record_bf16(const void* p, void* o, float a, int64_t n,
                                 int layout, int tile, int block,
                                 void* stream) {
  return launch_saxpy_record<__nv_bfloat16>(p, o, a, n, layout, tile, block,
                                            stream);
}

RIPPLE_ERROR_STRING_FN
