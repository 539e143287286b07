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
// Design: one CTA covers `block` consecutive cells (the reference's block
// argument) with up to 256 threads striding through them, so neighbouring
// threads touch neighbouring cells (coalesced for flat arrays, SoA and
// within AoSoA tiles; AoS reads component-strided records through the
// K0 accessor).  Arithmetic is float32 for both storage types.  K1's
// bounds-checked (BC) variant tests every index against n in every CTA;
// the unchecked (NBC) variant launches the whole blocks without the test
// and one guarded CTA for a ragged tail, so neither reads past n.  Later
// work: 16-byte vector loads and a grid sized to the SM count.
#include <cuda_runtime.h>

#include "record_index.cuh"

namespace {

constexpr int kMaxThreads = 256;

template <typename T, bool kCheck>
__global__ void saxpy_kernel(const T* __restrict__ x, const T* __restrict__ y,
                             T* __restrict__ out, float a, int64_t n,
                             int64_t first, int block) {
  const int64_t base = first + static_cast<int64_t>(blockIdx.x) * block;
  for (int k = threadIdx.x; k < block; k += blockDim.x) {
    const int64_t i = base + k;
    if (kCheck && i >= n) break;  // the paper's iterator validity check
    ripple::store_f(out + i, a * ripple::load_f(x + i) + ripple::load_f(y + i));
  }
}

template <typename T>
int launch_saxpy(const void* x, const void* y, void* out, float a, int64_t n,
                 int block, int bounds_check, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int threads = block < kMaxThreads ? block : kMaxThreads;
  auto px = static_cast<const T*>(x);
  auto py = static_cast<const T*>(y);
  auto po = static_cast<T*>(out);
  if (bounds_check) {
    const int64_t grid = (n + block - 1) / block;
    if (grid > 0)
      saxpy_kernel<T, true><<<grid, threads, 0, s>>>(px, py, po, a, n, 0, block);
  } else {
    const int64_t full = n / block;
    if (full > 0)
      saxpy_kernel<T, false><<<full, threads, 0, s>>>(px, py, po, a, n, 0, block);
    if (n % block)
      saxpy_kernel<T, true><<<1, threads, 0, s>>>(px, py, po, a, n,
                                                  full * block, block);
  }
  return static_cast<int>(cudaGetLastError());
}

// SAXPY_SPEC = (x, y): component 0 is x, component 1 is y.
template <typename T, int L>
__global__ void saxpy_record_kernel(const T* __restrict__ p,
                                    T* __restrict__ o, float a, int64_t n,
                                    int tile, int block) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * block;
  for (int k = threadIdx.x; k < block; k += blockDim.x) {
    const int64_t i = base + k;
    const int64_t ox = ripple::record_offset<L>(i, 0, n, 2, tile);
    const int64_t oy = ripple::record_offset<L>(i, 1, n, 2, tile);
    const T xv = p[ox];
    o[ox] = xv;
    ripple::store_f(o + oy, a * ripple::load_f(&xv) + ripple::load_f(p + oy));
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
                         int64_t n, int block, int bounds_check,
                         void* stream) {
  return launch_saxpy<float>(x, y, out, a, n, block, bounds_check, stream);
}

extern "C" int saxpy_bf16(const void* x, const void* y, void* out, float a,
                          int64_t n, int block, int bounds_check,
                          void* stream) {
  return launch_saxpy<__nv_bfloat16>(x, y, out, a, n, block, bounds_check,
                                     stream);
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
