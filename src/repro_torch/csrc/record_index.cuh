// Layout-generic record accessor for the CUDA kernels (paper §4.2-4.3).
//
// Replaces the JAX package's Pallas-side helpers RecordRef, record_grid_1d
// and block_spec_for (src/repro/core/layout.py:434-548): there a BlockSpec
// cut the record storage into blocks; here each kernel computes the element
// offset of component `c` of cell `i` itself, so a kernel body is written
// once for all three layouts.  Cells are numbered in row-major order over
// the record's space (n cells), C is the number of scalar components:
//
//   AoS   (*space, C)                 offset = i*C + c
//   SoA   (C, *space)                 offset = c*n + i
//   AoSoA (*space[:-1], nt, C, tile)  offset = ((i/tile)*C + c)*tile + i%tile
//
// For AoSoA over an N-d space the row-major cell index already walks the
// leading dims and the tiled last dim together, so the same formula holds.
// Layout codes match the order of repro_torch.core.layout.Layout.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>

namespace ripple {

enum RecordLayout : int { kAoS = 0, kSoA = 1, kAoSoA = 2 };

template <int L>
__device__ __forceinline__ int64_t record_offset(int64_t i, int c, int64_t n,
                                                 int C, int tile) {
  if constexpr (L == kAoS) {
    return i * C + c;
  } else if constexpr (L == kSoA) {
    return static_cast<int64_t>(c) * n + i;
  } else {
    return ((i / tile) * C + c) * tile + i % tile;
  }
}

// Loads widen to float and stores round from float, so every kernel
// computes in float32 for both float32 and bfloat16 storage.
__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

}  // namespace ripple

// Every C entry point returns cudaGetLastError() after its launches; the
// Python wrapper raises with this message when the code is not 0.
#define RIPPLE_ERROR_STRING_FN                                 \
  extern "C" const char* ripple_error_string(int code) {       \
    return cudaGetErrorString(static_cast<cudaError_t>(code)); \
  }
