// Eikonal Fast Iterative Method sweeps for Hopper (paper §7.4, Table 5): K5.
//
// Replaces eikonal_fim_pallas (src/repro/kernels/eikonal/kernel.py:84): for
// every (bx, by) tile of the interior, `inner` Jacobi sweeps of the 2-D
// Godunov upwind update (f = 1, grid step h) on the tile with its one-cell
// halo frozen at the input's values and the source cells pinned; phi is
// (nx+2, ny+2) row-major, the mask (nx, ny) bytes (torch.bool), the result
// the (nx, ny) interior.  With inner > 1 the result depends on the tile
// decomposition (the paper's ghost-zone trade), so the tile is the
// caller's: the wrapper checks that it divides the interior.
//
// Bound on the card: bytes.  A cell reads 4 + 1 bytes and writes 4 (float32)
// for 17 operations per sweep, about 8 per byte at inner = 4, below the
// H100's float32 ridge of ~20 per byte.
//
// Design: one 32 x 8 thread block per tile, threadIdx.x along the
// contiguous dim 1.  The haloed (bx+2) x (by+2) tile is loaded row by row
// (consecutive threads on consecutive addresses) into two float32 buffers
// in dynamic shared memory; each sweep reads one buffer and writes the
// other's interior (Jacobi, as the reference: an in-place Gauss-Seidel
// sweep would converge to other numbers), with a barrier in between.  The
// halo ring is written to both buffers once and never again.  A thread
// owns the cells (ty + 8a, tx + 32b) of the tile's interior, so no index
// needs a division, and keeps their source bits in one 64-bit register
// mask: a tile holds at most ceil(bx/8) * ceil(by/32) <= 64 cells per
// thread ((64, 256), the largest tuning candidate, holds exactly 64 and
// takes 2 x 66 x 258 x 4 = 136,224 bytes of shared memory).
//
// Arithmetic is float32 and uncontracted (__fmul_rn / __fadd_rn: nvcc would
// otherwise fuse a*b + c into an FMA, which neither the plain version nor
// XLA does), with a correctly rounded square root, so float32 results equal
// the plain version's.  For bfloat16 storage the tile is rounded to
// bfloat16 after every sweep, as the reference keeps its tile in bfloat16.
#include <cuda_runtime.h>

#include <cstdint>

#include "record_index.cuh"

namespace {

constexpr int kTX = 32;  // threads along dim 1 (threadIdx.x)
constexpr int kTY = 8;   // threads along dim 0 (threadIdx.y)
constexpr int kMaxCellsPerThread = 64;  // bits of the register source mask

__device__ __forceinline__ float round_to_storage(float v, const float*) {
  return v;
}
__device__ __forceinline__ float round_to_storage(float v,
                                                  const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// One Godunov update of the cell whose value is c, west/east w, e (dim 0)
// and south/north s, n (dim 1), as godunov_update in kernels/eikonal/ref.py:
//   a = min(w, e); b = min(s, n); lo = min(a, b); diff = |a - b|
//   new = diff >= h ? lo + h : (a + b + sqrt(max(2h^2 - diff^2, 0))) / 2
//   phi' = min(c, new)
// 16 operations (3 min, sub, abs, mul, sub, max, add, sqrt, add, mul,
// compare, add, select, min); the caller's source select makes 17.
__device__ __forceinline__ float godunov(float c, float w, float e, float s,
                                         float n, float h, float two_hh) {
  const float a = fminf(w, e);
  const float b = fminf(s, n);
  const float lo = fminf(a, b);
  const float diff = fabsf(__fsub_rn(a, b));
  const float rad = fmaxf(__fsub_rn(two_hh, __fmul_rn(diff, diff)), 0.0f);
  const float quad =
      __fmul_rn(0.5f, __fadd_rn(__fadd_rn(a, b), __fsqrt_rn(rad)));
  const float upd = diff >= h ? __fadd_rn(lo, h) : quad;
  return fminf(c, upd);
}

template <typename T>
__global__ void __launch_bounds__(kTX * kTY)
    fim_kernel(const T* __restrict__ phi, const uint8_t* __restrict__ mask,
               T* __restrict__ out, int nx, int ny, int bx, int by,
               int inner, float h) {
  extern __shared__ float smem[];
  const int tw = by + 2;  // tile row length (haloed)
  float* cur = smem;
  float* nxt = smem + (bx + 2) * tw;
  const int x0 = blockIdx.y * bx;  // tile origin, interior coordinates
  const int y0 = blockIdx.x * by;
  const int64_t hy = ny + 2;
  const int tx = threadIdx.x, ty = threadIdx.y;

  // haloed tile rows x0 .. x0+bx+1, columns y0 .. y0+by+1 of phi
  for (int r = ty; r < bx + 2; r += kTY) {
    const T* row = phi + static_cast<int64_t>(x0 + r) * hy + y0;
    for (int q = tx; q < tw; q += kTX) {
      const float v = ripple::load_f(row + q);
      cur[r * tw + q] = v;
      nxt[r * tw + q] = v;
    }
  }
  uint64_t src = 0;
  int bit = 0;
  for (int i = ty; i < bx; i += kTY) {
    const uint8_t* row = mask + static_cast<int64_t>(x0 + i) * ny + y0;
    for (int j = tx; j < by; j += kTX, ++bit)
      if (row[j]) src |= uint64_t{1} << bit;
  }
  const float two_hh = __fmul_rn(__fmul_rn(2.0f, h), h);
  __syncthreads();

  for (int sweep = 0; sweep < inner; ++sweep) {
    bit = 0;
    for (int i = ty; i < bx; i += kTY) {
      for (int j = tx; j < by; j += kTX, ++bit) {
        const int t = (i + 1) * tw + (j + 1);
        const float c = cur[t];
        const float v = (src >> bit) & 1u
                            ? c
                            : godunov(c, cur[t - tw], cur[t + tw],
                                      cur[t - 1], cur[t + 1], h, two_hh);
        nxt[t] = round_to_storage(v, phi);
      }
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  for (int i = ty; i < bx; i += kTY) {
    T* row = out + static_cast<int64_t>(x0 + i) * ny + y0;
    for (int j = tx; j < by; j += kTX)
      ripple::store_f(row + j, cur[(i + 1) * tw + (j + 1)]);
  }
}

template <typename T>
int launch_fim(const void* phi, const void* mask, void* out, int nx, int ny,
               int bx, int by, int inner, float h, void* stream) {
  if (bx < 1 || by < 1 || nx % bx || ny % by || inner < 0 ||
      ((bx + kTY - 1) / kTY) * ((by + kTX - 1) / kTX) > kMaxCellsPerThread ||
      nx / bx > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = 2 * sizeof(float) * (bx + 2) * (by + 2);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fim_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(ny / by, nx / bx);
  fim_kernel<T><<<grid, dim3(kTX, kTY), smem,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(phi), static_cast<const uint8_t*>(mask),
      static_cast<T*>(out), nx, ny, bx, by, inner, h);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int eikonal_fim_f32(const void* phi, const void* mask, void* out,
                               int nx, int ny, int bx, int by, int inner,
                               float h, void* stream) {
  return launch_fim<float>(phi, mask, out, nx, ny, bx, by, inner, h, stream);
}

extern "C" int eikonal_fim_bf16(const void* phi, const void* mask, void* out,
                                int nx, int ny, int bx, int by, int inner,
                                float h, void* stream) {
  return launch_fim<__nv_bfloat16>(phi, mask, out, nx, ny, bx, by, inner, h,
                                   stream);
}

RIPPLE_ERROR_STRING_FN
