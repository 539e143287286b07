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
// H100's float32 ridge of ~20 per byte.  What holds a kernel back from it:
// the loads and stores alone take ~1.25x the byte bound, and the sweeps
// (~20 instructions per cell, the correctly rounded square root a
// sequence of its own) do not overlap them.
//
// Design: the tile lives in registers.  A warp holds RPW rows of a tile
// (dim 0) by 32 CPL columns (dim 1): lane l owns the CPL consecutive
// columns l CPL .. l CPL + CPL - 1 of each of its rows, so a cell's W/E
// neighbours (dim 0) are registers of the same lane, and its S/N
// neighbours (dim 1) too, or at a lane's edge one __shfl away.  The frozen
// halo sits in registers as well: the rows above and below the warp's
// strip, and the columns left of lane 0 and right of lane 31.  A sweep
// writes its results into a second register set (Jacobi, as the reference:
// an in-place Gauss-Seidel sweep would converge to other numbers).  The
// sweep is a chain of dependent operations per cell (the square root among
// them), so it needs warps to hide its latency more than it needs fewer
// instructions: a lane holds 16 cells (RPW = 16 / CPL; CPL = 8 takes 32),
// which fit in 64 registers, so 32 warps share an SM.  A tile taller than
// one warp's rows (the main path's (8, 128): CPL = 4, two warps of 4 rows)
// is shared by its warps, which pass their first and last rows through
// shared memory once per sweep: one named barrier per tile and sweep (the
// tiles of a block never wait for each other), two buffers by the sweep's
// parity, so a fast warp never overwrites rows a slow one still reads.  A
// warp reads no other tile's cells, and each tile's halo stays frozen at
// the input.  A block holds several tiles, up to 16 warps.  Column slots
// past by (a tile narrower than 32 CPL) and row slots past bx are never
// updated: the first of each holds the tile's halo, so the update needs no
// special case at a ragged edge.  The geometry (columns a lane, rows a
// warp, warps a tile, tiles a block, the grid) comes from fim_geometry in
// kernels/eikonal/kernel.py; the launch checks it.
//
// Memory: every load of a warp's strip is issued before any is used (no
// branch or shuffle between them), so a warp has its RPW + 2 rows in
// flight at once.  A haloed row of ny + 2 values read from column
// y0 + l CPL is aligned to a pair whenever ny is even, so a lane loads its
// row in pairs (the left neighbour and its first CPL - 1 columns) and its
// last column alone; the source mask is read as 32-bit words (CPL bytes a
// lane) and the result stored as float4 (bf16: 8 bytes) per 4 columns.  A
// tile narrower than 32 CPL, or a shape or base off that alignment, takes
// the scalar loads and stores of the same kernel, which on an H100 take
// 1.1x as long at the (8, 128) tile and 1.35x at (64, 256).
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

using bf16 = __nv_bfloat16;

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 16;  // warps a block: 512 threads

__device__ __forceinline__ float round_to_storage(float v, const float*) {
  return v;
}
__device__ __forceinline__ float round_to_storage(float v, const bf16*) {
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

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ void store_quad(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store_quad(bf16* p, const float* v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
}

// Fetches one row of the tile as the warp holds it: `row` points at the
// haloed row's column y0 (the tile's left halo), c0 is the lane's first
// tile column.  v[k] = tile column c0 + k (slots past by read the right
// halo: no live cell reads them); left = the left halo (used by lane 0),
// right = the value right of the lane's last slot (used by lane 31).  No
// branch and no shuffle, so the loads of all rows are in flight at once.
template <int CPL, bool VEC, typename T>
__device__ __forceinline__ void fetch_row(const T* row, int c0, int by,
                                          float (&v)[CPL], float& left,
                                          float& right) {
  if constexpr (VEC) {  // by == 32 CPL, row + c0 aligned to a pair
    float p[CPL];  // haloed columns y0 + c0 .. y0 + c0 + CPL - 1
#pragma unroll
    for (int k = 0; k < CPL; k += 2) {
      const float2 q = load_pair(row + c0 + k);
      p[k] = q.x;
      p[k + 1] = q.y;
    }
    left = p[0];
#pragma unroll
    for (int k = 0; k + 1 < CPL; ++k) v[k] = p[k + 1];
    v[CPL - 1] = ripple::load_f(row + c0 + CPL);
    right = ripple::load_f(row + c0 + CPL + 1);
  } else {
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      v[k] = ripple::load_f(row + min(c0 + k, by) + 1);
    left = ripple::load_f(row);
    right = ripple::load_f(row + min(c0 + CPL, by) + 1);
  }
}

// The warp's strip with the rows beside it: tile rows r0 - 1 .. r0 + RPW,
// clamped to row bx (the halo below; slots past it are never updated).
template <int CPL, int RPW, bool VEC, typename T>
__device__ __forceinline__ void fetch_strip(const T* top, int64_t hy, int r0,
                                            int bx, int c0, int by,
                                            float (&cur)[RPW][CPL],
                                            float (&up)[CPL],
                                            float (&down)[CPL],
                                            float (&hl)[RPW],
                                            float (&hr)[RPW]) {
  float l, r;
  fetch_row<CPL, VEC>(top + r0 * hy, c0, by, up, l, r);
#pragma unroll
  for (int i = 0; i < RPW; ++i)
    fetch_row<CPL, VEC>(top + (min(r0 + i, bx) + 1) * hy, c0, by, cur[i],
                        hl[i], hr[i]);
  fetch_row<CPL, VEC>(top + (min(r0 + RPW, bx) + 1) * hy, c0, by, down, l,
                      r);
}

// Source bits of the lane's CPL cells of one interior row (`row` at the
// mask's column y0); slots past by read none.
template <int CPL>
__device__ __forceinline__ uint32_t source_bits(const uint8_t* row, int c0,
                                                int by, bool vec) {
  uint32_t bits = 0;
  if (vec && CPL >= 4) {  // CPL bytes as 32-bit words
#pragma unroll
    for (int q = 0; q < CPL; q += 4) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(row + c0 + q);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if ((w >> (8 * k)) & 0xffu) bits |= 1u << (q + k);
    }
  } else {
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      if (c0 + k < by && row[c0 + k]) bits |= 1u << k;
  }
  return bits;
}

// One Jacobi sweep of the warp's strip: nxt from cur.  live bit i CPL + k
// says cell (i, k) is updated; up/down are the rows beside the strip,
// hl/hr the frozen columns beside the warp (lanes 0 and 31).
template <int CPL, int RPW, typename T>
__device__ __forceinline__ void sweep(const float (&cur)[RPW][CPL],
                                      float (&nxt)[RPW][CPL],
                                      const float (&up)[CPL],
                                      const float (&down)[CPL],
                                      const float (&hl)[RPW],
                                      const float (&hr)[RPW], uint32_t live,
                                      float h, float two_hh, const T* tag) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const float from_left = __shfl_up_sync(kFull, cur[i][CPL - 1], 1);
    const float from_right = __shfl_down_sync(kFull, cur[i][0], 1);
    const float lf = lane == 0 ? hl[i] : from_left;
    const float rt = lane == 31 ? hr[i] : from_right;
#pragma unroll
    for (int k = 0; k < CPL; ++k) {
      const float c = cur[i][k];
      const float w = i == 0 ? up[k] : cur[i - 1][k];
      const float e = i == RPW - 1 ? down[k] : cur[i + 1][k];
      const float s = k == 0 ? lf : cur[i][k - 1];
      const float n = k == CPL - 1 ? rt : cur[i][k + 1];
      nxt[i][k] = (live >> (i * CPL + k)) & 1u
                      ? round_to_storage(godunov(c, w, e, s, n, h, two_hh),
                                         tag)
                      : c;
    }
  }
}

// Waits for the warps of one tile: named barrier 1 + tile (0 is
// __syncthreads), so the tiles of a block do not wait for each other.
__device__ __forceinline__ void tile_barrier(int tile, int wpt) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(tile + 1), "r"(32 * wpt)
               : "memory");
}

// The rows beside the strip from the neighbouring warps of the tile, through
// shared memory: each warp writes its first and last row into buffer
// `parity`, then reads its neighbours' (row above: the previous warp's last
// row; row below: the next warp's first row).
template <int CPL, int RPW>
__device__ __forceinline__ void exchange(float* edge, int parity,
                                         int buf_floats, int slot, int wt,
                                         int wpt, const float (&cur)[RPW][CPL],
                                         float (&up)[CPL],
                                         float (&down)[CPL]) {
  constexpr int W = 32 * CPL;
  const int c0 = (threadIdx.x & 31) * CPL;
  float* mine = edge + parity * buf_floats + slot * 2 * W;
#pragma unroll
  for (int k = 0; k < CPL; ++k) {
    mine[c0 + k] = cur[0][k];
    mine[W + c0 + k] = cur[RPW - 1][k];
  }
  tile_barrier(slot / wpt, wpt);
  if (wt > 0) {
#pragma unroll
    for (int k = 0; k < CPL; ++k) up[k] = mine[-W + c0 + k];
  }
  if (wt + 1 < wpt) {
#pragma unroll
    for (int k = 0; k < CPL; ++k) down[k] = mine[2 * W + c0 + k];
  }
}

// 16 cells a lane fit in 64 registers: two blocks of 512 threads an SM (the
// 8-column instance, 32 cells a lane, takes one)
template <typename T, int CPL, int RPW>
__global__ void __launch_bounds__(32 * kMaxWarps, CPL * RPW <= 16 ? 2 : 1)
    fim_kernel(const T* __restrict__ phi, const uint8_t* __restrict__ mask,
               T* __restrict__ out, int nx, int ny, int bx, int by,
               int inner, float h, int wpt) {
  static_assert(CPL * RPW <= 32, "32 cells a lane: one bit each in `live`");
  constexpr int W = 32 * CPL;
  extern __shared__ float edge[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tpb = blockDim.x / (32 * wpt);
  const int tile = warp / wpt, wt = warp - tile * wpt;
  const int x0 = (blockIdx.y * tpb + tile) * bx;  // tile origin (interior)
  const int y0 = blockIdx.x * by;
  const int r0 = wt * RPW;  // the warp's first tile row
  const int c0 = lane * CPL;
  const int64_t hy = ny + 2;
  // tile cell (i, j) is phi[x0 + i + 1][y0 + j + 1]
  const T* top = phi + static_cast<int64_t>(x0) * hy + y0;
  const bool full = by == W;
  const bool vec_in = full && CPL % 2 == 0 && hy % 2 == 0 &&
                      reinterpret_cast<uintptr_t>(phi) % (2 * sizeof(T)) == 0;
  const bool vec_io = full && ny % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(mask) % 4 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;

  float cur[RPW][CPL], nxt[RPW][CPL], up[CPL], down[CPL], hl[RPW], hr[RPW];
  // the rows above and below the strip are the tile's halo (or past it,
  // never read) for the first and last warp of a tile; other warps take
  // them from their neighbours each sweep
  if (CPL % 2 == 0 && vec_in)
    fetch_strip<CPL, RPW, CPL % 2 == 0>(top, hy, r0, bx, c0, by, cur, up,
                                        down, hl, hr);
  else
    fetch_strip<CPL, RPW, false>(top, hy, r0, bx, c0, by, cur, up, down, hl,
                                 hr);
  uint32_t cols = 0;  // the lane's slots inside the tile
#pragma unroll
  for (int k = 0; k < CPL; ++k)
    if (c0 + k < by) cols |= 1u << k;
  uint32_t live = 0;
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const uint8_t* mrow =
        mask + static_cast<int64_t>(x0 + min(r0 + i, bx - 1)) * ny + y0;
    const uint32_t src = source_bits<CPL>(mrow, c0, by, vec_io);
    live |= (r0 + i < bx ? cols & ~src : 0u) << (i * CPL);
  }
  const float two_hh = __fmul_rn(__fmul_rn(2.0f, h), h);

  const int buf_floats = tpb * wpt * 2 * W;
  const int slot = tile * wpt + wt;
  int s = 0;
  for (; s + 1 < inner; s += 2) {  // two sweeps: cur -> nxt -> cur
    if (wpt > 1) exchange<CPL, RPW>(edge, 0, buf_floats, slot, wt, wpt, cur,
                                    up, down);
    sweep<CPL, RPW>(cur, nxt, up, down, hl, hr, live, h, two_hh, phi);
    if (wpt > 1) exchange<CPL, RPW>(edge, 1, buf_floats, slot, wt, wpt, nxt,
                                    up, down);
    sweep<CPL, RPW>(nxt, cur, up, down, hl, hr, live, h, two_hh, phi);
  }
  if (s < inner) {
    if (wpt > 1) exchange<CPL, RPW>(edge, 0, buf_floats, slot, wt, wpt, cur,
                                    up, down);
    sweep<CPL, RPW>(cur, nxt, up, down, hl, hr, live, h, two_hh, phi);
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int k = 0; k < CPL; ++k) cur[i][k] = nxt[i][k];
  }

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (r0 + i >= bx) continue;
    T* orow = out + static_cast<int64_t>(x0 + r0 + i) * ny + y0 + c0;
    if (vec_io && CPL % 4 == 0) {
#pragma unroll
      for (int k = 0; k < CPL; k += 4) store_quad(orow + k, &cur[i][k]);
    } else if (vec_io && CPL % 2 == 0) {
#pragma unroll
      for (int k = 0; k < CPL; k += 2)
        store_pair(orow + k, cur[i][k], cur[i][k + 1]);
    } else {
#pragma unroll
      for (int k = 0; k < CPL; ++k)
        if (c0 + k < by) ripple::store_f(orow + k, cur[i][k]);
    }
  }
}

template <typename T, int CPL, int RPW>
int launch_shape(const T* phi, const uint8_t* mask, T* out, int nx, int ny,
                 int bx, int by, int inner, float h, int wpt, int tpb,
                 dim3 grid, cudaStream_t stream) {
  const size_t smem =
      wpt > 1 ? sizeof(float) * 2 * tpb * wpt * 2 * 32 * CPL : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fim_kernel<T, CPL, RPW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  fim_kernel<T, CPL, RPW><<<grid, 32 * wpt * tpb, smem, stream>>>(
      phi, mask, out, nx, ny, bx, by, inner, h, wpt);
  return static_cast<int>(cudaGetLastError());
}

// cpl, rpw, wpt, tpb: columns a lane, rows a warp, warps a tile, tiles a
// block; (gx, gy) the grid, tiles along dim 1 by groups of tpb tiles along
// dim 0
template <typename T>
int launch_fim(const void* phi_, const void* mask_, void* out_, int nx,
               int ny, int bx, int by, int inner, float h, int cpl, int rpw,
               int wpt, int tpb, int gx, int gy, void* stream_) {
  if (bx < 1 || by < 1 || nx % bx || ny % by || inner < 0 || wpt < 1 ||
      tpb < 1 || rpw < 1 || by > 32 * cpl || wpt * rpw < bx ||
      (wpt - 1) * rpw >= bx || wpt * tpb > kMaxWarps || tpb > 15 ||
      (nx / bx) % tpb ||
      gx != ny / by || gy != nx / bx / tpb || gy > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto phi = static_cast<const T*>(phi_);
  const auto mask = static_cast<const uint8_t*>(mask_);
  const auto out = static_cast<T*>(out_);
  const auto st = static_cast<cudaStream_t>(stream_);
  const dim3 grid(gx, gy);
#define RIPPLE_FIM_SHAPE(C, R)                                              \
  if (cpl == C && rpw == R)                                                 \
    return launch_shape<T, C, R>(phi, mask, out, nx, ny, bx, by, inner, h, \
                                 wpt, tpb, grid, st);
  RIPPLE_FIM_SHAPE(1, 16)
  RIPPLE_FIM_SHAPE(2, 8)
  RIPPLE_FIM_SHAPE(4, 4)
  RIPPLE_FIM_SHAPE(8, 4)
#undef RIPPLE_FIM_SHAPE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int eikonal_fim_f32(const void* phi, const void* mask, void* out,
                               int nx, int ny, int bx, int by, int inner,
                               float h, int cpl, int rpw, int wpt, int tpb,
                               int gx, int gy, void* stream) {
  return launch_fim<float>(phi, mask, out, nx, ny, bx, by, inner, h, cpl,
                           rpw, wpt, tpb, gx, gy, stream);
}

extern "C" int eikonal_fim_bf16(const void* phi, const void* mask, void* out,
                                int nx, int ny, int bx, int by, int inner,
                                float h, int cpl, int rpw, int wpt, int tpb,
                                int gx, int gy, void* stream) {
  return launch_fim<bf16>(phi, mask, out, nx, ny, bx, by, inner, h, cpl,
                          rpw, wpt, tpb, gx, gy, stream);
}

RIPPLE_ERROR_STRING_FN
