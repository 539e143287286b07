// FORCE flux-difference stencil for Hopper (paper §7.3, Table 4): K4.
//
// Replaces flux_difference_pallas (src/repro/kernels/stencil/kernel.py:67):
// the sum over x and y of lam_d * (F_{i+1/2} - F_{i-1/2}), F the FORCE flux
// (src/repro/physics/euler.py:64-114), on a 2-D Euler record EULER_SPEC
// (rho, E, mom[2]) haloed by one cell: space (nx+2, ny+2) in, (nx, ny) out.
// AoS and SoA are native; AoSoA is relayouted to SoA by the ops wrapper.
//
// Bound on the card: bytes.  Each cell reads 4 and writes 4 components
// (32 bytes in float32) for about 200 operations over its two unique
// faces, below the H100's float32 ridge of ~20 operations per byte.  What
// held the first version (a shared-memory tile, one cell a thread, 5.3x
// its bound) back: every face computed twice, ~24 IEEE divisions a cell,
// and a block barrier between the tile's loads and any arithmetic.
//
// Design: each face once, short strips streamed through registers.
// - A warp owns 32 adjacent interior columns (y, the contiguous axis; lane
//   l has column y0 + l) and walks a strip of rows down x.  It keeps in
//   registers the current row's state, the next row's, and the x-face flux
//   F_{i+1/2}, which becomes F_{i-1/2} of the next row; so a strip
//   computes its first x-face twice, 1/R of the x-faces for R rows.
// - A lane computes the y-face right of its cell from its right
//   neighbour's state (one __shfl_down); its left face is its left
//   neighbour's right face (one __shfl_up).  The two at the warp's edges
//   (the face left of lane 0, and the state right of lane 31) are prepared
//   once a strip, lane r for row r, into the warp's own slice of shared
//   memory (a __syncwarp, no block barrier), and read there row by row: a
//   face more per 32.
// - A state's 1/rho (a correctly rounded reciprocal, not a division), u, v
//   and p are computed once and feed both of its physical fluxes; each
//   face's Richtmyer midpoint state needs its own.  That is 3 reciprocals a
//   cell.  0.5 / lam and 0.5 lam are formed once, on the host.
// - Memory: the kernel is bound by how many loads are in flight, not by
//   its arithmetic (chip_smoke.py times its loads, shuffles and stores
//   alone at ~80 % of the whole on an H100).  A strip's start issues every
//   load it needs at once (the rows above and in it, two rows ahead, the
//   edge cells), and the walk keeps two rows ahead in flight (a register
//   ring), so short strips keep more loads in flight: the geometry takes 4
//   rows a strip and 4 warps a block, the fastest that tools/k4_geometry.py
//   reads at 4096^2 float32 on an H100.  At most 64 registers a thread, so
//   32 warps share an SM.  The kernel takes strips of up to 8 rows and
//   blocks of up to 4 warps.
// - Accesses: AoS, one cell a lane as one 16-byte (float32) or 8-byte
//   (bfloat16) load, aligned on every row whatever the row pitch ny + 2;
//   SoA, one element of each component a lane, 128 (64) bytes a warp-row.
//   A wider SoA access would be misaligned on every other row (the pitch is
//   16,392 bytes at 4096^2), and TMA cannot describe the tensor at all (its
//   strides must be multiples of 16 bytes).
// - Ragged edges are masked: rows by a warp-uniform strip length, columns
//   by clamping reads into the haloed row and masking stores.  Strip
//   length, warps a block and the grid come from flux_geometry in
//   kernels/stencil/kernel.py; the launch checks that they cover the
//   interior.
// All arithmetic is float32, also for bfloat16 storage (the division by
// rho and the E - ke difference lose too much in bfloat16); a result is
// rounded once, on the store.  The FLUX=false instances do the same loads,
// shuffles and stores with a sum in place of the flux arithmetic: the
// traffic alone, for timing.
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "record_index.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kC = 4;          // rho, E, mom_x, mom_y
constexpr int kMaxRows = 8;    // rows a strip: lane r prepares row r's edges
constexpr int kMaxWarps = 4;   // warps a block
constexpr int kAhead = 2;      // rows whose loads are in flight
constexpr unsigned kAll = 0xffffffffu;
// (gamma - 1) rounded once from double, as the reference's float32 path
constexpr float kGm1 = static_cast<float>(1.4 - 1.0);

// A cell's conserved state and what both of its physical fluxes need.
struct Cell {
  float rho, e, mx, my;  // conserved
  float u, v, p;         // velocity and pressure
};

__device__ __forceinline__ void derive(Cell& s) {
  const float inv = __frcp_rn(s.rho);
  s.u = s.mx * inv;
  s.v = s.my * inv;
  s.p = kGm1 * (s.e - 0.5f * (s.mx * s.mx + s.my * s.my) * inv);
}

// physical flux along dim D (0 = x, 1 = y)
template <int D>
__device__ __forceinline__ void phys(const Cell& s, float F[kC]) {
  const float w = D == 0 ? s.u : s.v;
  F[0] = D == 0 ? s.mx : s.my;
  F[1] = (s.e + s.p) * w;
  F[2] = s.mx * w + (D == 0 ? s.p : 0.0f);
  F[3] = s.my * w + (D == 1 ? s.p : 0.0f);
}

// FORCE flux at the face between a and b along D: the mean of the
// Lax-Friedrichs flux and the physical flux of the Richtmyer state.
// hil = 0.5 / lam, hl = 0.5 lam.
template <int D, bool FLUX>
__device__ __forceinline__ void face(const Cell& a, const Cell& b, float hil,
                                     float hl, float F[kC]) {
  const float ua[kC] = {a.rho, a.e, a.mx, a.my};
  const float ub[kC] = {b.rho, b.e, b.mx, b.my};
  if constexpr (!FLUX) {
#pragma unroll
    for (int c = 0; c < kC; ++c) F[c] = ua[c] + ub[c];
    return;
  }
  float fa[kC], fb[kC], um[kC], fm[kC];
  phys<D>(a, fa);
  phys<D>(b, fb);
#pragma unroll
  for (int c = 0; c < kC; ++c)
    um[c] = 0.5f * (ua[c] + ub[c]) - hl * (fb[c] - fa[c]);
  Cell m{um[0], um[1], um[2], um[3], 0.0f, 0.0f, 0.0f};
  derive(m);
  phys<D>(m, fm);
#pragma unroll
  for (int c = 0; c < kC; ++c)
    F[c] = 0.5f * ((0.5f * (fa[c] + fb[c]) - hil * (ub[c] - ua[c])) + fm[c]);
}

// The bits of one cell as loaded: AoS one vector, SoA one element of each
// component.
template <typename T, int L>
struct Raw {
  T v[kC];
};
template <>
struct Raw<float, ripple::kAoS> {
  float4 v;
};
template <>
struct Raw<bf16, ripple::kAoS> {
  uint2 v;
};

__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

__device__ __forceinline__ uint32_t float2_to_bf16x2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// cell i of a record of n cells
template <typename T, int L>
__device__ __forceinline__ Raw<T, L> load_raw(const T* __restrict__ u,
                                              int64_t i, int64_t n) {
  Raw<T, L> r;
  if constexpr (L == ripple::kSoA) {
#pragma unroll
    for (int c = 0; c < kC; ++c) r.v[c] = u[c * n + i];
  } else if constexpr (std::is_same_v<T, float>) {
    r.v = reinterpret_cast<const float4*>(u)[i];
  } else {
    r.v = reinterpret_cast<const uint2*>(u)[i];
  }
  return r;
}

template <typename T, int L, bool FLUX>
__device__ __forceinline__ Cell to_cell(const Raw<T, L>& r) {
  Cell s{};
  if constexpr (L == ripple::kSoA) {
    s.rho = ripple::load_f(&r.v[0]);
    s.e = ripple::load_f(&r.v[1]);
    s.mx = ripple::load_f(&r.v[2]);
    s.my = ripple::load_f(&r.v[3]);
  } else if constexpr (std::is_same_v<T, float>) {
    s.rho = r.v.x;
    s.e = r.v.y;
    s.mx = r.v.z;
    s.my = r.v.w;
  } else {
    const float2 a = bf16x2_to_float2(r.v.x), b = bf16x2_to_float2(r.v.y);
    s.rho = a.x;
    s.e = a.y;
    s.mx = b.x;
    s.my = b.y;
  }
  if constexpr (FLUX) derive(s);
  return s;
}

template <typename T, int L, bool FLUX>
__device__ __forceinline__ Cell cell_at(const T* __restrict__ u, int64_t i,
                                        int64_t n) {
  return to_cell<T, L, FLUX>(load_raw<T, L>(u, i, n));
}

template <typename T, int L>
__device__ __forceinline__ void store_cell(T* __restrict__ out, int64_t i,
                                           int64_t n, const float o[kC]) {
  if constexpr (L == ripple::kSoA) {
#pragma unroll
    for (int c = 0; c < kC; ++c) ripple::store_f(out + c * n + i, o[c]);
  } else if constexpr (std::is_same_v<T, float>) {
    reinterpret_cast<float4*>(out)[i] = make_float4(o[0], o[1], o[2], o[3]);
  } else {
    reinterpret_cast<uint2*>(out)[i] =
        make_uint2(float2_to_bf16x2(o[0], o[1]), float2_to_bf16x2(o[2], o[3]));
  }
}

struct Lam {
  float x, y;          // lam_d
  float hil_x, hil_y;  // 0.5 / lam_d
  float hl_x, hl_y;    // 0.5 lam_d
};

template <typename T, int L, bool FLUX>
__global__ void __launch_bounds__(32 * kMaxWarps, 8)
    flux_kernel(const T* __restrict__ u, T* __restrict__ out, int nx, int ny,
                int rows, Lam lam) {
  // per warp and strip row: the y-face left of lane 0's cell, and the
  // state right of lane 31's (rho, E, mom_x, mom_y, then v, p)
  __shared__ float4 edges[kMaxWarps][kMaxRows][3];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int y0 = (blockIdx.x * (blockDim.x >> 5) + warp) * 32;  // 1st column
  const int x0 = blockIdx.y * rows;
  if (y0 >= ny || x0 >= nx) return;  // a whole warp past the edge
  const int nrows = min(rows, nx - x0);  // the strip, warp-uniform
  const int hy = ny + 2;
  const int64_t n_in = static_cast<int64_t>(nx + 2) * hy;
  const int64_t n_out = static_cast<int64_t>(nx) * ny;
  // haloed column of this lane's cell, clamped into the row past the edge
  const int col = min(y0 + lane + 1, ny + 1);
  auto at = [&](int hrow, int hcol) {  // haloed (row, column)
    return static_cast<int64_t>(hrow) * hy + hcol;
  };

  // every load the strip's start needs goes out at once: the x-face above
  // the strip (haloed rows x0, x0 + 1), the rows ahead, and lane r's cells
  // at the warp's edges in row r
  const Raw<T, L> top = load_raw<T, L>(u, at(x0, col), n_in);
  const Raw<T, L> first = load_raw<T, L>(u, at(x0 + 1, col), n_in);
  Raw<T, L> ahead[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k)
    ahead[k] = load_raw<T, L>(u, at(min(x0 + 2 + k, nx + 1), col), n_in);
  {
    const int er = x0 + min(lane, nrows - 1) + 1;
    const Raw<T, L> a = load_raw<T, L>(u, at(er, y0), n_in);
    const Raw<T, L> b = load_raw<T, L>(u, at(er, y0 + 1), n_in);
    const Raw<T, L> c = load_raw<T, L>(u, at(er, min(y0 + 33, ny + 1)), n_in);
    float eg[kC];
    face<1, FLUX>(to_cell<T, L, FLUX>(a), to_cell<T, L, FLUX>(b), lam.hil_y,
                  lam.hl_y, eg);
    const Cell r = to_cell<T, L, FLUX>(c);
    if (lane < kMaxRows) {
      edges[warp][lane][0] = make_float4(eg[0], eg[1], eg[2], eg[3]);
      edges[warp][lane][1] = make_float4(r.rho, r.e, r.mx, r.my);
      edges[warp][lane][2] = make_float4(r.v, r.p, 0.0f, 0.0f);
    }
  }
  __syncwarp();

  Cell cur = to_cell<T, L, FLUX>(top);
  Cell nxt = to_cell<T, L, FLUX>(first);
  float fm[kC];
  face<0, FLUX>(cur, nxt, lam.hil_x, lam.hl_x, fm);
  cur = nxt;

  for (int i0 = 0; i0 < nrows; i0 += kAhead) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const int i = i0 + k;
      if (i >= nrows) break;
      nxt = to_cell<T, L, FLUX>(ahead[k]);
      // the loads kAhead rows further go out before this row's arithmetic
      // (clamped past the last row, where they are not used: unconditional
      // loads schedule better than loads behind the strip's end)
      ahead[k] =
          load_raw<T, L>(u, at(min(x0 + i + 2 + kAhead, nx + 1), col), n_in);
      float fp[kC];
      face<0, FLUX>(cur, nxt, lam.hil_x, lam.hl_x, fp);

      // the y-face right of this lane's cell, from its right neighbour
      // (lane 31's from the strip's edge cells)
      const float4 e0 = edges[warp][i][0], e1 = edges[warp][i][1],
                   e2 = edges[warp][i][2];
      Cell r;
      r.rho = __shfl_down_sync(kAll, cur.rho, 1);
      r.e = __shfl_down_sync(kAll, cur.e, 1);
      r.mx = __shfl_down_sync(kAll, cur.mx, 1);
      r.my = __shfl_down_sync(kAll, cur.my, 1);
      r.v = __shfl_down_sync(kAll, cur.v, 1);
      r.p = __shfl_down_sync(kAll, cur.p, 1);
      if (lane == 31) {
        r.rho = e1.x;
        r.e = e1.y;
        r.mx = e1.z;
        r.my = e1.w;
        r.v = e2.x;
        r.p = e2.y;
      }
      float gp[kC], gm[kC];
      face<1, FLUX>(cur, r, lam.hil_y, lam.hl_y, gp);
      // the y-face left of it: the left neighbour's right face
      const float eg[kC] = {e0.x, e0.y, e0.z, e0.w};
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float left = __shfl_up_sync(kAll, gp[c], 1);
        gm[c] = lane == 0 ? eg[c] : left;
      }

      if (y0 + lane < ny) {
        float o[kC];
#pragma unroll
        for (int c = 0; c < kC; ++c)
          o[c] = lam.x * (fp[c] - fm[c]) + lam.y * (gp[c] - gm[c]);
        store_cell<T, L>(out, static_cast<int64_t>(x0 + i) * ny + y0 + lane,
                         n_out, o);
      }
#pragma unroll
      for (int c = 0; c < kC; ++c) fm[c] = fp[c];
      cur = nxt;
    }
  }
}

template <typename T, bool FLUX>
int launch_flux(const void* u, void* out, int nx, int ny, int layout,
                float lam_x, float lam_y, int rows, int warps, int grid_x,
                int grid_y, void* stream) {
  // the geometry must cover the interior within the kernel's limits
  if (nx < 1 || ny < 1 || rows < 1 || rows > kMaxRows || warps < 1 ||
      warps > kMaxWarps || grid_x < 1 || grid_y < 1 || grid_y > 65535 ||
      static_cast<int64_t>(grid_x) * warps * 32 < ny ||
      static_cast<int64_t>(grid_y) * rows < nx)
    return static_cast<int>(cudaErrorInvalidValue);
  // AoS reads and writes one cell as one vector
  if (layout == ripple::kAoS &&
      (reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(out)) %
          (kC * sizeof(T)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const Lam lam{lam_x, lam_y, 0.5f / lam_x, 0.5f / lam_y, 0.5f * lam_x,
                0.5f * lam_y};
  const dim3 grid(grid_x, grid_y);
  auto pu = static_cast<const T*>(u);
  auto po = static_cast<T*>(out);
  switch (layout) {
    case ripple::kAoS:
      flux_kernel<T, ripple::kAoS, FLUX>
          <<<grid, 32 * warps, 0, s>>>(pu, po, nx, ny, rows, lam);
      break;
    case ripple::kSoA:
      flux_kernel<T, ripple::kSoA, FLUX>
          <<<grid, 32 * warps, 0, s>>>(pu, po, nx, ny, rows, lam);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define RIPPLE_FLUX_ENTRY(name, T, FLUX)                                    \
  extern "C" int name(const void* u, void* out, int nx, int ny, int layout, \
                      float lam_x, float lam_y, int rows, int warps,        \
                      int grid_x, int grid_y, void* stream) {               \
    return launch_flux<T, FLUX>(u, out, nx, ny, layout, lam_x, lam_y, rows, \
                                warps, grid_x, grid_y, stream);             \
  }

RIPPLE_FLUX_ENTRY(flux_difference_f32, float, true)
RIPPLE_FLUX_ENTRY(flux_difference_bf16, bf16, true)
RIPPLE_FLUX_ENTRY(flux_traffic_f32, float, false)
RIPPLE_FLUX_ENTRY(flux_traffic_bf16, bf16, false)

RIPPLE_ERROR_STRING_FN
