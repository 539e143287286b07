// FORCE flux-difference stencil for Hopper (paper §7.3, Table 4): K4.
//
// Replaces flux_difference_pallas (src/repro/kernels/stencil/kernel.py:67):
// the sum over x and y of lam_d * (F_{i+1/2} - F_{i-1/2}), F the FORCE flux
// (src/repro/physics/euler.py:64-114), on a 2-D Euler record EULER_SPEC
// (rho, E, mom[2]) haloed by one cell: space (nx+2, ny+2) in, (nx, ny) out.
// AoS and SoA are native; AoSoA is relayouted to SoA by the ops wrapper.
//
// Bound on the card: bytes.  Each cell reads 4 and writes 4 components
// (32 bytes in float32) for about 200 flops over its two unique faces —
// below the H100's float32 ridge of ~20 flops per byte.
//
// Design: a 32 x 16 thread block (threadIdx.x along the contiguous y axis)
// computes a 16 x 32 tile of cells.  It first stages the halo-inclusive
// (16+2) x (32+2) tile of all four components into shared memory — the
// paper's in_shared — walking the tile in storage order so that
// consecutive threads load consecutive addresses in either layout (AoS is
// read component-strided through the K0 accessor, record_index.cuh), and
// converts to float32 on the way.  Each thread then evaluates the four
// faces of its cell from shared memory; a face shared by two cells is
// computed twice, which costs flops the kernel has to spare.  The ragged
// edge of the last tiles is masked.  All arithmetic is float32, also for
// bfloat16 storage (the division by rho and the E - ke difference lose
// too much in bfloat16).  Later work: each thread computing several cells
// to reuse faces, and vector loads.
#include <cuda_runtime.h>

#include "record_index.cuh"

namespace {

constexpr int kTX = 16;  // cells per tile along space dim 0 (threadIdx.y)
constexpr int kTY = 32;  // cells per tile along space dim 1 (threadIdx.x)
constexpr int kC = 4;    // rho, E, mom_x, mom_y
// (gamma - 1) rounded once from double, as the reference's float32 path
constexpr float kGm1 = static_cast<float>(1.4 - 1.0);

__device__ __forceinline__ void phys_flux(const float U[kC], int dim,
                                          float F[kC]) {
  const float ke = 0.5f * (U[2] * U[2] + U[3] * U[3]) / U[0];
  const float p = kGm1 * (U[1] - ke);
  const float m = U[2 + dim];
  const float u = m / U[0];
  F[0] = m;
  F[1] = (U[1] + p) * u;
  F[2] = U[2] * u + (dim == 0 ? p : 0.0f);
  F[3] = U[3] * u + (dim == 1 ? p : 0.0f);
}

// FORCE flux at the interface between UL and UR along `dim`.
__device__ __forceinline__ void force_flux(const float UL[kC],
                                           const float UR[kC], int dim,
                                           float lam, float F[kC]) {
  float FL[kC], FR[kC], Urm[kC], Frm[kC], Flf[kC];
  phys_flux(UL, dim, FL);
  phys_flux(UR, dim, FR);
  const float half_inv_lam = 0.5f / lam;
  const float half_lam = 0.5f * lam;
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    Flf[c] = 0.5f * (FL[c] + FR[c]) - half_inv_lam * (UR[c] - UL[c]);
    Urm[c] = 0.5f * (UL[c] + UR[c]) - half_lam * (FR[c] - FL[c]);
  }
  phys_flux(Urm, dim, Frm);
#pragma unroll
  for (int c = 0; c < kC; ++c) F[c] = 0.5f * (Flf[c] + Frm[c]);
}

template <typename T, int L>
__global__ void __launch_bounds__(kTX * kTY)
    flux_kernel(const T* __restrict__ u, T* __restrict__ out, int nx, int ny,
                float lam_x, float lam_y) {
  __shared__ float s[kC][kTX + 2][kTY + 2];
  const int hy = ny + 2;
  const int64_t n_in = static_cast<int64_t>(nx + 2) * hy;
  const int x0 = blockIdx.y * kTX;
  const int y0 = blockIdx.x * kTY;
  const int tid = threadIdx.y * kTY + threadIdx.x;
  constexpr int kCells = (kTX + 2) * (kTY + 2);
  for (int k = tid; k < kC * kCells; k += kTX * kTY) {
    int c, cell;
    if constexpr (L == ripple::kAoS) {
      c = k % kC;
      cell = k / kC;
    } else {
      c = k / kCells;
      cell = k % kCells;
    }
    const int lx = cell / (kTY + 2), ly = cell % (kTY + 2);
    const int gx = x0 + lx, gy = y0 + ly;  // haloed coordinates
    if (gx < nx + 2 && gy < hy) {
      const int64_t i = static_cast<int64_t>(gx) * hy + gy;
      s[c][lx][ly] = ripple::load_f(u + ripple::record_offset<L>(i, c, n_in, kC, 1));
    }
  }
  __syncthreads();

  const int gx = x0 + threadIdx.y, gy = y0 + threadIdx.x;  // interior
  if (gx >= nx || gy >= ny) return;
  const int lx = threadIdx.y + 1, ly = threadIdx.x + 1;
  float Uc[kC], Um[kC], Up[kC], Fm[kC], Fp[kC], acc[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    Uc[c] = s[c][lx][ly];
    Um[c] = s[c][lx - 1][ly];
    Up[c] = s[c][lx + 1][ly];
  }
  force_flux(Um, Uc, 0, lam_x, Fm);
  force_flux(Uc, Up, 0, lam_x, Fp);
#pragma unroll
  for (int c = 0; c < kC; ++c) acc[c] = lam_x * (Fp[c] - Fm[c]);
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    Um[c] = s[c][lx][ly - 1];
    Up[c] = s[c][lx][ly + 1];
  }
  force_flux(Um, Uc, 1, lam_y, Fm);
  force_flux(Uc, Up, 1, lam_y, Fp);
  const int64_t n_out = static_cast<int64_t>(nx) * ny;
  const int64_t i = static_cast<int64_t>(gx) * ny + gy;
#pragma unroll
  for (int c = 0; c < kC; ++c)
    ripple::store_f(out + ripple::record_offset<L>(i, c, n_out, kC, 1),
                    acc[c] + lam_y * (Fp[c] - Fm[c]));
}

template <typename T>
int launch_flux(const void* u, void* out, int nx, int ny, int layout,
                float lam_x, float lam_y, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const dim3 block(kTY, kTX);
  const dim3 grid((ny + kTY - 1) / kTY, (nx + kTX - 1) / kTX);
  auto pu = static_cast<const T*>(u);
  auto po = static_cast<T*>(out);
  switch (layout) {
    case ripple::kAoS:
      flux_kernel<T, ripple::kAoS>
          <<<grid, block, 0, s>>>(pu, po, nx, ny, lam_x, lam_y);
      break;
    case ripple::kSoA:
      flux_kernel<T, ripple::kSoA>
          <<<grid, block, 0, s>>>(pu, po, nx, ny, lam_x, lam_y);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flux_difference_f32(const void* u, void* out, int nx, int ny,
                                   int layout, float lam_x, float lam_y,
                                   void* stream) {
  return launch_flux<float>(u, out, nx, ny, layout, lam_x, lam_y, stream);
}

extern "C" int flux_difference_bf16(const void* u, void* out, int nx, int ny,
                                    int layout, float lam_x, float lam_y,
                                    void* stream) {
  return launch_flux<__nv_bfloat16>(u, out, nx, ny, layout, lam_x, lam_y,
                                    stream);
}

RIPPLE_ERROR_STRING_FN
