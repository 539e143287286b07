// Particle update kernel for Hopper (paper §7.2, Table 3): K3.
//
// Replaces particle_update_pallas (src/repro/kernels/particle/kernel.py:59):
// x += v*dt for N particles of the record PARTICLE_SPEC (x[3], v[3]) stored
// as AoS (n, 6), SoA (6, n) or AoSoA (n_tiles, 6, tile); v is copied
// through.
//
// Bound on the card: bytes.  Six components read and written per particle
// and three multiply-adds: 48 bytes of float32 traffic for 6 flops.
//
// Design: one CTA covers `block` consecutive particles (the reference's
// block argument, n % block == 0) with up to 256 threads striding through
// them.  Every component is addressed through the K0 accessor
// (record_index.cuh), so the one body serves all three layouts: SoA and
// AoSoA give each component a contiguous run across a warp; AoS reads
// 6-wide records, whose neighbouring components the same warp consumes on
// its next loads from L1.  Float32 arithmetic for both storage types.
//
// In place: `o` may be `p` (the executor's regions write a node's output
// into its key's static buffer).  Each thread reads a particle's
// components before it writes them and no other thread touches them, so
// the two pointers carry no __restrict__; without that promise the
// compiler keeps loads and stores in source order, so the body issues
// all six loads first.  In place, v stays where it is (three stores a
// particle, not six).
#include <cuda_runtime.h>

#include "record_index.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kC = 6;  // x[3] at components 0..2, v[3] at 3..5

template <typename T, int L>
__global__ void particle_kernel(const T* p, T* o, float dt, int64_t n,
                                int tile, int block) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * block;
  const bool copy_v = o != p;  // in place, v is there already
  for (int k = threadIdx.x; k < block; k += blockDim.x) {
    const int64_t i = base + k;
    int64_t ox[3], ov[3];
    T xs[3], vs[3];
    // every load before any store: p and o may be one record
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      ox[c] = ripple::record_offset<L>(i, c, n, kC, tile);
      ov[c] = ripple::record_offset<L>(i, 3 + c, n, kC, tile);
      xs[c] = p[ox[c]];
      vs[c] = p[ov[c]];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (copy_v) o[ov[c]] = vs[c];
      ripple::store_f(o + ox[c],
                      ripple::load_f(&xs[c]) + ripple::load_f(&vs[c]) * dt);
    }
  }
}

template <typename T>
int launch_particle(const void* p, void* o, float dt, int64_t n, int layout,
                    int tile, int block, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int threads = block < kMaxThreads ? block : kMaxThreads;
  const int64_t grid = n / block;  // the wrapper checks n % block == 0
  auto pp = static_cast<const T*>(p);
  auto po = static_cast<T*>(o);
  if (grid > 0) {
    switch (layout) {
      case ripple::kAoS:
        particle_kernel<T, ripple::kAoS>
            <<<grid, threads, 0, s>>>(pp, po, dt, n, tile, block);
        break;
      case ripple::kSoA:
        particle_kernel<T, ripple::kSoA>
            <<<grid, threads, 0, s>>>(pp, po, dt, n, tile, block);
        break;
      case ripple::kAoSoA:
        particle_kernel<T, ripple::kAoSoA>
            <<<grid, threads, 0, s>>>(pp, po, dt, n, tile, block);
        break;
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int particle_update_f32(const void* p, void* o, float dt,
                                   int64_t n, int layout, int tile,
                                   int block, void* stream) {
  return launch_particle<float>(p, o, dt, n, layout, tile, block, stream);
}

extern "C" int particle_update_bf16(const void* p, void* o, float dt,
                                    int64_t n, int layout, int tile,
                                    int block, void* stream) {
  return launch_particle<__nv_bfloat16>(p, o, dt, n, layout, tile, block,
                                        stream);
}

RIPPLE_ERROR_STRING_FN
