// Mamba-2 SSD intra-chunk dual form for Hopper: K7.
//
// Replaces ssd_intra_chunk_pallas (src/repro/kernels/ssd/kernel.py:72): for
// every (batch, chunk, head), with L positions per chunk,
//   cs      = cumsum(dt * A)                                   (L,)
//   y_intra = ((C B^T) o exp(cs_i - cs_j) [j <= i]) (dt x)     (L, P)
//   s_chunk = sum_j exp(cs_{L-1} - cs_j) dt_j x_j B_j^T        (P, N), float32
// x is (B, S, H, P) in the storage type, dt (B, S, H) and A (H,) float32,
// B and C (B, S, N) in the storage type (n_groups = 1); y_intra comes back
// (B, S, H, P) in the storage type and s_chunk (B, S/L, H, P, N) in float32.
// The inter-chunk state scan, y_inter and the D skip are torch ops in
// kernels/ssd/ops.py, as ssd_pallas leaves them to XLA.
//
// Bound on the card: bytes.  Per block 2 L^2 N + 2 L^2 P + 2 L P N
// operations (4.2 M at L = P * 2 = N = 128) against ~50 KB of bf16 tiles:
// about 80 operations per byte, below the bf16 tensor cores' ridge of ~295,
// above the float32 CUDA cores' ~20.
//
// bf16 route (ssd_wgmma_kernel): wgmma on sm_90a.  One 256-thread block
// per (head, chunk, batch), as two warpgroups of 64 chunk rows: at a
// 640-token prompt (5 chunks) that is 120 blocks for 132 SMs, where sharing
// C B^T between the heads of a chunk would leave half of them idle, and
// C B^T is some 0.5 us of tensor-core time a block.  C, B and x are staged
// in bf16 by 16-byte cp.async copies into the 128-byte-swizzled layout of
// hopper.cuh (a 128-row tile of N = 128 columns is two 16 KB slabs): 80 KB
// of tiles and 1.5 KB of float32 vectors (dt, cs, the weights w), two
// blocks per SM.  The cumulative sum of dt * A is a scan by four warps,
// then a scan of their totals.  C B^T is one wgmma product with both
// operands K-major in shared memory (warpgroup 0 forms the 64 x 64 block
// left of the diagonal, warpgroup 1 its 64 x 128 rows).  On the
// accumulator fragments S'_ij = (C B^T)_ij exp(cs_i - cs_j) dt_j for
// j <= i and 0 elsewhere (the decay never passes through exp above the
// diagonal, where cs_i - cs_j > 0 could overflow to inf, and inf * 0 is
// NaN); dt_j folded into S' keeps x exact in bf16.  y_intra = S' x takes
// S' as the register A operand, converted in place from the accumulator
// layout, with x (positions x P, P contiguous) the B operand read
// transposed, as K6's P V.  S' is issued twice, S'_hi = bf16(S') and
// S'_lo = bf16(S' - S'_hi): S' rounded once to bf16 puts some 3 % of the
// outputs at the mamba2-130m shape outside y_intra's limit, the split none
// (tests/test_torch_ssd.py emulates both).  The chunk state xT diag(w) B,
// w_j = dt_j exp(cs_{L-1} - cs_j), is m64n64 per warpgroup over one 64-
// column slab of B, with A = (w x)^T built in registers from the staged x
// and issued as two bf16 pieces (hi, lo): one piece is outside the states'
// float32 limit (2e-5, 2e-5), two are inside.  The bf16 route needs P and
// N multiples of 8 and 16-byte-aligned x, B and C (the wrapper raises
// before the launch).
//
// Chunks of 129-256 positions (the tile registry's 256): the same block
// walks two 128-row query tiles.  Query tile 1 reads key tile 0 in full
// (its S block is m64n128 with no diagonal) and key tile 1 up to the
// diagonal; y accumulates over the two key tiles in one register
// fragment, and the chunk state sums the two key tiles, each with its
// weights w_j = dt_j exp(cs_{L-1} - cs_j).  All of a 256-chunk's B, C and
// x are staged (160 KB of tiles, slabs of 256 swizzled rows) rather than
// restaging key tiles: a block then reads each input once, and at one
// block an SM (the shared memory allows no second) its 256 threads are as
// many as two blocks of the 128-chunk's shape, with half the blocks.  Its
// instance may use up to 255 registers (y is live across a second S
// product).  Chunks of up to 128 run the 128-row instance, unchanged.
//
// float32 route (ssd_chunk_kernel): the float32 CUDA cores; no served
// model runs the SSD in float32.  One 256-thread block per (head, chunk,
// batch).  The B tile, the C tile (overwritten by dt * x once C B^T is
// formed) and the L x L score tile sit in dynamic shared memory in float32
// (199 KB at L = N = 128, P = 64), rows padded by one float so that 16
// threads reading 16 rows hit 16 banks.  A chunk of 129-256 positions
// cannot be held whole: the kernel walks 128-row query blocks and, for
// each, the key blocks up to it, staging one (query, key) pair of C and B
// tiles at a time, and sums the chunk state over the key blocks, the
// last one still staged from the y pass.  The cumulative sum is a warp
// scan: each lane sums L/32 consecutive positions, then the lane totals
// are scanned with shuffles.  Each of the 16 x 16 threads owns rows
// ty + 16 i and columns tx + 16 j of every product.  Every head recomputes
// C B^T, as the TPU kernel does.
//
// Both routes take chunks of up to 256 positions, P <= 64 and N <= 128;
// the ragged L (a prompt shorter than the model's chunk) is masked in the
// tiles.
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "hopper.cuh"
#include "record_index.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxPR = 4;      // P <= 64
constexpr int kMaxNR = 8;      // N <= 128
constexpr int kMaxL = 256;     // positions a chunk

struct Dims {
  int S, H, P, N, L, nc;
};

// float offsets of the shared-memory regions for key and query blocks of
// LR * 16 rows, NB blocks a chunk
struct Smem {
  int bs, xs, ss, lt;  // row strides of B / C, of dt * x, of scores; rows
  size_t b, cx, s, cs, dtv, dec, total;
};

__host__ __device__ inline Smem smem_layout(int LR, int NB, int P, int N) {
  Smem m;
  m.lt = 16 * LR;
  m.bs = N + 1;
  m.xs = P;
  m.ss = m.lt + 1;
  m.b = 0;
  m.cx = m.b + static_cast<size_t>(m.lt) * m.bs;
  const int cx_stride = m.bs > m.xs ? m.bs : m.xs;
  m.s = m.cx + static_cast<size_t>(m.lt) * cx_stride;
  m.cs = m.s + static_cast<size_t>(m.lt) * m.ss;
  m.dtv = m.cs + m.lt * NB;
  m.dec = m.dtv + m.lt * NB;
  m.total = (m.dec + m.lt * NB) * sizeof(float);
  return m;
}

template <typename T, int LR, int NB>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ C, T* __restrict__ y,
                     float* __restrict__ s_out, Dims d) {
  extern __shared__ float smem[];
  const Smem lay = smem_layout(LR, NB, d.P, d.N);
  float* sB = smem + lay.b;
  float* sCX = smem + lay.cx;
  float* sS = smem + lay.s;
  float* cs = smem + lay.cs;
  float* dtv = smem + lay.dtv;
  float* dec = smem + lay.dec;

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int L = d.L, P = d.P, N = d.N;
  const int lt = lay.lt, nt = lt * NB;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row0 = static_cast<int64_t>(b) * d.S + static_cast<int64_t>(c) * L;

  // B rows k0.. into sB and, unless q0 < 0, C rows q0.. into sCX; rows
  // past L zero
  auto stage_bc = [&](int k0, int q0) {
    for (int i = warp; i < lt; i += kThreads / 32) {
      const bool kin = k0 + i < L, qin = q0 + i < L;
      for (int n = lane; n < N; n += 32) {
        sB[i * lay.bs + n] =
            kin ? ripple::load_f(Bm + (row0 + k0 + i) * N + n) : 0.0f;
        if (q0 >= 0)
          sCX[i * lay.bs + n] =
              qin ? ripple::load_f(C + (row0 + q0 + i) * N + n) : 0.0f;
      }
    }
  };
  auto stage_dtx = [&](int k0) {
    for (int i = warp; i < lt; i += kThreads / 32) {
      const int j = k0 + i;
      for (int p = lane; p < P; p += 32)
        sCX[i * lay.xs + p] =
            j < L ? dtv[j] * ripple::load_f(x + ((row0 + j) * d.H + h) * P + p)
                  : 0.0f;
    }
  };

  // dt (past L zero), and the first B and C blocks
  for (int i = threadIdx.x; i < nt; i += kThreads)
    dtv[i] = i < L ? dt[(row0 + i) * d.H + h] : 0.0f;
  stage_bc(0, 0);
  __syncthreads();

  // cs = inclusive cumsum of dt * A over the chunk: warp 0 scans
  if (warp == 0) {
    const float a = A[h];
    const int per = (nt + 31) / 32;
    const int start = lane * per;
    float run = 0.0f;
    for (int e = start; e < start + per && e < nt; ++e) {
      run += dtv[e] * a;
      cs[e] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    const float before = incl - run;
    for (int e = start; e < start + per && e < nt; ++e) cs[e] += before;
  }
  __syncthreads();
  // the decay to the chunk's end, exp(cs_{L-1} - cs_j)
  for (int i = threadIdx.x; i < nt; i += kThreads)
    dec[i] = i < L ? expf(cs[L - 1] - cs[i]) : 0.0f;

  // y_intra, a query block at a time: the sum over key blocks kb <= qb of
  // scores (dt x), the scores of a block pair formed in shared memory.  A
  // chunk of one block runs each loop once, straight through.
  const int pr = (P + 15) / 16;
  const int nb = NB == 1 ? 1 : (L + lt - 1) / lt;  // blocks with positions
  for (int qb = 0; qb < nb; ++qb) {
    const int q0 = qb * lt;
    float ya[LR][kMaxPR];
#pragma unroll
    for (int i = 0; i < LR; ++i)
#pragma unroll
      for (int j = 0; j < kMaxPR; ++j) ya[i][j] = 0.0f;
    for (int kb = 0; kb <= qb; ++kb) {
      const int k0 = kb * lt;
      if (qb + kb > 0) {  // the first pair was staged above
        __syncthreads();  // every thread done with the last pair's tiles
        stage_bc(k0, q0);
        __syncthreads();
      }
      // scores = (C B^T) o decay, lower triangle only
      {
        float acc[LR][LR];
#pragma unroll
        for (int i = 0; i < LR; ++i)
#pragma unroll
          for (int j = 0; j < LR; ++j) acc[i][j] = 0.0f;
        for (int n = 0; n < N; ++n) {
          float ca[LR], bb[LR];
#pragma unroll
          for (int i = 0; i < LR; ++i) ca[i] = sCX[(ty + 16 * i) * lay.bs + n];
#pragma unroll
          for (int j = 0; j < LR; ++j) bb[j] = sB[(tx + 16 * j) * lay.bs + n];
#pragma unroll
          for (int i = 0; i < LR; ++i)
#pragma unroll
            for (int j = 0; j < LR; ++j)
              acc[i][j] = fmaf(ca[i], bb[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < LR; ++i) {
          const int r = q0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < LR; ++j) {
            const int q = k0 + tx + 16 * j;
            sS[(ty + 16 * i) * lay.ss + tx + 16 * j] =
                (q <= r && r < L) ? acc[i][j] * expf(cs[r] - cs[q]) : 0.0f;
          }
        }
      }
      __syncthreads();
      // C is no longer needed: its space takes dt * x of the key block
      stage_dtx(k0);
      __syncthreads();
      const int kn = min(lt, L - k0);
      for (int k = 0; k < kn; ++k) {
        float sa[LR];
#pragma unroll
        for (int i = 0; i < LR; ++i) sa[i] = sS[(ty + 16 * i) * lay.ss + k];
#pragma unroll
        for (int j = 0; j < kMaxPR; ++j) {
          const int p = tx + 16 * j;
          if (j < pr && p < P) {
            const float xb = sCX[k * lay.xs + p];
#pragma unroll
            for (int i = 0; i < LR; ++i) ya[i][j] = fmaf(sa[i], xb, ya[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < LR; ++i) {
      const int r = q0 + ty + 16 * i;
      if (r >= L) continue;
#pragma unroll
      for (int j = 0; j < kMaxPR; ++j) {
        const int p = tx + 16 * j;
        if (j < pr && p < P)
          ripple::store_f(y + ((row0 + r) * d.H + h) * P + p, ya[i][j]);
      }
    }
  }

  // s_chunk[p][n] = sum_j exp(cs_{L-1} - cs_j) (dt x)[j][p] B[j][n], the
  // last block first: its B and dt x are still staged
  {
    const int nr = (N + 15) / 16;
    float acc[kMaxPR][kMaxNR];
#pragma unroll
    for (int i = 0; i < kMaxPR; ++i)
#pragma unroll
      for (int j = 0; j < kMaxNR; ++j) acc[i][j] = 0.0f;
    for (int kb = nb - 1; kb >= 0; --kb) {
      const int k0 = kb * lt;
      if (kb < nb - 1) {
        __syncthreads();
        stage_bc(k0, -1);
        stage_dtx(k0);
        __syncthreads();
      }
      const int kn = min(lt, L - k0);
      for (int k = 0; k < kn; ++k) {
        const float dk = dec[k0 + k];
        float wa[kMaxPR], bb[kMaxNR];
#pragma unroll
        for (int i = 0; i < kMaxPR; ++i) {
          const int p = ty + 16 * i;
          wa[i] = (i < pr && p < P) ? sCX[k * lay.xs + p] * dk : 0.0f;
        }
#pragma unroll
        for (int j = 0; j < kMaxNR; ++j) {
          const int n = tx + 16 * j;
          bb[j] = (j < nr && n < N) ? sB[k * lay.bs + n] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < kMaxPR; ++i)
#pragma unroll
          for (int j = 0; j < kMaxNR; ++j)
            acc[i][j] = fmaf(wa[i], bb[j], acc[i][j]);
      }
    }
    float* so = s_out + ((static_cast<int64_t>(b) * d.nc + c) * d.H + h) *
                            static_cast<int64_t>(P) * N;
#pragma unroll
    for (int i = 0; i < kMaxPR; ++i) {
      const int p = ty + 16 * i;
      if (i >= pr || p >= P) continue;
#pragma unroll
      for (int j = 0; j < kMaxNR; ++j) {
        const int n = tx + 16 * j;
        if (j < nr && n < N) so[p * N + n] = acc[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 route: wgmma on the tensor cores
// ---------------------------------------------------------------------------

using namespace ripple::hopper;
using bf16 = __nv_bfloat16;

constexpr int kLT = 128;  // chunk rows per tile: two warpgroups of 64
constexpr int kSlab = kLT * kRowBytes;  // one 64-column slab of a tile
constexpr float kLog2e = 1.4426950408889634f;

// NS: 64-column slabs of the B and C tiles (N <= 64 NS); QT: 128-row tiles
// a chunk (L <= 128 QT).  A tile of QT * 128 rows is staged as slabs of
// QT * 128 swizzled rows.
template <int NS, int QT>
struct WgmmaSmem {
  static constexpr int kSlabQ = QT * kSlab;
  static constexpr int kC = 0;
  static constexpr int kB = NS * kSlabQ;
  static constexpr int kX = 2 * NS * kSlabQ;
  static constexpr int kCs = kX + kSlabQ;  // float32 cs, dt, w, warp totals
  static constexpr int kDt = kCs + 4 * kLT * QT;
  static constexpr int kW = kDt + 4 * kLT * QT;
  static constexpr int kTot = kW + 4 * kLT * QT;
  // 1024 bytes to align the base to the swizzle pattern's repeat
  static constexpr int kBytes = kTot + 16 * QT + 1024;
};

// exp(d) as exp2(d log2 e): a few float32 ulps from expf, and shorter (the
// scores' limit is 2^-6 relative)
__device__ __forceinline__ float decay(float d) { return exp2f(kLog2e * d); }

// x[j][p] of the staged x tile (one slab, row j, 128-byte swizzle)
__device__ __forceinline__ float x_at(const uint8_t* sx, int j, int p) {
  return __bfloat162float(*reinterpret_cast<const bf16*>(
      sx + j * kRowBytes + ((((p >> 3) ^ (j & 7))) << 4) + (p & 7) * 2));
}

// Splits (a0, a1) into bf16 pairs hi = bf16(a) and lo = bf16(a - hi).
__device__ __forceinline__ void split2(float a0, float a1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a0, a1);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(a0 - hf.x, a1 - hf.y));
}

// y += S' x for the 64 chunk rows from q0 (a warpgroup's), against the key
// positions key0 .. key0 + 64 NJ - 1: S = C B^T, S' on the fragments, then
// S'_hi x + S'_lo x.  FIRST zeroes y first, right before its product, so
// that y is not live across S.
template <int NJ, int NS, int QT, bool FIRST>
__device__ __forceinline__ void ssd_y_tile(uint32_t sC, uint32_t sB,
                                           uint32_t sX, const float* cs,
                                           const float* dtv, int q0,
                                           int key0, int L,
                                           float (&ya)[32]) {
  constexpr int kSlabQ = QT * kSlab;
  const int lane = threadIdx.x & 31;
  const int r0 = q0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
  float acc[NJ][32];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.0f;
    fence_acc(acc[j]);
  }
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4 * NS; ++ks) {
    const uint32_t col = (ks & 3) * 32;  // 16 bf16 within the slab
    const uint64_t da = wgmma_desc(
        sC + (ks >> 2) * kSlabQ + q0 * kRowBytes + col, 16, 8 * kRowBytes);
    const uint64_t db = wgmma_desc(
        sB + (ks >> 2) * kSlabQ + key0 * kRowBytes + col, 16, 8 * kRowBytes);
    if constexpr (NJ == 1) {
      wgmma_ss(acc[0], da, db, ks > 0);
    } else {
      wgmma_ss2(acc[0], acc[1], da, db, ks > 0);
    }
  }
  wgmma_commit();
  wgmma_wait();
#pragma unroll
  for (int j = 0; j < NJ; ++j) fence_acc(acc[j]);

  // S'_ij = S_ij exp(cs_i - cs_j) dt_j where j <= i < L, else 0, split into
  // the A fragments of 16 columns each
  const float cs_r[2] = {cs[r0], cs[r0 + 8]};
  uint32_t hi[4 * NJ][4], lo[4 * NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int rr = (i >> 1) & 1, r = r0 + 8 * rr;
      const int q = key0 + j * 64 + 8 * (i >> 2) + 2 * (lane & 3);
      const float s0 = (q <= r && r < L)
                           ? acc[j][i] * decay(cs_r[rr] - cs[q]) * dtv[q]
                           : 0.0f;
      const float s1 =
          (q + 1 <= r && r < L)
              ? acc[j][i + 1] * decay(cs_r[rr] - cs[q + 1]) * dtv[q + 1]
              : 0.0f;
      split2(s0, s1, hi[4 * j + (i >> 3)][(i >> 1) & 3],
             lo[4 * j + (i >> 3)][(i >> 1) & 3]);
    }

  if constexpr (FIRST) {
#pragma unroll
    for (int i = 0; i < 32; ++i) ya[i] = 0.0f;
  }
  fence_acc(ya);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * NJ; ++kk) {
    const uint64_t dx = wgmma_desc(sX + (key0 + kk * 16) * kRowBytes, kSlabQ,
                                   8 * kRowBytes);
    wgmma_rs(ya, hi[kk], dx);
    wgmma_rs(ya, lo[kk], dx);
  }
  wgmma_commit();
  wgmma_wait();
  fence_acc(ya);
}

// y_intra rows q0 .. q0 + 63 of the chunk from the accumulator fragments
__device__ __forceinline__ void ssd_y_store(const float (&ya)[32], int q0,
                                            int L, int P, bf16* y,
                                            int64_t row0, int H, int h) {
  const int lane = threadIdx.x & 31;
  const int r0 = q0 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2);
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = r0 + 8 * ((i >> 1) & 1);
    const int p = 8 * (i >> 2) + 2 * (lane & 3);
    if (r < L && p < P)
      *reinterpret_cast<__nv_bfloat162*>(y + ((row0 + r) * H + h) * P + p) =
          __floats2bfloat162_rn(ya[i], ya[i + 1]);
  }
}

template <int NS, int QT>
__global__ void __launch_bounds__(kThreads, QT == 1 ? 2 : 1)
    ssd_wgmma_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const bf16* __restrict__ Bm,
                     const bf16* __restrict__ C, bf16* __restrict__ y,
                     float* __restrict__ s_out, Dims d) {
  using S = WgmmaSmem<NS, QT>;
  constexpr int kRows = kLT * QT;  // positions staged
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);
  float* cs = reinterpret_cast<float*>(gbase + S::kCs);
  float* dtv = reinterpret_cast<float*>(gbase + S::kDt);
  float* wv = reinterpret_cast<float*>(gbase + S::kW);
  float* tot = reinterpret_cast<float*>(gbase + S::kTot);

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int L = d.L, P = d.P, N = d.N, H = d.H;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t row0 = static_cast<int64_t>(b) * d.S +
                       static_cast<int64_t>(c) * L;

  load_tile<kRows, 64 * NS, kThreads>(base + S::kC, C + row0 * N, N, L, N);
  load_tile<kRows, 64 * NS, kThreads>(base + S::kB, Bm + row0 * N, N, L, N);
  load_tile<kRows, 64, kThreads>(base + S::kX, x + (row0 * H + h) * P,
                                 static_cast<int64_t>(H) * P, L, P);
  cp_async_commit();

  // cs = inclusive cumsum of dt * A: each warp scans 32 positions, then
  // adds the totals of the warps before it
  if (t < kRows) {
    const float dtt = t < L ? dt[(row0 + t) * H + h] : 0.0f;
    float v = dtt * A[h];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += up;
    }
    dtv[t] = dtt;
    cs[t] = v;
    if (lane == 31) tot[warp] = v;
  }
  __syncthreads();
  if (t < kRows) {
    float before = 0.0f;
    for (int w = 0; w < warp; ++w) before += tot[w];
    cs[t] += before;
  }
  __syncthreads();
  // w_j = dt_j exp(cs_{L-1} - cs_j), the chunk state's weights
  if (t < kRows) wv[t] = t < L ? dtv[t] * expf(cs[L - 1] - cs[t]) : 0.0f;
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  // y_intra: warpgroup wg takes rows 64 wg .. of each 128-row query tile,
  // against the key tiles before it in full and its own up to the diagonal
  // (64 positions for warpgroup 0, 128 for warpgroup 1)
  const int wg = t >> 7;
  const uint32_t sC = base + S::kC, sB = base + S::kB, sX = base + S::kX;
#pragma unroll
  for (int qt = 0; qt < QT; ++qt) {
    const int q0 = qt * kLT + wg * 64;
    if (q0 >= L) continue;
    float ya[32];
    if (qt == 0) {
      if (wg == 0)
        ssd_y_tile<1, NS, QT, true>(sC, sB, sX, cs, dtv, q0, 0, L, ya);
      else
        ssd_y_tile<2, NS, QT, true>(sC, sB, sX, cs, dtv, q0, 0, L, ya);
    } else {
      ssd_y_tile<2, NS, QT, true>(sC, sB, sX, cs, dtv, q0, 0, L, ya);
      if (wg == 0)
        ssd_y_tile<1, NS, QT, false>(sC, sB, sX, cs, dtv, q0, kLT, L, ya);
      else
        ssd_y_tile<2, NS, QT, false>(sC, sB, sX, cs, dtv, q0, kLT, L, ya);
    }
    ssd_y_store(ya, q0, L, P, y, row0, H, h);
  }

  // s_chunk = (w x)^T B: warpgroup wg takes the 64 columns of slab wg of B;
  // A[p][j] = x[j][p] w_j in registers, issued as two bf16 pieces, a
  // 128-position key tile at a time
  if (wg < NS) {
    const uint8_t* sx = gbase + S::kX;
    const int p0 = ((t >> 5) & 3) * 16 + (lane >> 2);
    float sa[32];
#pragma unroll
    for (int kt = 0; kt < QT; ++kt) {
      const int k0 = kt * kLT;
      if (kt > 0 && k0 >= L) continue;
      uint32_t ah[8][4], al[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int reg = 0; reg < 4; ++reg) {
          const int p = p0 + 8 * (reg & 1);
          const int j = k0 + kk * 16 + 2 * (lane & 3) + 8 * (reg >> 1);
          split2(x_at(sx, j, p) * wv[j], x_at(sx, j + 1, p) * wv[j + 1],
                 ah[kk][reg], al[kk][reg]);
        }
      const int nk = (L - k0 + 15) / 16;
      if (kt == 0) {
#pragma unroll
        for (int i = 0; i < 32; ++i) sa[i] = 0.0f;
      }
      fence_acc(sa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk < nk) {
          const uint64_t db = wgmma_desc(
              sB + wg * S::kSlabQ + (k0 + kk * 16) * kRowBytes, S::kSlabQ,
              8 * kRowBytes);
          wgmma_rs(sa, ah[kk], db);
          wgmma_rs(sa, al[kk], db);
        }
      }
      wgmma_commit();
      wgmma_wait();
      fence_acc(sa);
    }
    float* so = s_out + ((static_cast<int64_t>(b) * d.nc + c) * H + h) *
                            static_cast<int64_t>(P) * N;
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int p = p0 + 8 * ((i >> 1) & 1);
      const int n = wg * 64 + 8 * (i >> 2) + 2 * (lane & 3);
      if (p < P && n < N)
        *reinterpret_cast<float2*>(so + p * N + n) =
            make_float2(sa[i], sa[i + 1]);
    }
  }
}

template <int NS, int QT>
int launch_wgmma(const bf16* x, const float* dt, const float* A,
                 const bf16* Bm, const bf16* C, bf16* y, float* s, int batch,
                 const Dims& d, cudaStream_t stream) {
  constexpr int smem = WgmmaSmem<NS, QT>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_wgmma_kernel<NS, QT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(d.H, d.nc, batch);
  ssd_wgmma_kernel<NS, QT><<<grid, kThreads, smem, stream>>>(
      x, dt, A, Bm, C, y, s, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int LR, int NB>
int launch_lr(const T* x, const float* dt, const float* A, const T* Bm,
              const T* C, T* y, float* s, int batch, const Dims& d,
              cudaStream_t stream) {
  const size_t smem = smem_layout(LR, NB, d.P, d.N).total;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_kernel<T, LR, NB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(d.H, d.nc, batch);
  ssd_chunk_kernel<T, LR, NB><<<grid, kThreads, smem, stream>>>(
      x, dt, A, Bm, C, y, s, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ssd(const void* x, const void* dt, const void* A, const void* Bm,
               const void* C, void* y, void* s, int batch, int S, int H,
               int P, int N, int L, void* stream) {
  if (batch < 1 || H < 1 || L < 1 || L > kMaxL || S % L || P < 1 ||
      P > 16 * kMaxPR || N < 1 || N > 16 * kMaxNR || batch > 65535 ||
      S / L > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Dims d{S, H, P, N, L, S / L};
  const auto x_ = static_cast<const T*>(x);
  const auto dt_ = static_cast<const float*>(dt);
  const auto A_ = static_cast<const float*>(A);
  const auto B_ = static_cast<const T*>(Bm);
  const auto C_ = static_cast<const T*>(C);
  const auto y_ = static_cast<T*>(y);
  const auto s_ = static_cast<float*>(s);
  const auto st = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same_v<T, bf16>) {
    bool aligned = P % 8 == 0 && N % 8 == 0;
    for (const void* ptr : {x, Bm, C})
      aligned = aligned && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
    if (!aligned) return static_cast<int>(cudaErrorInvalidValue);
    if (L > kLT)
      return N <= 64
                 ? launch_wgmma<1, 2>(x_, dt_, A_, B_, C_, y_, s_, batch, d, st)
                 : launch_wgmma<2, 2>(x_, dt_, A_, B_, C_, y_, s_, batch, d, st);
    if (N <= 64)
      return launch_wgmma<1, 1>(x_, dt_, A_, B_, C_, y_, s_, batch, d, st);
    return launch_wgmma<2, 1>(x_, dt_, A_, B_, C_, y_, s_, batch, d, st);
  }
  if (L <= 16) return launch_lr<T, 1, 1>(x_, dt_, A_, B_, C_, y_, s_, batch, d, st);
  if (L <= 32) return launch_lr<T, 2, 1>(x_, dt_, A_, B_, C_, y_, s_, batch, d, st);
  if (L <= 64) return launch_lr<T, 4, 1>(x_, dt_, A_, B_, C_, y_, s_, batch, d, st);
  if (L <= 128) return launch_lr<T, 8, 1>(x_, dt_, A_, B_, C_, y_, s_, batch, d, st);
  return launch_lr<T, 8, 2>(x_, dt_, A_, B_, C_, y_, s_, batch, d, st);
}

}  // namespace

extern "C" int ssd_intra_chunk_f32(const void* x, const void* dt,
                                   const void* A, const void* Bm,
                                   const void* C, void* y, void* s, int batch,
                                   int S, int H, int P, int N, int L,
                                   void* stream) {
  return launch_ssd<float>(x, dt, A, Bm, C, y, s, batch, S, H, P, N, L,
                           stream);
}

extern "C" int ssd_intra_chunk_bf16(const void* x, const void* dt,
                                    const void* A, const void* Bm,
                                    const void* C, void* y, void* s,
                                    int batch, int S, int H, int P, int N,
                                    int L, void* stream) {
  return launch_ssd<bf16>(x, dt, A, Bm, C, y, s, batch, S, H, P, N, L,
                          stream);
}

RIPPLE_ERROR_STRING_FN
