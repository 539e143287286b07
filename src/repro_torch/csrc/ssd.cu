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
// Bound on the card: operations.  Per block 2 L^2 N + 2 L^2 P + 2 L P N
// operations (4.2 M at L = P * 2 = N = 128) against ~50 KB of bf16 tiles:
// about 80 operations per byte, above the float32 ridge of ~20.  This first
// version runs on the float32 CUDA cores; the three products are
// tensor-core shaped (L, N, P multiples of 16) and go to wgmma later.
//
// Design: one 256-thread block per (head, chunk, batch).  The B tile, the C
// tile (overwritten by dt * x once C B^T is formed) and the L x L score tile
// sit in dynamic shared memory in float32 (199 KB at L = N = 128, P = 64),
// rows padded by one float so that 16 threads reading 16 rows hit 16 banks.
// The cumulative sum is a warp scan: each lane sums L/32 consecutive
// positions, then the lane totals are scanned with shuffles.  Each of the
// 16 x 16 threads owns rows ty + 16 i and columns tx + 16 j of every
// product.  The decay is formed only where j <= i (above the diagonal
// cs_i - cs_j > 0 could overflow exp to inf, and inf * 0 is NaN), and is
// exactly 0 elsewhere.  Every head recomputes C B^T, as the TPU kernel does,
// although n_groups = 1 makes it the same for all heads of a chunk.  Chunks
// of up to 128 positions, P <= 64 and N <= 128 are taken; the ragged L (a
// prompt shorter than the model's chunk) is masked in the tiles.
#include <cuda_runtime.h>

#include <cstdint>

#include "record_index.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxPR = 4;      // P <= 64
constexpr int kMaxNR = 8;      // N <= 128

struct Dims {
  int S, H, P, N, L, nc;
};

// float offsets of the shared-memory regions for a chunk of LR * 16 rows
struct Smem {
  int bs, xs, ss, lt;  // row strides of B / C, of dt * x, of scores; rows
  size_t b, cx, s, cs, dtv, total;
};

__host__ __device__ inline Smem smem_layout(int LR, int P, int N) {
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
  m.dtv = m.cs + m.lt;
  m.total = (m.dtv + m.lt) * sizeof(float);
  return m;
}

template <typename T, int LR>
__global__ void __launch_bounds__(kThreads)
    ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const T* __restrict__ Bm,
                     const T* __restrict__ C, T* __restrict__ y,
                     float* __restrict__ s_out, Dims d) {
  extern __shared__ float smem[];
  const Smem lay = smem_layout(LR, d.P, d.N);
  float* sB = smem + lay.b;
  float* sCX = smem + lay.cx;
  float* sS = smem + lay.s;
  float* cs = smem + lay.cs;
  float* dtv = smem + lay.dtv;

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int L = d.L, P = d.P, N = d.N;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row0 = static_cast<int64_t>(b) * d.S + static_cast<int64_t>(c) * L;

  // dt, and B and C tiles (rows past L zero)
  for (int i = threadIdx.x; i < lay.lt; i += kThreads)
    dtv[i] = i < L ? dt[(row0 + i) * d.H + h] : 0.0f;
  for (int i = warp; i < lay.lt; i += kThreads / 32) {
    for (int n = lane; n < N; n += 32) {
      const bool in = i < L;
      sB[i * lay.bs + n] = in ? ripple::load_f(Bm + (row0 + i) * N + n) : 0.0f;
      sCX[i * lay.bs + n] = in ? ripple::load_f(C + (row0 + i) * N + n) : 0.0f;
    }
  }
  __syncthreads();

  // cs = inclusive cumsum of dt * A over the L positions: warp 0 scans
  if (warp == 0) {
    const float a = A[h];
    const int per = (lay.lt + 31) / 32;
    const int start = lane * per;
    float run = 0.0f;
    for (int e = start; e < start + per && e < lay.lt; ++e) {
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
    for (int e = start; e < start + per && e < lay.lt; ++e) cs[e] += before;
  }
  __syncthreads();

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
        for (int j = 0; j < LR; ++j) acc[i][j] = fmaf(ca[i], bb[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < LR; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < LR; ++j) {
        const int q = tx + 16 * j;
        sS[r * lay.ss + q] =
            (q <= r && r < L) ? acc[i][j] * expf(cs[r] - cs[q]) : 0.0f;
      }
    }
  }
  __syncthreads();

  // C is no longer needed: its space takes dt * x (rows past L zero)
  for (int i = warp; i < lay.lt; i += kThreads / 32) {
    for (int p = lane; p < P; p += 32) {
      sCX[i * lay.xs + p] =
          i < L ? dtv[i] * ripple::load_f(x + ((row0 + i) * d.H + h) * P + p)
                : 0.0f;
    }
  }
  __syncthreads();
  // dtv now holds the decay to the chunk's end, exp(cs_{L-1} - cs_j)
  for (int i = threadIdx.x; i < lay.lt; i += kThreads)
    dtv[i] = i < L ? expf(cs[L - 1] - cs[i]) : 0.0f;

  // y_intra = scores (dt x)
  {
    const int pr = (P + 15) / 16;
    float acc[LR][kMaxPR];
#pragma unroll
    for (int i = 0; i < LR; ++i)
#pragma unroll
      for (int j = 0; j < kMaxPR; ++j) acc[i][j] = 0.0f;
    for (int k = 0; k < L; ++k) {
      float sa[LR];
#pragma unroll
      for (int i = 0; i < LR; ++i) sa[i] = sS[(ty + 16 * i) * lay.ss + k];
#pragma unroll
      for (int j = 0; j < kMaxPR; ++j) {
        const int p = tx + 16 * j;
        if (j < pr && p < P) {
          const float xb = sCX[k * lay.xs + p];
#pragma unroll
          for (int i = 0; i < LR; ++i) acc[i][j] = fmaf(sa[i], xb, acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < LR; ++i) {
      const int r = ty + 16 * i;
      if (r >= L) continue;
#pragma unroll
      for (int j = 0; j < kMaxPR; ++j) {
        const int p = tx + 16 * j;
        if (j < pr && p < P)
          ripple::store_f(y + ((row0 + r) * d.H + h) * P + p, acc[i][j]);
      }
    }
  }
  __syncthreads();  // dtv holds the decay to the end for every thread

  // s_chunk[p][n] = sum_j exp(cs_{L-1} - cs_j) (dt x)[j][p] B[j][n]
  {
    const int pr = (P + 15) / 16, nr = (N + 15) / 16;
    float acc[kMaxPR][kMaxNR];
#pragma unroll
    for (int i = 0; i < kMaxPR; ++i)
#pragma unroll
      for (int j = 0; j < kMaxNR; ++j) acc[i][j] = 0.0f;
    for (int k = 0; k < L; ++k) {
      const float dk = dtv[k];
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
        for (int j = 0; j < kMaxNR; ++j) acc[i][j] = fmaf(wa[i], bb[j], acc[i][j]);
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

template <typename T, int LR>
int launch_lr(const T* x, const float* dt, const float* A, const T* Bm,
              const T* C, T* y, float* s, int batch, const Dims& d,
              cudaStream_t stream) {
  const size_t smem = smem_layout(LR, d.P, d.N).total;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ssd_chunk_kernel<T, LR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid(d.H, d.nc, batch);
  ssd_chunk_kernel<T, LR><<<grid, kThreads, smem, stream>>>(x, dt, A, Bm, C,
                                                            y, s, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ssd(const void* x, const void* dt, const void* A, const void* Bm,
               const void* C, void* y, void* s, int batch, int S, int H,
               int P, int N, int L, void* stream) {
  if (batch < 1 || H < 1 || L < 1 || L > 128 || S % L || P < 1 ||
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
  if (L <= 16) return launch_lr<T, 1>(x_, dt_, A_, B_, C_, y_, s_, batch, d, st);
  if (L <= 32) return launch_lr<T, 2>(x_, dt_, A_, B_, C_, y_, s_, batch, d, st);
  if (L <= 64) return launch_lr<T, 4>(x_, dt_, A_, B_, C_, y_, s_, batch, d, st);
  return launch_lr<T, 8>(x_, dt_, A_, B_, C_, y_, s_, batch, d, st);
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
  return launch_ssd<__nv_bfloat16>(x, dt, A, Bm, C, y, s, batch, S, H, P, N,
                                   L, stream);
}

RIPPLE_ERROR_STRING_FN
