// Flash-attention forward for Hopper: K6.
//
// Replaces flash_attention_pallas (src/repro/kernels/attention/kernel.py:132):
// out = softmax(q k^T * scale + mask) v per (batch, query head), with online
// softmax and float32 accumulation.  q is (B, Hq, Sq, D); k and v are
// (B, Hkv, Skv, D) each, given by element strides so that the model's
// (B, S, H, D) tensors and the fused AoS cache (B, Hkv, Skv, 2, D) need no
// copy (the last dim must be contiguous).  GQA maps query head h to KV head
// h / (Hq / Hkv).  Masks: causal with a query offset (visible where
// q_pos >= k_pos, q_pos = q_offset + row) and a sliding window (visible where
// k_pos > q_pos - window); the KV block loop is clipped to the visible band.
// In both routes a masked score gets probability exactly 0 and never enters
// exp, so a fully masked tile leaves m, l and the accumulator unchanged;
// query rows past the ragged end of Sq are computed on zeros and not
// stored, keys past the end of Skv are masked.  The output is rounded once.
//
// Bound on the card: operations.  About 4 * Sq * Skv * D operations per head
// (half under the causal mask) against 2 * D * (Sq + 2 Skv) bytes of bf16:
// at the qwen3 prefill shape some 800 operations per byte, far above the
// ridge, so the bf16 route belongs on the tensor cores (989 TFLOP/s).
//
// bf16 route (attn_wgmma_kernel): wgmma on sm_90a.  One 256-thread block per
// 128 query rows of one head, as two warpgroups of 64 rows; the q tiles run
// longest first (the last causal tile is launched first).  Shared memory holds
// the q tile, loaded once, and a two-stage ring of 64-key K and V tiles filled
// by 16-byte cp.async copies (zero-filled past the ragged ends and past D), all
// in the 128-byte-swizzled layout the wgmma descriptors read: each 64-column
// slab is rows of 128 bytes whose 16-byte chunk c sits at c ^ (row % 8).
// S = Q K^T is m64n64k16 with both operands in shared memory (K stored keys x
// D, D contiguous: the K-major B operand).  The online softmax runs on the
// accumulator fragments in registers: rows reduced over the four lanes that
// share them, the mask tested only on tiles that cut the band, scale * log2 e
// folded into one FMA before the special-function unit's ex2, and a tile
// masked for all 64 rows of a warpgroup skipped.  O += P V takes P
// as the register A operand, converted in place from the accumulator layout,
// with V as the B operand read transposed (V is keys x D with D contiguous),
// 128 columns of D per m64n128k16.  P is issued twice into the one float32 O
// accumulator, as P_hi = bf16(P) and P_lo = bf16(P - P_hi), while l sums the
// float32 P: P rounded once to bf16 puts some 5 % of the outputs at the qwen3
// shape outside the limit held against the float32 plain version (atol 1e-5,
// rtol 2^-6), the split puts none (one output ulp at most), at 1.5x the
// tensor-core work of the usual design.  The softmax's instructions, not the
// tensor cores, set the pace: 128 registers a thread for two blocks per SM
// leave no room to overlap one tile's softmax with the next tile's products
// inside a warpgroup.  Shared memory: 96 KB at D = 128 (two blocks per SM),
// 192 KB at D = 256.  It needs 16-byte-aligned base pointers, and (b, h, s)
// strides and D that are multiples of 8 elements.
//
// float32 route (attn_f32_kernel): the float32 CUDA cores (67 TFLOP/s).
// TF32 tensor cores would round the inputs to 10 mantissa bits, outside the
// float32 limit of 1e-5, and no served model runs attention in float32.
// One 256-thread block per (64-row q tile, head, batch); the q tile, one
// 64-row K tile, one V tile (K and q rows padded to D + 1 so that 16
// threads reading 16 rows hit 16 banks) and the 64 x 64 probability tile
// sit in dynamic shared memory (115 KB at D = 128, 214 KB at D = 256).  The
// 16 x 16 threads each own 4 score rows (ty + 16 i) by 4 columns (tx + 16 j)
// and the same 4 output rows by D / 16 columns, so the running max, sum and
// rescale of a row stay in the registers of the 16 threads that share it,
// reduced with warp shuffles.
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "hopper.cuh"
#include "record_index.cuh"

namespace {

using namespace ripple::hopper;

constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t sqb, sqh, sqs, skb, skh, sks, svb, svh, svs, sob, soh, sos;
  int hq, hkv, sq, skv, d, q_offset, window, causal;
  float scale;
};

// First and one-past-last KV block (of bk keys) holding a visible key for
// some query row in [q0, q0 + bq).
__device__ __forceinline__ int2 kv_band(const Params& p, int q0, int bq,
                                        int bk) {
  const int pos_first = p.q_offset + q0;
  const int pos_last = p.q_offset + min(q0 + bq, p.sq) - 1;
  int hi = (p.skv + bk - 1) / bk;
  if (p.causal) hi = pos_last < 0 ? 0 : min(hi, pos_last / bk + 1);
  int lo = 0;
  if (p.window > 0) {
    const int first_visible = pos_first - p.window + 1;
    lo = first_visible > 0 ? first_visible / bk : 0;
  }
  return make_int2(lo, hi);
}

__device__ __forceinline__ bool visible(const Params& p, int qpos, int kpos) {
  return kpos < p.skv && (!p.causal || qpos >= kpos) &&
         (p.window <= 0 || kpos > qpos - p.window);
}

// ---------------------------------------------------------------------------
// float32 route: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = kBQ / 16;
constexpr int kCols = kBK / 16;
constexpr int kPS = kBK + 1;   // probability tile row stride

template <int NJ>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) *
         (2 * kBQ * (16 * NJ + 1) + kBK * 16 * NJ + kBQ * kPS);
}

template <int NJ>
__global__ void __launch_bounds__(kThreads) attn_f32_kernel(Params p) {
  constexpr int DP = 16 * NJ;  // head dim padded to the thread grid
  constexpr int QS = DP + 1;   // q and k tile row stride
  extern __shared__ float smem[];
  float* sq = smem;
  float* sk = sq + kBQ * QS;
  float* sv = sk + kBK * QS;
  float* sp = sv + kBK * DP;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.hq / p.hkv);
  const float* q = static_cast<const float*>(p.q) + b * p.sqb + h * p.sqh;
  const float* k = static_cast<const float*>(p.k) + b * p.skb + hk * p.skh;
  const float* v = static_cast<const float*>(p.v) + b * p.svb + hk * p.svh;
  float* o = static_cast<float*>(p.o) + b * p.sob + h * p.soh;

  for (int idx = threadIdx.x; idx < kBQ * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    sq[r * QS + c] = (q0 + r < p.sq && c < p.d) ? q[(q0 + r) * p.sqs + c]
                                                : 0.0f;
  }
  const int2 band = kv_band(p, q0, kBQ, kBK);

  int qpos[kRows];
  float m[kRows], l[kRows], acc[kRows][NJ];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    qpos[i] = p.q_offset + q0 + ty + 16 * i;
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;
  }

  for (int kb = band.x; kb < band.y; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = threadIdx.x; idx < kBK * DP; idx += kThreads) {
      const int r = idx / DP, c = idx % DP;
      const bool in = k0 + r < p.skv && c < p.d;
      sk[r * QS + c] = in ? k[(k0 + r) * p.sks + c] : 0.0f;
      sv[r * DP + c] = in ? v[(k0 + r) * p.svs + c] : 0.0f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.0f;
    for (int c = 0; c < DP; ++c) {
      float qa[kRows], ka[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qa[i] = sq[(ty + 16 * i) * QS + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) ka[j] = sk[(tx + 16 * j) * QS + c];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      bool ok[kCols];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        ok[j] = visible(p, qpos[i], k0 + tx + 16 * j);
        s[i][j] *= p.scale;
        if (ok[j]) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float pr = ok[j] ? expf(s[i][j] - m_new) : 0.0f;
        sum += pr;
        sp[(ty + 16 * i) * kPS + tx + 16 * j] = pr;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      m[i] = m_new;
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    for (int kk = 0; kk < kBK; ++kk) {
      float pa[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pa[i] = sp[(ty + 16 * i) * kPS + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float vb = sv[kk * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][j] = fmaf(pa[i], vb, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= p.sq) continue;
    const float den = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = tx + 16 * j;
      if (c < p.d) o[r * p.sos + c] = acc[i][j] / den;
    }
  }
}

template <int NJ>
int launch_f32(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = f32_smem_bytes<NJ>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_f32_kernel<NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((p.sq + kBQ - 1) / kBQ, p.hq, batch);
  attn_f32_kernel<NJ><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 route: wgmma on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kWQ = 128;      // query rows per block: two warpgroups of 64
constexpr int kWK = 64;       // keys per KV tile
constexpr int kWThreads = 256;

// 2^x on the special-function unit (relative error ~2^-22; 0 below 2^-126)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DP>
struct WgmmaSmem {
  static constexpr int kQ = kWQ * DP * 2;     // the q tile
  static constexpr int kTile = kWK * DP * 2;  // one K or V tile
  // q, then (K, V) per stage of the ring; 1024 bytes to align the base to
  // the swizzle pattern's repeat
  static constexpr int kBytes = kQ + 4 * kTile + 1024;
};

template <int DP>
__global__ void __launch_bounds__(kWThreads, DP <= 128 ? 2 : 1)
    attn_wgmma_kernel(Params p) {
  using S = WgmmaSmem<DP>;
  constexpr int NS = DP / 64;  // 64-column slabs
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sq_tile = base;
  const uint32_t skv = base + S::kQ;  // stage st: K at + 2 st kTile, V after

  const int q0 = (gridDim.z - 1 - blockIdx.z) * kWQ;  // longest tiles first
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (p.hq / p.hkv);
  const auto* q = static_cast<const __nv_bfloat16*>(p.q) + b * p.sqb +
                  h * p.sqh;
  const auto* k = static_cast<const __nv_bfloat16*>(p.k) + b * p.skb +
                  hk * p.skh;
  const auto* v = static_cast<const __nv_bfloat16*>(p.v) + b * p.svb +
                  hk * p.svh;
  auto* o = static_cast<__nv_bfloat16*>(p.o) + b * p.sob + h * p.soh;

  const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  // this thread's two rows of the block's tile (accumulator layout)
  const int row0 = wg * 64 + warp * 16 + (lane >> 2);
  const int qpos0 = p.q_offset + q0 + row0;
  // the warpgroup's query positions, for tiles it sees whole
  const int wg_first = p.q_offset + q0 + wg * 64;
  const int wg_last = wg_first + 63;
  const float sl2 = p.scale * 1.4426950408889634f;
  // a warpgroup whose rows all lie past Sq only helps load
  const bool idle = q0 + wg * 64 >= p.sq;

  const int2 band = kv_band(p, q0, kWQ, kWK);
  const int nkb = band.y - band.x;

  load_tile<kWQ, DP, kWThreads>(sq_tile, q + q0 * p.sqs, p.sqs, p.sq - q0,
                                p.d);
  if (nkb > 0) {
    const int k0 = band.x * kWK;
    load_tile<kWK, DP, kWThreads>(skv, k + k0 * p.sks, p.sks, p.skv - k0,
                                  p.d);
    load_tile<kWK, DP, kWThreads>(skv + S::kTile, v + k0 * p.svs, p.svs,
                                  p.skv - k0, p.d);
  }
  cp_async_commit();

  float acc[NS][32];
  float s[32];
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[j][i] = 0.0f;

  for (int it = 0; it < nkb; ++it) {
    const int k0 = (band.x + it) * kWK;
    const uint32_t sk = skv + (it & 1) * 2 * S::kTile;
    const uint32_t sv = sk + S::kTile;
    if (it + 1 < nkb) {  // prefetch the next tile into the other stage
      const uint32_t nk = skv + ((it + 1) & 1) * 2 * S::kTile;
      const int k1 = k0 + kWK;
      load_tile<kWK, DP, kWThreads>(nk, k + k1 * p.sks, p.sks, p.skv - k1,
                                    p.d);
      load_tile<kWK, DP, kWThreads>(nk + S::kTile, v + k1 * p.svs, p.svs,
                                    p.skv - k1, p.d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();

    // a tile masked for every row of the warpgroup would change nothing
    const bool hidden = (p.causal && k0 > wg_last) ||
                        (p.window > 0 && k0 + kWK - 1 <= wg_first - p.window);
    if (!idle && !hidden) {
      // S = Q K^T over DP / 16 steps of 16 columns
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.0f;
      fence_acc(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        const uint32_t col = (ks & 3) * 32;  // 16 bf16 within the slab
        const uint64_t da = wgmma_desc(
            sq_tile + (ks >> 2) * (kWQ * kRowBytes) + wg * 64 * kRowBytes + col,
            16, 8 * kRowBytes);
        const uint64_t db = wgmma_desc(sk + (ks >> 2) * (kWK * kRowBytes) + col,
                                       16, 8 * kRowBytes);
        wgmma_ss(s, da, db, ks > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_acc(s);

      // online softmax on the fragments: s[i] is row row0 + 8 ((i >> 1) & 1),
      // key k0 + 8 (i >> 2) + 2 (lane & 3) + (i & 1); m is kept scaled by
      // scale * log2 e, so p = 2^(s sl2 - m) is one FMA and one ex2
      const bool whole = k0 + kWK <= p.skv &&
                         (!p.causal || wg_first >= k0 + kWK - 1) &&
                         (p.window <= 0 || k0 > wg_last - p.window);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int r = (i >> 1) & 1;
        if (!whole &&
            !visible(p, qpos0 + 8 * r,
                     k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1)))
          s[i] = kNegInf;
        mx[r] = fmaxf(mx[r], s[i]);
      }
      float alpha[2], m_new[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        m_new[r] = mx[r] == kNegInf ? m[r] : fmaxf(m[r], mx[r] * sl2);
        alpha[r] = m_new[r] == m[r] ? 1.0f : fast_exp2(m[r] - m_new[r]);
        m[r] = m_new[r];
      }
      uint32_t ph[4][4], pl[4][4];  // P_hi, P_lo as A fragments per 16 keys
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int r = (i >> 1) & 1;
        float p0 = fast_exp2(fmaf(s[i], sl2, -m_new[r]));
        float p1 = fast_exp2(fmaf(s[i + 1], sl2, -m_new[r]));
        if (!whole) {  // a masked score never counts
          p0 = s[i] == kNegInf ? 0.0f : p0;
          p1 = s[i + 1] == kNegInf ? 0.0f : p1;
        }
        rs[r] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        ph[i >> 3][(i >> 1) & 3] = bf16x2_bits(hi);
        pl[i >> 3][(i >> 1) & 3] =
            bf16x2_bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[j][i] *= alpha[(i >> 1) & 1];

      // O += P_hi V + P_lo V over 4 steps of 16 keys, 128 columns of D (two
      // slabs; the descriptor's leading offset steps between them) or 64 at
      // a time
#pragma unroll
      for (int j = 0; j < NS; ++j) fence_acc(acc[j]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int j = 0; j < NS; j += 2) {
          const uint64_t dv =
              wgmma_desc(sv + j * (kWK * kRowBytes) + kk * 16 * kRowBytes,
                         kWK * kRowBytes, 8 * kRowBytes);
          if constexpr (NS == 1) {
            wgmma_rs(acc[0], ph[kk], dv);
            wgmma_rs(acc[0], pl[kk], dv);
          } else {
            wgmma_rs2(acc[j], acc[j + 1], ph[kk], dv);
            wgmma_rs2(acc[j], acc[j + 1], pl[kk], dv);
          }
        }
      }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int j = 0; j < NS; ++j) fence_acc(acc[j]);
    }
    __syncthreads();  // this stage is free for the prefetch after next
  }
  cp_async_wait<0>();

  // l: the four lanes of a row hold partial sums under one running max
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    den[r] = fmaxf(l[r], 1e-20f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + 8 * r;
    if (row >= p.sq) continue;
    __nv_bfloat16* orow = o + row * p.sos;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) {
        const int col = j * 64 + c8 * 8 + 2 * (lane & 3);
        if (col < p.d)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[j][4 * c8 + 2 * r] / den[r],
                                    acc[j][4 * c8 + 2 * r + 1] / den[r]);
      }
  }
}

template <int DP>
int launch_wgmma(const Params& p, int batch, cudaStream_t stream) {
  constexpr int smem = WgmmaSmem<DP>::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      attn_wgmma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(p.hq, batch, (p.sq + kWQ - 1) / kWQ);
  attn_wgmma_kernel<DP><<<grid, kWThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int check_args(int batch, int hq, int hkv, int sq, int skv, int d) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv || sq < 1 || skv < 1 ||
      d < 1 || d > 256 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

Params make_params(const void* q, const void* k, const void* v, void* o,
                   const int64_t* st, int hq, int hkv, int sq, int skv, int d,
                   int q_offset, int window, int causal, float scale) {
  return Params{q,     k,     v,      o,      st[0],    st[1],  st[2],
                st[3], st[4], st[5],  st[6],  st[7],    st[8],  st[9],
                st[10], st[11], hq,   hkv,    sq,       skv,    d,
                q_offset, window, causal, scale};
}

}  // namespace

// strides: (b, h, s) element strides of q, k, v and o, in that order
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o,
                                   const int64_t* strides, int batch, int hq,
                                   int hkv, int sq, int skv, int d,
                                   int q_offset, int window, int causal,
                                   float scale, void* stream) {
  if (int e = check_args(batch, hq, hkv, sq, skv, d)) return e;
  if (hq > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(q, k, v, o, strides, hq, hkv, sq, skv, d,
                               q_offset, window, causal, scale);
  const auto s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch_f32<4>(p, batch, s);
  if (d <= 128) return launch_f32<8>(p, batch, s);
  return launch_f32<16>(p, batch, s);
}

// The bf16 route also needs 16-byte-aligned pointers and strides and D that
// are multiples of 8 elements (the wrapper raises before the launch).
extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o,
                                    const int64_t* strides, int batch, int hq,
                                    int hkv, int sq, int skv, int d,
                                    int q_offset, int window, int causal,
                                    float scale, void* stream) {
  if (int e = check_args(batch, hq, hkv, sq, skv, d)) return e;
  bool aligned = d % 8 == 0 && (sq + kWQ - 1) / kWQ <= 65535;
  for (const void* ptr : {q, k, v, static_cast<const void*>(o)})
    aligned = aligned && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  for (int i = 0; i < 12; ++i) aligned = aligned && strides[i] % 8 == 0;
  if (!aligned) return static_cast<int>(cudaErrorInvalidValue);
  const Params p = make_params(q, k, v, o, strides, hq, hkv, sq, skv, d,
                               q_offset, window, causal, scale);
  const auto s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch_wgmma<64>(p, batch, s);
  if (d <= 128) return launch_wgmma<128>(p, batch, s);
  return launch_wgmma<256>(p, batch, s);
}

RIPPLE_ERROR_STRING_FN
