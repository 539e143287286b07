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
//
// Bound on the card: operations.  About 4 * Sq * Skv * D operations per head
// (half under the causal mask) against 2 * D * (Sq + 2 Skv) bytes of bf16:
// at the qwen3 prefill shape some 800 operations per byte, far above the
// ridge.  This first version runs on the float32 CUDA cores (67 TFLOP/s), not
// the tensor cores (989 TFLOP/s bf16): wgmma, TMA and a warp-specialised
// pipeline are later work.
//
// Design: one 256-thread block per (64-row q tile, head, batch).  The q tile,
// one 64-row K tile, one V tile (float32, K and q rows padded to D + 1 so that
// 16 threads reading 16 rows hit 16 banks) and the 64 x 64 probability tile
// sit in dynamic shared memory (115 KB at D = 128, 214 KB at D = 256).  The
// 16 x 16 threads each own 4 score rows (ty + 16 i) by 4 columns (tx + 16 j)
// and the same 4 output rows by D / 16 columns, so the running max, sum and
// rescale of a row stay in the registers of the 16 threads that share it,
// reduced with warp shuffles.  Masked scores (outside the band, or past the
// ragged end of Skv) get probability exactly 0 and never enter exp, so a
// fully masked tile leaves m, l and acc unchanged; query rows past the ragged
// end of Sq are computed on zeros and not stored.  bf16 is loaded, widened to
// float32 once, and the output rounded once.
#include <cuda_runtime.h>

#include <cstdint>

#include "record_index.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kRows = kBQ / 16;
constexpr int kCols = kBK / 16;
constexpr int kPS = kBK + 1;   // probability tile row stride
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

template <int NJ>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (2 * kBQ * (16 * NJ + 1) + kBK * 16 * NJ + kBQ * kPS);
}

template <typename T, int NJ>
__global__ void __launch_bounds__(kThreads) attn_kernel(Params p) {
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
  const T* q = static_cast<const T*>(p.q) + b * p.sqb + h * p.sqh;
  const T* k = static_cast<const T*>(p.k) + b * p.skb + hk * p.skh;
  const T* v = static_cast<const T*>(p.v) + b * p.svb + hk * p.svh;
  T* o = static_cast<T*>(p.o) + b * p.sob + h * p.soh;

  for (int idx = threadIdx.x; idx < kBQ * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    sq[r * QS + c] = (q0 + r < p.sq && c < p.d)
                         ? ripple::load_f(q + (q0 + r) * p.sqs + c)
                         : 0.0f;
  }

  // the KV blocks that hold a visible key for some row of this tile
  const int pos_first = p.q_offset + q0;
  const int pos_last = p.q_offset + min(q0 + kBQ, p.sq) - 1;
  int hi = (p.skv + kBK - 1) / kBK;
  if (p.causal) hi = pos_last < 0 ? 0 : min(hi, pos_last / kBK + 1);
  int lo = 0;
  if (p.window > 0) {
    const int first_visible = pos_first - p.window + 1;
    lo = first_visible > 0 ? first_visible / kBK : 0;
  }

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

  for (int kb = lo; kb < hi; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = threadIdx.x; idx < kBK * DP; idx += kThreads) {
      const int r = idx / DP, c = idx % DP;
      const bool in = k0 + r < p.skv && c < p.d;
      sk[r * QS + c] = in ? ripple::load_f(k + (k0 + r) * p.sks + c) : 0.0f;
      sv[r * DP + c] = in ? ripple::load_f(v + (k0 + r) * p.svs + c) : 0.0f;
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
        const int kp = k0 + tx + 16 * j;
        ok[j] = kp < p.skv && (!p.causal || qpos[i] >= kp) &&
                (p.window <= 0 || kp > qpos[i] - p.window);
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
      if (c < p.d) ripple::store_f(o + r * p.sos + c, acc[i][j] / den);
    }
  }
}

template <typename T, int NJ>
int launch_nj(const Params& p, int batch, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<NJ>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attn_kernel<T, NJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((p.sq + kBQ - 1) / kBQ, p.hq, batch);
  attn_kernel<T, NJ><<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_attn(const void* q, const void* k, const void* v, void* o,
                const int64_t* strides, int batch, int hq, int hkv, int sq,
                int skv, int d, int q_offset, int window, int causal,
                float scale, void* stream) {
  if (batch < 1 || hq < 1 || hkv < 1 || hq % hkv || sq < 1 || skv < 1 ||
      d < 1 || d > 256 || batch > 65535 || hq > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{q, k, v, o,
                 strides[0], strides[1], strides[2], strides[3], strides[4],
                 strides[5], strides[6], strides[7], strides[8], strides[9],
                 strides[10], strides[11],
                 hq, hkv, sq, skv, d, q_offset, window, causal, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  if (d <= 64) return launch_nj<T, 4>(p, batch, s);
  if (d <= 128) return launch_nj<T, 8>(p, batch, s);
  return launch_nj<T, 16>(p, batch, s);
}

}  // namespace

// strides: (b, h, s) element strides of q, k, v and o, in that order
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o,
                                   const int64_t* strides, int batch, int hq,
                                   int hkv, int sq, int skv, int d,
                                   int q_offset, int window, int causal,
                                   float scale, void* stream) {
  return launch_attn<float>(q, k, v, o, strides, batch, hq, hkv, sq, skv, d,
                            q_offset, window, causal, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o,
                                    const int64_t* strides, int batch, int hq,
                                    int hkv, int sq, int skv, int d,
                                    int q_offset, int window, int causal,
                                    float scale, void* stream) {
  return launch_attn<__nv_bfloat16>(q, k, v, o, strides, batch, hq, hkv, sq,
                                    skv, d, q_offset, window, causal, scale,
                                    stream);
}

RIPPLE_ERROR_STRING_FN
