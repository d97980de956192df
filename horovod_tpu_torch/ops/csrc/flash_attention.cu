// Flash attention for Hopper: forward (B1), dQ (B2) and dK/dV (B3) passes.
//
// Replaces the Pallas TPU kernels of horovod_tpu/ops/flash_attention.py:
//   B1 fa_fwd_kernel_sm90 (bf16), fa_fwd_kernel (f32)  <- _fa_kernel
//      (online-softmax forward, emits o, m, l)
//   B2 fa_bwd_dq_kernel_sm90 (bf16), fa_bwd_dq_kernel (f32)
//                                                      <- _fa_bwd_dq_kernel
//      (FA2 dQ pass, k innermost)
//   B3 fa_bwd_dkv_kernel_sm90 (bf16), fa_bwd_dkv_kernel (f32)
//                                                      <- _fa_bwd_dkv_kernel
//      (FA2 dK/dV pass, q innermost)
//
// What bounds them on the H100 at the Llama-3-8B training shape (B*H = 64,
// T = 2048, D = 128, causal, bf16): tensor-core operations. B1 does 2 products
// (~68.7 GFLOP, ~69.5 us at 989 TFLOP/s dense bf16), B2 3 products (~103
// GFLOP, ~104 us), B3 4 products (~137 GFLOP, ~139 us); q, k, v and o are ~34
// MB each, ~10 us at 3.35 TB/s, so every pass is compute-bound.
//
// Two designs live here:
// - bf16 B1, B2 and B3 run on the tensor cores: wgmma products on TMA-fed
//   tiles, a producer warpgroup and two consumer warpgroups a block
//   (flash_attention_sm90.cuh, which has their note).
// - This file's kernels multiply on the CUDA cores in f32 out of f32 tiles in
//   shared memory. They serve every f32 call (the tensor cores take f32 only
//   as TF32, too coarse for the f32 tolerance). What they keep from the flash
//   design is the memory behaviour: the [Tq, Tk] score matrix never reaches
//   device memory, each q-tile (B1, B2) or k-tile (B3) is owned by one thread
//   block that loops over the other axis with its running state in shared
//   memory and registers, and tiles above the causal diagonal are skipped.
// Neither uses atomics, so results are deterministic.
//
// Layout: q/o/dq are [B, Tq, H, D], k/v/dk/dv [B, Tk, H, D], all contiguous
// (the model's own layout, so no fold/unfold copies); m, l, dsum [B, H, Tq]
// f32; the optional additive key bias [B, Tk] f32. The TPU wrapper padded T to
// a block multiple and passed padded keys as a NEG_INF bias; here the kernel
// masks the ragged edge itself and the wrapper pads nothing.
//
// Masking algebra, kept exactly from the TPU kernel (ring attention and
// merge_partials depend on it): the finite NEG_INF = -1e30, probabilities at
// s <= NEG_INF/2 set to 0, and rows that see no key get l = 0 and output 0
// (the l == 0 -> 1 divide guard).
//
// Interface: plain C, loaded with ctypes. Each entry point launches on the
// given stream, allocates nothing, and returns a cudaError_t code.
// dtype: 0 = float32, 1 = bfloat16. Head dims 64 and 128. The bf16 kernels
// read their operands by TMA, which needs them 16-byte aligned (the Python
// wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_sm90.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;       // q rows per tile
constexpr int BK = 64;       // k rows per tile
constexpr int NT = 256;      // threads per block: a 16 x 16 grid
constexpr int PLD = BK + 1;  // padded row length of the [BQ, BK] score tiles

// Rows [row0, row0 + ROWS) of one (batch, head) slice into shared memory as
// f32 [ROWS][D + 1] (the +1 keeps column reads free of bank conflicts).
// Rows at or past n are zero.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int n,
                                          int64_t row_stride) {
  for (int i = threadIdx.x; i < ROWS * D; i += NT) {
    const int r = i / D, c = i % D, t = row0 + r;
    dst[r * (D + 1) + c] = t < n ? src[t * row_stride + c] : 0.f;
  }
}

// The masked, scaled score of one (q position, k position) pair, as the TPU
// kernel forms it: s * scale + bias, NEG_INF above the causal diagonal, and
// NEG_INF past the ragged key edge (the TPU wrapper's padding bias).
__device__ __forceinline__ float masked_score(float s, float scale, const float* bias, int qp,
                                              int kp, int Tk, int causal) {
  if (kp >= Tk) return NEG_INF;
  float x = s * scale;
  if (bias != nullptr) x += bias[kp];
  if (causal && qp < kp) x = NEG_INF;
  return x;
}

// Number of k-tiles a q-tile starting at q0 must visit (causal tile skip).
__device__ __forceinline__ int visible_k_tiles(int q0, int Tk, int causal) {
  const int nk = (Tk + BK - 1) / BK;
  return causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
}

// S = Q K^T and, with WITH_DP, dP = dO V^T for this thread's 4 x 4 cells
// (rows ty + 16 i, columns tx + 16 j) of a [BQ, BK] tile.
template <int D, bool WITH_DP>
__device__ __forceinline__ void tile_products(const float* qs, const float* ks, const float* dos,
                                              const float* vs, int ty, int tx, float s[4][4],
                                              float dp[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += a[i] * b[j];
    if (WITH_DP) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dos[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = vs[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] += a[i] * b[j];
    }
  }
}

// ---------------------------------------------------------------- B1 forward
template <int D>
__global__ void __launch_bounds__(NT)
    fa_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ bias,
                  float* __restrict__ o, float* __restrict__ m_out, float* __restrict__ l_out,
                  int H, int Tq, int Tk, float scale, int causal) {
  constexpr int LD = D + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;              // [BQ][LD]
  float* ks = qs + BQ * LD;      // [BK][LD]
  float* vs = ks + BK * LD;      // [BK][LD]
  float* ps = vs + BK * LD;      // [BQ][PLD] scores, then probabilities
  float* m_s = ps + BQ * PLD;    // [BQ] running row max
  float* l_s = m_s + BQ;         // [BQ] running denominator
  float* c_s = l_s + BQ;         // [BQ] this tile's rescale exp(m_prev - m_new)

  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * BQ;
  const int64_t rs = (int64_t)H * D;
  const float* qb = q + ((int64_t)b * Tq * H + h) * D;
  const float* kb = k + ((int64_t)b * Tk * H + h) * D;
  const float* vb = v + ((int64_t)b * Tk * H + h) * D;
  const float* bb = bias == nullptr ? nullptr : bias + (int64_t)b * Tk;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_tile<D, BQ>(qs, qb, q0, Tq, rs);
  if (threadIdx.x < BQ) {
    m_s[threadIdx.x] = NEG_INF;
    l_s[threadIdx.x] = 0.f;
  }
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int nk = visible_k_tiles(q0, Tk, causal);
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * BK;
    __syncthreads();  // the previous tile's readers of ks, vs, ps are done
    load_tile<D, BK>(ks, kb, k0, Tk, rs);
    load_tile<D, BK>(vs, vb, k0, Tk, rs);
    __syncthreads();

    float s[4][4], unused[4][4];
    tile_products<D, false>(qs, ks, nullptr, nullptr, ty, tx, s, unused);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        ps[r * PLD + c] = masked_score(s[i][j], scale, bb, q0 + r, k0 + c, Tk, causal);
      }
    __syncthreads();

    // Online softmax: each warp owns BQ / 8 rows, each lane two columns.
    for (int rr = 0; rr < BQ / 8; ++rr) {
      const int r = warp * (BQ / 8) + rr;
      float* row = ps + r * PLD;
      const float a0 = row[lane], a1 = row[lane + 32];
      float mx = fmaxf(a0, a1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      // Rows still fully masked have m_new == NEG_INF, where exp(s - m_new)
      // would be 1: zero those probabilities explicitly.
      const float p0 = a0 <= NEG_INF / 2 ? 0.f : expf(a0 - m_new);
      const float p1 = a1 <= NEG_INF / 2 ? 0.f : expf(a1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
        c_s[r] = corr;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V over this thread's rows ty + 16 i, columns tx + 16 j.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * PLD + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += pv[i] * vv[j];
    }
  }
  __syncthreads();

  float* ob = o + ((int64_t)b * Tq * H + h) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, t = q0 + r;
    if (t >= Tq) continue;
    const float l = l_s[r];
    const float den = l == 0.f ? 1.f : l;
#pragma unroll
    for (int j = 0; j < DJ; ++j) ob[t * rs + tx + 16 * j] = acc[i][j] / den;
  }
  if (threadIdx.x < BQ && q0 + threadIdx.x < Tq) {
    m_out[(int64_t)bh * Tq + q0 + threadIdx.x] = m_s[threadIdx.x];
    l_out[(int64_t)bh * Tq + q0 + threadIdx.x] = l_s[threadIdx.x];
  }
}

// Per-row softmax statistics of a q-tile into shared memory: m, the guarded
// denominator (l == 0 -> 1) and dsum = rowsum(dO * O). Rows past Tq get
// m = 0, l = 1, dsum = 0 and are masked out by the callers.
__device__ __forceinline__ void load_row_stats(float* m_s, float* l_s, float* d_s,
                                               const float* m, const float* l,
                                               const float* dsum, int64_t base, int q0,
                                               int Tq) {
  if (threadIdx.x < BQ) {
    const int t = q0 + threadIdx.x;
    const bool in = t < Tq;
    const float lv = in ? l[base + t] : 1.f;
    m_s[threadIdx.x] = in ? m[base + t] : 0.f;
    l_s[threadIdx.x] = lv == 0.f ? 1.f : lv;
    d_s[threadIdx.x] = in ? dsum[base + t] : 0.f;
  }
}

// p and ds = p * (dp - dsum) of one cell, recomputed from the saved softmax
// statistics exactly as _recompute_p_ds does.
__device__ __forceinline__ void recompute_p_ds(float s, float dp, float scale, const float* bias,
                                               int qp, int kp, int Tq, int Tk, int causal,
                                               float m, float l, float dsum, float* p_out,
                                               float* ds_out) {
  const float x = masked_score(s, scale, bias, qp, kp, Tk, causal);
  const float p = (qp >= Tq || x <= NEG_INF / 2) ? 0.f : expf(x - m) / l;
  *p_out = p;
  *ds_out = p * (dp - dsum);
}

// ---------------------------------------------------------------- B2 dQ pass
template <int D>
__global__ void __launch_bounds__(NT)
    fa_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ m, const float* __restrict__ l,
                     const float* __restrict__ dsum, const float* __restrict__ bias,
                     float* __restrict__ dq, int H, int Tq, int Tk, float scale, int causal) {
  constexpr int LD = D + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;             // [BQ][LD]
  float* dos = qs + BQ * LD;    // [BQ][LD]
  float* ks = dos + BQ * LD;    // [BK][LD]
  float* vs = ks + BK * LD;     // [BK][LD]
  float* dss = vs + BK * LD;    // [BQ][PLD]
  float* m_s = dss + BQ * PLD;  // [BQ]
  float* l_s = m_s + BQ;        // [BQ]
  float* d_s = l_s + BQ;        // [BQ]

  const int bh = blockIdx.y, b = bh / H, h = bh % H, q0 = blockIdx.x * BQ;
  const int64_t rs = (int64_t)H * D;
  const int64_t qoff = ((int64_t)b * Tq * H + h) * D, koff = ((int64_t)b * Tk * H + h) * D;
  const float* bb = bias == nullptr ? nullptr : bias + (int64_t)b * Tk;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<D, BQ>(qs, q + qoff, q0, Tq, rs);
  load_tile<D, BQ>(dos, dout + qoff, q0, Tq, rs);
  load_row_stats(m_s, l_s, d_s, m, l, dsum, (int64_t)bh * Tq, q0, Tq);
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  const int nk = visible_k_tiles(q0, Tk, causal);
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * BK;
    __syncthreads();
    load_tile<D, BK>(ks, k + koff, k0, Tk, rs);
    load_tile<D, BK>(vs, v + koff, k0, Tk, rs);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_products<D, true>(qs, ks, dos, vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        float p, ds;
        recompute_p_ds(s[i][j], dp[i][j], scale, bb, q0 + r, k0 + c, Tq, Tk, causal, m_s[r],
                       l_s[r], d_s[r], &p, &ds);
        dss[r * PLD + c] = ds;
      }
    __syncthreads();

    // dQ += dS K over this thread's rows ty + 16 i, columns tx + 16 j.
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float a[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = dss[(ty + 16 * i) * PLD + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] += a[i] * kv[j];
    }
  }

  float* dqb = dq + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= Tq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dqb[t * rs + tx + 16 * j] = acc[i][j] * scale;
  }
}

// ------------------------------------------------------------- B3 dK/dV pass
template <int D>
__global__ void __launch_bounds__(NT)
    fa_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ m, const float* __restrict__ l,
                      const float* __restrict__ dsum, const float* __restrict__ bias,
                      float* __restrict__ dk, float* __restrict__ dv, int H, int Tq, int Tk,
                      float scale, int causal) {
  constexpr int LD = D + 1, DJ = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;             // [BK][LD]
  float* vs = ks + BK * LD;     // [BK][LD]
  float* qs = vs + BK * LD;     // [BQ][LD]
  float* dos = qs + BQ * LD;    // [BQ][LD]
  float* pss = dos + BQ * LD;   // [BQ][PLD]
  float* dss = pss + BQ * PLD;  // [BQ][PLD]
  float* m_s = dss + BQ * PLD;  // [BQ]
  float* l_s = m_s + BQ;        // [BQ]
  float* d_s = l_s + BQ;        // [BQ]

  const int bh = blockIdx.y, b = bh / H, h = bh % H, k0 = blockIdx.x * BK;
  const int64_t rs = (int64_t)H * D;
  const int64_t qoff = ((int64_t)b * Tq * H + h) * D, koff = ((int64_t)b * Tk * H + h) * D;
  const float* bb = bias == nullptr ? nullptr : bias + (int64_t)b * Tk;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_tile<D, BK>(ks, k + koff, k0, Tk, rs);
  load_tile<D, BK>(vs, v + koff, k0, Tk, rs);
  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk_acc[i][j] = 0.f;
      dv_acc[i][j] = 0.f;
    }

  // Causal: q-tiles wholly above this k-tile's first key see none of it.
  const int nq = (Tq + BQ - 1) / BQ;
  const int iq0 = causal ? k0 / BQ : 0;
  for (int iq = iq0; iq < nq; ++iq) {
    const int q0 = iq * BQ;
    __syncthreads();
    load_tile<D, BQ>(qs, q + qoff, q0, Tq, rs);
    load_tile<D, BQ>(dos, dout + qoff, q0, Tq, rs);
    load_row_stats(m_s, l_s, d_s, m, l, dsum, (int64_t)bh * Tq, q0, Tq);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_products<D, true>(qs, ks, dos, vs, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        float p, ds;
        recompute_p_ds(s[i][j], dp[i][j], scale, bb, q0 + r, k0 + c, Tq, Tk, causal, m_s[r],
                       l_s[r], d_s[r], &p, &ds);
        pss[r * PLD + c] = p;
        dss[r * PLD + c] = ds;
      }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over this thread's key rows ty + 16 i,
    // columns tx + 16 j.
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float pv[4], dsv[4], dov[DJ], qv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pss[r * PLD + ty + 16 * i];
        dsv[i] = dss[r * PLD + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        dov[j] = dos[r * LD + tx + 16 * j];
        qv[j] = qs[r * LD + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          dv_acc[i][j] += pv[i] * dov[j];
          dk_acc[i][j] += dsv[i] * qv[j];
        }
    }
  }

  float* dkb = dk + koff;
  float* dvb = dv + koff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t >= Tk) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dkb[t * rs + tx + 16 * j] = dk_acc[i][j] * scale;
      dvb[t * rs + tx + 16 * j] = dv_acc[i][j];
    }
  }
}

constexpr size_t fwd_smem(int D) {
  return sizeof(float) * (size_t)(3 * BQ * (D + 1) + BQ * PLD + 3 * BQ);
}
constexpr size_t dq_smem(int D) {
  return sizeof(float) * (size_t)(4 * BQ * (D + 1) + BQ * PLD + 3 * BQ);
}
constexpr size_t dkv_smem(int D) {
  return sizeof(float) * (size_t)(4 * BQ * (D + 1) + 2 * BQ * PLD + 3 * BQ);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const float* bias, void* o,
               float* m, float* l, int B, int H, int Tq, int Tk, float scale, int causal,
               cudaStream_t stream) {
  auto kernel = fa_fwd_kernel<D>;
  const size_t smem = fwd_smem(D);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>((const float*)q, (const float*)k, (const float*)v, bias,
                                     (float*)o, m, l, H, Tq, Tk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* m,
              const float* l, const float* dsum, const float* bias, void* dq, int B, int H,
              int Tq, int Tk, float scale, int causal, cudaStream_t stream) {
  auto kernel = fa_bwd_dq_kernel<D>;
  const size_t smem = dq_smem(D);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  kernel<<<grid, NT, smem, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                     (const float*)dout, m, l, dsum, bias, (float*)dq, H, Tq, Tk,
                                     scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* m,
               const float* l, const float* dsum, const float* bias, void* dk, void* dv, int B,
               int H, int Tq, int Tk, float scale, int causal, cudaStream_t stream) {
  auto kernel = fa_bwd_dkv_kernel<D>;
  const size_t smem = dkv_smem(D);
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tk + BK - 1) / BK, B * H);
  kernel<<<grid, NT, smem, stream>>>((const float*)q, (const float*)k, (const float*)v,
                                     (const float*)dout, m, l, dsum, bias, (float*)dk, (float*)dv,
                                     H, Tq, Tk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes shared with the Python wrapper.
#define HVD_F32 0
#define HVD_BF16 1

// f32 to this file's CUDA-core kernels, bf16 to the tensor-core ones.
#define HVD_DISPATCH_SM90(LAUNCH, ...)                                     \
  if (dtype == HVD_F32 && D == 64) return LAUNCH<64>(__VA_ARGS__);         \
  if (dtype == HVD_F32 && D == 128) return LAUNCH<128>(__VA_ARGS__);       \
  if (dtype == HVD_BF16 && D == 64) return sm90::LAUNCH<64>(__VA_ARGS__);   \
  if (dtype == HVD_BF16 && D == 128) return sm90::LAUNCH<128>(__VA_ARGS__); \
  return (int)cudaErrorInvalidValue;

extern "C" {

const char* hvd_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int hvd_fa_fwd(int dtype, int D, const void* q, const void* k, const void* v,
               const float* bias, void* o, float* m, float* l, int B, int H, int Tq, int Tk,
               float scale, int causal, void* stream) {
  HVD_DISPATCH_SM90(launch_fwd, q, k, v, bias, o, m, l, B, H, Tq, Tk, scale, causal,
                    (cudaStream_t)stream)
}

int hvd_fa_bwd_dq(int dtype, int D, const void* q, const void* k, const void* v,
                  const void* dout, const float* m, const float* l, const float* dsum,
                  const float* bias, void* dq, int B, int H, int Tq, int Tk, float scale,
                  int causal, void* stream) {
  HVD_DISPATCH_SM90(launch_dq, q, k, v, dout, m, l, dsum, bias, dq, B, H, Tq, Tk, scale,
                    causal, (cudaStream_t)stream)
}

int hvd_fa_bwd_dkv(int dtype, int D, const void* q, const void* k, const void* v,
                   const void* dout, const float* m, const float* l, const float* dsum,
                   const float* bias, void* dk, void* dv, int B, int H, int Tq, int Tk,
                   float scale, int causal, void* stream) {
  HVD_DISPATCH_SM90(launch_dkv, q, k, v, dout, m, l, dsum, bias, dk, dv, B, H, Tq, Tk,
                    scale, causal, (cudaStream_t)stream)
}

}  // extern "C"
