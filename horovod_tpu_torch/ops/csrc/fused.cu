// Fused Adasum kernels for Hopper: the three sums (B4) and the combine (B5).
//
// Replaces the Pallas TPU kernels of horovod_tpu/ops/fused.py:
//   B4 norms_dot_partial_kernel + norms_dot_final_kernel <- _norms_dot_kernel
//      (a.b, |a|^2, |b|^2 in one read of each operand)
//   B5 combine_kernel                                    <- _combine_kernel
//      (ca * a + cb * b elementwise)
//
// What bounds them on the H100: bytes. B4 reads 2 * 4 * n bytes and B5 moves
// 3 * 4 * n; at the 2-layer Llama-3-8B-width flat gradient (n = 1,486,901,248)
// that is 3.551 ms and 5.326 ms at 3.35 TB/s. Their arithmetic (3 f64 FMAs a
// pair for B4, 2 f32 products and an add for B5) is far below the card's rates.
//
// What this design does about it: a plain grid-stride pass with 16-byte
// (float4) loads and stores, 4 float4 of each operand in flight per thread
// in B4, and enough blocks to fill the 132 SMs.
//
// The TPU kernel carried its three sums in SMEM across a sequential grid. On
// the GPU blocks run in any order, so B4 is a deterministic two-stage
// reduction with no atomics: stage 1 writes one f64 triple per block, stage 2
// (one block) sums them in a fixed order, rounds once to f32 and derives the
// coefficients ca, cb (adasum_coefficients) into a device buffer that B5
// reads, so no value goes through the host. Sums accumulate in f64: at the
// main path's n a thread sums ~10^4 products, and an f32 sum in that order
// alone could be off by ~1e-4 of the result.
//
// Symmetry: butterfly partners compute combine(x, y) and combine(y, x) and
// must get bit-identical results. B4's per-element order depends only on n
// and the operands' common alignment, never on which operand comes first, and
// an f32 product is exact in f64, so the partners' (dot, na, nb) are (dot, nb,
// na). B5 rounds each product and the sum once, with explicit intrinsics:
// nvcc would otherwise contract ca * a + cb * b into fma(ca, a, cb * b),
// whose partner fma(cb, b, ca * a) rounds differently.
//
// Edges: indices are int64 (the full Llama-3-8B gradient has 8.0e9 elements);
// a scalar head and tail cover a vector that does not start or end on a
// 16-byte boundary, and operands whose addresses differ modulo 16 take the
// scalar path throughout. B5 may write into a (in place): each element is
// read before it is written, by the same thread.
//
// Interface: plain C, loaded with ctypes. Each entry point launches on the
// given stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ double warp_sum(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Sums three per-thread values over the block in a fixed order; thread 0
// ends with the totals.
__device__ __forceinline__ void block_sum3(double& s0, double& s1, double& s2) {
  __shared__ double red[3][kWarps];
  s0 = warp_sum(s0);
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = s0;
    red[1][warp] = s1;
    red[2][warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    s0 = warp_sum(lane < kWarps ? red[0][lane] : 0.0);
    s1 = warp_sum(lane < kWarps ? red[1][lane] : 0.0);
    s2 = warp_sum(lane < kWarps ? red[2][lane] : 0.0);
  }
}

struct Sums {
  double dot = 0.0, na = 0.0, nb = 0.0;
  __device__ __forceinline__ void add(float x, float y) {
    const double dx = x, dy = y;
    dot = fma(dx, dy, dot);
    na = fma(dx, dx, na);
    nb = fma(dy, dy, nb);
  }
  __device__ __forceinline__ void add4(float4 x, float4 y) {
    add(x.x, y.x);
    add(x.y, y.y);
    add(x.z, y.z);
    add(x.w, y.w);
  }
};

// Elements before the first 16-byte boundary of p (p is 4-byte aligned).
__host__ __forceinline__ int64_t head_of(const void* p) {
  return (int64_t)((16 - (uintptr_t)p % 16) % 16) / 4;
}

// Stage 1 of B4: one (a.b, |a|^2, |b|^2) triple per block into partials.
__global__ void __launch_bounds__(kThreads)
    norms_dot_partial_kernel(const float* __restrict__ a, const float* __restrict__ b,
                             int64_t n, int64_t head, int vec, double* __restrict__ partials) {
  Sums s;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t tail = 0;
  if (vec) {
    for (int64_t i = tid; i < head; i += stride) s.add(a[i], b[i]);
    const float4* a4 = reinterpret_cast<const float4*>(a + head);
    const float4* b4 = reinterpret_cast<const float4*>(b + head);
    const int64_t nvec = (n - head) / 4;
    int64_t i = tid;
    for (; i + 3 * stride < nvec; i += 4 * stride) {
      float4 x[4], y[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        x[u] = a4[i + u * stride];
        y[u] = b4[i + u * stride];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) s.add4(x[u], y[u]);
    }
    for (; i < nvec; i += stride) s.add4(a4[i], b4[i]);
    tail = head + 4 * nvec;
  }
  for (int64_t i = tail + tid; i < n; i += stride) s.add(a[i], b[i]);
  block_sum3(s.dot, s.na, s.nb);
  if (threadIdx.x == 0) {
    partials[3 * blockIdx.x + 0] = s.dot;
    partials[3 * blockIdx.x + 1] = s.na;
    partials[3 * blockIdx.x + 2] = s.nb;
  }
}

// adasum_coefficients for one operand: 1 - dot / (2 |x|^2), or 1 when the
// squared norm is not above eps; each operation rounded once, as the plain
// PyTorch formula rounds it.
__device__ __forceinline__ float coefficient(float dot, float norm, float eps) {
  return norm > eps ? __fsub_rn(1.0f, __fdiv_rn(dot, __fmul_rn(2.0f, norm))) : 1.0f;
}

// Stage 2 of B4: the block triples summed in a fixed order, rounded once to
// f32; stats = [a.b, |a|^2, |b|^2, ca, cb].
__global__ void __launch_bounds__(kThreads)
    norms_dot_final_kernel(const double* __restrict__ partials, int nblocks, float eps,
                           float* __restrict__ stats) {
  double dot = 0.0, na = 0.0, nb = 0.0;
  for (int i = threadIdx.x; i < nblocks; i += kThreads) {
    dot += partials[3 * i + 0];
    na += partials[3 * i + 1];
    nb += partials[3 * i + 2];
  }
  block_sum3(dot, na, nb);
  if (threadIdx.x == 0) {
    const float d = __double2float_rn(dot);
    const float fa = __double2float_rn(na);
    const float fb = __double2float_rn(nb);
    stats[0] = d;
    stats[1] = fa;
    stats[2] = fb;
    stats[3] = coefficient(d, fa, eps);
    stats[4] = coefficient(d, fb, eps);
  }
}

__device__ __forceinline__ float combine1(float ca, float x, float cb, float y) {
  return __fadd_rn(__fmul_rn(ca, x), __fmul_rn(cb, y));
}

// B5: out = ca * a + cb * b with (ca, cb) = stats[3], stats[4]. out may be a.
__global__ void __launch_bounds__(kThreads)
    combine_kernel(const float* a, const float* __restrict__ b, const float* __restrict__ stats,
                   float* out, int64_t n, int64_t head, int vec) {
  const float ca = stats[3], cb = stats[4];
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t tail = 0;
  if (vec) {
    for (int64_t i = tid; i < head; i += stride) out[i] = combine1(ca, a[i], cb, b[i]);
    const float4* a4 = reinterpret_cast<const float4*>(a + head);
    const float4* b4 = reinterpret_cast<const float4*>(b + head);
    float4* o4 = reinterpret_cast<float4*>(out + head);
    const int64_t nvec = (n - head) / 4;
    for (int64_t i = tid; i < nvec; i += stride) {
      const float4 x = a4[i], y = b4[i];
      float4 r;
      r.x = combine1(ca, x.x, cb, y.x);
      r.y = combine1(ca, x.y, cb, y.y);
      r.z = combine1(ca, x.z, cb, y.z);
      r.w = combine1(ca, x.w, cb, y.w);
      o4[i] = r;
    }
    tail = head + 4 * nvec;
  }
  for (int64_t i = tail + tid; i < n; i += stride) out[i] = combine1(ca, a[i], cb, b[i]);
}

int64_t blocks_for(int64_t n, int64_t cap) {
  const int64_t want = (n / 4 + kThreads - 1) / kThreads;
  return want < 1 ? 1 : (want < cap ? want : cap);
}

}  // namespace

extern "C" {

// B4. partials holds 3 * max_blocks doubles of scratch; stats gets
// [a.b, |a|^2, |b|^2, ca, cb] as f32.
int hvd_adasum_norms_dot(const float* a, const float* b, int64_t n, float eps,
                         double* partials, int max_blocks, float* stats, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int vec = (uintptr_t)a % 16 == (uintptr_t)b % 16;
  int64_t head = vec ? head_of(a) : 0;
  if (head > n) head = n;
  const int blocks = (int)blocks_for(n, max_blocks);
  norms_dot_partial_kernel<<<blocks, kThreads, 0, s>>>(a, b, n, head, vec, partials);
  norms_dot_final_kernel<<<1, kThreads, 0, s>>>(partials, blocks, eps, stats);
  return (int)cudaGetLastError();
}

// B5. stats as written by hvd_adasum_norms_dot; out may equal a.
int hvd_adasum_combine(const float* a, const float* b, const float* stats, float* out, int64_t n,
                       int max_blocks, void* stream) {
  if (n == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t off = (uintptr_t)a % 16;
  const int vec = (uintptr_t)b % 16 == off && (uintptr_t)out % 16 == off;
  int64_t head = vec ? head_of(a) : 0;
  if (head > n) head = n;
  const int blocks = (int)blocks_for(n, max_blocks);
  combine_kernel<<<blocks, kThreads, 0, s>>>(a, b, stats, out, n, head, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
