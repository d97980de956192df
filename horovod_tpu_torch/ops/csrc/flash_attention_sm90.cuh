// Flash attention on Hopper's tensor cores: the bf16 forward (B1), dQ (B2)
// and dK/dV (B3) kernels, included by flash_attention.cu.
//
//   fa_fwd_kernel_sm90      <- horovod_tpu/ops/flash_attention.py::_fa_kernel
//   fa_bwd_dq_kernel_sm90   <- horovod_tpu/ops/flash_attention.py::_fa_bwd_dq_kernel
//   fa_bwd_dkv_kernel_sm90  <- horovod_tpu/ops/flash_attention.py::_fa_bwd_dkv_kernel
//
// What bounds them: tensor-core operations. At the Llama-3-8B training shape
// (B*H = 64, T = 2048, D = 128, causal) B1 does two products, 68.7 GFLOP,
// 69.5 us at the H100's 989 TFLOP/s dense bf16; B2 does three, 103 GFLOP,
// 104 us; B3 does four, 137 GFLOP, 139 us. Their bytes (q, k, v, dO, o, dq,
// dk, dv ~34 MB each) take ~10 us a tensor at 3.35 TB/s.
//
// What the design does about it. Every product is a wgmma (bf16 operands,
// f32 accumulators) and every operand tile arrives by TMA:
// - A block is three warpgroups: two consumers, each owning 64 rows of the
//   block's tile, and a producer whose first thread (B1, B2) or first warp
//   (B3) keeps TMA loads in flight. setmaxnreg hands the producer's
//   registers to the consumers (24 against 240 a thread).
// - Operand tiles land in shared memory in the 128-byte swizzle that wgmma's
//   descriptors read. A TMA box is 64 bf16 columns wide at that swizzle, so a
//   D = 128 row arrives as two boxes, and each k-step of 16 columns selects
//   its box and a 32-byte offset inside it. Tensor maps are 4-D over the
//   [B, T, H, D] layout, dims (D, H, T, B); TMA zero-fills rows past T.
// - The streamed operands run through a ring of stages guarded by mbarriers:
//   "full" ones count TMA bytes (and, in B3, the producer warp's arrivals
//   after it wrote the statistics), "empty" ones one arrival from each
//   consumer warp when it is done with the stage.
// - P is never kept between the passes. B2 and B3 recompute it from the
//   forward's row statistics, as the TPU kernels do: p = exp2(s scale
//   log2(e) - c) with c = m log2(e) + log2(l) after the l == 0 -> 1 guard.
// - The two consumer warpgroups take turns to issue their products (named
//   barriers 1 and 2), so that one's softmax or elementwise work overlaps
//   the other's products on the tensor cores.
// - B1, per 128-row q-tile (Q loaded once), K and V tiles of 128 rows
//   through a three-stage ring, K and V on barriers of their own: S = Q K^T
//   with both operands in shared memory (K's [BK, D] rows are K-major); the
//   online softmax on the accumulator fragment in registers (row max and row
//   sum over the four lanes that share a row, exp2 with log2(e) folded in);
//   P packed in registers, where the S accumulator's layout is already the
//   A-operand layout of the next wgmma; O += P V with V's [BK, D] rows as the
//   MN-major (transposed) B operand. Iteration j issues S_j and then
//   P_{j-1} V_{j-1}, and the softmax of S_j runs while the latter is on the
//   tensor cores. Tiles above the causal diagonal are skipped, only the
//   diagonal tile is masked, and a head's heaviest (last) q-tiles start
//   first. Two stages left the loads' latency exposed; the third fills the
//   shared memory.
// - B3, per 128-row k-tile with K and V resident, Q and dO streamed in
//   64-row tiles with m log2(e) + log2(l) and dsum: S^T = K Q^T and dP^T =
//   V dO^T, P^T recomputed in registers, dV += P^T dO issued, dS^T = P^T
//   (dP^T - dsum) formed while it runs, then dK += dS^T Q; P^T and dS^T are
//   register A operands, dO and Q MN-major B operands. No atomics: the result
//   is deterministic.
// - B2, per 128-row q-tile with Q and dO resident (TMA, once), K and V
//   tiles of 64 rows through a four-stage ring on one barrier a stage: S = Q
//   K^T and dP = dO V^T (all four operands K-major), then dQ += dS K with
//   dS from registers and the same K tile read as the MN-major B operand.
//   Each thread's two q rows are fixed, so c and dsum stay in registers
//   from the start. Iteration j issues S_j and dP_j and then dS_{j-1}
//   K_{j-1}, and forms dS_j = P_j (dP_j - dsum) while the latter is on the
//   tensor cores; first and last iterations are peeled, as in B1. k-tiles of
//   64 rows because registers, not shared memory, bound the tile: the dQ
//   accumulator (64 f32 a thread at D = 128), S, dP and dS's hi and lo
//   fragments (32 each) come to 160 of the consumers' 240, and 128-row
//   tiles would need 256. Four stages, with Q and dO, fill 192 KB of shared
//   memory at D = 128. Tiles above the causal diagonal are skipped, only
//   the diagonal, ragged and bias tiles are masked, and no atomics are
//   needed: a block owns its dQ rows.
// - Precision of the second products. The TPU kernels round P and dS once to
//   bf16 (p.astype(v.dtype), ds.astype(q.dtype)). Here that missed the
//   per-element tolerance against the f32 plain versions at the training
//   shape several times over: B1 rounds p against the running row max, not
//   the final one, and B3's dS differs from the plain one before rounding.
//   So P (B1), dS (B2) and P^T, dS^T (B3) enter as two bf16 fragments, hi =
//   bf16(x) and lo = bf16(x - hi), about 16 bits of x, at the cost of one
//   more wgmma for each of them: three products in B1, four in B2 and six in
//   B3 where the TPU does two, three and four.
//
// The masking algebra is the TPU kernel's, as in flash_attention.cu: the
// finite NEG_INF, p = 0 where s <= NEG_INF / 2, l = 0 and output 0 for rows
// that see no key.
//
// The f32 path keeps flash_attention.cu's CUDA-core kernels: the tensor
// cores take f32 only as TF32, too coarse for its tolerance.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NT = 384;           // threads: consumer warpgroups 0 and 1, producer 2
constexpr int CONSUMER_WARPS = 8;
constexpr int ROW_BYTES = 128;    // one swizzled row of a 64-column box

// ------------------------------------------------------------ PTX wrappers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 4-D tensor map, coordinates (d, h, t, b), into shared memory;
// completion is reported to the barrier as transaction bytes.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d, int h, int t, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d), "r"(h), "r"(t), "r"(b)
      : "memory");
}

template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N of this warpgroup's committed wgmma groups are
// pending; groups complete in the order they were committed.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Named barriers over the two consumer warpgroups (256 threads): one
// warpgroup waits at its own while the other arrives.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma's issue or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor for a tile in the 128-byte swizzle. For a
// K-major operand (rows of 64 contiguous k values) lbo is unused and sbo is
// the stride of 8-row groups (1024 bytes). For an MN-major operand (rows of
// 64 contiguous m or n values, one row per k) lbo is the stride between
// 64-wide column boxes and sbo the stride of 8-row (8 k) groups.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// 2^x by the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to 0, where the softmax's terms are negligible).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The k-step kk (16 columns) of an m64 f32 accumulator fragment as two bf16
// A-operand fragments of the next wgmmas, hi = bf16(x) and lo = bf16(x - hi):
// the accumulator and A layouts agree element for element, and hi + lo keeps
// x to about 16 bits.
template <int N>
__device__ __forceinline__ void acc_to_a2(const float (&d)[N], int kk, uint32_t (&hi)[4],
                                          uint32_t (&lo)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float x0 = d[8 * kk + 2 * r], x1 = d[8 * kk + 2 * r + 1];
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    hi[r] = *reinterpret_cast<const uint32_t*>(&h);
    lo[r] = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
  }
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]^T, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128]^T, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A in registers, B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// An m64nN f32 accumulator fragment: thread t of the warpgroup holds d[i] at
// row 16 (t / 32) + (t % 32) / 4 + 8 ((i >> 1) & 1) and column 8 (i >> 2) +
// 2 (t % 4) + (i & 1).

// ---------------------------------------------------------------- B1 forward

// One tile of the online softmax on an m64nN score fragment, in place: the
// masked, scaled scores x = s * scale (+ bias), the running row max m and
// the rescale corr = exp(m_old - m), then p = exp(x - m), with p = 0 where
// x <= NEG_INF / 2 (rows still fully masked have m == NEG_INF, where exp(x -
// m) would be 1). l stays a per-thread partial sum over this thread's
// columns until the epilogue; the rescale is the same for the four lanes of
// a row.
template <bool MASKED, int N>
__device__ __forceinline__ void online_softmax(float (&sc)[N], float (&m_run)[2],
                                               float (&l_run)[2], float (&corr)[2], float scale,
                                               const float* bb, int k0, int Tk, int causal,
                                               int row0, int c2) {
  float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int rr = (i >> 1) & 1, kp = k0 + 8 * (i >> 2) + c2 + (i & 1);
    float x = sc[i] * scale;
    if (MASKED) {
      if (bb != nullptr && kp < Tk) x += bb[kp];
      if (kp >= Tk || (causal && row0 + 8 * rr < kp)) x = NEG_INF;
    }
    sc[i] = x;
    mx[rr] = fmaxf(mx[rr], x);
  }
  float neg_m[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
    mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
    corr[rr] = exp2_approx((m_run[rr] - mx[rr]) * LOG2E);
    neg_m[rr] = -mx[rr] * LOG2E;
    m_run[rr] = mx[rr];
  }
  float ls[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int rr = (i >> 1) & 1;
    float p = exp2_approx(fmaf(sc[i], LOG2E, neg_m[rr]));
    if (MASKED && sc[i] <= NEG_INF / 2) p = 0.f;
    sc[i] = p;
    ls[rr] += p;
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) l_run[rr] = l_run[rr] * corr[rr] + ls[rr];
}


template <int D>
struct Fwd {
  static constexpr int BQ = 128;  // q rows a block (64 a consumer warpgroup)
  static constexpr int BK = 128;  // k rows a streamed tile
  static constexpr int STAGES = 3;  // all the shared memory holds: the loads' latency shows at 2
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int Q_BOX = BQ * ROW_BYTES;   // one 64-column box of the q-tile
  static constexpr int KV_BOX = BK * ROW_BYTES;  // of a k or v tile
  static constexpr size_t SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 3 * STAGES);
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
    fa_fwd_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ m_out,
                       float* __restrict__ l_out, int H, int Tq, int Tk, float scale, int causal) {
  using C = Fwd<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;  // the swizzle needs 1024-byte alignment
  const uint32_t sK = sQ + C::Q_BYTES;
  const uint32_t sV = sK + C::STAGES * C::KV_BYTES;
  const uint32_t bar_q = sV + C::STAGES * C::KV_BYTES;
  const uint32_t bar_k = bar_q + 8;                  // [C::STAGES] K arrived
  const uint32_t bar_v = bar_k + 8 * C::STAGES;      // [C::STAGES] V arrived
  const uint32_t bar_empty = bar_v + 8 * C::STAGES;  // [C::STAGES]

  // A head's q-tiles are neighbours in the grid, so the blocks in flight
  // share few heads' K and V in L2; within a head the heaviest (last)
  // q-tiles start first.
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int nq = (Tq + C::BQ - 1) / C::BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * C::BQ;
  const int nk_all = (Tk + C::BK - 1) / C::BK;
  const int nk = causal ? min(nk_all, (q0 + C::BQ - 1) / C::BK + 1) : nk_all;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    regs_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
      for (int x = 0; x < D / 64; ++x) tma_load(sQ + x * C::Q_BOX, &tm_q, bar_q, 64 * x, h, q0, b);
      for (int it = 0; it < nk; ++it) {
        const int s = it % C::STAGES;
        mbar_wait(bar_empty + 8 * s, ((it / C::STAGES) & 1) ^ 1);
        // K and V report separately: S needs K a phase before P V needs V.
        mbar_expect_tx(bar_k + 8 * s, C::KV_BYTES);
#pragma unroll
        for (int x = 0; x < D / 64; ++x)
          tma_load(sK + s * C::KV_BYTES + x * C::KV_BOX, &tm_k, bar_k + 8 * s, 64 * x, h,
                   it * C::BK, b);
        mbar_expect_tx(bar_v + 8 * s, C::KV_BYTES);
#pragma unroll
        for (int x = 0; x < D / 64; ++x)
          tma_load(sV + s * C::KV_BYTES + x * C::KV_BOX, &tm_v, bar_v + 8 * s, 64 * x, h,
                   it * C::BK, b);
      }
    }
  } else {  // consumers: warpgroup wg owns q rows q0 + 64 wg ...
    regs_inc<240>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32, c2 = 2 * (lane & 3);
    const int q_first = q0 + 64 * wg;
    const int row0 = q_first + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
    const float* bb = bias == nullptr ? nullptr : bias + (int64_t)b * Tk;

    float acc[D / 2], sc[C::BK / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < C::BK / 2; ++i) sc[i] = 0.f;
    float m_run[2] = {NEG_INF, NEG_INF}, l_run[2] = {0.f, 0.f}, corr[2];
    uint32_t p_hi[C::BK / 16][4], p_lo[C::BK / 16][4];

    // Iteration j issues S_j = Q K_j^T and then O += P_{j-1} V_{j-1}; the
    // softmax of S_j runs while the second product is on the tensor cores.
    // The warpgroups take turns to issue (named barriers 1 and 2, warpgroup
    // 0 first), so one's softmax overlaps the other's products.
    const uint64_t desc_q = sw128_desc(sQ + 64 * wg * ROW_BYTES, 16, 1024);
    // S_j into sc, over D in k-steps of 16: box kk / 4, 32 bytes a step inside it.
    auto issue_s = [&](int j) {
      const uint64_t dk = sw128_desc(sK + (j % C::STAGES) * C::KV_BYTES, 16, 1024);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc, desc_q + ((kk / 4) * C::Q_BOX + (kk % 4) * 32) / 16,
                 dk + ((kk / 4) * C::KV_BOX + (kk % 4) * 32) / 16, kk > 0);
      wgmma_commit();
    };
    // O += P_j V_j, P as bf16 hi + lo from registers, V MN-major (rows of 64
    // d values per k; the two d boxes lie KV_BOX apart).
    auto issue_pv = [&](int j) {
      const uint64_t dv =
          sw128_desc(sV + (j % C::STAGES) * C::KV_BYTES, C::KV_BOX, 1024);
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk) {
        wgmma_rs(acc, p_hi[kk], dv + kk * 16 * ROW_BYTES / 16);
        wgmma_rs(acc, p_lo[kk], dv + kk * 16 * ROW_BYTES / 16);
      }
      wgmma_commit();
    };
    // The softmax of S_j in place; masking is needed with a bias, on the
    // ragged key edge and on the causal diagonal, and other tiles skip it.
    auto softmax = [&](int j) {
      fence_regs(sc);
      const int k0 = j * C::BK;
      if (bb != nullptr || k0 + C::BK > Tk || (causal && k0 + C::BK - 1 > q_first))
        online_softmax<true>(sc, m_run, l_run, corr, scale, bb, k0, Tk, causal, row0, c2);
      else
        online_softmax<false>(sc, m_run, l_run, corr, scale, bb, k0, Tk, causal, row0, c2);
    };
    // After P_{j-1} V_{j-1}: free its stage, rescale O, and pack P_j.
    auto rescale_pack = [&]() {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk) acc_to_a2(sc, kk, p_hi[kk], p_lo[kk]);
    };
    auto release = [&](int j) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * (j % C::STAGES));
    };

    if (wg == 1) named_arrive(1);
    mbar_wait(bar_q, 0);
    mbar_wait(bar_k, 0);
    named_sync(1 + wg);
    wgmma_fence();
    issue_s(0);
    named_arrive(2 - wg);
    wgmma_wait<0>();
    softmax(0);
    rescale_pack();
    for (int j = 1; j < nk; ++j) {
      mbar_wait(bar_k + 8 * (j % C::STAGES), (j / C::STAGES) & 1);
      mbar_wait(bar_v + 8 * ((j - 1) % C::STAGES), ((j - 1) / C::STAGES) & 1);
      named_sync(1 + wg);
      wgmma_fence();
      issue_s(j);
      issue_pv(j - 1);
      named_arrive(2 - wg);
      wgmma_wait<1>();
      softmax(j);
      wgmma_wait<0>();
      fence_regs(acc);
      release(j - 1);
      rescale_pack();
    }
    mbar_wait(bar_v + 8 * ((nk - 1) % C::STAGES), ((nk - 1) / C::STAGES) & 1);
    named_sync(1 + wg);
    wgmma_fence();
    issue_pv(nk - 1);
    if (wg == 0) named_arrive(2);
    wgmma_wait<0>();
    fence_regs(acc);
    release(nk - 1);

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float l = l_run[rr];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const int row = row0 + 8 * rr;
      if (row >= Tq) continue;
      const float den = l == 0.f ? 1.f : l;
      __nv_bfloat16* orow = o + (((int64_t)b * Tq + row) * H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int i = 4 * j + 2 * rr;
        *reinterpret_cast<uint32_t*>(orow + 8 * j + c2) =
            pack_bf16(acc[i] / den, acc[i + 1] / den);
      }
      if ((lane & 3) == 0) {
        m_out[(int64_t)bh * Tq + row] = m_run[rr];
        l_out[(int64_t)bh * Tq + row] = l;
      }
    }
  }
}

// ------------------------------------------------------------- B3 dK/dV pass

// P^T of one tile from the S^T fragment (key rows kr[], q columns q0 + ...),
// as recompute_p_ds forms it: p = exp2(x log2(e) - c) with c = m log2(e) +
// log2(l) from the stage's statistics sm. Packed to bf16 hi + lo A fragments.
template <bool MASKED, int N>
__device__ __forceinline__ void probs(float (&st)[N], const float* sm, const int (&kr)[2],
                                      const float (&kb)[2], float scale, int q0, int Tq,
                                      int Tk, int causal, int c2, uint32_t (&p_hi)[N / 8][4],
                                      uint32_t (&p_lo)[N / 8][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int rr = (i >> 1) & 1, qc = 8 * (i >> 2) + c2 + (i & 1);
    float x = st[i] * scale;
    if (MASKED) x += kb[rr];
    float p = exp2_approx(fmaf(x, LOG2E, -sm[qc]));
    if (MASKED && (x <= NEG_INF / 2 || q0 + qc >= Tq || kr[rr] >= Tk ||
                   (causal && q0 + qc < kr[rr])))
      p = 0.f;
    st[i] = p;
  }
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) acc_to_a2(st, kk, p_hi[kk], p_lo[kk]);
}

// dS^T = P^T (dP^T - dsum) from the dP^T fragment and P^T as hi + lo (16
// bits of it, the P that dV used), packed to bf16 hi + lo A fragments.
template <int N>
__device__ __forceinline__ void dscores(float (&dpt)[N], const uint32_t (&p_hi)[N / 8][4],
                                        const uint32_t (&p_lo)[N / 8][4], const float* dsum,
                                        int c2, uint32_t (&ds_hi)[N / 8][4],
                                        uint32_t (&ds_lo)[N / 8][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int qc = 8 * (i >> 2) + c2 + (i & 1);
    const uint32_t h = p_hi[i / 8][(i % 8) / 2], l = p_lo[i / 8][(i % 8) / 2];
    const float p = (i & 1) ? __uint_as_float(h & 0xffff0000u) + __uint_as_float(l & 0xffff0000u)
                            : __uint_as_float(h << 16) + __uint_as_float(l << 16);
    dpt[i] = p * (dpt[i] - dsum[qc]);
  }
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) acc_to_a2(dpt, kk, ds_hi[kk], ds_lo[kk]);
}

template <int D>
struct Dkv {
  static constexpr int BK = 128;  // k rows a block (64 a consumer warpgroup)
  static constexpr int BQ = 64;   // q rows a streamed tile
  static constexpr int STAGES = 2;
  static constexpr int K_BYTES = BK * D * 2;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int K_BOX = BK * ROW_BYTES;
  static constexpr int Q_BOX = BQ * ROW_BYTES;
  static constexpr int STATS = 2 * BQ;  // floats a stage: m log2(e) + log2(l), dsum
  static constexpr size_t SMEM = 1024 + 2 * K_BYTES + 2 * STAGES * Q_BYTES +
                                 STAGES * STATS * sizeof(float) + 8 * (1 + 2 * STAGES);
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
    fa_bwd_dkv_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ m,
                           const float* __restrict__ l, const float* __restrict__ dsum,
                           const float* __restrict__ bias, __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int H, int Tq, int Tk, float scale,
                           int causal) {
  using C = Dkv<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t sK = (raw + 1023) & ~1023u;
  const uint32_t sV = sK + C::K_BYTES;
  const uint32_t sQ = sV + C::K_BYTES;                 // [C::STAGES]
  const uint32_t sDO = sQ + C::STAGES * C::Q_BYTES;       // [C::STAGES]
  const uint32_t sStats = sDO + C::STAGES * C::Q_BYTES;  // [C::STAGES][STATS] f32
  float* stats = reinterpret_cast<float*>(smem_raw + (sStats - raw));
  const uint32_t bar_kv = sStats + C::STAGES * C::STATS * sizeof(float);
  const uint32_t bar_full = bar_kv + 8;
  const uint32_t bar_empty = bar_full + 8 * C::STAGES;

  // A head's k-tiles are neighbours in the grid (its Q and dO stay in L2);
  // the first k-tiles see the most q-tiles and start first.
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * C::BK;
  const int nq = (Tq + C::BQ - 1) / C::BQ;
  const int iq0 = causal ? k0 / C::BQ : 0;  // q-tiles above this k-tile see none of it
  const int n_it = max(0, nq - iq0);
  const int64_t stat0 = (int64_t)bh * Tq;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 32);  // the producer warp's lanes; lane 0's carries the bytes
      mbar_init(bar_empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer: its first warp
    regs_dec<24>();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x / 32 == 8) {
      if (lane == 0) {
        mbar_expect_tx(bar_kv, 2 * C::K_BYTES);
#pragma unroll
        for (int x = 0; x < D / 64; ++x) {
          tma_load(sK + x * C::K_BOX, &tm_k, bar_kv, 64 * x, h, k0, b);
          tma_load(sV + x * C::K_BOX, &tm_v, bar_kv, 64 * x, h, k0, b);
        }
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % C::STAGES, q0 = (iq0 + it) * C::BQ;
        mbar_wait(bar_empty + 8 * s, ((it / C::STAGES) & 1) ^ 1);
        // Row statistics: p = exp(x - m) / l is exp2(x log2(e) - c) with
        // c = m log2(e) + log2(l), after the l == 0 -> 1 guard. Rows past Tq
        // get neutral values and are masked by the consumers.
        float* st = stats + s * C::STATS;
        for (int r = lane; r < C::BQ; r += 32) {
          const int tq = q0 + r;
          const bool in = tq < Tq;
          const float lv = in ? l[stat0 + tq] : 1.f;
          st[r] = in ? fmaf(m[stat0 + tq], LOG2E, __log2f(lv == 0.f ? 1.f : lv)) : 0.f;
          st[C::BQ + r] = in ? dsum[stat0 + tq] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(bar_full + 8 * s, 2 * C::Q_BYTES);
#pragma unroll
          for (int x = 0; x < D / 64; ++x) {
            tma_load(sQ + s * C::Q_BYTES + x * C::Q_BOX, &tm_q, bar_full + 8 * s, 64 * x, h, q0,
                     b);
            tma_load(sDO + s * C::Q_BYTES + x * C::Q_BOX, &tm_do, bar_full + 8 * s, 64 * x, h,
                     q0, b);
          }
        } else {
          mbar_arrive(bar_full + 8 * s);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns k rows k0 + 64 wg ...
    regs_inc<240>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32, c2 = 2 * (lane & 3);
    const int k_first = k0 + 64 * wg, k_last = k_first + 63;
    int kr[2];
    float kb[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      kr[rr] = k_first + 16 * warp + lane / 4 + 8 * rr;  // this thread's key rows
      kb[rr] = (bias != nullptr && kr[rr] < Tk) ? bias[(int64_t)b * Tk + kr[rr]] : 0.f;
    }

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      dk_acc[i] = 0.f;
      dv_acc[i] = 0.f;
    }

    // The warpgroups take turns to issue the first two products (named
    // barriers 1 and 2, warpgroup 0 first), so that one's elementwise work
    // overlaps the other's products.
    if (wg == 1 && n_it > 0) named_arrive(1);
    mbar_wait(bar_kv, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % C::STAGES, q0 = (iq0 + it) * C::BQ;
      mbar_wait(bar_full + 8 * s, (it / C::STAGES) & 1);
      named_sync(1 + wg);

      // S^T = K Q^T and dP^T = V dO^T: all four operands K-major.
      float st[C::BQ / 2], dpt[C::BQ / 2];
#pragma unroll
      for (int i = 0; i < C::BQ / 2; ++i) {
        st[i] = 0.f;
        dpt[i] = 0.f;
      }
      const uint64_t d_k = sw128_desc(sK + 64 * wg * ROW_BYTES, 16, 1024);
      const uint64_t d_v = sw128_desc(sV + 64 * wg * ROW_BYTES, 16, 1024);
      const uint64_t d_q = sw128_desc(sQ + s * C::Q_BYTES, 16, 1024);
      const uint64_t d_do = sw128_desc(sDO + s * C::Q_BYTES, 16, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = ((kk / 4) * C::K_BOX + (kk % 4) * 32) / 16;
        const uint32_t b_off = ((kk / 4) * C::Q_BOX + (kk % 4) * 32) / 16;
        wgmma_ss(st, d_k + a_off, d_q + b_off, kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = ((kk / 4) * C::K_BOX + (kk % 4) * 32) / 16;
        const uint32_t b_off = ((kk / 4) * C::Q_BOX + (kk % 4) * 32) / 16;
        wgmma_ss(dpt, d_v + a_off, d_do + b_off, kk > 0);
      }
      wgmma_commit();
      if (wg == 0 || it + 1 < n_it) named_arrive(2 - wg);
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T first; dV += P^T dO runs on the tensor cores while dS^T is
      // formed, then dK += dS^T Q. P^T and dS^T enter as bf16 hi + lo; dO and
      // Q are MN-major (rows of 64 d values per q; the two d boxes lie Q_BOX
      // apart). Masking is needed with a bias, on the ragged edges and on the
      // causal diagonal; other tiles skip it.
      const float* sm = stats + s * C::STATS;
      uint32_t p_hi[C::BQ / 16][4], p_lo[C::BQ / 16][4], ds_hi[C::BQ / 16][4],
          ds_lo[C::BQ / 16][4];
      if (bias != nullptr || q0 + C::BQ > Tq || k_last >= Tk || (causal && q0 < k_last))
        probs<true>(st, sm, kr, kb, scale, q0, Tq, Tk, causal, c2, p_hi, p_lo);
      else
        probs<false>(st, sm, kr, kb, scale, q0, Tq, Tk, causal, c2, p_hi, p_lo);
      const uint64_t t_do = sw128_desc(sDO + s * C::Q_BYTES, C::Q_BOX, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::BQ / 16; ++kk) {
        wgmma_rs(dv_acc, p_hi[kk], t_do + kk * 16 * ROW_BYTES / 16);
        wgmma_rs(dv_acc, p_lo[kk], t_do + kk * 16 * ROW_BYTES / 16);
      }
      wgmma_commit();
      dscores(dpt, p_hi, p_lo, sm + C::BQ, c2, ds_hi, ds_lo);
      const uint64_t t_q = sw128_desc(sQ + s * C::Q_BYTES, C::Q_BOX, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::BQ / 16; ++kk) {
        wgmma_rs(dk_acc, ds_hi[kk], t_q + kk * 16 * ROW_BYTES / 16);
        wgmma_rs(dk_acc, ds_lo[kk], t_q + kk * 16 * ROW_BYTES / 16);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    }

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      if (kr[rr] >= Tk) continue;
      const int64_t off = (((int64_t)b * Tk + kr[rr]) * H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int i = 4 * j + 2 * rr;
        *reinterpret_cast<uint32_t*>(dk + off + 8 * j + c2) =
            pack_bf16(dk_acc[i] * scale, dk_acc[i + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + off + 8 * j + c2) = pack_bf16(dv_acc[i], dv_acc[i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------- B2 dQ pass

// dS = p (dP - dsum) of one tile, in place in the dP fragment (q rows row0
// and row0 + 8, key columns k0 + ...), as recompute_p_ds forms it: p =
// exp2(x log2(e) - c) of the masked, scaled score x, with c = m log2(e) +
// log2(l) of the row, and p = 0 where x <= NEG_INF / 2.
template <bool MASKED, int N>
__device__ __forceinline__ void dq_scores(const float (&sc)[N], float (&dp)[N],
                                          const float (&c)[2], const float (&dsr)[2], float scale,
                                          const float* bb, int k0, int Tk, int causal, int row0,
                                          int c2) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int rr = (i >> 1) & 1, kp = k0 + 8 * (i >> 2) + c2 + (i & 1);
    float x = sc[i] * scale;
    if (MASKED) {
      if (bb != nullptr && kp < Tk) x += bb[kp];
      if (kp >= Tk || (causal && row0 + 8 * rr < kp)) x = NEG_INF;
    }
    float p = exp2_approx(fmaf(x, LOG2E, -c[rr]));
    if (MASKED && x <= NEG_INF / 2) p = 0.f;
    dp[i] = p * (dp[i] - dsr[rr]);
  }
}

template <int D>
struct Dq {
  static constexpr int BQ = 128;  // q rows a block (64 a consumer warpgroup)
  static constexpr int BK = 64;   // k rows a streamed tile: at 128 S, dP and dS would spill
  static constexpr int STAGES = 4;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int Q_BOX = BQ * ROW_BYTES;
  static constexpr int KV_BOX = BK * ROW_BYTES;
  static constexpr size_t SMEM =
      1024 + 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 2 * STAGES);
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
    fa_bwd_dq_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do, const float* __restrict__ m,
                          const float* __restrict__ l, const float* __restrict__ dsum,
                          const float* __restrict__ bias, __nv_bfloat16* __restrict__ dq, int H,
                          int Tq, int Tk, float scale, int causal) {
  using C = Dq<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sDO = sQ + C::Q_BYTES;
  const uint32_t sK = sDO + C::Q_BYTES;                 // [C::STAGES]
  const uint32_t sV = sK + C::STAGES * C::KV_BYTES;     // [C::STAGES]
  const uint32_t bar_q = sV + C::STAGES * C::KV_BYTES;  // Q and dO arrived
  const uint32_t bar_full = bar_q + 8;                  // [C::STAGES] K and V arrived
  const uint32_t bar_empty = bar_full + 8 * C::STAGES;  // [C::STAGES]

  // As in B1: a head's q-tiles are neighbours in the grid, and the heaviest
  // (last) q-tiles start first.
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int nq = (Tq + C::BQ - 1) / C::BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * C::BQ;
  const int nk_all = (Tk + C::BK - 1) / C::BK;
  const int nk = causal ? min(nk_all, (q0 + C::BQ - 1) / C::BK + 1) : nk_all;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {  // producer
    regs_dec<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(bar_q, 2 * C::Q_BYTES);
#pragma unroll
      for (int x = 0; x < D / 64; ++x) {
        tma_load(sQ + x * C::Q_BOX, &tm_q, bar_q, 64 * x, h, q0, b);
        tma_load(sDO + x * C::Q_BOX, &tm_do, bar_q, 64 * x, h, q0, b);
      }
      for (int it = 0; it < nk; ++it) {
        const int s = it % C::STAGES;
        mbar_wait(bar_empty + 8 * s, ((it / C::STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * C::KV_BYTES);
#pragma unroll
        for (int x = 0; x < D / 64; ++x) {
          tma_load(sK + s * C::KV_BYTES + x * C::KV_BOX, &tm_k, bar_full + 8 * s, 64 * x, h,
                   it * C::BK, b);
          tma_load(sV + s * C::KV_BYTES + x * C::KV_BOX, &tm_v, bar_full + 8 * s, 64 * x, h,
                   it * C::BK, b);
        }
      }
    }
  } else {  // consumers: warpgroup wg owns q rows q0 + 64 wg ...
    regs_inc<240>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32, c2 = 2 * (lane & 3);
    const int q_first = q0 + 64 * wg;
    const int row0 = q_first + 16 * warp + lane / 4;  // this thread's rows: row0, row0 + 8
    const float* bb = bias == nullptr ? nullptr : bias + (int64_t)b * Tk;

    // The rows' statistics stay in registers: c = m log2(e) + log2(l) after
    // the l == 0 -> 1 guard, and dsum. Rows past Tq get c = -NEG_INF, so
    // that every p of theirs is 0, and write nothing.
    float c[2], dsr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = row0 + 8 * rr;
      const bool in = row < Tq;
      const float lv = in ? l[(int64_t)bh * Tq + row] : 1.f;
      c[rr] = in ? fmaf(m[(int64_t)bh * Tq + row], LOG2E, __log2f(lv == 0.f ? 1.f : lv))
                 : -NEG_INF;
      dsr[rr] = in ? dsum[(int64_t)bh * Tq + row] : 0.f;
    }

    float acc[D / 2], sc[C::BK / 2], dp[C::BK / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < C::BK / 2; ++i) {
      sc[i] = 0.f;
      dp[i] = 0.f;
    }
    uint32_t ds_hi[C::BK / 16][4], ds_lo[C::BK / 16][4];

    // Iteration j issues S_j = Q K_j^T and dP_j = dO V_j^T, then dQ +=
    // dS_{j-1} K_{j-1}; dS_j is formed while the latter is on the tensor
    // cores. The warpgroups take turns to issue, as in B1.
    const uint64_t desc_q = sw128_desc(sQ + 64 * wg * ROW_BYTES, 16, 1024);
    const uint64_t desc_do = sw128_desc(sDO + 64 * wg * ROW_BYTES, 16, 1024);
    // S_j and dP_j, all four operands K-major, over D in k-steps of 16.
    auto issue_sdp = [&](int j) {
      const uint32_t st = (j % C::STAGES) * C::KV_BYTES;
      const uint64_t dk = sw128_desc(sK + st, 16, 1024), dv = sw128_desc(sV + st, 16, 1024);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc, desc_q + ((kk / 4) * C::Q_BOX + (kk % 4) * 32) / 16,
                 dk + ((kk / 4) * C::KV_BOX + (kk % 4) * 32) / 16, kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dp, desc_do + ((kk / 4) * C::Q_BOX + (kk % 4) * 32) / 16,
                 dv + ((kk / 4) * C::KV_BOX + (kk % 4) * 32) / 16, kk > 0);
      wgmma_commit();
    };
    // dQ += dS_j K_j, dS as bf16 hi + lo from registers, the same K tile as
    // the MN-major B operand (rows of 64 d values per key; the two d boxes
    // lie KV_BOX apart).
    auto issue_dq = [&](int j) {
      const uint64_t dk = sw128_desc(sK + (j % C::STAGES) * C::KV_BYTES, C::KV_BOX, 1024);
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk) {
        wgmma_rs(acc, ds_hi[kk], dk + kk * 16 * ROW_BYTES / 16);
        wgmma_rs(acc, ds_lo[kk], dk + kk * 16 * ROW_BYTES / 16);
      }
      wgmma_commit();
    };
    // dS_j in place in dP; masking is needed with a bias, on the ragged key
    // edge and on the causal diagonal, and other tiles skip it.
    auto scores = [&](int j) {
      fence_regs(sc);
      fence_regs(dp);
      const int k0 = j * C::BK;
      if (bb != nullptr || k0 + C::BK > Tk || (causal && k0 + C::BK - 1 > q_first))
        dq_scores<true>(sc, dp, c, dsr, scale, bb, k0, Tk, causal, row0, c2);
      else
        dq_scores<false>(sc, dp, c, dsr, scale, bb, k0, Tk, causal, row0, c2);
    };
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk) acc_to_a2(dp, kk, ds_hi[kk], ds_lo[kk]);
    };
    auto release = [&](int j) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * (j % C::STAGES));
    };

    if (wg == 1) named_arrive(1);
    mbar_wait(bar_q, 0);
    mbar_wait(bar_full, 0);
    named_sync(1 + wg);
    wgmma_fence();
    issue_sdp(0);
    named_arrive(2 - wg);
    wgmma_wait<0>();
    scores(0);
    pack();
    for (int j = 1; j < nk; ++j) {
      mbar_wait(bar_full + 8 * (j % C::STAGES), (j / C::STAGES) & 1);
      named_sync(1 + wg);
      wgmma_fence();
      issue_sdp(j);
      issue_dq(j - 1);
      named_arrive(2 - wg);
      wgmma_wait<1>();
      scores(j);
      wgmma_wait<0>();
      fence_regs(acc);
      release(j - 1);
      pack();
    }
    named_sync(1 + wg);
    wgmma_fence();
    issue_dq(nk - 1);
    if (wg == 0) named_arrive(2);
    wgmma_wait<0>();
    fence_regs(acc);
    release(nk - 1);

#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = row0 + 8 * rr;
      if (row >= Tq) continue;
      __nv_bfloat16* qrow = dq + (((int64_t)b * Tq + row) * H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int i = 4 * j + 2 * rr;
        *reinterpret_cast<uint32_t*>(qrow + 8 * j + c2) =
            pack_bf16(acc[i] * scale, acc[i + 1] * scale);
      }
    }
  }
}

// ------------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function; it is looked up through the
// runtime so that the library needs no link against libcuda.
inline cudaError_t encode_fn(EncodeTiledFn* out) {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  *out = fn;
  return cudaSuccess;
}

// A 4-D map over a contiguous bf16 [B, T, H, D] tensor, dims (D, H, T, B),
// boxes of 64 d values by `rows` t values, 128-byte swizzle, zero fill past T.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int B, int T, int H, int D,
                            int rows) {
  EncodeTiledFn fn;
  cudaError_t err = encode_fn(&fn);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)T * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, const float* bias, void* o,
               float* m, float* l, int B, int H, int Tq, int Tk, float scale, int causal,
               cudaStream_t stream) {
  using C = Fwd<D>;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = make_map(&tq, q, B, Tq, H, D, C::BQ)) != cudaSuccess ||
      (err = make_map(&tk, k, B, Tk, H, D, C::BK)) != cudaSuccess ||
      (err = make_map(&tv, v, B, Tk, H, D, C::BK)) != cudaSuccess)
    return (int)err;
  auto kernel = fa_fwd_kernel_sm90<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + C::BQ - 1) / C::BQ, B * H);
  kernel<<<grid, NT, C::SMEM, stream>>>(tq, tk, tv, bias, (__nv_bfloat16*)o, m, l, H, Tq, Tk,
                                        scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const float* m,
              const float* l, const float* dsum, const float* bias, void* dq, int B, int H,
              int Tq, int Tk, float scale, int causal, cudaStream_t stream) {
  using C = Dq<D>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = make_map(&tq, q, B, Tq, H, D, C::BQ)) != cudaSuccess ||
      (err = make_map(&tdo, dout, B, Tq, H, D, C::BQ)) != cudaSuccess ||
      (err = make_map(&tk, k, B, Tk, H, D, C::BK)) != cudaSuccess ||
      (err = make_map(&tv, v, B, Tk, H, D, C::BK)) != cudaSuccess)
    return (int)err;
  auto kernel = fa_bwd_dq_kernel_sm90<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tq + C::BQ - 1) / C::BQ, B * H);
  kernel<<<grid, NT, C::SMEM, stream>>>(tq, tk, tv, tdo, m, l, dsum, bias, (__nv_bfloat16*)dq, H,
                                        Tq, Tk, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const float* m,
               const float* l, const float* dsum, const float* bias, void* dk, void* dv, int B,
               int H, int Tq, int Tk, float scale, int causal, cudaStream_t stream) {
  using C = Dkv<D>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err;
  if ((err = make_map(&tq, q, B, Tq, H, D, C::BQ)) != cudaSuccess ||
      (err = make_map(&tdo, dout, B, Tq, H, D, C::BQ)) != cudaSuccess ||
      (err = make_map(&tk, k, B, Tk, H, D, C::BK)) != cudaSuccess ||
      (err = make_map(&tv, v, B, Tk, H, D, C::BK)) != cudaSuccess)
    return (int)err;
  auto kernel = fa_bwd_dkv_kernel_sm90<D>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Tk + C::BK - 1) / C::BK, B * H);
  kernel<<<grid, NT, C::SMEM, stream>>>(tq, tk, tv, tdo, m, l, dsum, bias, (__nv_bfloat16*)dk,
                                        (__nv_bfloat16*)dv, H, Tq, Tk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace sm90
