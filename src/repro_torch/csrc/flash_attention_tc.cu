// Flash attention (prefill) on Hopper's tensor cores: bf16 operands, f32
// accumulation, wgmma fed by TMA. Head dim 128.
//
// Replaces the TPU kernel
// repro/kernels/flash_attention/flash_attention.py (flash_attention_pallas)
// for bf16 at head dim 128, the width of every full-size dense config.
// flash_attention.cu (3xTF32 on the tensor cores) keeps f32 and the other
// head dims; kernels/flash_attention/ops.py::route chooses before any
// launch.
//
// What bounds it on an H100: operations. At the prefill shape (B=1, H=16,
// KV=2, S=8192, hd=128, causal) a call does 2.75e11 flops of bf16 products
// on ~75 MB: 0.278 ms at the 989 TFLOP/s dense bf16 tensor rate, 0.02 ms of
// memory. f32 arithmetic outside the tensor cores would take 4.1 ms (67
// TFLOP/s), so only the tensor cores can come near the bound.
//
// Design (the shape of FlashAttention-3, without its persistent
// scheduler):
// * one CTA of 384 threads per (128-row query tile, b*h); the causal grid
//   runs its heaviest query tiles first;
// * warpgroup 0 is the producer: `setmaxnreg` cuts it to 24 registers and
//   one thread issues TMA loads, Q once and 128-key K and V tiles into a
//   2-stage ring; K and V have full and empty mbarriers of their own, so
//   Q.K^T starts before V lands and a K tile is refilled as soon as its
//   product is done;
// * warpgroups 1 and 2 consume 64 query rows each, at 240 registers:
//   S = Q.K^T as 8 `wgmma.m64n128k16` over the head dim (A = Q and B = K
//   from shared memory, both K-major), the online softmax in registers
//   (a row lives on 4 threads of the accumulator layout: its max and sum
//   take two quad shuffles; scale*log2(e) is folded into one fma before
//   exp2f), then O += P.V as 8 `wgmma.m64n128k16` over the keys, with P
//   rounded to bf16 (round to nearest) and fed from registers in the
//   accumulator-to-A-fragment layout, and V from shared memory MN-major
//   (the head dim contiguous: the instruction's transpose bit for B);
// * the tensor cores are kept busy two ways: a warpgroup issues tile i's
//   Q.K^T together with tile i-1's P.V, so tile i's softmax runs while
//   that P.V is in flight; and the two warpgroups take turns issuing
//   (named barriers 1 and 2, "ping-pong"), so one's softmax runs under the
//   other's products;
// * shared memory: Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB. Each
//   128-wide tile is two TMA boxes of 64 columns (128 bytes, the widest a
//   128-byte swizzle allows), stored one after the other; the wgmma
//   descriptors use the same 128-byte swizzle (8-row atoms of 1024 bytes:
//   stride byte offset 1024; for V the leading byte offset is the 16 KB
//   between the two 64-column boxes);
// * tensor maps are built on the host per call over the strided
//   (B, S, heads, hd) storage and passed as __grid_constant__ parameters,
//   so a CUDA graph can capture the launch; TMA fills rows and keys past
//   the end with zeros.
// Semantics are the Pallas kernel's, as in flash_attention.cu: masked
// scores are the finite -1e30 and masked keys add p = 0 (only the diagonal
// tile and the ragged last tile are masked); the causal limit is kj <= qi
// and keys past sk are masked; the output is acc / max(l, 1e-30) (a row
// with no live key gives 0), rounded to bf16 (nearest even); rows >= sq
// are not stored. The row sum l is taken from the f32 p before rounding.
// The library builds with -fmad=false: each intended fused multiply-add
// is an explicit __fmaf_rn.
//
// ptxas (-Xptxas -v, sm_90a): 168 registers a thread at launch (the
// consumers raise theirs to 240 with setmaxnreg, the producer drops to 24),
// no spills; chip_smoke.py prints the build log.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "moby_kernels.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kHd = 128;               // head dim
constexpr int kBm = 128;               // query rows per CTA (2 x 64)
constexpr int kBn = 128;               // keys per tile
constexpr int kStages = 2;
constexpr int kThreads = 384;          // producer + 2 consumer warpgroups
constexpr int kBox = 64;               // TMA box width: 64 bf16 = 128 bytes
constexpr int kTileBytes = kBn * kHd * 2;          // 32 KB (K, V or Q)
constexpr int kHalfBytes = kTileBytes / 2;         // one 64-column box
constexpr int kSmemQ = 0;
constexpr int kSmemK = kSmemQ + kTileBytes;
constexpr int kSmemV = kSmemK + kStages * kTileBytes;
constexpr int kSmemBar = kSmemV + kStages * kTileBytes;   // 160 KB
constexpr int kNumBars = 1 + 4 * kStages;   // q; full and empty, K and V
constexpr int kSmemBytes = kSmemBar + 8 * kNumBars + 1024;  // + alignment
constexpr float kLog2e = 1.4426950408889634f;

// -- shared-memory barriers and TMA ------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One TMA box (64 head dims x 128 rows of one (b, head)) into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int d0, int row,
                                         int head, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(row),
      "r"(head), "r"(b)
      : "memory");
}

// -- wgmma ---------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle. Offsets in bytes.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma (as CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// The same for the A fragments, which wgmma reads after it is issued:
// their registers must hold until the wait.
__device__ __forceinline__ void fence_regs(uint32_t (&a)[kBn / 16][4]) {
#pragma unroll
  for (int i = 0; i < kBn / 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// Named barriers 1 and 2 over the 256 consumer threads: the two consumer
// warpgroups take turns issuing their products (ping-pong), so one's
// softmax runs while the other's products hold the tensor cores.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// D (64x128 f32) (+)= A (smem, K-major) * B (smem, K-major), k = 16;
// accumulate = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64x128 f32) += A (registers: bf16 pairs in the accumulator's row
// layout) * B (smem, MN-major: the transpose bit set), k = 16.
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __float22bfloat162_rn(make_float2(lo, hi));
  return *reinterpret_cast<const uint32_t*>(&v);
}


// S = Q.K^T for one warpgroup's 64 rows and a 128-key tile: 4 steps of 16
// over the head dim in each 64-wide box (not committed).
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_addr,
                                         uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < kHd / 16; ++kk) {
    const uint32_t off = (kk / 4) * kHalfBytes + (kk % 4) * 32;
    wgmma_ss(s, smem_desc(q_addr + off, 16, 1024),
             smem_desc(k_addr + off, 16, 1024), kk > 0);
  }
}

// O += P.V over the 128 keys of a tile: V is MN-major (the head dim
// contiguous); its two 64-column boxes lie 16 KB apart (the leading byte
// offset); each 16-key step is 2 KB further (not committed).
__device__ __forceinline__ void issue_pv(float (&acc)[64],
                                         const uint32_t (&p)[kBn / 16][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < kBn / 16; ++kk)
    wgmma_rs(acc, p[kk], smem_desc(v_addr + kk * 16 * 128, kHalfBytes, 1024));
}

// P (f32, rounded to bf16) as the A operand: register pairs of the
// accumulator are the A fragment of a 16-key step, in place.
__device__ __forceinline__ void pack_p(const float (&s)[64],
                                       uint32_t (&p)[kBn / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBn / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// A thread's two rows: running max (scaled by scale*log2 e) and sum.
struct RowState {
  float m_lo, m_hi, l_lo, l_hi;
};

// Folds a tile's scores into the running state of the thread's two rows
// and leaves p = exp2(s * scale_log2 - m) in s (f32). `mask`: the tile
// holds the diagonal or the ragged end; masked keys are set to -inf, so
// they add p = 0, and a row with no live key keeps m = -1e30. Returns the
// factors by which the accumulator so far must be scaled.
__device__ __forceinline__ float2 online_softmax(float (&s)[64], RowState& r,
                                                 bool mask, int k0, int col0,
                                                 int r_lo, int sk,
                                                 int causal,
                                                 float scale_log2) {
  if (mask) {
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      const int kj = k0 + (j / 4) * 8 + col0 + (j % 2);
      const int qi = r_lo + ((j / 2) % 2) * 8;
      if (kj >= sk || (causal && kj > qi)) s[j] = -INFINITY;
    }
  }
  float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    if ((j / 2) % 2) mx_hi = fmaxf(mx_hi, s[j]);
    else mx_lo = fmaxf(mx_lo, s[j]);
  }
#pragma unroll
  for (int x = 1; x <= 2; x <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, x));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, x));
  }
  const float mn_lo = fmaxf(r.m_lo, mx_lo * scale_log2);
  const float mn_hi = fmaxf(r.m_hi, mx_hi * scale_log2);
  const float2 corr = make_float2(exp2f(r.m_lo - mn_lo),
                                  exp2f(r.m_hi - mn_hi));
  r.m_lo = mn_lo;
  r.m_hi = mn_hi;
  float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const bool hi = (j / 2) % 2;
    s[j] = exp2f(__fmaf_rn(s[j], scale_log2, hi ? -mn_hi : -mn_lo));
    if (hi) sum_hi += s[j];
    else sum_lo += s[j];
  }
  r.l_lo = __fmaf_rn(r.l_lo, corr.x, sum_lo);
  r.l_hi = __fmaf_rn(r.l_hi, corr.y, sum_hi);
  return corr;
}

struct Shape {
  long long o_b, o_h, o_s;   // output strides in elements (head dim 1)
  int n_heads, group, sq, sk, causal;
  float scale_log2;          // hd^-0.5 * log2(e)
};

__global__ void __launch_bounds__(kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                __nv_bfloat16* __restrict__ o, const Shape a) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the tiles to it.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + kSmemBar;
  const uint32_t bar_fullk = bar_q + 8;                 // [kStages]
  const uint32_t bar_fullv = bar_fullk + 8 * kStages;   // [kStages]
  const uint32_t bar_emptyk = bar_fullv + 8 * kStages;  // [kStages]
  const uint32_t bar_emptyv = bar_emptyk + 8 * kStages; // [kStages]

  const int bh = blockIdx.y;
  const int b = bh / a.n_heads, h = bh % a.n_heads, kvh = h / a.group;
  const int qt = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kBm;
  // Keys past the tile's last query row are masked for every row.
  const int k_end = a.causal ? min(a.sk, q0 + kBm) : a.sk;
  const int n_tiles = (k_end + kBn - 1) / kBn;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_fullk + 8 * s, 1);
      mbar_init(bar_fullv + 8 * s, 1);
      mbar_init(bar_emptyk + 8 * s, kThreads - 128);  // every consumer thread
      mbar_init(bar_emptyv + 8 * s, kThreads - 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the TMA loads in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, kTileBytes);
      tma_load(base + kSmemQ, &qmap, bar_q, 0, q0, h, b);
      tma_load(base + kSmemQ + kHalfBytes, &qmap, bar_q, kBox, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t round = i / kStages;
        // The first round finds the ring empty (parity 1 passes at once).
        // K and V are released apart: K once S = Q.K^T is done, V once
        // P.V is, one tile later.
        const uint32_t kdst = base + kSmemK + s * kTileBytes;
        const uint32_t vdst = base + kSmemV + s * kTileBytes;
        mbar_wait(bar_emptyk + 8 * s, (round & 1) ^ 1);
        mbar_expect_tx(bar_fullk + 8 * s, kTileBytes);
        tma_load(kdst, &kmap, bar_fullk + 8 * s, 0, i * kBn, kvh, b);
        tma_load(kdst + kHalfBytes, &kmap, bar_fullk + 8 * s, kBox, i * kBn,
                 kvh, b);
        mbar_wait(bar_emptyv + 8 * s, (round & 1) ^ 1);
        mbar_expect_tx(bar_fullv + 8 * s, kTileBytes);
        tma_load(vdst, &vmap, bar_fullv + 8 * s, 0, i * kBn, kvh, b);
        tma_load(vdst + kHalfBytes, &vmap, bar_fullv + 8 * s, kBox, i * kBn,
                 kvh, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int t = threadIdx.x - 128 * wg;
    const int warp = t / 32, lane = t % 32;
    // Accumulator layout of wgmma m64nN (f32): register j of a thread holds
    // row r_lo (+8 when (j/2) is odd), column (j/4)*8 + col0 + (j%2).
    const int r_lo = q0 + 64 * (wg - 1) + 16 * warp + lane / 4;
    const int r_hi = r_lo + 8;
    const int col0 = 2 * (lane % 4);
    const uint32_t q_addr = base + kSmemQ + (wg - 1) * 64 * 128;

    float acc[64], s[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.0f;
    uint32_t p[kBn / 16][4];
    RowState r{kNeg, kNeg, 0.0f, 0.0f};
    const int me = wg - 1;   // this consumer; its turn is barrier 1 + me
    auto k_addr = [&](int i) {
      return base + kSmemK + (i % kStages) * kTileBytes;
    };
    auto v_addr = [&](int i) {
      return base + kSmemV + (i % kStages) * kTileBytes;
    };
    auto parity = [](int i) {
      return static_cast<uint32_t>(i / kStages) & 1;
    };
    auto mask = [&](int i) {
      return i * kBn + kBn > a.sk || (a.causal && i * kBn + kBn - 1 > q0);
    };

    // Tile i's S = Q.K^T is issued together with tile i-1's O += P.V, so
    // the softmax of tile i runs while P.V of tile i-1 is in flight. The
    // warpgroups issue in turns: n_tiles + 1 turns each; consumer 1 opens
    // consumer 0's first turn and skips the signal after its own last.
    mbar_wait(bar_q, 0);
    if (n_tiles > 0) {
      if (me == 1) bar_arrive(1);
      mbar_wait(bar_fullk, 0);
      bar_sync(1 + me);
      wgmma_fence();
      issue_qk(s, q_addr, k_addr(0));
      wgmma_commit();
      bar_arrive(2 - me);
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(bar_emptyk);
      online_softmax(s, r, mask(0), 0, col0, r_lo, a.sk, a.causal,
                     a.scale_log2);   // acc is 0: nothing to rescale
      pack_p(s, p);
      for (int i = 1; i < n_tiles; ++i) {
        mbar_wait(bar_fullk + 8 * (i % kStages), parity(i));
        mbar_wait(bar_fullv + 8 * ((i - 1) % kStages), parity(i - 1));
        bar_sync(1 + me);
        wgmma_fence();
        issue_qk(s, q_addr, k_addr(i));
        wgmma_commit();
        issue_pv(acc, p, v_addr(i - 1));
        wgmma_commit();
        bar_arrive(2 - me);
        wgmma_wait<1>();   // S of tile i (groups complete in order)
        fence_regs(s);
        mbar_arrive(bar_emptyk + 8 * (i % kStages));
        const float2 corr = online_softmax(s, r, mask(i), i * kBn, col0,
                                           r_lo, a.sk, a.causal,
                                           a.scale_log2);
        wgmma_wait<0>();   // P.V of tile i-1
        fence_regs(acc);
        fence_regs(p);
        mbar_arrive(bar_emptyv + 8 * ((i - 1) % kStages));
#pragma unroll
        for (int j = 0; j < 64; ++j) acc[j] *= (j / 2) % 2 ? corr.y : corr.x;
        pack_p(s, p);
      }
      const int last = n_tiles - 1;
      mbar_wait(bar_fullv + 8 * (last % kStages), parity(last));
      bar_sync(1 + me);
      wgmma_fence();
      issue_pv(acc, p, v_addr(last));
      wgmma_commit();
      if (me == 0) bar_arrive(2);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(p);
      mbar_arrive(bar_emptyv + 8 * (last % kStages));
    }
    float l_lo = r.l_lo, l_hi = r.l_hi;

#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, x);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, x);
    }
    const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
    __nv_bfloat16* ob = o + b * a.o_b + h * a.o_h;
#pragma unroll
    for (int j = 0; j < 64; j += 2) {
      const bool hi = (j / 2) % 2;
      const int qi = hi ? r_hi : r_lo;
      if (qi >= a.sq) continue;
      const float den = hi ? den_hi : den_lo;
      *reinterpret_cast<__nv_bfloat162*>(ob + qi * a.o_s + (j / 4) * 8 +
                                         col0) =
          __float22bfloat162_rn(make_float2(acc[j] / den, acc[j + 1] / den));
    }
  }
}

// cuTensorMapEncodeTiled, a driver-API call, reached through the runtime
// (no link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over (hd, S, heads, B) storage with element strides st =
// {b, h, s}: boxes of 64 head dims x 128 rows, 128-byte swizzle, rows past
// the end read as zeros.
int make_map(CUtensorMap* map, const void* ptr, int rows, int heads,
             int batch, const long long* st) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {kHd, static_cast<cuuint64_t>(rows > 0 ? rows : 1),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st[2]) * 2,
                                 static_cast<cuuint64_t>(st[1]) * 2,
                                 static_cast<cuuint64_t>(st[0]) * 2};
  const cuuint32_t box[4] = {kBox, kBn, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// bf16 q (B,H,SQ,128), k/v (B,KV,SK,128), o (B,H,SQ,128), each through
// element strides st = {q: b,h,s, k: b,h,s, v: b,h,s, o: b,h,s} with the
// head dim contiguous; base addresses 16-byte aligned and the strides of
// q, k and v multiples of 8 elements (TMA's 16 bytes). H is a multiple of
// KV. Returns a CUDA error code (cudaErrorInvalidValue when a tensor map
// cannot describe an operand).
MOBY_API int moby_flash_attention_tc(const void* q, const void* k,
                                     const void* v, void* o,
                                     const long long* st, int batch,
                                     int n_heads, int n_kv_heads, int sq,
                                     int sk, int causal, float scale,
                                     void* stream) {
  if (batch * n_heads == 0 || sq == 0) return 0;
  CUtensorMap qmap, kmap, vmap;
  int err = make_map(&qmap, q, sq, n_heads, batch, st);
  if (!err) err = make_map(&kmap, k, sk, n_kv_heads, batch, st + 3);
  if (!err) err = make_map(&vmap, v, sk, n_kv_heads, batch, st + 6);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Shape a{st[9], st[10], st[11], n_heads, n_heads / n_kv_heads, sq, sk,
                causal, scale * kLog2e};
  const dim3 grid((sq + kBm - 1) / kBm, batch * n_heads);
  flash_tc_kernel<<<grid, kThreads, kSmemBytes,
                    static_cast<cudaStream_t>(stream)>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), a);
  return static_cast<int>(cudaGetLastError());
}
