// Flash attention (prefill) on Hopper's tensor cores: bf16 operands, f32
// accumulation, wgmma fed by TMA. (qk, value) head dims (64, 64) (zamba2,
// whisper), (128, 128) (every full-size dense config) and (192, 128) (MLA:
// deepseek-v2's nope 128 + rope 64).
//
// Replaces the TPU kernel
// repro/kernels/flash_attention/flash_attention.py (flash_attention_pallas)
// for bf16 at head dims 64 and 128, and the JAX package's plain attention
// at MLA's (192, 128) (repro/models/layers.py::multihead_attention, which
// the Pallas kernel does not take). flash_attention.cu (3xTF32 on the
// tensor cores) keeps f32 and bf16 at head dims 16 and 32 (it also took
// bf16 at 64 until this instance did); kernels/flash_attention/ops.py::route
// chooses before any launch.
//
// What bounds it on an H100: operations. At the prefill shape (B=1, H=16,
// KV=2, S=8192, hd=128, causal) a call does 2.75e11 flops of bf16 products
// on ~75 MB: 0.278 ms at the 989 TFLOP/s dense bf16 tensor rate, 0.02 ms of
// memory. f32 arithmetic outside the tensor cores would take 4.1 ms (67
// TFLOP/s), so only the tensor cores can come near the bound. At MLA's
// prefill (B=1, H=KV=128, S=8192, qk 192, value 128, causal): 2.75e12
// flops, 2.78 ms. At zamba2's prefill (B=1, H=KV=32, S=8192, hd 64) the
// products are again 2.75e11 flops (0.278 ms), but a tile now has half the
// products for the same exponentials: 1.07e9 exp2 at the special-function
// units' 16 a clock an SM take as long, ~0.278 ms, so at hd 64 the kernel
// reaches its bound only if every tile's softmax runs under other tiles'
// products.
//
// Design (the shape of FlashAttention-3, without its persistent
// scheduler):
// * one CTA of 128 (NC + 1) threads per (64 NC-row query tile, b*h), NC = 2
//   consumer warpgroups at qk 128 and 192, 3 at hd 64; the causal grid runs
//   its heaviest query tiles first;
// * warpgroup 0 is the producer: `setmaxnreg` cuts it to 24 registers (32
//   at NC = 3) and one thread issues TMA loads, Q once and 128-key K and V
//   tiles into a 2-stage ring; K and V have full and empty mbarriers of
//   their own, so Q.K^T starts before V lands and a K tile is refilled as
//   soon as its product is done;
// * the consumer warpgroups take 64 query rows each, at 240 registers (160
//   at NC = 3): S = Q.K^T as QK / 16 `wgmma.m64n128k16` over the qk head
//   dim (4 at 64, 8 at 128, 12 at 192; A = Q and B = K from shared memory,
//   both K-major), the online softmax in registers (a row lives on 4
//   threads of the accumulator layout: its max and sum take two quad
//   shuffles; scale*log2(e) is folded into one fma before ex2), then O +=
//   P.V as 8 `wgmma.m64nVDk16` over the keys, with P rounded to bf16
//   (round to nearest) and fed from registers in the
//   accumulator-to-A-fragment layout, and V from shared memory MN-major
//   (the head dim contiguous: the instruction's transpose bit for B);
// * the tensor cores are kept busy two ways: a warpgroup issues tile i's
//   Q.K^T together with tile i-1's P.V, so tile i's softmax runs while
//   that P.V is in flight; and the consumers take turns issuing (named
//   barriers 1 .. NC, "ping-pong"), so one's softmax runs under the others'
//   products;
// * hd 64: the halved accumulators (O 64 x 64, 32 registers) and tiles
//   (one 16 KB box each) leave room for a third consumer warpgroup: a
//   192-row query tile reads each K/V tile from L2 for three softmaxes
//   instead of two, and the ping-pong has two warpgroups' products to hide
//   each softmax under (tools/tc_hd64_probe.py at zamba2's prefill: 6.6%
//   of the call with the exponentials below, 2% with exp2f). The
//   exponentials are `ex2.approx.ftz` alone (9.3%: exp2f's non-flushing
//   form adds a compare and two multiplies to each; 3.5% at hd 128);
// * shared memory: Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB at qk 128;
//   Q 48 KB + 2 x (K 48 KB + V 32 KB) = 208 KB at qk 192, so two stages
//   still fit the 227 KB; Q 24 KB + 2 x (16 KB + 16 KB) = 88 KB at hd 64.
//   Each tile is QK / 64 (Q, K) or VD / 64 (V) TMA boxes of 64 columns
//   (128 bytes, the widest a 128-byte swizzle allows) by 128 rows (Q: 64
//   NC rows), stored one after the other; the wgmma descriptors use the
//   same 128-byte swizzle (8-row atoms of 1024 bytes: stride byte offset
//   1024; for V the leading byte offset is the 16 KB between two 64-column
//   boxes). The S accumulator is 64 x 128 a consumer warpgroup at every
//   width, O 64 x VD;
// * tensor maps are built on the host per call over the strided
//   (B, S, heads, hd) storage and passed as __grid_constant__ parameters,
//   so a CUDA graph can capture the launch; TMA fills rows and keys past
//   the end with zeros.
// Semantics are the Pallas kernel's, as in flash_attention.cu: masked
// scores are the finite -1e30 and masked keys add p = 0 (only the diagonal
// tile and the ragged last tile are masked); the causal limit is kj <= qi
// and keys past sk are masked; the output is acc / max(l, 1e-30) (a row
// with no live key gives 0), rounded to bf16 (nearest even); rows >= sq
// are not stored. The row sum l is taken from the f32 p before rounding;
// p below 2^-126 is 0. The library builds with -fmad=false: each intended
// fused multiply-add is an explicit __fmaf_rn. The barrier, TMA, wgmma and
// ex2 helpers are hopper.cuh's, shared with flash_attention_bwd_tc.cu.
//
// ptxas (-Xptxas -v, sm_90a): 168 registers a thread at launch at qk 128
// and 192 (the consumers raise theirs to 240 with setmaxnreg, the producer
// drops to 24), 128 at hd 64 (consumers 160, producer 32), no spills;
// chip_smoke.py prints the build log.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "moby_kernels.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kBn = 128;               // keys per tile
constexpr int kStages = 2;
constexpr int kBox = 64;               // TMA box width: 64 bf16 = 128 bytes
constexpr int kKvBox = kBn * kBox * 2;      // a K or V box: 16 KB
constexpr int kNumBars = 1 + 4 * kStages;   // q; full and empty, K and V
constexpr float kLog2e = 1.4426950408889634f;

// An instance: qk head dim QK, value head dim VD, NC consumer warpgroups
// of 64 query rows each (a CTA's query tile is 64 NC rows). Shared memory:
// Q, then the K and V rings, then the barriers.
template <int QK, int VD, int NC>
struct Layout {
  static constexpr int kBm = 64 * NC;          // query rows per CTA
  static constexpr int kThreads = 128 * (NC + 1);
  // setmaxnreg: the producer's and each consumer's registers (at most
  // 65,536 over the CTA).
  static constexpr int kProducerRegs = NC == 2 ? 24 : 32;
  static constexpr int kConsumerRegs = NC == 2 ? 240 : 160;
  static constexpr int kQkBoxes = QK / kBox;
  static constexpr int kQBox = kBm * kBox * 2;              // a Q box
  static constexpr int kQBytes = kQkBoxes * kQBox;          // a Q tile
  static constexpr int kKBytes = kQkBoxes * kKvBox;         // a K tile
  static constexpr int kVBytes = VD / kBox * kKvBox;        // a V tile
  static constexpr int kAcc = VD / 2;     // O accumulator floats a thread
  static constexpr int kSmemQ = 0;
  static constexpr int kSmemK = kSmemQ + kQBytes;
  static constexpr int kSmemV = kSmemK + kStages * kKBytes;
  static constexpr int kSmemBar = kSmemV + kStages * kVBytes;
  static constexpr int kSmemBytes = kSmemBar + 8 * kNumBars + 1024;  // align
  static_assert(QK % kBox == 0 && (VD == 64 || VD == 128), "head dims");
  static_assert(NC == 2 || NC == 3, "consumer warpgroups");
  static_assert(128 * kProducerRegs + 128 * NC * kConsumerRegs <= 65536,
                "registers");
  static_assert(kSmemBytes <= 232448, "shared memory");
};

// Named barriers 1 .. NC, each between two consumer warpgroups (256
// threads): the consumers take turns issuing their products (ping-pong),
// so one's softmax runs while another's products hold the tensor cores.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// S = Q.K^T for one warpgroup's 64 rows and a 128-key tile: 4 steps of 16
// over the head dim in each 64-wide box; Q's boxes lie QBox bytes apart,
// K's 16 KB (not committed).
template <int QK, int QBox>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q_addr,
                                         uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < QK / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss(s, smem_desc(q_addr + (kk / 4) * QBox + col, 16, 1024),
             smem_desc(k_addr + (kk / 4) * kKvBox + col, 16, 1024), kk > 0);
  }
}

// O += P.V over the 128 keys of a tile: V is MN-major (the head dim
// contiguous); at VD 128 its two 64-column boxes lie 16 KB apart (the
// leading byte offset); each 16-key step is 2 KB further (not committed).
template <int VD>
__device__ __forceinline__ void issue_pv(float (&acc)[VD / 2],
                                         const uint32_t (&p)[kBn / 16][4],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < kBn / 16; ++kk)
    wgmma_rs_n<VD>(acc, p[kk],
                   smem_desc(v_addr + kk * 16 * 128, kKvBox, 1024));
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
  const float2 corr = make_float2(ex2_ftz(r.m_lo - mn_lo),
                                  ex2_ftz(r.m_hi - mn_hi));
  r.m_lo = mn_lo;
  r.m_hi = mn_hi;
  float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const bool hi = (j / 2) % 2;
    s[j] = ex2_ftz(__fmaf_rn(s[j], scale_log2, hi ? -mn_hi : -mn_lo));
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

template <int QK, int VD, int NC>
__global__ void __launch_bounds__(Layout<QK, VD, NC>::kThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                __nv_bfloat16* __restrict__ o, const Shape a) {
  using L = Layout<QK, VD, NC>;
  constexpr int kBm = L::kBm, kAcc = L::kAcc;
  constexpr int kSmemQ = L::kSmemQ, kSmemK = L::kSmemK, kSmemV = L::kSmemV;
  constexpr int kSmemBar = L::kSmemBar;
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
      mbar_init(bar_emptyk + 8 * s, 128 * NC);  // every consumer thread
      mbar_init(bar_emptyv + 8 * s, 128 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the TMA loads in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        L::kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar_q, L::kQBytes);
#pragma unroll
      for (int x = 0; x < L::kQkBoxes; ++x)
        tma_load(base + kSmemQ + x * L::kQBox, &qmap, bar_q, x * kBox, q0,
                 h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        const uint32_t round = i / kStages;
        // The first round finds the ring empty (parity 1 passes at once).
        // K and V are released apart: K once S = Q.K^T is done, V once
        // P.V is, one tile later.
        const uint32_t kdst = base + kSmemK + s * L::kKBytes;
        const uint32_t vdst = base + kSmemV + s * L::kVBytes;
        mbar_wait(bar_emptyk + 8 * s, (round & 1) ^ 1);
        mbar_expect_tx(bar_fullk + 8 * s, L::kKBytes);
#pragma unroll
        for (int x = 0; x < L::kQkBoxes; ++x)
          tma_load(kdst + x * kKvBox, &kmap, bar_fullk + 8 * s, x * kBox,
                   i * kBn, kvh, b);
        mbar_wait(bar_emptyv + 8 * s, (round & 1) ^ 1);
        mbar_expect_tx(bar_fullv + 8 * s, L::kVBytes);
#pragma unroll
        for (int x = 0; x < VD / kBox; ++x)
          tma_load(vdst + x * kKvBox, &vmap, bar_fullv + 8 * s, x * kBox,
                   i * kBn, kvh, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        L::kConsumerRegs));
    const int t = threadIdx.x - 128 * wg;
    const int warp = t / 32, lane = t % 32;
    // Accumulator layout of wgmma m64nN (f32): register j of a thread holds
    // row r_lo (+8 when (j/2) is odd), column (j/4)*8 + col0 + (j%2).
    const int r_lo = q0 + 64 * (wg - 1) + 16 * warp + lane / 4;
    const int r_hi = r_lo + 8;
    const int col0 = 2 * (lane % 4);
    const uint32_t q_addr = base + kSmemQ + (wg - 1) * 64 * 128;

    float acc[kAcc], s[64];
#pragma unroll
    for (int j = 0; j < kAcc; ++j) acc[j] = 0.0f;
    uint32_t p[kBn / 16][4];
    RowState r{kNeg, kNeg, 0.0f, 0.0f};
    // This consumer's turn is barrier 1 + me; it then opens the next's.
    const int me = wg - 1, next = 1 + (me + 1) % NC;
    auto k_addr = [&](int i) {
      return base + kSmemK + (i % kStages) * L::kKBytes;
    };
    auto v_addr = [&](int i) {
      return base + kSmemV + (i % kStages) * L::kVBytes;
    };
    auto parity = [](int i) {
      return static_cast<uint32_t>(i / kStages) & 1;
    };
    auto mask = [&](int i) {
      return i * kBn + kBn > a.sk || (a.causal && i * kBn + kBn - 1 > q0);
    };

    // Tile i's S = Q.K^T is issued together with tile i-1's O += P.V, so
    // the softmax of tile i runs while P.V of tile i-1 is in flight. The
    // warpgroups issue in turns, 0, 1, .., NC-1, 0, ..: n_tiles + 1 turns
    // each; the last consumer opens consumer 0's first turn and skips the
    // signal after its own last.
    mbar_wait(bar_q, 0);
    if (n_tiles > 0) {
      if (me == NC - 1) bar_arrive(1);
      mbar_wait(bar_fullk, 0);
      bar_sync(1 + me);
      wgmma_fence();
      issue_qk<QK, L::kQBox>(s, q_addr, k_addr(0));
      wgmma_commit();
      bar_arrive(next);
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
        issue_qk<QK, L::kQBox>(s, q_addr, k_addr(i));
        wgmma_commit();
        issue_pv<VD>(acc, p, v_addr(i - 1));
        wgmma_commit();
        bar_arrive(next);
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
        for (int j = 0; j < kAcc; ++j)
          acc[j] *= (j / 2) % 2 ? corr.y : corr.x;
        pack_p(s, p);
      }
      const int last = n_tiles - 1;
      mbar_wait(bar_fullv + 8 * (last % kStages), parity(last));
      bar_sync(1 + me);
      wgmma_fence();
      issue_pv<VD>(acc, p, v_addr(last));
      wgmma_commit();
      if (me != NC - 1) bar_arrive(next);
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
    for (int j = 0; j < kAcc; j += 2) {
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

template <int QK, int VD, int NC>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int batch, int n_heads, int n_kv_heads,
           int sq, int sk, int causal, float scale, cudaStream_t stream) {
  using L = Layout<QK, VD, NC>;
  CUtensorMap qmap, kmap, vmap;
  int err = make_map(&qmap, q, sq, n_heads, batch, st, L::kBm, QK);
  if (!err) err = make_map(&kmap, k, sk, n_kv_heads, batch, st + 3, kBn, QK);
  if (!err) err = make_map(&vmap, v, sk, n_kv_heads, batch, st + 6, kBn, VD);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      flash_tc_kernel<QK, VD, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Shape a{st[9], st[10], st[11], n_heads, n_heads / n_kv_heads, sq, sk,
                causal, scale * kLog2e};
  const dim3 grid((sq + L::kBm - 1) / L::kBm, batch * n_heads);
  flash_tc_kernel<QK, VD, NC><<<grid, L::kThreads, L::kSmemBytes, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q (B,H,SQ,hd), k (B,KV,SK,hd), v (B,KV,SK,vd), o (B,H,SQ,vd),
// hd = 64 (vd 64), 128 (vd 128) or 192 (vd 128), each through element
// strides st = {q: b,h,s, k: b,h,s, v: b,h,s, o: b,h,s} with the head dim
// contiguous; base addresses 16-byte aligned and the strides of q, k and v
// multiples of 8 elements (TMA's 16 bytes). H is a multiple of KV. Returns
// a CUDA error code (cudaErrorInvalidValue for another head dim or when a
// tensor map cannot describe an operand).
MOBY_API int moby_flash_attention_tc(const void* q, const void* k,
                                     const void* v, void* o,
                                     const long long* st, int batch,
                                     int n_heads, int n_kv_heads, int sq,
                                     int sk, int head_dim, int causal,
                                     float scale, void* stream) {
  if (batch * n_heads == 0 || sq == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return launch<64, 64, 3>(q, k, v, o, st, batch, n_heads,
                                      n_kv_heads, sq, sk, causal, scale, s);
    case 128: return launch<128, 128, 2>(q, k, v, o, st, batch, n_heads,
                                         n_kv_heads, sq, sk, causal, scale,
                                         s);
    case 192: return launch<192, 128, 2>(q, k, v, o, st, batch, n_heads,
                                         n_kv_heads, sq, sk, causal, scale,
                                         s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
