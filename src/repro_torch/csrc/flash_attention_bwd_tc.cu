// Backward pass of blocked softmax attention (prefill) on Hopper's tensor
// cores: bf16 operands, f32 accumulation, wgmma fed by TMA. (qk, value)
// head dims (64, 64) (zamba2, whisper), (128, 128) (every full-size dense
// config, moonshot) and (192, 128) (MLA: deepseek-v2's nope 128 + rope
// 64), GQA-aware: dQ, dK and dV from Q, K, V, the forward's output O and
// its cotangent dO.
//
// Replaces the VJP around the TPU kernel: repro/ops/api.py (_flash_bwd),
// jax.vjp of repro/models/layers.py::_chunked_attention, for bf16 at head
// dims 64 and 128 (the route that training takes at full width), and
// jax.vjp of JAX's plain attention at MLA's (192, 128)
// (repro/models/layers.py::_dense_attention, _chunked_attention, which
// the Pallas kernel does not take).
// flash_attention_bwd.cu (3xTF32 on the tensor cores) keeps f32 and bf16
// at head dims 16 and 32 (it also took bf16 at 64 until this instance
// did); kernels/flash_attention/ops.py::route chooses before any launch.
// Its plain version is
// kernels/flash_attention/ref.py::flash_attention_bwd_ref:
//   A = softmax(scale Q.K^T) with the forward's masking (masked keys give
//   p = 0, the causal limit kj <= qi, keys past sk masked),
//   dV = A^T dO, dP = dO V^T, dS = A * (dP - rowsum(dO * O)),
//   dQ = scale dS K, dK = scale dS^T Q,
// with the G = H / KV query heads of a kv head summed into its dK and dV.
//
// What bounds it on an H100: operations. At the training shape (B=1,
// H=16, KV=2, S=4096, hd=128, causal) the five products of the gradient
// are 1.7e11 flops on ~40 MB of inputs and outputs: 0.17 ms at the 989
// TFLOP/s dense bf16 tensor rate, 0.012 ms of memory. This kernel executes
// seven products a (query tile, key tile) pair (S and dP twice: once in
// each of its two kernels), all of them as wgmma on the tensor cores; the
// f32 work outside them (the softmax and dS, ~10 instructions and one
// exp2 a score, twice) competes with them for issue slots and the SFU. At
// hd 64 (zamba2's gradient: B=1, H=KV=32, S=4096, causal) the products
// are again 1.7e11 flops, but that f32 work a score is the same for half
// the products. At MLA's (192, 128) (MLA T: B=1, H=KV=128, S=4096,
// causal) the products take 2 (3 x 192 + 2 x 128) flops a live pair,
// 1.79e12 in all on 1.34 GB: 1.81 ms at the bf16 tensor rate, 0.40 ms of
// memory; the f32 work a score is that of hd 128 for 1.6 times the
// products.
//
// Precision: every product has bf16 operands and an f32 accumulator. P and
// dS are rounded to bf16 (round to nearest even) only as the A operands of
// dV += P^T.dO, dK += dS^T.Q and dQ += dS.K, as every tensor-core flash
// attention backward does; the softmax, dS = P (dP - D), the row
// statistics and every accumulator stay f32, and each output is rounded
// once to bf16. chip_smoke.py (grads_close, bwd_rounding_terms) states the
// allowance this needs against the float64 gradient.
//
// What bounds it at MLA's (192, 128), as measured (tools/mla_bwd_probe.py,
// MLA T's shape): power. The card holds its 700 W limit through the call
// and its SM clock drops from ~1.8-1.9 GHz (a short eager burst) to a
// median of ~1.45 GHz under the sustained load of repeated calls (CUDA
// graph replays), the two kernels then running back to back with gaps of
// ~0.6 us. cuDNN's backward takes the five products (1,664 flops a live
// pair, dQ summed by atomics); this kernel, deterministic and without
// atomics, takes seven (2,304: S and dP again in the dq kernel) at about
// the same energy a flop, so it stays ~1.2-1.3x SDPA's backward there.
//
// Design (the shape of FlashAttention-3's backward, without its atomics,
// so two calls give the same bits), three launches of one entry point in
// stream order, each of the first two with 384 threads: warpgroup 0 the
// producer (`setmaxnreg` cuts it to 24 registers; one thread issues TMA
// loads, the resident 128-row tiles once and 64-row tiles into a 2-stage
// ring with full and empty mbarriers), warpgroups 1 and 2 consumers of 64
// rows each at 240 registers, whose f32 work interleaves with each
// other's products:
// * dq_tc_kernel, a CTA per (b*h, 128-row query tile) (walking at (192,
//   128): below), the heaviest causal tiles first: Q, dO and O resident;
//   D = rowsum(dO * O) as the diagonals of dO.O^T and O.dO^T on the
//   tensor cores (summed as dP and dP^T are, so a row whose only live key
//   is j gets dS = 0 exactly in both kernels,
//   as in the exact gradient); one walk over the 64-key tiles, online as
//   the forward: S = Q.K^T and dP = dO.V^T as `wgmma.m64n64k16` (A and B
//   from shared memory, K-major), the rows' running max m and sum l,
//   P~ = exp2(S c - m), dS~ = P~ (dP - D) in the accumulators' registers,
//   then dQ~ += dS~.K as `wgmma.m64nHDk16` with dS~ fed from registers in
//   the accumulator-to-A-fragment layout and K read MN-major (the
//   transpose bit), dQ~ rescaled as m grows; dQ = scale dQ~ / l. Writes dQ
//   (bf16) and the rows' (lse = m + log2 l, D) as f32 statistics, rows
//   past sq with lse = +inf so that they give p = 0 below;
// * dkv_tc_kernel, a CTA per (b*h, 128-key tile) (walking at (192, 128)),
//   the heaviest first: K and V resident; the ring brings each 64-row
//   query tile that sees the keys with its rows' (lse, D) (a bulk copy each, on the same barrier); S^T =
//   K.Q^T and dP^T = V.dO^T (m64n64k16), P^T = exp2(S^T c - lse) and dS^T
//   in registers, dV += P^T.dO (m64nVDk16) and dK += dS^T.Q (m64nQKk16;
//   A from registers, B MN-major). The 64 x QK and 64 x VD f32
//   accumulators stay in registers over the walk. At qk 192 they are 160
//   floats a thread, and S^T and dP^T beside them would be 224 of the 240
//   (a build that kept both spilled, 4 bytes: ptxas -v): there S^T alone
//   is computed first, P^T kept only as its bf16 A fragments, dV += P^T.dO
//   issued with dP^T = V.dO^T, and dS^T = P^T (dP^T - D) taken from the
//   fragments (P^T rounded once more than at hd 64 and 128, within the
//   same allowance: chip_smoke.py), then dK += dS^T.Q; the CTA writes f32
//   partials of its query
//   head. One CTA a query head keeps 512 CTAs at the training shape busy
//   (one a kv head would give 64 for the 132 SMs). At G = 1 (one query
//   head a kv head: zamba2, whisper) it writes dK and dV in bf16 instead,
//   with no partials and no third launch: at zamba2's gradient shape the
//   partials are 67 MB written and read again (tools/tc_hd64_probe.py:
//   7.5% of the call). The group sum adds the partials to +0, which turns
//   a -0 into +0; the direct write adds +0 before rounding, so the two
//   agree bit for bit (chip_smoke.py's group_sum_path holds them to it);
// * reduce_tc_kernel sums the G partials of each kv head in head order and
//   rounds once to bf16.
// At (192, 128) (MLA T: 4,096 items of each kernel at B=1, H=128, S=4096)
// both kernels walk (Layout::kWalk): one CTA an SM takes a static list of
// (b*h, tile) items, the heaviest first, dealt to the CTAs in rounds that
// alternate direction (snake_item), as level as a greedy scheduler; the
// ring runs on across items, and the producer loads an item's resident
// tiles once both consumer warpgroups have taken the previous item's last
// S and dP (a release barrier), under the previous item's last products
// and stores. At hd 64 and 128 `if constexpr` leaves a CTA an item, with
// each CTA's item decoded before the warpgroups split, as before the walk
// (cuobjdump: dkv's instruction counts as before, dq's 8 and 48 fewer and
// scheduled otherwise; their times within a second build of the old
// source's).
// The exponentials are ex2.approx.ftz alone (p below 2^-126 is 0; 2.7% of
// the call at zamba2's shape, 4.8% at hd 128: exp2f's non-flushing form
// adds a compare and two multiplies to each).
// Shared memory at hd 128: 2 resident tiles of 32 KB, 2 stages of 2 x 16
// KB, then O (dq, 32 KB) or 2 x 512 bytes of statistics (dkv): ~161 KB; at
// hd 64 tiles of half the size and 3 stages, ~97 KB; at (192, 128) the
// qk-dim tiles (Q, K) are three boxes: 48 + 32 KB resident, 2 stages of
// 24 + 16 KB, O 32 KB: ~193 KB. Each tile is QK / 64 or VD / 64 TMA boxes
// of 64 columns (128 bytes, the widest a 128-byte swizzle allows), one
// after the other;
// the wgmma descriptors use the same swizzle
// (8-row atoms of 1024 bytes: stride byte offset 1024; MN-major: leading
// byte offset = the box size). Tensor maps are built on the host per call
// over the strided (B, S, heads, hd) storage and passed as
// __grid_constant__ parameters, so a CUDA graph can capture the launches;
// TMA fills rows and keys past the end with zeros. Masking is applied
// only to the tiles that need it (the causal diagonal, the ragged last key
// tile). The library builds with -fmad=false: each intended fused
// multiply-add is an explicit __fmaf_rn.
//
// Tried on the card and left out (tools/bwd_tc_probe.py): a first pass for
// the rows' statistics before dQ's walk (0.14 ms more at the training
// shape); a tile's next products issued before its f32 work, or kept in
// flight across loop iterations (ptxas then serializes every wgmma:
// warnings C7515, C7512); a 3-stage ring; two tiles' S in one commit group.
// At (192, 128) (tools/mla_bwd_probe.py, MLA T's shape): a dkv kernel over
// 64-key tiles whose two consumer warpgroups split the products by
// accumulator (S^T, P^T and dV; dP^T, dS^T and dK; P^T handed over in
// shared memory), 3.60-3.88 ms against 2.54-2.73 (Q and dO streamed once
// per 64 keys, and the second warpgroup waiting on the first's P^T);
// dq's dO held in registers for dP (RS wgmma), no gain; a 3-stage dkv
// ring (its third region cut to the statistics), no gain; a warpgroup
// skipping the tiles wholly masked for it, slower (it runs a tile ahead
// of the other and takes the 2-stage ring's slack); dQ~ rescaled only
// where a warp's vote finds a row's max moved, within 0.4% of the walk
// either way over two probe calls of 10 turns (the probe's `tc_vote`
// build); an item's first ring tile loaded before its resident tiles,
// 0.6% in one call, not kept. The walk itself: 2.3-3.4% faster than a CTA
// an item, in every turn.
//
// ptxas (-Xptxas -v, sm_90a): 168 registers a thread at launch for both
// kernels at all three pairs of head dims (the consumers raise theirs to
// 240 with setmaxnreg, the producer drops to 24), no spills; chip_smoke.py
// prints the build log.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "moby_kernels.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 384;          // producer + 2 consumer warpgroups
constexpr int kBox = 64;               // TMA box width: 64 bf16 = 128 bytes
constexpr int kWide = 128;             // rows of a resident tile (2 x 64)
constexpr int kNarrow = 64;            // rows of a streamed tile
constexpr int kWideBox = kWide * kBox * 2;       // one 64-column box: 16 KB
constexpr int kNarrowBox = kNarrow * kBox * 2;   // 8 KB
constexpr int kStatBytes = 2 * kNarrow * 4;

// Shared memory at (qk, value) head dims (QK, VD): two resident tiles, A
// at the qk dim and B at the value dim (dq: Q, dO; dkv: K, V), kStages
// stages of two streamed tiles, again at the qk dim and then the value dim
// (dq: K, V; dkv: Q, dO), then a third region (dq: the resident O tile;
// dkv: each stage's lse and D of its 64 query rows), the barriers. Each
// tile is QK / 64 or VD / 64 boxes, one after the other.
template <int QK, int VD>
struct Layout {
  static_assert((QK == 64 && VD == 64) || (QK == 128 && VD == 128) ||
                (QK == 192 && VD == 128), "head dims");
  // A 3-stage ring at hd 64, where a stage is 16 KB and a tile's work
  // short (tools/tc_hd64_probe.py: 2-3% of the call); 2 at 128 and 192.
  static constexpr int kStages = QK == 64 ? 3 : 2;
  // At (192, 128) a CTA an SM walks its items (cta_item), the next item's
  // resident tiles loaded once the consumers release the last ones.
  static constexpr bool kWalk = QK == 192;
  // resident (and their release, walking); full, empty
  static constexpr int kNumBars = (kWalk ? 2 : 1) + 2 * kStages;
  static constexpr int kWideA = QK / kBox * kWideBox;       // 16, 32, 48 KB
  static constexpr int kWideB = VD / kBox * kWideBox;       // 16 or 32 KB
  static constexpr int kNarrowA = QK / kBox * kNarrowBox;   // 8, 16, 24 KB
  static constexpr int kNarrowB = VD / kBox * kNarrowBox;   // 8 or 16 KB
  static constexpr int kAccQk = QK / 2;   // dQ, dK floats a thread
  static constexpr int kAccV = VD / 2;    // dV floats a thread
  // At qk 192 a dkv consumer holds dK (96 floats) and dV (64) over the
  // walk: it keeps a tile's P^T only as its bf16 A fragments (P^T rounded
  // once, as dV's operand) and takes dS^T = P^T (dP^T - D) from them, so
  // one 64 x 64 f32 tile (dP^T) is live beside the accumulators instead
  // of two (S^T and dP^T: 224 registers of the 240).
  static constexpr bool kPackedP = QK == 192;
  static constexpr int kSmemA = 0;
  static constexpr int kSmemB = kWideA;
  static constexpr int kSmemRing = kWideA + kWideB;
  static constexpr int kStageBytes = kNarrowA + kNarrowB;
  static constexpr int kSmemC = kSmemRing + kStages * kStageBytes;
  static constexpr int kSmemBar = kSmemC + kWideB;
  static constexpr int kSmemBytes = kSmemBar + 8 * kNumBars + 1024;  // align
  static_assert(kStages * kStatBytes <= kWideB, "statistics");
  static_assert(kSmemBytes <= 232448, "shared memory");
};

// Defined to 1 only by tools/bwd_tc_probe.py, to time what a forward that
// saved its rows' log-sum-exp would leave of the dq kernel: that build keeps
// the running max at 0 (no row max, no rescaling; right only while the
// scaled scores stay far from f32's exponent range, as on the probe's
// normal inputs).
#ifndef MOBY_BWD_TC_PROBE_FIXED_MAX
#define MOBY_BWD_TC_PROBE_FIXED_MAX 0
#endif
constexpr bool kProbeFixedMax = MOBY_BWD_TC_PROBE_FIXED_MAX;

struct Args {
  __nv_bfloat16 *dq, *dk, *dv;
  float* stats;                // (2, B*H, rows): lse, D
  float* part;                 // (B*H, SK, QK) dK, then (B*H, SK, VD) dV
  long long dq_b, dq_h, dq_s;  // elements
  long long dk_b, dk_h, dk_s, dv_b, dv_h, dv_s;
  int n_bh, n_heads, group, sq, sk, rows, causal;
  float scale, scale_log2;     // hd^-0.5, and times log2(e)
};

// S (64 x 64 f32) = A.B^T over head dim HD: A the warpgroup's 64 rows of
// a resident 128-row tile (boxes 16 KB apart), B 64 rows of a tile whose
// boxes lie BBox apart (a streamed 64-row tile, or the warpgroup's rows of
// a resident one), both K-major; 4 steps of 16 in each 64-wide box (not
// committed).
template <int HD, int BBox = kNarrowBox>
__device__ __forceinline__ void issue_nt(float (&s)[32], uint32_t a_addr,
                                         uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    wgmma_ss_n64(s, smem_desc(a_addr + (kk / 4) * kWideBox + col, 16, 1024),
                 smem_desc(b_addr + (kk / 4) * BBox + col, 16, 1024),
                 kk > 0);
  }
}

// acc (64 x HD f32) += A.B over 64 rows: A from registers (four 16-wide
// fragments), B a streamed 64-row tile read MN-major (the head dim
// contiguous; at HD 128 and 192 its boxes 8 KB apart, the leading byte
// offset; each 16-row step 2 KB further) (not committed).
template <int HD>
__device__ __forceinline__ void issue_nn(float (&acc)[HD / 2],
                                         const uint32_t (&a)[4][4],
                                         uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs_n<HD>(acc, a[kk],
                   smem_desc(b_addr + kk * 16 * 128, kNarrowBox, 1024));
}

// A 64 x 64 f32 accumulator, rounded to bf16, as the A operand: its
// register pairs are the A fragments of the four 16-wide steps, in place.
__device__ __forceinline__ void pack(const float (&x)[32],
                                     uint32_t (&f)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[kk][i] = pack_bf16(x[8 * kk + 2 * i], x[8 * kk + 2 * i + 1]);
}

// Element j of the accumulator that `pack` rounded into f, as f32.
__device__ __forceinline__ float unpacked(const uint32_t (&f)[4][4], int j) {
  const uint32_t w = f[j / 8][(j % 8) / 2];
  return __uint_as_float(j % 2 ? w & 0xffff0000u : w << 16);
}

// The resident tiles' barrier (with `walk`, then their release by every
// consumer thread); a full and an empty barrier a ring stage.
__device__ __forceinline__ void init_bars(uint32_t bar_res,
                                          uint32_t bar_full,
                                          uint32_t bar_empty, int stages,
                                          bool walk = false) {
  if (threadIdx.x == 0) {
    mbar_init(bar_res, 1);
    if (walk) mbar_init(bar_res + 8, kThreads - 128);
    for (int s = 0; s < stages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kThreads - 128);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The HD / 64 TMA boxes (all of a tile's head dims) of `map` at (row,
// head, b).
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, uint32_t box_bytes,
                                          const CUtensorMap* map,
                                          uint32_t bar, int row, int head,
                                          int b) {
#pragma unroll
  for (int x = 0; x < HD / kBox; ++x)
    tma_load(dst + x * box_bytes, map, bar, x * kBox, row, head, b);
}

// The k-th item of CTA c of a grid of g in the walk's snake order: round
// k takes items [k g, (k + 1) g), forward in even rounds and backward in
// odd ones, so that the CTAs' sums over the heaviest-first items stay
// level (tests/test_torch_attention.py models it). A grid of an item a
// CTA takes item c alone.
__device__ __forceinline__ int snake_item(int c, int k, int g) {
  return k * g + ((k & 1) ? g - 1 - c : c);
}

// A (b*h, tile) item: bh = b * n_heads + h, its kv head, and the tile's
// rank (its place, heaviest first).
struct Item {
  int bh, b, h, kvh, rank;
};

// `it` = the CTA's j-th item; false past its last. With kWalk the CTA
// walks snake_item's items (item = rank * n_bh + bh), decoding each at
// its loop's head; else it takes the one item of its place in a (n_bh,
// tiles) grid, decoded before the warpgroups split (so that the hd 64 and
// 128 kernels keep the code they had before the walk).
template <bool kWalk>
__device__ __forceinline__ bool cta_item(int j, int n_items, const Args& a,
                                         Item& it) {
  if constexpr (kWalk) {
    const int item = snake_item(blockIdx.x, j, gridDim.x);
    if (item >= n_items) return false;
    it.bh = item % a.n_bh;
    it.rank = item / a.n_bh;
  } else {
    if (j > 0) return false;
    it.bh = blockIdx.x;
    it.rank = blockIdx.y;
  }
  it.b = it.bh / a.n_heads;
  it.h = it.bh % a.n_heads;
  it.kvh = it.h / a.group;
  return true;
}

template <int QK, int VD>
__global__ void __launch_bounds__(kThreads, 1)
dq_tc_kernel(const __grid_constant__ CUtensorMap qmap,    // 128-row boxes
             const __grid_constant__ CUtensorMap domap,   // 128-row boxes
             const __grid_constant__ CUtensorMap omap,    // 128-row boxes
             const __grid_constant__ CUtensorMap kmap,    // 64-row boxes
             const __grid_constant__ CUtensorMap vmap,    // 64-row boxes
             const Args a) {
  using L = Layout<QK, VD>;
  constexpr int kAcc = L::kAccQk, kStages = L::kStages;
  constexpr bool kWalk = L::kWalk;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the tiles to it.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_res = base + L::kSmemBar;
  const uint32_t bar_res_free = bar_res + 8;             // with kWalk
  const uint32_t bar_full = bar_res + (kWalk ? 16 : 8);  // [kStages]
  const uint32_t bar_empty = bar_full + 8 * kStages;     // [kStages]
  const int n_qt = kWalk ? (a.sq + kWide - 1) / kWide : gridDim.y;
  // The item's query tile (causal: the last, which sees every key, first)
  // and its key tiles: keys past its last query row are masked for every
  // row.
  Item it;
  int q0, n_tiles;
  auto next = [&](int j) {
    if (!cta_item<kWalk>(j, a.n_bh * n_qt, a, it)) return false;
    q0 = (a.causal ? n_qt - 1 - it.rank : it.rank) * kWide;
    const int k_end = a.causal ? min(a.sk, q0 + kWide) : a.sk;
    n_tiles = (k_end + kNarrow - 1) / kNarrow;
    return true;
  };
  if constexpr (!kWalk) next(0);
  init_bars(bar_res, bar_full, bar_empty, kStages, kWalk);

  const int wg = threadIdx.x / 128;
  int e = 0;   // walking: ring tiles so far (the ring runs on across items)
  if (wg == 0) {
    // ---- producer: one thread keeps the TMA loads in flight ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      for (int j = 0; kWalk ? next(j) : j == 0; ++j) {
        const int b = it.b, h = it.h, kvh = it.kvh;
        // Walking: once both consumer warpgroups have taken the previous
        // item's last S and dP, so that these loads run under its last dQ
        // product and stores.
        if constexpr (kWalk) mbar_wait(bar_res_free, (j & 1) ^ 1);
        mbar_expect_tx(bar_res, L::kWideA + 2 * L::kWideB);
        load_tile<QK>(base + L::kSmemA, kWideBox, &qmap, bar_res, q0, h, b);
        load_tile<VD>(base + L::kSmemB, kWideBox, &domap, bar_res, q0, h, b);
        load_tile<VD>(base + L::kSmemC, kWideBox, &omap, bar_res, q0, h, b);
        // A key and a value tile a stage. The first round finds the ring
        // empty (parity 1 passes at once); the ring runs on across items.
        for (int i = 0; i < n_tiles; ++i) {
          const int r = kWalk ? e++ : i, s = r % kStages;
          const uint32_t dst = base + L::kSmemRing + s * L::kStageBytes;
          mbar_wait(bar_empty + 8 * s, ((r / kStages) & 1) ^ 1);
          mbar_expect_tx(bar_full + 8 * s, L::kStageBytes);
          load_tile<QK>(dst, kNarrowBox, &kmap, bar_full + 8 * s,
                        i * kNarrow, kvh, b);
          load_tile<VD>(dst + L::kNarrowA, kNarrowBox, &vmap,
                        bar_full + 8 * s, i * kNarrow, kvh, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int me = wg - 1;
    const int t = threadIdx.x - 128 * wg;
    const int warp = t / 32, lane = t % 32;
    const int col0 = 2 * (lane % 4);
    const uint32_t q_addr = base + L::kSmemA + me * 64 * 128;
    const uint32_t do_addr = base + L::kSmemB + me * 64 * 128;
    const uint32_t o_addr = base + L::kSmemC + me * 64 * 128;
    for (int j = 0; kWalk ? next(j) : j == 0; ++j) {
      const int bh = it.bh, b = it.b, h = it.h;
      // Accumulator layout of wgmma m64nN (f32): register x of a thread
      // holds row r_lo (+8 when (x/2) is odd), column (x/4)*8 + col0 +
      // (x%2).
      const int row0 = q0 + 64 * me;
      const int r_lo = row0 + 16 * warp + lane / 4;
      const int r_hi = r_lo + 8;
      auto masked = [&](int i) {   // the tile's masking is needed
        return i * kNarrow + kNarrow > a.sk ||
               (a.causal && i * kNarrow + kNarrow - 1 > row0);
      };
      auto live = [&](int kj, int qi) {
        return kj < a.sk && (!a.causal || kj <= qi);
      };

      // D = rowsum(dO * O), O as the forward stored it, twice: the
      // diagonal of dO.O^T, summed exactly as this kernel's dP = dO.V^T is,
      // and of O.dO^T, summed as the dkv kernel's dP^T = V.dO^T is (written
      // to the statistics). Where O_i is V_j (a row whose only live key is
      // j), D_i then equals dP_ij bit for bit in each kernel and dS_ij is
      // 0, as in the exact gradient. The diagonal (r, r) lies on one of row
      // r's four threads: a quad sum of it and three zeros.
      float s[32], dp[32];
      float d_lo = 0.f, d_hi = 0.f, dkv_lo = 0.f, dkv_hi = 0.f;
      mbar_wait(bar_res, j & 1);
      wgmma_fence();
      issue_nt<VD, kWideBox>(s, do_addr, o_addr);
      issue_nt<VD, kWideBox>(dp, o_addr, do_addr);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      if (kWalk && n_tiles == 0) mbar_arrive(bar_res_free);
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const bool hi = (x / 2) % 2;
        if ((x / 4) * 8 + col0 + (x % 2) == 16 * warp + lane / 4 + 8 * hi) {
          (hi ? d_hi : d_lo) = s[x];
          (hi ? dkv_hi : dkv_lo) = dp[x];
        }
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        d_lo += __shfl_xor_sync(0xffffffffu, d_lo, x);
        d_hi += __shfl_xor_sync(0xffffffffu, d_hi, x);
        dkv_lo += __shfl_xor_sync(0xffffffffu, dkv_lo, x);
        dkv_hi += __shfl_xor_sync(0xffffffffu, dkv_hi, x);
      }

      // One walk over the key tiles, online as the forward's softmax: S =
      // Q.K^T and dP = dO.V^T, the rows' running max m (of the scores times
      // scale * log2 e; a row lives on 4 threads: its max by two quad
      // shuffles) and sum l (per thread until the end), P~ = exp2(S c - m),
      // dS~ = P~ (dP - D), and dQ~ += dS~.K, dQ~ rescaled by exp2(m_old -
      // m) as m grows; at the end dQ = scale dQ~ / l. dS~ is dS times l
      // exp2(m_final - m): the operand rounded to bf16 is dS up to a
      // factor, with dS's own relative rounding error.
      float m_lo = kProbeFixedMax ? 0.f : kNeg, m_hi = m_lo;
      float l_lo = 0.f, l_hi = 0.f;
      float acc[kAcc];
      uint32_t f[4][4];
#pragma unroll
      for (int x = 0; x < kAcc; ++x) acc[x] = 0.f;
      for (int i = 0; i < n_tiles; ++i) {
        const int r = kWalk ? e++ : i, st = r % kStages;
        const uint32_t k_addr = base + L::kSmemRing + st * L::kStageBytes;
        mbar_wait(bar_full + 8 * st, (r / kStages) & 1);
        wgmma_fence();
        issue_nt<QK>(s, q_addr, k_addr);
        issue_nt<VD>(dp, do_addr, k_addr + L::kNarrowA);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        // The item's last read of Q and dO: the next item's may load.
        if (kWalk && i == n_tiles - 1) mbar_arrive(bar_res_free);
        if (masked(i)) {   // masked keys: s = -inf, so p = 0
#pragma unroll
          for (int x = 0; x < 32; ++x) {
            const int kj = i * kNarrow + (x / 4) * 8 + col0 + (x % 2);
            if (!live(kj, (x / 2) % 2 ? r_hi : r_lo)) s[x] = -INFINITY;
          }
        }
        float corr_lo = 1.f, corr_hi = 1.f;
        if (!kProbeFixedMax) {
          float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
          for (int x = 0; x < 32; ++x) {
            if ((x / 2) % 2) mx_hi = fmaxf(mx_hi, s[x]);
            else mx_lo = fmaxf(mx_lo, s[x]);
          }
#pragma unroll
          for (int x = 1; x <= 2; x <<= 1) {
            mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, x));
            mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, x));
          }
          const float mn_lo = fmaxf(m_lo, mx_lo * a.scale_log2);
          const float mn_hi = fmaxf(m_hi, mx_hi * a.scale_log2);
          corr_lo = ex2_ftz(m_lo - mn_lo);
          corr_hi = ex2_ftz(m_hi - mn_hi);
          m_lo = mn_lo;
          m_hi = mn_hi;
        }
        float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
        for (int x = 0; x < 32; ++x) {
          const bool hi = (x / 2) % 2;
          const float p = ex2_ftz(__fmaf_rn(s[x], a.scale_log2,
                                            hi ? -m_hi : -m_lo));
          if (hi) sum_hi += p;
          else sum_lo += p;
          dp[x] = p * (dp[x] - (hi ? d_hi : d_lo));
        }
        l_lo = __fmaf_rn(l_lo, corr_lo, sum_lo);
        l_hi = __fmaf_rn(l_hi, corr_hi, sum_hi);
        if (!kProbeFixedMax) {
#pragma unroll
          for (int x = 0; x < kAcc; ++x)
            acc[x] *= (x / 2) % 2 ? corr_hi : corr_lo;
        }
        pack(dp, f);
        wgmma_fence();
        issue_nn<QK>(acc, f, k_addr);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(f);
        mbar_arrive(bar_empty + 8 * st);
      }
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        l_lo += __shfl_xor_sync(0xffffffffu, l_lo, x);
        l_hi += __shfl_xor_sync(0xffffffffu, l_hi, x);
      }
      const float lse_lo = m_lo + log2f(l_lo), lse_hi = m_hi + log2f(l_hi);
      // A row with no key (sk = 0) has acc = 0 and l = 0: dQ = 0.
      const float inv_lo = a.scale / fmaxf(l_lo, 1e-30f);
      const float inv_hi = a.scale / fmaxf(l_hi, 1e-30f);

      __nv_bfloat16* dqb = a.dq + b * a.dq_b + h * a.dq_h;
#pragma unroll
      for (int x = 0; x < kAcc; x += 2) {
        const bool hi = (x / 2) % 2;
        const int qi = hi ? r_hi : r_lo;
        if (qi >= a.sq) continue;
        *reinterpret_cast<__nv_bfloat162*>(dqb + qi * a.dq_s + (x / 4) * 8 +
                                           col0) =
            __float22bfloat162_rn(make_float2(
                acc[x] * (hi ? inv_hi : inv_lo),
                acc[x + 1] * (hi ? inv_hi : inv_lo)));
      }
      if (lane % 4 == 0) {
        float* lse = a.stats + static_cast<long long>(bh) * a.rows;
        float* dsum = lse + static_cast<long long>(a.n_bh) * a.rows;
        lse[r_lo] = r_lo < a.sq ? lse_lo : INFINITY;
        lse[r_hi] = r_hi < a.sq ? lse_hi : INFINITY;
        dsum[r_lo] = dkv_lo;
        dsum[r_hi] = dkv_hi;
      }
    }
  }
}

template <int QK, int VD>
__global__ void __launch_bounds__(kThreads, 1)
dkv_tc_kernel(const __grid_constant__ CUtensorMap kmap,   // 128-row boxes
              const __grid_constant__ CUtensorMap vmap,   // 128-row boxes
              const __grid_constant__ CUtensorMap qmap,   // 64-row boxes
              const __grid_constant__ CUtensorMap domap,  // 64-row boxes
              const Args a) {
  using L = Layout<QK, VD>;
  constexpr int kAccQk = L::kAccQk, kAccV = L::kAccV, kStages = L::kStages;
  constexpr bool kWalk = L::kWalk;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_res = base + L::kSmemBar;
  const uint32_t bar_res_free = bar_res + 8;             // with kWalk
  const uint32_t bar_full = bar_res + (kWalk ? 16 : 8);
  const uint32_t bar_empty = bar_full + 8 * kStages;
  const int n_kt = kWalk ? (a.sk + kWide - 1) / kWide : gridDim.y;
  const int n_qt = (a.sq + kNarrow - 1) / kNarrow;
  // The item's first key and, causal, its first query tile: query rows
  // below k0 see none of its keys.
  Item it;
  int k0, t0;
  auto next = [&](int j) {
    if (!cta_item<kWalk>(j, a.n_bh * n_kt, a, it)) return false;
    k0 = it.rank * kWide;
    t0 = a.causal ? k0 / kNarrow : 0;
    return true;
  };
  if constexpr (!kWalk) next(0);
  init_bars(bar_res, bar_full, bar_empty, kStages, kWalk);

  const int wg = threadIdx.x / 128;
  int e = 0;   // walking: ring tiles so far
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      for (int j = 0; kWalk ? next(j) : j == 0; ++j) {
        const int bh = it.bh, b = it.b, h = it.h, kvh = it.kvh;
        const float* lse = a.stats + static_cast<long long>(bh) * a.rows;
        const float* dsum = lse + static_cast<long long>(a.n_bh) * a.rows;
        // Walking: once both consumer warpgroups have taken the previous
        // item's last S^T and dP^T from K and V.
        if constexpr (kWalk) mbar_wait(bar_res_free, (j & 1) ^ 1);
        mbar_expect_tx(bar_res, L::kWideA + L::kWideB);
        load_tile<QK>(base + L::kSmemA, kWideBox, &kmap, bar_res, k0, kvh, b);
        load_tile<VD>(base + L::kSmemB, kWideBox, &vmap, bar_res, k0, kvh, b);
        for (int qt = t0; qt < n_qt; ++qt) {
          const int r = kWalk ? e++ : qt - t0, s = r % kStages;
          const uint32_t dst = base + L::kSmemRing + s * L::kStageBytes;
          const uint32_t sdst = base + L::kSmemC + s * kStatBytes;
          const uint32_t full = bar_full + 8 * s;
          mbar_wait(bar_empty + 8 * s, ((r / kStages) & 1) ^ 1);
          mbar_expect_tx(full, L::kStageBytes + kStatBytes);
          load_tile<QK>(dst, kNarrowBox, &qmap, full, qt * kNarrow, h, b);
          load_tile<VD>(dst + L::kNarrowA, kNarrowBox, &domap, full,
                        qt * kNarrow, h, b);
          bulk_load(sdst, lse + qt * kNarrow, kStatBytes / 2, full);
          bulk_load(sdst + kStatBytes / 2, dsum + qt * kNarrow,
                    kStatBytes / 2, full);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int me = wg - 1;
    const int t = threadIdx.x - 128 * wg;
    const int warp = t / 32, lane = t % 32;
    const int col0 = 2 * (lane % 4);
    const uint32_t k_addr = base + L::kSmemA + me * 64 * 128;
    const uint32_t v_addr = base + L::kSmemB + me * 64 * 128;
    const float* stats_smem = reinterpret_cast<const float*>(
        smem_raw + (base - smem_u32(smem_raw)) + L::kSmemC);
    for (int j = 0; kWalk ? next(j) : j == 0; ++j) {
      const int bh = it.bh, b = it.b, h = it.h, kvh = it.kvh;
      // Accumulator rows are keys, columns queries (S^T).
      const int key0 = k0 + 64 * me;
      const int kr_lo = key0 + 16 * warp + lane / 4;
      const int kr_hi = kr_lo + 8;

      float s[32], dp[32], dk[kAccQk], dv[kAccV];
      uint32_t pf[4][4], sf[4][4];
#pragma unroll
      for (int x = 0; x < kAccQk; ++x) dk[x] = 0.f;
#pragma unroll
      for (int x = 0; x < kAccV; ++x) dv[x] = 0.f;
      mbar_wait(bar_res, j & 1);
      if (kWalk && t0 >= n_qt) mbar_arrive(bar_res_free);
      for (int qt = t0; qt < n_qt; ++qt) {
        const int r = kWalk ? e++ : qt - t0, st = r % kStages;
        const uint32_t q_addr = base + L::kSmemRing + st * L::kStageBytes;
        const uint32_t do_addr = q_addr + L::kNarrowA;
        const float* lse = stats_smem + st * (kStatBytes / 4);
        const float* dsum = lse + kNarrow;
        mbar_wait(bar_full + 8 * st, (r / kStages) & 1);
        // Rows past sq have lse = +inf: p = 0 without a mask.
        const bool mask = a.causal && key0 + 63 > qt * kNarrow;
        // The item's last read of K and V: the next item's may load.
        const bool release = kWalk && qt == n_qt - 1;
        // P^T = exp2(S^T c - lse) in place of S^T, masked keys 0.
        auto softmax_t = [&]() {
#pragma unroll
          for (int g = 0; g < 8; ++g) {   // query columns 8g + col0 + (0, 1)
            const float2 l2 =
                *reinterpret_cast<const float2*>(lse + 8 * g + col0);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int x = 4 * g + u;
              float p = ex2_ftz(__fmaf_rn(s[x], a.scale_log2,
                                          -(u % 2 ? l2.y : l2.x)));
              if (mask && (u / 2 ? kr_hi : kr_lo) >
                              qt * kNarrow + 8 * g + col0 + u % 2)
                p = 0.f;
              s[x] = p;
            }
          }
        };
        // dS^T = P^T (dP^T - D) in place of dP^T, P^T from `p(x)`.
        auto ds_t = [&](auto p) {
#pragma unroll
          for (int g = 0; g < 8; ++g) {
            const float2 d2 =
                *reinterpret_cast<const float2*>(dsum + 8 * g + col0);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int x = 4 * g + u;
              dp[x] = p(x) * (dp[x] - (u % 2 ? d2.y : d2.x));
            }
          }
        };
        if constexpr (!L::kPackedP) {
          wgmma_fence();
          issue_nt<QK>(s, k_addr, q_addr);      // S^T = K.Q^T
          issue_nt<VD>(dp, v_addr, do_addr);    // dP^T = V.dO^T
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(s);
          fence_regs(dp);
          if (release) mbar_arrive(bar_res_free);
          softmax_t();
          ds_t([&](int x) { return s[x]; });
          pack(s, pf);
          pack(dp, sf);
          wgmma_fence();
          issue_nn<VD>(dv, pf, do_addr);
          issue_nn<QK>(dk, sf, q_addr);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dv);
          fence_regs(dk);
          fence_regs(pf);
          fence_regs(sf);
        } else {
          // S^T; P^T as dV's bf16 A fragments (S^T's registers free
          // again); dV += P^T.dO beside dP^T = V.dO^T; dS^T from the
          // fragments; dK += dS^T.Q.
          wgmma_fence();
          issue_nt<QK>(s, k_addr, q_addr);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(s);
          softmax_t();
          pack(s, pf);
          wgmma_fence();
          issue_nn<VD>(dv, pf, do_addr);
          issue_nt<VD>(dp, v_addr, do_addr);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dv);
          fence_regs(dp);
          fence_regs(pf);
          if (release) mbar_arrive(bar_res_free);
          ds_t([&](int x) { return unpacked(pf, x); });
          pack(dp, sf);
          wgmma_fence();
          issue_nn<QK>(dk, sf, q_addr);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dk);
          fence_regs(sf);
        }
        mbar_arrive(bar_empty + 8 * st);
      }

      if (a.group == 1) {
        // One query head a kv head: dK and dV rounded once to bf16 here,
        // no partials and no group sum. The sum starts from +0, so it turns
        // a -0 partial into +0; adding +0 here does the same, so the two
        // paths agree bit for bit.
        __nv_bfloat16* dkb = a.dk + b * a.dk_b + kvh * a.dk_h;
        __nv_bfloat16* dvb = a.dv + b * a.dv_b + kvh * a.dv_h;
#pragma unroll
        for (int x = 0; x < kAccQk; x += 2) {
          const int kr = (x / 2) % 2 ? kr_hi : kr_lo;
          if (kr >= a.sk) continue;
          const int d = (x / 4) * 8 + col0;
          *reinterpret_cast<__nv_bfloat162*>(dkb + kr * a.dk_s + d) =
              __float22bfloat162_rn(make_float2(dk[x] * a.scale + 0.f,
                                                dk[x + 1] * a.scale + 0.f));
          if (x < kAccV)
            *reinterpret_cast<__nv_bfloat162*>(dvb + kr * a.dv_s + d) =
                __float22bfloat162_rn(make_float2(dv[x] + 0.f,
                                                  dv[x + 1] + 0.f));
        }
      } else {
        // Partials of this query head, keys < sk: dK (B*H, SK, QK), then
        // dV (B*H, SK, VD), f32.
        float* out_k = a.part + static_cast<long long>(bh) * a.sk * QK;
        float* out_v = a.part + static_cast<long long>(a.n_bh) * a.sk * QK +
                       static_cast<long long>(bh) * a.sk * VD;
#pragma unroll
        for (int x = 0; x < kAccQk; x += 2) {
          const int kr = (x / 2) % 2 ? kr_hi : kr_lo;
          if (kr >= a.sk) continue;
          const int d = (x / 4) * 8 + col0;
          *reinterpret_cast<float2*>(out_k + static_cast<long long>(kr) * QK +
                                     d) =
              make_float2(dk[x] * a.scale, dk[x + 1] * a.scale);
          if (x < kAccV)
            *reinterpret_cast<float2*>(out_v +
                                       static_cast<long long>(kr) * VD + d) =
                make_float2(dv[x], dv[x + 1]);
        }
      }
    }
  }
}

// dK, dV of each kv head: its G query heads' partials summed in head
// order (from +0), rounded once to bf16; 4 head dims a thread (of dK, and
// of dV where the value dim reaches them).
template <int QK, int VD>
__global__ void reduce_tc_kernel(const float* __restrict__ part,
                                 __nv_bfloat16* dk, __nv_bfloat16* dv,
                                 long long dk_b, long long dk_h,
                                 long long dk_s, long long dv_b,
                                 long long dv_h, long long dv_s, int batch,
                                 int n_heads, int n_kv, int sk) {
  constexpr int kQuads = QK / 4;
  const int g = n_heads / n_kv;
  const long long n = static_cast<long long>(batch) * n_kv * sk * kQuads;
  const float* part_v =
      part + static_cast<long long>(batch) * n_heads * sk * QK;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int d = static_cast<int>(i % kQuads) * 4;
    const long long row = i / kQuads;
    const int c = static_cast<int>(row % sk);
    const int bkv = static_cast<int>(row / sk);
    const int b = bkv / n_kv, kvh = bkv % n_kv;
    const long long head0 =
        (static_cast<long long>(b) * n_heads + kvh * g) * sk + c;
    const float* src_k = part + head0 * QK + d;
    const float* src_v = part_v + head0 * VD + d;
    const bool has_v = d < VD;
    float4 sk4 = make_float4(0.f, 0.f, 0.f, 0.f), sv4 = sk4;
    for (int j = 0; j < g; ++j) {
      const float4 x = *reinterpret_cast<const float4*>(
          src_k + static_cast<long long>(j) * sk * QK);
      sk4 = make_float4(sk4.x + x.x, sk4.y + x.y, sk4.z + x.z, sk4.w + x.w);
      if (has_v) {
        const float4 y = *reinterpret_cast<const float4*>(
            src_v + static_cast<long long>(j) * sk * VD);
        sv4 = make_float4(sv4.x + y.x, sv4.y + y.y, sv4.z + y.z,
                          sv4.w + y.w);
      }
    }
    __nv_bfloat162* pk = reinterpret_cast<__nv_bfloat162*>(
        dk + b * dk_b + kvh * dk_h + c * dk_s + d);
    pk[0] = __float22bfloat162_rn(make_float2(sk4.x, sk4.y));
    pk[1] = __float22bfloat162_rn(make_float2(sk4.z, sk4.w));
    if (has_v) {
      __nv_bfloat162* pv = reinterpret_cast<__nv_bfloat162*>(
          dv + b * dv_b + kvh * dv_h + c * dv_s + d);
      pv[0] = __float22bfloat162_rn(make_float2(sv4.x, sv4.y));
      pv[1] = __float22bfloat162_rn(make_float2(sv4.z, sv4.w));
    }
  }
}

template <int QK, int VD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, void* stats,
           void* part, const long long* st, int batch, int n_heads,
           int n_kv_heads, int sq, int sk, int stats_rows, int causal,
           float scale, cudaStream_t s) {
  using L = Layout<QK, VD>;
  const int n_qt = (sq + kWide - 1) / kWide, n_kt = (sk + kWide - 1) / kWide;
  if (stats_rows < n_qt * kWide) return static_cast<int>(cudaErrorInvalidValue);
  // An empty operand's map is never read: it is built over the other
  // side's storage, so the encoder sees a real address.
  const void* qs = sq ? q : k;
  const void* dos = sq ? dout : k;
  const void* ks = sk ? k : q;
  const void* vs = sk ? v : q;
  CUtensorMap q_wide, do_wide, o_wide, k_narrow, v_narrow;  // dq kernel
  CUtensorMap k_wide, v_wide, q_narrow, do_narrow;          // dkv kernel
  // The storage behind an empty operand has the other side's head dim.
  const int vd_s = sq ? VD : QK;
  int err = make_map(&q_wide, qs, sq, n_heads, batch, st, kWide, QK);
  if (!err)
    err = make_map(&do_wide, dos, sq, n_heads, batch, st + 12, kWide, vd_s);
  if (!err) err = make_map(&o_wide, sq ? o : k, sq, n_heads, batch, st + 9,
                           kWide, vd_s);
  if (!err) err = make_map(&q_narrow, qs, sq, n_heads, batch, st, kNarrow, QK);
  if (!err)
    err = make_map(&do_narrow, dos, sq, n_heads, batch, st + 12, kNarrow,
                   vd_s);
  if (!err)
    err = make_map(&k_wide, ks, sk, n_kv_heads, batch, st + 3, kWide, QK);
  if (!err)
    err = make_map(&v_wide, vs, sk, n_kv_heads, batch, st + 6, kWide,
                   sk ? VD : QK);
  if (!err)
    err = make_map(&k_narrow, ks, sk, n_kv_heads, batch, st + 3, kNarrow, QK);
  if (!err)
    err = make_map(&v_narrow, vs, sk, n_kv_heads, batch, st + 6, kNarrow,
                   sk ? VD : QK);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      dq_tc_kernel<QK, VD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kSmemBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(dkv_tc_kernel<QK, VD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             L::kSmemBytes);
  // Walking: a CTA an SM (at most one an item); else a CTA a (b*h, tile).
  int sms = 0, dev = 0;
  if (L::kWalk && e == cudaSuccess) e = cudaGetDevice(&dev);
  if (L::kWalk && e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_bh = batch * n_heads;
  auto grid = [&](int tiles) {
    const long long items = static_cast<long long>(n_bh) * tiles;
    return L::kWalk
        ? dim3(static_cast<unsigned>(items < sms ? items : sms))
        : dim3(static_cast<unsigned>(n_bh), static_cast<unsigned>(tiles));
  };
  const Args a{static_cast<__nv_bfloat16*>(dq),
               static_cast<__nv_bfloat16*>(dk),
               static_cast<__nv_bfloat16*>(dv), static_cast<float*>(stats),
               static_cast<float*>(part), st[15], st[16], st[17], st[18],
               st[19], st[20], st[21], st[22], st[23], batch * n_heads,
               n_heads, n_heads / n_kv_heads, sq, sk, stats_rows, causal,
               scale, scale * kLog2e};
  // No keys: dQ is 0 (no key tile); no queries: dK and dV are 0 (no query
  // tile reaches a key tile).
  if (sq) {
    dq_tc_kernel<QK, VD><<<grid(n_qt), kThreads, L::kSmemBytes, s>>>(
        q_wide, do_wide, o_wide, k_narrow, v_narrow, a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (!sk) return 0;
  dkv_tc_kernel<QK, VD><<<grid(n_kt), kThreads, L::kSmemBytes, s>>>(
      k_wide, v_wide, q_narrow, do_narrow, a);
  e = cudaGetLastError();
  if (e != cudaSuccess || n_heads == n_kv_heads) return static_cast<int>(e);
  const long long groups = static_cast<long long>(batch) * n_kv_heads * sk *
                           (QK / 4) / kMobyThreads + 1;
  const int blocks = static_cast<int>(
      groups < 132 * kMobyBlocksPerSm ? groups : 132 * kMobyBlocksPerSm);
  reduce_tc_kernel<QK, VD><<<blocks, kMobyThreads, 0, s>>>(
      static_cast<const float*>(part), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), st[18], st[19], st[20], st[21],
      st[22], st[23], batch, n_heads, n_kv_heads, sk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, dq (B,H,SQ,hd), o, dout (B,H,SQ,vd), k, dk (B,KV,SK,hd) and v, dv
// (B,KV,SK,vd), (hd, vd) = (64, 64), (128, 128) or (192, 128), through
// element strides st[3 t .. 3 t + 2] = {b, head, s} for t = q, k, v, o,
// dout, dq, dk, dv; the head dim contiguous; base addresses 16-byte
// aligned and the strides of q, k, v, o and dout multiples of 8 elements
// (TMA's and the 16-byte loads' 16 bytes). H is a multiple of KV.
// Scratch: stats (2, B*H, stats_rows) with stats_rows >= SQ rounded up to
// 128, and, where H > KV, part (B*H*SK*(hd + vd) f32: dK's partials, then
// dV's; at H = KV it is not read). Returns a CUDA error code
// (cudaErrorInvalidValue for other head dims, when a tensor map cannot
// describe an operand or stats_rows is short).
MOBY_API int moby_flash_attention_bwd_tc(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* stats, void* part,
    const long long* st, int batch, int n_heads, int n_kv_heads, int sq,
    int sk, int head_dim, int value_dim, int stats_rows, int causal,
    float scale, void* stream) {
  if (batch * n_heads == 0 || (sq == 0 && sk == 0)) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64 && value_dim == 64)
    return launch<64, 64>(q, k, v, o, dout, dq, dk, dv, stats, part, st,
                          batch, n_heads, n_kv_heads, sq, sk, stats_rows,
                          causal, scale, s);
  if (head_dim == 128 && value_dim == 128)
    return launch<128, 128>(q, k, v, o, dout, dq, dk, dv, stats, part, st,
                            batch, n_heads, n_kv_heads, sq, sk, stats_rows,
                            causal, scale, s);
  if (head_dim == 192 && value_dim == 128)
    return launch<192, 128>(q, k, v, o, dout, dq, dk, dv, stats, part, st,
                            batch, n_heads, n_kv_heads, sq, sk, stats_rows,
                            causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
