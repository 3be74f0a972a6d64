// MLA decode attention over the compressed (latent) cache: the absorbed
// form of DeepSeek-V2's decode step.
//
// Replaces no Pallas kernel: the JAX package computes this step with plain
// einsums (repro/models/mla.py::mla_decode_apply, the scores, the masked
// softmax rounded to the cache type and w . ckv). It was added because the
// port runs every attention of its serving paths as a kernel, and because
// K6 (decode_attention.cu) does not suit this shape: it serves at most 8
// query heads a block from SIMT f32 arithmetic, so at 128 heads over one
// latent "kv head" it would read each cache tile 16 times and do ~92
// GFLOP a layer outside the tensor cores.
//
// Contract (kernels/mla_decode_attention/ops.py): q_lat (B, H, R), q_rope
// (B, H, P), ckv (B, S, R), krope (B, S, P), lengths (B,) int32 read on the
// device; o_lat (B, H, R) = softmax((q_lat.ckv + q_rope.krope) * scale)
// . ckv over positions [0, min(lengths[b], S)), in the inputs' type.
// Positions at or past the length add p = 0; masked scores are the finite
// -1e30; a request of length 0 gives 0. ckv is both the first R columns of
// the keys and the values, and is read once for both.
//
// What bounds it on an H100: bytes. At deepseek-v2's serving shape (R 512,
// P 64, H 128, bf16) a live position is 1,152 bytes and 128 x 2 x 1,088 =
// 278,528 flops: 242 flops a byte, under the 295 at which the bf16 tensor
// cores and not the memory would bound it; on the SIMT cores (67 TFLOP/s
// f32) it would be 14x over the memory time.
//
// Design of the bf16 instance at (R, P) = (512, 64): wgmma fed by TMA,
// warp-specialised, in the shape of flash_attention_tc.cu, with heads as
// wgmma's M (64 a CTA).
// * The schedule: every request's live tiles of 64 positions, in request
//   order, are cut into C equal runs (to a tile), one a cluster, C the
//   clusters that fit on the card at once (one CTA an SM): the work is
//   balanced by live tiles, whatever the lengths. The kernel reads
//   `lengths` on the device and finds its run by a warp's prefix sum. A
//   run's stretch of one request is a segment; each writes an
//   unnormalised partial (m, l, acc) to slot cluster + request, and a
//   second kernel merges a (request, head) row's slots.
// * At H > 64 a cluster is two CTAs, heads 0-63 and 64-127 of the same
//   requests. Each CTA's producer issues half of a tile's nine TMA boxes
//   (eight of ckv, one of krope: 64 positions x 64 columns, 128-byte
//   swizzle) multicast into both CTAs, so each byte of the cache leaves
//   L2 once; each CTA's full barrier expects the whole tile, and a stage is
//   refilled only once the consumer warps of both CTAs have released it
//   (an arrive on the peer's empty barrier through mapa). At H <= 64 a
//   cluster is one CTA.
// * A CTA is 384 threads. Warpgroup 0 is the producer (setmaxnreg down to
//   40; one thread keeps a ring of 2 stages full). Warpgroup 1 computes
//   S = Q.K^T (64 heads x 64 positions over depth 576: 36
//   wgmma.m64n64k16, A = Q and B = the tile, both K-major from shared
//   memory), the online softmax in registers (log2 domain, a row on a quad
//   of threads), rounds P to bf16 (nearest even), hands P and the rescale
//   factors to warpgroup 2 through shared memory (thread to thread: the
//   same fragment layout; mbarriers P full / P empty), then O += P.V for
//   value columns 0-255 with P from registers. Warpgroup 2 does P.V for
//   columns 256-511. V is the ckv part of the same stage, MN-major (the
//   transpose bit), so a tile is read once for K and V. 64 x 256 f32
//   accumulators are 128 registers a consumer thread (setmaxnreg up to
//   232). No block-wide barrier runs in the tile loop.
// * Shared memory (226 KB): Q [q_lat | q_rope] of the CTA's 64 heads as
//   nine swizzled boxes (72 KB, loaded by the consumers at each segment's
//   start), 2 stages of 72 KB, the P exchange (8 KB). 64-position stages
//   allow only 2 (32-position ones would allow 4, but halve wgmma's N and
//   double each tile's fixed costs).
// * Rows of a tile at or past the request's length are masked in the
//   softmax (p = 0), and their values zeroed in the CTA's copy of the
//   stage before P.V, so what the cache holds there cannot reach the
//   result; TMA reads rows past S as zeros.
// Design of the f32 instance at (512, 64) (deepseek-v2 in f32: MLA B's
// decode): the tensor cores by 3xTF32 mma.sync (tf32x3.cuh), heads as the
// mma's M, 16 a CTA. In f32 a live position is 2,304 bytes and 3 x
// 278,528 TF32 flops at 128 heads: the products bound it (495 TFLOP/s).
// * The schedule is the tensor-core instance's, over tiles of 32
//   positions: C runs, C the groups of ceil(H / 16) CTAs that fit on the
//   card at once (one CTA an SM), a run a group; the CTAs of a group
//   (heads 0-15, 16-31, ...) are neighbours in launch order, so a tile
//   leaves memory once and the others read it from L2; the merge is the
//   same second pass (a block a (request, head) row, over every SM).
// * A CTA is 8 warps. A segment's Q (16 heads) and its first tile of
//   [ckv | krope] arrive in one group of 16-byte cp.async copies (rows at
//   or past the last head or the length zero-filled), into padded f32 rows;
//   each next tile of the segment is in flight while one is consumed (a
//   ring of 2: 199 KB of shared memory with the exchanges).
// * Warp w takes k-steps [9w, 9w + 9) of the scores' 72 (576 dims): each
//   Q and K element is read and split by one warp; the 8 shares are summed
//   in shared memory in warp order, and warp w runs the online softmax of
//   heads 2w and 2w + 1 (a half-warp a head, two positions a lane). P goes
//   back in the scores' fragment layout, and warp w takes value columns
//   [64w, 64w + 64) of P.V: each V element read and split by one warp.
// * Four barriers a tile: the tile landed, the shares written, P written,
//   the tile consumed.
// The instances at SMOKE's (16, 8) (f32 and bf16) are a plain SIMT kernel
// (8 heads a block, the tile widened to f32 in shared memory, a warp a
// head's softmax, each request's positions in equal splits); only
// correctness runs reach them.
//
// The library builds with -fmad=false: each intended fused multiply-add is
// an explicit fmaf. The barrier, TMA, cluster and wgmma helpers are
// hopper.cuh's; the 3xTF32 split, mma.sync and cp.async tf32x3.cuh's.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"
#include "moby_kernels.cuh"
#include "tf32x3.cuh"

// Probe builds (tools/mla_decode_probe.py) leave phases of the tensor-core
// instance out, or undo a step of its design, to time the rest: bit 1 the
// scores, 2 the softmax, 4 the P.V product, 8 the copies of the cache; 16
// each CTA copies the whole tile itself (no multicast), 32 each request's
// tiles are cut into C / B equal runs (not balanced by live tiles; the
// merge then reads the wrong slots). 0 here: the kernel as it is.
#ifndef MOBY_MLA_PROBE_SKIP
#define MOBY_MLA_PROBE_SKIP 0
#endif

namespace {

constexpr int kProbeSkip = MOBY_MLA_PROBE_SKIP;
constexpr float kNeg = -1e30f;
constexpr int kTile = 32;       // the SIMT instance: positions a tile
constexpr int kThreads = 256;   // ... and threads a block

struct Args {
  long long ql_b, ql_h;         // q_lat (B, H, R)
  long long qr_b, qr_h;         // q_rope (B, H, P)
  long long c_b, c_s;           // ckv (B, S, R)
  long long k_b, k_s;           // krope (B, S, P)
  int n_heads, s_len, n_split;
  float scale;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The run of whole tiles of positions that split `split` of `n_split`
// takes from a request of `len` live positions: [start, end).
__device__ __forceinline__ void split_range(int len, int split, int n_split,
                                            int& start, int& end) {
  const int tiles = (len + kTile - 1) / kTile;
  const int per = (tiles + n_split - 1) / n_split * kTile;
  start = min(split * per, len);
  end = min(start + per, len);
}

// -- the schedule of the tensor-core and tf32x3 instances: every request's
// live tiles of kT positions (64 and 32), requests in order, cut into
// n_runs runs of equal length (to a tile). Run c takes global tiles
// [c N / C, (c + 1) N / C) of the N; its stretch of request b is a
// segment, and its unnormalised partial goes to slot c + b (unique: along
// the tiles c and b never fall and one of them rises at each new segment,
// so there are at most C + B - 1). kernels/mla_decode_attention/ops.py::
// plan is the same in Python. A run is a cluster's (tensor-core instance)
// or a group of CTAs' that split the heads (tf32x3).

template <int kT>
__device__ __forceinline__ int live_tiles(const int* lengths, int b,
                                          int s_len) {
  return (min(max(lengths[b], 0), s_len) + kT - 1) / kT;
}

// Warp-collective: the live tiles of requests [0, batch).
template <int kT>
__device__ __forceinline__ int count_tiles(const int* lengths, int batch,
                                           int s_len) {
  const int lane = threadIdx.x % 32;
  int n = 0;
  for (int b = lane; b < batch; b += 32) n += live_tiles<kT>(lengths, b, s_len);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
  return n;
}

// Warp-collective: the request that holds global tile `tile` (below the
// total) and its first global tile.
template <int kT>
__device__ __forceinline__ void find_request(const int* lengths, int batch,
                                             int s_len, int tile, int& b_out,
                                             int& first) {
  const int lane = threadIdx.x % 32;
  int done = 0;   // tiles of the requests before this chunk of 32
  for (int base = 0; base < batch; base += 32) {
    const int b = base + lane;
    const int n = b < batch ? live_tiles<kT>(lengths, b, s_len) : 0;
    int incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    const unsigned hit = __ballot_sync(0xffffffffu, done + incl > tile);
    if (hit) {
      const int f = __ffs(hit) - 1;
      b_out = base + f;
      first = done + __shfl_sync(0xffffffffu, incl - n, f);
      return;
    }
    done += __shfl_sync(0xffffffffu, incl, 31);
  }
  b_out = batch;
  first = done;
}

__device__ __forceinline__ int run_start(int c, int n_runs, int total) {
  return static_cast<int>(static_cast<long long>(c) * total / n_runs);
}

// The run that holds global tile i: the last c with run_start(c) <= i.
__device__ __forceinline__ int run_of(int i, int n_runs, int total) {
  return static_cast<int>(((i + 1LL) * n_runs + total - 1) / total) - 1;
}

// Runs of no tile (more runs than tiles) write nothing.
__device__ __forceinline__ bool run_live(int c, int n_runs, int total) {
  return run_start(c, n_runs, total) < run_start(c + 1, n_runs, total);
}

// The runs' shape for the merge.
struct RunArgs {
  int batch, n_heads, s_len, n_runs;
};

// The merge of both (512, 64) instances: one block per (b, head) row, the
// partials of request b's segments (slots c + b for the runs c that hold
// its tiles: from the run of its first tile to that of its last, those
// whose runs are not empty) rescaled to their common max (log2 domain) and
// normalised; a request with no live position gives 0. A weight that
// underflows to 0 skips its slot.
constexpr int kMergeThreads = 128;

template <int kT, int R, typename T>
__global__ void __launch_bounds__(kMergeThreads)
mla_decode_merge_kernel(const int* __restrict__ lengths, RunArgs a,
                        const float* __restrict__ part_m,
                        const float* __restrict__ part_l,
                        const float* __restrict__ part_acc,
                        T* __restrict__ out) {
  static_assert(R % kMergeThreads == 0, "columns a thread");
  constexpr int kCols = R / kMergeThreads;
  extern __shared__ float w_s[];   // [n_runs]
  __shared__ float denom_s;
  __shared__ int c_lo_s, c_hi_s;
  const int row = blockIdx.x, b = row / a.n_heads, h = row % a.n_heads;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int total = count_tiles<kT>(lengths, a.batch, a.s_len);
    const int first = count_tiles<kT>(lengths, b, a.s_len);
    const int n = live_tiles<kT>(lengths, b, a.s_len);
    int c_lo = 0, c_hi = -1;
    if (n > 0) {
      c_lo = run_of(first, a.n_runs, total);
      c_hi = run_of(first + n - 1, a.n_runs, total);
    }
    float m = kNeg;
    for (int c = c_lo + lane; c <= c_hi; c += 32)
      if (run_live(c, a.n_runs, total))
        m = fmaxf(m, part_m[static_cast<long long>(c + b) * a.n_heads + h]);
    m = warp_max(m);
    float l = 0.0f;
    for (int c = c_lo + lane; c <= c_hi; c += 32) {
      const long long at = static_cast<long long>(c + b) * a.n_heads + h;
      const float w =
          run_live(c, a.n_runs, total) ? exp2f(part_m[at] - m) : 0.0f;
      w_s[c - c_lo] = w;
      if (w != 0.0f) l = fmaf(part_l[at], w, l);
    }
    l = warp_sum(l);
    if (lane == 0) {
      denom_s = fmaxf(l, 1e-30f);
      c_lo_s = c_lo;
      c_hi_s = c_hi;
    }
  }
  __syncthreads();
  const float denom = denom_s;
  const int c_lo = c_lo_s, c_hi = c_hi_s;
  // A thread's columns d = threadIdx.x + 128 i in accumulators of their
  // own: a slot's loads issue together; the slots are summed in order.
  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.0f;
  for (int c = c_lo; c <= c_hi; ++c) {
    const float w = w_s[c - c_lo];
    if (w == 0.0f) continue;
    const float* src = part_acc +
                       (static_cast<long long>(c + b) * a.n_heads + h) * R +
                       threadIdx.x;
#pragma unroll
    for (int i = 0; i < kCols; ++i)
      acc[i] = fmaf(src[i * kMergeThreads], w, acc[i]);
  }
  T* dst = out + static_cast<long long>(row) * R + threadIdx.x;
#pragma unroll
  for (int i = 0; i < kCols; ++i)
    narrow(dst + i * kMergeThreads, acc[i] / denom);
}

// ---- the tensor-core instance: bf16, R 512, P 64 ---------------------------

namespace tc {

constexpr int kR = 512, kP = 64;
constexpr int kHeads = 64;                      // heads a CTA: wgmma's M
constexpr int kTile = 64;                       // positions a stage
constexpr int kStages = 2;
constexpr int kThreads = 384;                   // producer + 2 consumers
constexpr int kConsumerWarps = 8;
constexpr int kBoxBytes = 64 * 128;             // 64 rows x 64 bf16
constexpr int kBoxes = (kR + kP) / 64;          // 8 of ckv, 1 of krope
constexpr int kTileBytes = kBoxes * kBoxBytes;  // a stage, and Q: 72 KB
constexpr int kSmemQ = 0;
constexpr int kSmemStage = kSmemQ + kTileBytes;
constexpr int kSmemP = kSmemStage + kStages * kTileBytes;  // 128 x 64 B
constexpr int kSmemCorr = kSmemP + 128 * 64;               // 128 x float2
constexpr int kSmemBar = kSmemCorr + 128 * 8;
constexpr int kNumBars = 2 * kStages + 2;   // full, empty; P full, P empty
constexpr int kSmemPlan = kSmemBar + 8 * kNumBars;
constexpr int kSmemBytes = kSmemPlan + 16 + 1024;   // + 1024: alignment
static_assert(kSmemBytes <= 232448, "shared memory");
constexpr float kLog2e = 1.4426950408889634f;

struct TcArgs {
  long long ql_b, ql_h;         // q_lat (B, H, R)
  long long qr_b, qr_h;         // q_rope (B, H, P)
  int batch, n_heads, s_len, n_clusters;
  float scale_log2;             // scale * log2(e)
};

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A consumer warpgroup's walk over its cluster's run: warpgroup 1
// (kScores) the scores, the softmax and value columns 0-255, warpgroup 2
// columns 256-511. Each is a code path of its own, so that no wgmma sits
// in a branch that ptxas sees as divergent (it would serialise them).
struct Cta {
  uint8_t* smem;
  uint32_t base, bar_full, bar_empty, bar_pfull, bar_pempty, rank;
  int c, h0, hg, b_first, first_tile, lo, hi;
};

template <int kCluster, bool kScores>
__device__ __forceinline__ void consume(const Cta& cta,
                                        const __nv_bfloat16* __restrict__ q_lat,
                                        const __nv_bfloat16* __restrict__ q_rope,
                                        const int* __restrict__ lengths,
                                        const TcArgs& a,
                                        float* __restrict__ part_m,
                                        float* __restrict__ part_l,
                                        float* __restrict__ part_acc) {
  uint8_t* const smem = cta.smem;
  const uint32_t base = cta.base, bar_full = cta.bar_full,
                 bar_empty = cta.bar_empty, bar_pfull = cta.bar_pfull,
                 bar_pempty = cta.bar_pempty, rank = cta.rank;
  const int c = cta.c, h0 = cta.h0, hg = cta.hg, b_first = cta.b_first,
            first_tile = cta.first_tile, lo = cta.lo, hi = cta.hi;
  constexpr int cw = kScores ? 0 : 1;
  const int t = threadIdx.x % 128, ct = threadIdx.x - 128;
  const int lane = threadIdx.x % 32;
  // Accumulator layout of wgmma m64nN (f32): register j of a thread holds
  // row r_lo (+8 when (j/2) is odd), column (j/4)*8 + col0 + (j%2).
  const int r_lo = 16 * (t / 32) + lane / 4, r_hi = r_lo + 8;
  const int col0 = 2 * (lane % 4);
  uint4* const p_x = reinterpret_cast<uint4*>(smem + kSmemP);
  float2* const corr_x = reinterpret_cast<float2*>(smem + kSmemCorr);
  float acc0[64], acc1[64];
  int k = 0;
  for (int b = b_first, first = first_tile, g = lo; g < hi; ++b) {
    const int n = live_tiles<kTile>(lengths, b, a.s_len);
    const int j0 = g - first, j1 = min(n, hi - first);
    if (j1 <= j0) {
      first += n;
      continue;
    }
    // Request b's queries [q_lat | q_rope] for the CTA's heads, swizzled
    // as a TMA box would be (chunk q of row r at q ^ (r % 8)); zero rows
    // past the last head. The previous segment's scores are done: the
    // other warpgroup got its last P after them.
    {
      const __nv_bfloat16* ql = q_lat + b * a.ql_b + h0 * a.ql_h;
      const __nv_bfloat16* qr = q_rope + b * a.qr_b + h0 * a.qr_h;
#pragma unroll
      for (int i = 0; i < kHeads * 72 / 256; i += 6) {
        uint4 v[6];
#pragma unroll
        for (int u = 0; u < 6; ++u) {
          const int e = (i + u) * 256 + ct, r = e / 72, q = e % 72;
          v[u] = make_uint4(0u, 0u, 0u, 0u);
          if (r < hg)
            v[u] = *reinterpret_cast<const uint4*>(
                q < 64 ? ql + r * a.ql_h + q * 8
                       : qr + r * a.qr_h + (q - 64) * 8);
        }
#pragma unroll
        for (int u = 0; u < 6; ++u) {
          const int e = (i + u) * 256 + ct, r = e / 72, q = e % 72;
          *reinterpret_cast<uint4*>(smem + kSmemQ + (q / 8) * kBoxBytes +
                                    r * 128 + ((q % 8) ^ (r % 8)) * 16) =
              v[u];
        }
      }
      fence_proxy_async();
      named_sync(1, 256);
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) acc0[i] = acc1[i] = 0.0f;
    float m_lo = kNeg, m_hi = kNeg, l_lo = 0.0f, l_hi = 0.0f;
    const int len = min(max(lengths[b], 0), a.s_len);

    for (int j = j0; j < j1; ++j, ++k) {
      const int s = k % kStages;
      const uint32_t stage = base + kSmemStage + s * kTileBytes;
      mbar_wait(bar_full + 8 * s, (k / kStages) & 1);
      uint32_t p[kTile / 16][4];
      float2 corr;
      if constexpr (kScores) {
        // S = Q.K^T: 64 heads x 64 positions over depth 576, A = Q and
        // B = the tile, both K-major in 64-column boxes.
        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
        if constexpr ((kProbeSkip & 1) == 0) {
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kBoxes * 4; ++kk) {
            const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
            wgmma_ss_n64(sc, smem_desc(base + kSmemQ + off, 16, 1024),
                         smem_desc(stage + off, 16, 1024), kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(sc);
        }
        const int live = len - j * kTile;   // at least 1
        corr = make_float2(1.0f, 1.0f);
        if constexpr ((kProbeSkip & 2) == 0) {
          // The online softmax in the log2 domain; positions at or past
          // the length score -inf and add p = 0.
          if (live < kTile) {
#pragma unroll
            for (int i = 0; i < 32; ++i)
              if ((i / 4) * 8 + col0 + (i % 2) >= live) sc[i] = -INFINITY;
          }
          float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            if ((i / 2) % 2) mx_hi = fmaxf(mx_hi, sc[i]);
            else mx_lo = fmaxf(mx_lo, sc[i]);
          }
#pragma unroll
          for (int x = 1; x <= 2; x <<= 1) {
            mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, x));
            mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, x));
          }
          const float mn_lo = fmaxf(m_lo, mx_lo * a.scale_log2);
          const float mn_hi = fmaxf(m_hi, mx_hi * a.scale_log2);
          corr = make_float2(exp2f(m_lo - mn_lo), exp2f(m_hi - mn_hi));
          m_lo = mn_lo;
          m_hi = mn_hi;
          float sum_lo = 0.0f, sum_hi = 0.0f;
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const bool hi = (i / 2) % 2;
            sc[i] = exp2f(__fmaf_rn(sc[i], a.scale_log2,
                                    hi ? -mn_hi : -mn_lo));
            if (hi) sum_hi += sc[i];
            else sum_lo += sc[i];
          }
          l_lo = __fmaf_rn(l_lo, corr.x, sum_lo);
          l_hi = __fmaf_rn(l_hi, corr.y, sum_hi);
        }
        // P rounded to bf16 (nearest even): register pairs of the
        // accumulator are the A fragment of a 16-position step.
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            p[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
        if (live < kTile) {
          // The tile's rows at or past the length hold other positions
          // of the cache (or TMA's zeros past S): zero their values, so
          // that p = 0 times them is 0 whatever they hold.
          uint8_t* st = smem + (stage - base);
          for (int e = t; e < (kTile - live) * 64; e += 128) {
            const int row = live + e / 64, q = e % 64;
            *reinterpret_cast<uint4*>(st + (q / 8) * kBoxBytes + row * 128 +
                                      (q % 8) * 16) =
                make_uint4(0u, 0u, 0u, 0u);
          }
          fence_proxy_async();
          named_sync(2, 128);
        }
        // Hand P and the rescale factors to warpgroup 2, thread to
        // thread (the same fragment layout), once it took the last ones.
        mbar_wait(bar_pempty, (k & 1) ^ 1);
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
          p_x[kk * 128 + t] = make_uint4(p[kk][0], p[kk][1], p[kk][2],
                                         p[kk][3]);
        corr_x[t] = corr;
        mbar_arrive(bar_pfull);
      } else {
        mbar_wait(bar_pfull, k & 1);
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          const uint4 v = p_x[kk * 128 + t];
          p[kk][0] = v.x;
          p[kk][1] = v.y;
          p[kk][2] = v.z;
          p[kk][3] = v.w;
        }
        corr = corr_x[t];
        mbar_arrive(bar_pempty);
      }
      // O += P.V over the tile's 64 positions: B = this warpgroup's 256
      // value columns of the same stage's ckv, MN-major (the transpose
      // bit), as two 128-column products; boxes 8 KB apart (the leading
      // byte offset), a 16-position step 2 KB further.
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const float f = (i / 2) % 2 ? corr.y : corr.x;
        acc0[i] *= f;
        acc1[i] *= f;
      }
      if constexpr ((kProbeSkip & 4) == 0) {
        const uint32_t v0 = stage + 4 * cw * kBoxBytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          wgmma_rs(acc0, p[kk], smem_desc(v0 + kk * 2048, kBoxBytes, 1024));
          wgmma_rs(acc1, p[kk], smem_desc(v0 + 2 * kBoxBytes + kk * 2048,
                                          kBoxBytes, 1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc0);
        fence_regs(acc1);
        fence_regs(p);
      }
      // Release the stage in every CTA of the cluster: a warp's reads
      // are done once each of its threads has waited.
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * s);
      if (kCluster > 1 && lane == 1)
        mbar_arrive_cluster(bar_empty + 8 * s, rank ^ 1u);
    }

    // The segment's unnormalised partial: slot c + b, rows h0 + r.
    const long long row0 = static_cast<long long>(c + b) * a.n_heads + h0;
    float* pa = part_acc + row0 * kR + 256 * cw;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = (i / 2) % 2 ? r_hi : r_lo;
      if (r < hg) {
        const int col = (i / 4) * 8 + col0;
        *reinterpret_cast<float2*>(pa + r * kR + col) =
            make_float2(acc0[i], acc0[i + 1]);
        *reinterpret_cast<float2*>(pa + r * kR + 128 + col) =
            make_float2(acc1[i], acc1[i + 1]);
      }
    }
    if constexpr (kScores) {
#pragma unroll
      for (int x = 1; x <= 2; x <<= 1) {
        l_lo += __shfl_xor_sync(0xffffffffu, l_lo, x);
        l_hi += __shfl_xor_sync(0xffffffffu, l_hi, x);
      }
      if (lane % 4 == 0) {
        if (r_lo < hg) {
          part_m[row0 + r_lo] = m_lo;
          part_l[row0 + r_lo] = l_lo;
        }
        if (r_hi < hg) {
          part_m[row0 + r_hi] = m_hi;
          part_l[row0 + r_hi] = l_hi;
        }
      }
    }
    g = first + j1;
    first += n;
  }
}

// One CTA of 384 threads takes 64 heads of the requests of its cluster's
// run; at H > 64 a cluster of two CTAs (heads 0-63 and 64-127) shares each
// tile, half of its TMA boxes issued by each CTA into both.
template <int kCluster>
__global__ void __launch_bounds__(kThreads, 1)
mla_decode_tc_kernel(const __grid_constant__ CUtensorMap ckv_map,
                     const __grid_constant__ CUtensorMap krope_map,
                     const __nv_bfloat16* __restrict__ q_lat,
                     const __nv_bfloat16* __restrict__ q_rope,
                     const int* __restrict__ lengths, const TcArgs a,
                     float* __restrict__ part_m, float* __restrict__ part_l,
                     float* __restrict__ part_acc) {
  // Probe bit 16: each CTA copies every box itself (no multicast).
  constexpr bool kMulticast = kCluster > 1 && (kProbeSkip & 16) == 0;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 bytes: align the tiles to it.
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t bar_full = base + kSmemBar;            // [kStages]
  const uint32_t bar_empty = bar_full + 8 * kStages;    // [kStages]
  const uint32_t bar_pfull = bar_empty + 8 * kStages;
  const uint32_t bar_pempty = bar_pfull + 8;
  int* const plan = reinterpret_cast<int*>(smem + kSmemPlan);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t rank = kCluster > 1 ? cluster_ctarank() : 0u;
  const int c = blockIdx.x / kCluster;
  const int h0 = static_cast<int>(rank) * kHeads;
  const int hg = min(kHeads, a.n_heads - h0);

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      // Every consumer warp of every CTA of the cluster releases a stage.
      mbar_init(bar_empty + 8 * s, kConsumerWarps * kCluster);
    }
    mbar_init(bar_pfull, 128);
    mbar_init(bar_pempty, 128);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (warp == 1) {
    // This cluster's run [lo, hi) of the global tiles, from `lengths` on
    // the device; its first request and that request's first tile.
    const int total = count_tiles<kTile>(lengths, a.batch, a.s_len);
    int lo, hi, b0 = 0, first = 0;
    if constexpr ((kProbeSkip & 32) != 0) {
      // Probe bit 32: each request's tiles cut into C / B equal runs.
      const int per = max(1, a.n_clusters / a.batch);
      b0 = c / per;
      lo = hi = 0;
      if (b0 < a.batch) {
        first = count_tiles<kTile>(lengths, b0, a.s_len);
        const int n = live_tiles<kTile>(lengths, b0, a.s_len);
        lo = first + c % per * n / per;
        hi = first + (c % per + 1) * n / per;
      }
    } else {
      lo = run_start(c, a.n_clusters, total);
      hi = run_start(c + 1, a.n_clusters, total);
      if (lo < hi) find_request<kTile>(lengths, a.batch, a.s_len, lo, b0, first);
    }
    if (lane == 0) {
      plan[0] = b0;
      plan[1] = first;
      plan[2] = lo;
      plan[3] = hi;
    }
  }
  // The barriers are initialised and the plan is written, in both CTAs,
  // before either CTA copies into or arrives on the other's.
  cluster_sync();
  const int b_first = plan[0], first_tile = plan[1], lo = plan[2],
            hi = plan[3];

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread keeps the ring of 2 stages full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int k = 0;   // the run's tile count: stage k % 2, round k / 2
      for (int b = b_first, first = first_tile, g = lo; g < hi; ++b) {
        const int n = live_tiles<kTile>(lengths, b, a.s_len);
        const int j0 = g - first, j1 = min(n, hi - first);
        for (int j = j0; j < j1; ++j, ++k) {
          const int s = k % kStages;
          const uint32_t stage = base + kSmemStage + s * kTileBytes;
          const uint32_t full = bar_full + 8 * s;
          // The first round finds the ring empty (parity 1 passes).
          mbar_wait(bar_empty + 8 * s, ((k / kStages) & 1) ^ 1);
          if constexpr ((kProbeSkip & 8) != 0) {
            mbar_arrive(full);
            continue;
          }
          // The whole tile lands in this CTA: this producer's boxes and,
          // in a cluster, the peer's.
          mbar_expect_tx(full, kTileBytes);
          for (int x = kMulticast ? static_cast<int>(rank) : 0; x < kBoxes;
               x += kMulticast ? kCluster : 1) {
            const CUtensorMap* map = x < kBoxes - 1 ? &ckv_map : &krope_map;
            const int col = x < kBoxes - 1 ? x * 64 : 0;
            if constexpr (kMulticast)
              tma_load_3d_multicast(stage + x * kBoxBytes, map, full, col,
                                    j * kTile, b, (1u << kCluster) - 1);
            else
              tma_load_3d(stage + x * kBoxBytes, map, full, col, j * kTile,
                          b);
          }
        }
        if (j1 > j0) g = first + j1;
        first += n;
      }
    }
    // No CTA leaves while its peer may still copy into it or arrive on
    // its barriers.
    cluster_sync();
  } else {
    // ---- consumers: 64 x 256 f32 accumulators a thread (setmaxnreg up to
    // 232), warpgroup 1 with the scores and the softmax ----
    const Cta cta{smem, base, bar_full, bar_empty, bar_pfull, bar_pempty,
                  rank, c, h0, hg, b_first, first_tile, lo, hi};
    if (wg == 1) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
      consume<kCluster, true>(cta, q_lat, q_rope, lengths, a, part_m,
                              part_l, part_acc);
    } else {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
      consume<kCluster, false>(cta, q_lat, q_rope, lengths, a, part_m,
                               part_l, part_acc);
    }
    cluster_sync();
  }
}

template <int kCluster>
cudaLaunchConfig_t launch_config(cudaLaunchAttribute* attr, int n_clusters,
                                 cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_clusters * kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmemBytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of kCluster CTAs that fit on the card at once (one CTA an SM).
template <int kCluster>
int max_clusters(int* n) {
  cudaError_t err = cudaFuncSetAttribute(
      mla_decode_tc_kernel<kCluster>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<kCluster>(&attr, 1, nullptr);
  err = cudaOccupancyMaxActiveClusters(n, mla_decode_tc_kernel<kCluster>,
                                       &cfg);
  return static_cast<int>(err);
}

template <int kCluster>
int launch(const void* q_lat, const void* q_rope, const void* ckv,
           const void* krope, const void* lengths, void* out, float* pm,
           float* pl, float* pa, const long long* st, int batch, int n_heads,
           int s_len, int n_clusters, float scale, cudaStream_t stream) {
  if (n_clusters < 1) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap ckv_map, krope_map;
  int err = make_map_3d(&ckv_map, ckv, kR, s_len, batch, st[5], st[4],
                        kTile);
  if (!err)
    err = make_map_3d(&krope_map, krope, kP, s_len, batch, st[7], st[6],
                      kTile);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(
      mla_decode_tc_kernel<kCluster>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const TcArgs a{st[0], st[1], st[2], st[3], batch, n_heads, s_len,
                 n_clusters, scale * kLog2e};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      launch_config<kCluster>(&attr, n_clusters, stream);
  e = cudaLaunchKernelEx(&cfg, mla_decode_tc_kernel<kCluster>, ckv_map,
                         krope_map, static_cast<const __nv_bfloat16*>(q_lat),
                         static_cast<const __nv_bfloat16*>(q_rope),
                         static_cast<const int*>(lengths), a, pm, pl, pa);
  if (e != cudaSuccess) return static_cast<int>(e);
  mla_decode_merge_kernel<kTile, kR, __nv_bfloat16>
      <<<batch * n_heads, kMergeThreads, n_clusters * sizeof(float),
         stream>>>(static_cast<const int*>(lengths),
                   RunArgs{batch, n_heads, s_len, n_clusters}, pm, pl, pa,
                   static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// ---- the tf32x3 instance: f32, R 512, P 64 ---------------------------------

namespace tf {

constexpr int kR = 512, kP = 64, kK = kR + kP;
constexpr int kHeads = 16;                  // heads a CTA: the mma's M
constexpr int kTile = 32;                   // positions a tile
constexpr int kStages = 2;                  // tiles in the cp.async ring
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kSteps = kK / 8 / kWarps;     // k-steps of the scores a warp: 9
constexpr int kCols = kR / kWarps;          // value columns a warp: 64
constexpr int kN = kTile / 8;               // score n-tiles; P.V k-steps
constexpr int kRow = kK + 4;                // f32 a row of Q or a tile, padded
constexpr int kSmemQ = 0;                                 // [kHeads][kRow]
constexpr int kSmemTile = kSmemQ + kHeads * kRow * 4;     // [stage][kTile][kRow]
constexpr int kSmemRed = kSmemTile + kStages * kTile * kRow * 4;  // [warp][kN][lane]
constexpr int kSmemP = kSmemRed + kWarps * kN * 32 * 16;  // [kN][lane]
constexpr int kSmemCorr = kSmemP + kN * 32 * 16;          // [kHeads]
constexpr int kSmemPlan = kSmemCorr + kHeads * 4;
constexpr int kSmemBytes = kSmemPlan + 16;
static_assert(kSteps * 8 * kWarps == kK, "the scores' depth by warp");
static_assert(kSmemBytes <= 232448, "shared memory");

struct TfArgs {
  long long ql_b, ql_h;         // q_lat (B, H, R)
  long long qr_b, qr_h;         // q_rope (B, H, P)
  long long c_b, c_s;           // ckv (B, S, R)
  long long k_b, k_s;           // krope (B, S, P)
  int batch, n_heads, s_len, n_runs;
  float scale_log2;             // scale * log2(e)
};

// Rows [0, n) of [a | b] (a row of a: kR floats at a + r * sa; of b: kP
// at b + r * sb) into dst ([rows][kRow] f32) by 16-byte cp.async; rows
// [n, rows) are zeros.
template <int kRows>
__device__ __forceinline__ void copy_rows(float* dst, const float* a,
                                          long long sa, const float* b,
                                          long long sb, int n) {
  for (int e = threadIdx.x; e < kRows * (kK / 4); e += kThreads) {
    const int row = e / (kK / 4), q4 = e % (kK / 4);
    const bool ok = row < n;
    const long long r = ok ? row : 0;
    const float* src = q4 < kR / 4 ? a + r * sa + q4 * 4
                                   : b + r * sb + (q4 - kR / 4) * 4;
    cp_async16(dst + row * kRow + q4 * 4, src, ok);
  }
}

// A CTA of 8 warps takes 16 heads (h0 = 16 x its group) of the requests of
// its run (run = blockIdx.x / groups); the groups of a run are neighbours
// in launch order, so a tile leaves memory once and the other groups read
// it from L2.
__global__ void __launch_bounds__(kThreads, 1)
mla_decode_tf32x3_kernel(const float* __restrict__ q_lat,
                         const float* __restrict__ q_rope,
                         const float* __restrict__ ckv,
                         const float* __restrict__ krope,
                         const int* __restrict__ lengths, const TfArgs a,
                         float* __restrict__ part_m,
                         float* __restrict__ part_l,
                         float* __restrict__ part_acc) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* const qs = reinterpret_cast<float*>(smem + kSmemQ);
  float* const ring = reinterpret_cast<float*>(smem + kSmemTile);
  float4* const red = reinterpret_cast<float4*>(smem + kSmemRed);
  float4* const p_s = reinterpret_cast<float4*>(smem + kSmemP);
  float* const corr_s = reinterpret_cast<float*>(smem + kSmemCorr);
  int* const plan = reinterpret_cast<int*>(smem + kSmemPlan);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;   // the mma's groupID, thread
  const int groups = (a.n_heads + kHeads - 1) / kHeads;
  const int c = blockIdx.x / groups;
  const int h0 = blockIdx.x % groups * kHeads;
  const int hg = min(kHeads, a.n_heads - h0);
  if (warp == 0) {
    // This run [lo, hi) of the global tiles, from `lengths` on the device;
    // its first request and that request's first tile.
    const int total = count_tiles<kTile>(lengths, a.batch, a.s_len);
    const int lo = run_start(c, a.n_runs, total);
    const int hi = run_start(c + 1, a.n_runs, total);
    int b0 = 0, first = 0;
    if (lo < hi) find_request<kTile>(lengths, a.batch, a.s_len, lo, b0, first);
    if (lane == 0) {
      plan[0] = b0;
      plan[1] = first;
      plan[2] = lo;
      plan[3] = hi;
    }
  }
  __syncthreads();
  const int b_first = plan[0], first_tile = plan[1], lo = plan[2],
            hi = plan[3];
  // The softmax of rows (heads) 2 warp and 2 warp + 1: this lane's row,
  // its positions 2 k2 and 2 k2 + 1 of a tile, and where the scores'
  // fragments hold them (n-tile, lane, register).
  const int sr = 2 * warp + lane / 16, k2 = lane % 16;
  const int s_n = k2 / 4, s_lane = sr % 8 * 4 + k2 % 4, s_reg = sr / 8 * 2;
  // This warp's A fragments of Q: a0 (g, t), a1 (g+8, t), a2 (g, t+4),
  // a3 (g+8, t+4) of its k-steps, dims [72 warp, + 72) of [q_lat | q_rope].
  const float* const qa = qs + gq * kRow + warp * kSteps * 8 + tq;

  float acc[kCols / 8][4];   // O, heads g and g + 8 x this warp's columns
  float mc_run = 0.0f, l_run = 0.0f;   // row sr: max (log2 domain), sum
  for (int b = b_first, first = first_tile, g = lo; g < hi; ++b) {
    const int n = live_tiles<kTile>(lengths, b, a.s_len);
    const int j0 = g - first, j1 = min(n, hi - first);
    if (j1 <= j0) {
      first += n;
      continue;
    }
    const int len = min(max(lengths[b], 0), a.s_len);
    const float* cb = ckv + b * a.c_b;
    const float* kb = krope + b * a.k_b;
    // The segment's queries (heads past the last are zeros) and its first
    // tile in one group of copies; then each tile's successor in flight
    // while it is consumed.
    copy_rows<kHeads>(qs, q_lat + b * a.ql_b + h0 * a.ql_h, a.ql_h,
                      q_rope + b * a.qr_b + h0 * a.qr_h, a.qr_h, hg);
    copy_rows<kTile>(ring, cb + static_cast<long long>(j0) * kTile * a.c_s,
                     a.c_s, kb + static_cast<long long>(j0) * kTile * a.k_s,
                     a.k_s, len - j0 * kTile);
    cp_async_commit();
#pragma unroll
    for (int d = 0; d < kCols / 8; ++d)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[d][i] = 0.0f;
    mc_run = kNeg;
    l_run = 0.0f;

    for (int j = j0; j < j1; ++j) {
      const int p0 = j * kTile;
      if (j + 1 < j1) {
        const long long p1 = p0 + kTile;
        copy_rows<kTile>(ring + (j + 1 - j0) % kStages * kTile * kRow,
                         cb + p1 * a.c_s, a.c_s, kb + p1 * a.k_s, a.k_s,
                         len - static_cast<int>(p1));
      }
      cp_async_commit();
      cp_async_wait<1>();   // tile j (and the segment's Q) has landed
      __syncthreads();
      const float* tile = ring + (j - j0) % kStages * kTile * kRow;

      // This warp's share of S = Q.K^T (its 9 of the 72 k-steps; B
      // fragments b0 = K[n*8 + g][d*8 + t], b1 at dim t + 4), to `red`.
      {
        float sc[kN][4];
#pragma unroll
        for (int nn = 0; nn < kN; ++nn)
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[nn][i] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < kSteps; ++kk) {
          uint32_t ah[4], al[4];
          split(qa[kk * 8], ah[0], al[0]);
          split(qa[kk * 8 + 8 * kRow], ah[1], al[1]);
          split(qa[kk * 8 + 4], ah[2], al[2]);
          split(qa[kk * 8 + 8 * kRow + 4], ah[3], al[3]);
          const float* kt = tile + gq * kRow + (warp * kSteps + kk) * 8 + tq;
#pragma unroll
          for (int nn = 0; nn < kN; ++nn) {
            uint32_t bh[2], bl[2];
            split(kt[nn * 8 * kRow], bh[0], bl[0]);
            split(kt[nn * 8 * kRow + 4], bh[1], bl[1]);
            mma(sc[nn], al, bh);
            mma(sc[nn], ah, bl);
            mma(sc[nn], ah, bh);
          }
        }
#pragma unroll
        for (int nn = 0; nn < kN; ++nn)
          red[(warp * kN + nn) * 32 + lane] =
              make_float4(sc[nn][0], sc[nn][1], sc[nn][2], sc[nn][3]);
      }
      __syncthreads();

      // The online softmax of rows sr (a half-warp each): the warps'
      // shares summed in warp order, positions at or past the length
      // masked (-1e30, p = 0); p = 2^(s c - m c) to p_s in the scores'
      // fragment layout, the row's rescale factor to corr_s.
      {
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float2 x = *reinterpret_cast<const float2*>(
              reinterpret_cast<const float*>(red + (w * kN + s_n) * 32 +
                                             s_lane) + s_reg);
          s0 += x.x;
          s1 += x.y;
        }
        const bool live0 = p0 + 2 * k2 < len, live1 = p0 + 2 * k2 + 1 < len;
        s0 = live0 ? s0 : kNeg;
        s1 = live1 ? s1 : kNeg;
        float mx = fmaxf(s0, s1);
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float mc_new = fmaxf(mc_run, mx * a.scale_log2);
        const float e0 =
            live0 ? exp2_fast(__fmaf_rn(s0, a.scale_log2, -mc_new)) : 0.0f;
        const float e1 =
            live1 ? exp2_fast(__fmaf_rn(s1, a.scale_log2, -mc_new)) : 0.0f;
        float ps = e0 + e1;
#pragma unroll
        for (int o = 8; o > 0; o >>= 1)
          ps += __shfl_xor_sync(0xffffffffu, ps, o);
        const float corr = exp2_fast(mc_run - mc_new);
        l_run = l_run * corr + ps;
        mc_run = mc_new;
        *reinterpret_cast<float2*>(
            reinterpret_cast<float*>(p_s + s_n * 32 + s_lane) + s_reg) =
            make_float2(e0, e1);
        if (k2 == 0) corr_s[sr] = corr;
      }
      __syncthreads();

      // O += P.V over the tile for this warp's 64 columns: A fragment of
      // positions kk*8 + {2t, 2t+1} (the scores' layout: a0 = p(g, 2t),
      // a1 = p(g+8, 2t), a2 = p(g, 2t+1), a3 = p(g+8, 2t+1)); B fragment
      // b0 = V[kk*8 + 2t][col], b1 = V[kk*8 + 2t + 1][col], V = the ckv
      // columns of the same tile.
      {
        const float cg = corr_s[gq], cg8 = corr_s[gq + 8];
#pragma unroll
        for (int d = 0; d < kCols / 8; ++d) {
          acc[d][0] *= cg;
          acc[d][1] *= cg;
          acc[d][2] *= cg8;
          acc[d][3] *= cg8;
        }
#pragma unroll
        for (int kk = 0; kk < kN; ++kk) {
          const float4 pv = p_s[kk * 32 + lane];
          const float pa[4] = {pv.x, pv.z, pv.y, pv.w};
          uint32_t ph[4], pl[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) split(pa[i], ph[i], pl[i]);
          const float* vt = tile + (kk * 8 + 2 * tq) * kRow + warp * kCols + gq;
#pragma unroll
          for (int d = 0; d < kCols / 8; ++d) {
            uint32_t bh[2], bl[2];
            split(vt[d * 8], bh[0], bl[0]);
            split(vt[d * 8 + kRow], bh[1], bl[1]);
            mma(acc[d], pl, bh);
            mma(acc[d], ph, bl);
            mma(acc[d], ph, bh);
          }
        }
      }
      // The stage, red and p_s are free for the next tile; after the
      // segment's last, Q is free for the next segment.
      __syncthreads();
    }

    // The segment's unnormalised partial: slot c + b, rows h0 + r.
    const long long row0 = static_cast<long long>(c + b) * a.n_heads + h0;
    float* pa = part_acc + row0 * kR + warp * kCols + 2 * tq;
#pragma unroll
    for (int d = 0; d < kCols / 8; ++d) {
      if (gq < hg)
        *reinterpret_cast<float2*>(pa + gq * kR + d * 8) =
            make_float2(acc[d][0], acc[d][1]);
      if (gq + 8 < hg)
        *reinterpret_cast<float2*>(pa + (gq + 8) * kR + d * 8) =
            make_float2(acc[d][2], acc[d][3]);
    }
    if (k2 == 0 && sr < hg) {
      part_m[row0 + sr] = mc_run;
      part_l[row0 + sr] = l_run;
    }

    g = first + j1;
    first += n;
  }
}

// Runs of CTAs that fit on the card at once (one CTA an SM; a run is
// ceil(H / 16) CTAs), at least 1.
int max_runs(int n_heads, int* n) {
  cudaError_t err = cudaFuncSetAttribute(
      mla_decode_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, mla_decode_tf32x3_kernel, kThreads, kSmemBytes);
  const int groups = (n_heads + kHeads - 1) / kHeads;
  *n = std::max(1, per_sm * sms / groups);
  return static_cast<int>(err);
}

int launch(const void* q_lat, const void* q_rope, const void* ckv,
           const void* krope, const void* lengths, void* out, float* pm,
           float* pl, float* pa, const long long* st, int batch, int n_heads,
           int s_len, int n_runs, float scale, cudaStream_t stream) {
  if (n_runs < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      mla_decode_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const TfArgs a{st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
                 batch, n_heads, s_len, n_runs, scale * 1.4426950408889634f};
  const int groups = (n_heads + kHeads - 1) / kHeads;
  mla_decode_tf32x3_kernel<<<n_runs * groups, kThreads, kSmemBytes, stream>>>(
      static_cast<const float*>(q_lat), static_cast<const float*>(q_rope),
      static_cast<const float*>(ckv), static_cast<const float*>(krope),
      static_cast<const int*>(lengths), a, pm, pl, pa);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  mla_decode_merge_kernel<kTile, kR, float>
      <<<batch * n_heads, kMergeThreads, n_runs * sizeof(float), stream>>>(
          static_cast<const int*>(lengths),
          RunArgs{batch, n_heads, s_len, n_runs}, pm, pl, pa,
          static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tf

// ---- the SIMT instances: f32 and bf16 at (16, 8) ----------------------------

namespace simt {

constexpr int kHeads = 8;   // heads a block: a warp each in the softmax

template <int R, int P>
struct Smem {
  static constexpr int kK = R + P;
  static constexpr int kRow = kK + 1;   // f32 a tile row: lanes' rows apart
  static constexpr int kFloats = kHeads * kK + kTile * kRow +
                                 kHeads * kTile + kHeads;
  static constexpr int kBytes = kFloats * 4;
  static_assert(kBytes <= 232448, "shared memory");
};

template <int R, int P, typename T>
__global__ void __launch_bounds__(kThreads)
mla_decode_simt_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_rope,
                       const T* __restrict__ ckv, const T* __restrict__ krope,
                       const int* __restrict__ lengths, Args a,
                       float* __restrict__ part_m, float* __restrict__ part_l,
                       float* __restrict__ part_acc) {
  using S = Smem<R, P>;
  constexpr int kK = S::kK, kRow = S::kRow;
  constexpr int kCols = (R + kThreads - 1) / kThreads;   // columns a thread
  extern __shared__ float smemf[];
  float* q_s = smemf;                          // [kHeads][kK]
  float* tile = q_s + kHeads * kK;             // [kTile][kRow]
  float* p_s = tile + kTile * kRow;            // [kHeads][kTile]
  float* corr_s = p_s + kHeads * kTile;        // [kHeads]
  const int n_grp = (a.n_heads + kHeads - 1) / kHeads;
  const int split = blockIdx.x / n_grp, b = blockIdx.y;
  const int h0 = blockIdx.x % n_grp * kHeads;
  const int hg = min(kHeads, a.n_heads - h0);
  const int len = min(max(lengths[b], 0), a.s_len);
  int start, end;
  split_range(len, split, a.n_split, start, end);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int e = tid; e < kHeads * kK; e += kThreads) {
    const int g = e / kK, d = e % kK;
    float x = 0.0f;
    if (g < hg)
      x = widen(d < R ? q_lat[b * a.ql_b + (h0 + g) * a.ql_h + d]
                      : q_rope[b * a.qr_b + (h0 + g) * a.qr_h + d - R]);
    q_s[e] = x;
  }
  float acc[kHeads][kCols];
#pragma unroll
  for (int g = 0; g < kHeads; ++g)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[g][c] = 0.0f;
  float m_run = kNeg, l_run = 0.0f;   // warp g's head g

  for (int t0 = start; t0 < end; t0 += kTile) {
    __syncthreads();   // the previous tile is consumed (and q_s written)
    for (int e = tid; e < kTile * kK; e += kThreads) {
      const int j = e / kK, d = e % kK;
      const long long sj = t0 + j;
      float x = 0.0f;
      if (sj < end)
        x = widen(d < R ? ckv[b * a.c_b + sj * a.c_s + d]
                        : krope[b * a.k_b + sj * a.k_s + d - R]);
      tile[j * kRow + d] = x;
    }
    __syncthreads();
    // Scores and softmax: warp g takes head g, lane j position j.
    {
      const float* qg = q_s + warp * kK;
      const float* kr = tile + lane * kRow;
      float dot = 0.0f;
#pragma unroll 8
      for (int d = 0; d < kK; ++d) dot = fmaf(qg[d], kr[d], dot);
      const bool live = t0 + lane < end;
      const float s = live ? dot * a.scale : kNeg;
      const float m_new = fmaxf(m_run, warp_max(s));
      const float p = live ? expf(s - m_new) : 0.0f;
      const float corr = expf(m_run - m_new);
      l_run = fmaf(l_run, corr, warp_sum(p));
      m_run = m_new;
      p_s[warp * kTile + lane] = p;
      if (lane == 0) corr_s[warp] = corr;
    }
    __syncthreads();
    // P.V: thread its columns tid, tid + 256, ... of every head.
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tid + c * kThreads;
      if (col >= R) break;
#pragma unroll
      for (int g = 0; g < kHeads; ++g) {
        float x = acc[g][c] * corr_s[g];
#pragma unroll 8
        for (int j = 0; j < kTile; ++j)
          x = fmaf(p_s[g * kTile + j], tile[j * kRow + col], x);
        acc[g][c] = x;
      }
    }
  }

  const long long rows = static_cast<long long>(gridDim.y) * a.n_heads;
  const long long row0 = split * rows + static_cast<long long>(b) *
                         a.n_heads + h0;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = tid + c * kThreads;
    if (col >= R) break;
#pragma unroll
    for (int g = 0; g < kHeads; ++g)
      if (g < hg) part_acc[(row0 + g) * R + col] = acc[g][c];
  }
  if (lane == 0 && warp < hg) {
    part_m[row0 + warp] = m_run;
    part_l[row0 + warp] = l_run;
  }
}

}  // namespace simt

// One block per (b, head) row: rescale its splits' partials to their
// common max and normalise. A row with no live position gives 0.
constexpr int kCombineThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
mla_decode_combine_kernel(int r_dim, int n_split,
                          const float* __restrict__ part_m,
                          const float* __restrict__ part_l,
                          const float* __restrict__ part_acc,
                          T* __restrict__ out) {
  extern __shared__ float w_s[];   // [n_split]
  __shared__ float denom_s;
  const long long row = blockIdx.x, rows = gridDim.x;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float m = kNeg;
    for (int c = lane; c < n_split; c += 32)
      m = fmaxf(m, part_m[c * rows + row]);
    m = warp_max(m);
    float l = 0.0f;
    for (int c = lane; c < n_split; c += 32) {
      const float w = expf(part_m[c * rows + row] - m);
      w_s[c] = w;
      l = fmaf(part_l[c * rows + row], w, l);
    }
    l = warp_sum(l);
    if (lane == 0) denom_s = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const float denom = denom_s;
  for (int d = threadIdx.x; d < r_dim; d += kCombineThreads) {
    float acc = 0.0f;
    for (int c = 0; c < n_split; ++c)
      acc = fmaf(part_acc[(c * rows + row) * r_dim + d], w_s[c], acc);
    narrow(out + row * r_dim + d, acc / denom);
  }
}

template <typename T, typename Kernel>
int launch(Kernel partial, int smem, int heads_per_block, int r_dim,
           const void* q_lat, const void* q_rope, const void* ckv,
           const void* krope, const void* lengths, void* out, float* pm,
           float* pl, float* pa, int batch, const Args& a,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // A request's head blocks of one split are neighbours in launch order,
  // so they read its cache at about the same time (the second from L2).
  const dim3 grid(a.n_split * ((a.n_heads + heads_per_block - 1) /
                               heads_per_block),
                  batch);
  partial<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_rope),
      static_cast<const T*>(ckv), static_cast<const T*>(krope),
      static_cast<const int*>(lengths), a, pm, pl, pa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_decode_combine_kernel<T><<<batch * a.n_heads, kCombineThreads,
                                 a.n_split * sizeof(float), stream>>>(
      r_dim, a.n_split, pm, pl, pa, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_lat (B,H,R) and q_rope (B,H,P) through strides st[0..1], st[2..3] =
// {b, h}; ckv (B,S,R) and krope (B,S,P) through st[4..5], st[6..7] =
// {b, s}; the last dim contiguous, and at (512, 64) every base and stride
// 16-byte aligned (TMA's, cp.async's and the 16-byte query loads'). lengths (B,)
// int32: positions attended per request ([0, lengths)). out (B,H,R)
// contiguous, of the inputs' type (bf16 if is_bf16, else f32). (R, P) is
// (512, 64) or (16, 8); H at most 128 (the wrapper's limit). n_part: at
// (512, 64) the runs, bf16's clusters (moby_mla_decode_clusters) or f32's
// (moby_mla_decode_runs), with scratch part_m, part_l (n_part + B, H) and
// part_acc (n_part + B, H, R) f32; at (16, 8) the SIMT instance's splits a
// request, with scratch part_m, part_l (n_part, B*H) and part_acc (n_part,
// B*H, R).
MOBY_API int moby_mla_decode_attention(
    const void* q_lat, const void* q_rope, const void* ckv, const void* krope,
    const void* lengths, void* out, void* part_m, void* part_l,
    void* part_acc, const long long* st, int batch, int n_heads, int s_len,
    int r_dim, int p_dim, int n_part, int is_bf16, float scale,
    void* stream) {
  if (batch * n_heads == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* pm = static_cast<float*>(part_m);
  auto* pl = static_cast<float*>(part_l);
  auto* pa = static_cast<float*>(part_acc);
  const bool wide = r_dim == 512 && p_dim == 64;
  if (!wide && !(r_dim == 16 && p_dim == 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (wide && is_bf16)
    return n_heads > tc::kHeads
               ? tc::launch<2>(q_lat, q_rope, ckv, krope, lengths, out, pm,
                               pl, pa, st, batch, n_heads, s_len, n_part,
                               scale, s)
               : tc::launch<1>(q_lat, q_rope, ckv, krope, lengths, out, pm,
                               pl, pa, st, batch, n_heads, s_len, n_part,
                               scale, s);
  if (wide)
    return tf::launch(q_lat, q_rope, ckv, krope, lengths, out, pm, pl, pa,
                      st, batch, n_heads, s_len, n_part, scale, s);
  const Args a{st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
               n_heads, s_len, n_part, scale};
  if (is_bf16)
    return launch<__nv_bfloat16>(
        simt::mla_decode_simt_kernel<16, 8, __nv_bfloat16>,
        simt::Smem<16, 8>::kBytes, simt::kHeads, r_dim, q_lat, q_rope, ckv,
        krope, lengths, out, pm, pl, pa, batch, a, s);
  return launch<float>(simt::mla_decode_simt_kernel<16, 8, float>,
                       simt::Smem<16, 8>::kBytes, simt::kHeads, r_dim, q_lat,
                       q_rope, ckv, krope, lengths, out, pm, pl, pa, batch, a,
                       s);
}

// The clusters the tensor-core instance runs at n_heads query heads: as
// many as fit on the card at once (a CTA an SM; a cluster of 2 at more
// than 64 heads), or minus a CUDA error code.
MOBY_API int moby_mla_decode_clusters(int n_heads) {
  int n = 0;
  const int err = n_heads > tc::kHeads ? tc::max_clusters<2>(&n)
                                       : tc::max_clusters<1>(&n);
  return err ? -err : n;
}

// The runs the tf32x3 instance splits the live tiles into at n_heads query
// heads: the groups of ceil(n_heads / 16) CTAs that fit on the card at
// once (one CTA an SM), or minus a CUDA error code.
MOBY_API int moby_mla_decode_runs(int n_heads) {
  int n = 0;
  const int err = tf::max_runs(n_heads, &n);
  return err ? -err : n;
}
