// Blocked online-softmax attention (prefill), GQA-aware, f32-accurate on
// the tensor cores by a 3xTF32 split.
//
// Replaces the TPU kernel
// repro/kernels/flash_attention/flash_attention.py (flash_attention_pallas).
// This is the "tf32x3" route: f32 inputs, and bf16 at head dims 16 and
// 32 and at MLA's (24, 16) (the SMOKE configs). bf16 at head dims 64 and 128 (zamba2, whisper
// and the full-width dense configs) runs on the tensor cores in bf16 in
// flash_attention_tc.cu; kernels/flash_attention/ops.py::route chooses.
// The bf16 hd-64 instance this kernel had until then is gone (its times
// stay in PERF.md). The value head dim VD
// equals the qk head dim HD, except at MLA's (HD, VD) = (192, 128)
// (deepseek-v2, f32) and (24, 16) (its SMOKE config, f32 and bf16: rows
// of 48 and 32 bytes in bf16, whole 16-byte copies): the JAX
// package's plain attention at those dims
// (repro/models/layers.py::multihead_attention), which the Pallas kernel
// does not take.
//
// What bounds it on an H100: operations. At the serving shape of prefill
// (B=1, H=16, KV=2, S=8192, hd=128, causal) a call does 2.75e11 flops on
// ~75 MB of q/k/v/o: 4.1 ms of float32 arithmetic outside the tensor cores
// at 67 TFLOP/s, against 0.02 ms of memory. The tensor cores take TF32
// (10-bit mantissas) at 495 TFLOP/s; three TF32 products a product keep
// f32 accuracy, so the floor is 3 x 2.75e11 / 495e12 = 1.67 ms. mma.sync
// reaches only part of that TF32 rate, and float32 instructions do not
// issue beside its products while integer ones do
// (tools/mma_sync_rate.py measures both; PERF.md has the numbers): the
// splits' subtractions and the softmax cost time of their own.
//
// The 3xTF32 split (tf32x3.cuh): each f32 operand becomes hi, rounded to
// TF32, and lo = x - hi; a product is lo_a*hi_b + hi_a*lo_b + hi_a*hi_b by
// mma.sync.m16n8k8 (TF32 in, f32 accumulators). bf16 values are exact in
// TF32, so for bf16 Q.K^T takes one product and P.V two (p split, V
// exact).
//
// Why mma.sync and not wgmma: wgmma transposes only 16-bit operands, so a
// TF32 B operand must be K-major in shared memory, and V in P.V is
// MN-major (the head dim contiguous). With mma.sync every thread loads its
// own B fragment from shared memory in any layout.
//
// Design:
// * one block of NW = 8 warps (4 where 8 would leave SMs idle: the grid is
//   sized on the host from the SM count) per (query tile, b, group of hb
//   query heads of one kv head), hb = gcd(H / KV, NW). Each warp takes 16
//   query rows of one head (the mma's M), so a block stacks hb heads x
//   16 * NW / hb rows, and each K/V tile is read from memory once for all
//   of them (qwen2.5-3B: 8 heads a kv head, one block a group at NW = 8).
//   The causal grid runs its heaviest query tiles first;
// * K and V tiles of 64 keys arrive by 16-byte cp.async (zero-filled past
//   sk) in a 2-stage ring in dynamic shared memory, the next tile in
//   flight while one is consumed: one __syncthreads a tile. Rows are
//   padded (4 floats or 8 bf16) so that the B fragments, K[key g][dim t,
//   t+4] for Q.K^T and V[key 2t, 2t+1][dim g] for P.V, are read without
//   bank conflicts. The wrapper checks 16-byte aligned bases and strides;
// * a warp keeps its Q fragments in shared memory (f32, in fragment order:
//   one 16-byte load a k-step) and its O accumulator in registers; each B
//   fragment is split in registers as it is loaded. At hd 128 the block
//   holds 64 KB of Q and 132 KB of ring, one block an SM. Splitting each
//   K/V tile once for the block into shared memory was slower on the card
//   (twice the fragment loads), as were 32-key tiles; 4-warp blocks are
//   faster where 8-warp ones would leave SMs idle (LM B's shape) and
//   slower elsewhere (the prefill shape). K and V rows have their own
//   widths in a stage;
// * MLA's f32 (192, 128) (deepseek-v2's prefill, H = KV: no K/V tile is
//   shared between heads) has a tiling of its own (Tiling<192, 128>): 8
//   warps over 32-key tiles in a 2-stage ring (96 KB of Q + 82 KB), where
//   64-key tiles allowed only 4 warps (one a scheduler, stalled on its own
//   loads and mma chains). Its blocks are persistent, one an SM: every
//   (b, head) pair's query tiles, heaviest first, laid end to end by their
//   key tiles and cut into equal runs, a run a block; the ring runs on
//   across a block's items (the next item's first tiles load during the
//   last tiles of one), and each warp copies the next item's Q as soon as
//   its last scores are taken, behind that tile's softmax and P.V; a warp
//   skips the tiles whose keys all lie past its last row. A pair's query
//   tiles are neighbours in a run, so its K/V tiles are read again from
//   L2;
// * the online softmax runs in f32 on the accumulator fragments (a row
//   lives on the 4 threads of a quad: two shuffles for its max; the sum l
//   stays per thread until the end), as p = 2^(s c - m c) with c = scale *
//   log2(e), one fma and the SFU's ex2.approx; only the tiles that cross
//   sk or a row's diagonal are masked, and the accumulator is rescaled
//   only when some row's max moved. P goes from the S accumulators to
//   P.V's A fragments without shuffles: P.V's k index t stands for key 2t
//   and t + 4 for key 2t + 1, and the B fragment reads V's rows in that
//   order;
// * semantics are the Pallas kernel's: masked scores are the finite -1e30
//   and masked keys give p = 0 (so a row with no live key gives 0); the
//   causal limit is kj <= qi and keys past sk are masked; the output is
//   acc / max(l, 1e-30), rounded to the input type (nearest even); rows
//   >= sq are not stored. The library builds with -fmad=false: the one
//   intended fused multiply-add is an explicit __fmaf_rn.
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "moby_kernels.cuh"
#include "tf32x3.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
// Dynamic shared memory a block may use on an H100 (227 KB).
constexpr int kMaxSmem = 232448;

struct Strides {                 // in elements; the head dim has stride 1
  long long b, h, s;
};

// An instance's tiles: keys a K/V tile, tiles in the cp.async ring, and
// whether a block walks a run of items (persistent) or takes one.
template <int HD, int VD, typename T>
struct Tiling {
  static constexpr int kBk = 64;
  static constexpr int kStages = 2;
  static constexpr bool kPersistent = false;
};

// MLA's f32 (192, 128): 32-key tiles, so that 8 warps' Q (96 KB) and the
// ring (2 stages, 82 KB) fit; one persistent block an SM.
template <>
struct Tiling<192, 128, float> {
  static constexpr int kBk = 32;
  static constexpr int kStages = 2;
  static constexpr bool kPersistent = true;
};

// Shared memory of a block: each warp's Q fragments ([warp][hd/8][lane]
// of 4 f32 words), then a ring of K/V stages (K [kBk][HD + pad], then V
// [kBk][VD + pad], each).
template <int HD, int VD, typename T, int NW>
struct Smem {
  using Tl = Tiling<HD, VD, T>;
  static constexpr int kRowK = HD + kPad<T>;     // elements
  static constexpr int kRowV = VD + kPad<T>;
  static constexpr int kTile = Tl::kBk * (kRowK + kRowV);   // elements a stage
  static constexpr int kQ = NW * (HD / 8) * 32 * 16;
  static constexpr int kBytes =
      kQ + Tl::kStages * kTile * static_cast<int>(sizeof(T));
  static constexpr bool kFits = kBytes <= kMaxSmem;
};

// Keys [k0, k0 + BK) of K and V into one stage: K [BK][HD + pad], then
// V [BK][VD + pad].
template <int HD, int VD, typename T, int NW>
__device__ __forceinline__ void load_tile(T* stage, const T* kb,
                                          long long kss, const T* vb,
                                          long long vss, int k0, int sk) {
  using S = Smem<HD, VD, T, NW>;
  constexpr int kBk = S::Tl::kBk;
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunksK = HD / kVec;       // 16-byte chunks a row
  constexpr int kChunksV = VD / kVec;
  constexpr int kChunks = kChunksK + kChunksV;
  T* vstage = stage + kBk * S::kRowK;
  for (int c = threadIdx.x; c < kBk * kChunks; c += NW * 32) {
    const int r = c / kChunks, piece = c % kChunks;
    const bool ok = k0 + r < sk;
    const long long kj = ok ? k0 + r : 0;
    if (piece < kChunksK) {
      const int col = piece * kVec;
      cp_async16(stage + r * S::kRowK + col, kb + kj * kss + col, ok);
    } else {
      const int col = (piece - kChunksK) * kVec;
      cp_async16(vstage + r * S::kRowV + col, vb + kj * vss + col, ok);
    }
  }
}

// The persistent instance's copy of a warp's A fragments of Q (f32),
// into its slots of shared memory by 4-byte cp.async (in flight until the
// caller's next wait; each lane writes and reads back only its own): a0
// (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4) of each 8-dim k-step,
// at qf[d * 32]. Rows past sq are 0 (and never stored).
template <int HD>
__device__ __forceinline__ void copy_q(uint4* qf, const float* qp,
                                       long long qss, int row0, int sq,
                                       int gq, int tq) {
#pragma unroll 4
  for (int d = 0; d < HD / 8; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + gq + (i & 1) * 8;
      const bool ok = r < sq;
      cp_async4(reinterpret_cast<float*>(qf + d * 32) + i,
                qp + (ok ? r : 0) * qss + d * 8 + tq + (i & 2) * 2, ok);
    }
}

// A B fragment element of a stage, split (f32); bf16 is exact in TF32
// (lo unused).
template <typename T>
__device__ __forceinline__ void fragment(const T* at, uint32_t& hi,
                                         uint32_t& lo) {
  if constexpr (std::is_same<T, float>::value) {
    split(*at, hi, lo);
  } else {
    hi = __float_as_uint(widen(*at));
    lo = 0u;
  }
}

// S = Q.K^T for one 16 x BK tile of scores: B fragments b0 =
// K[n*8 + g][d*8 + t], b1 at dim t + 4. For f32 the small products
// (lo.hi + hi.lo) go to accumulators of their own, added to the big ones
// (hi.hi) at the end: two independent chains of products.
template <int HD, int BK, typename T>
__device__ __forceinline__ void scores(const T* kt, const uint4* qf,
                                       int gq, int tq,
                                       float (&sc)[BK / 8][4]) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kRow = HD + kPad<T>;
  constexpr int kN = BK / 8;
  float small[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[n][i] = small[n][i] = 0.0f;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    const uint4 q4 = qf[d * 32];
    uint32_t ah[4] = {q4.x, q4.y, q4.z, q4.w}, al[4];
    if (kF32) {
#pragma unroll
      for (int i = 0; i < 4; ++i) split(__uint_as_float(ah[i]), ah[i], al[i]);
    }
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const T* at = kt + (n * 8 + gq) * kRow + d * 8 + tq;
      uint32_t bh[2], bl[2];
      fragment(at, bh[0], bl[0]);
      fragment(at + 4, bh[1], bl[1]);
      if (kF32) {
        mma(small[n], al, bh);
        mma(small[n], ah, bl);
      }
      mma(sc[n], ah, bh);
    }
  }
  if (kF32) {
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] += small[n][i];
  }
}

// Online softmax of one 16 x BK tile of scores sc, raw dot products
// (rows g: c0, c1 and g+8: c2, c3; key k0 + n*8 + 2t + c), which then
// holds p = 2^(s c - m c), c = scale * log2(e) (one fma and the SFU's
// exp2; the running max m of a row is kept as mc = m c). Rescales the rows
// of acc, unless no row's max moved. kMask: the tile holds keys past sk
// or above a row's diagonal.
template <bool kMask, int kD, int BK>
__device__ __forceinline__ void online_softmax(
    float (&sc)[BK / 8][4], float (&acc)[kD][4], float (&m)[2],
    float (&mc)[2], float (&l)[2], const int (&rq)[2], int k0, int tq,
    int sk, int causal, float c) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bool live[BK / 8][2];
    float tile_max = kNeg;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kj = k0 + n * 8 + 2 * tq + j;
        live[n][j] = !kMask || (kj < sk && (!causal || kj <= rq[r]));
        float& s = sc[n][2 * r + j];
        if (kMask) s = live[n][j] ? s : kNeg;
        tile_max = fmaxf(tile_max, s);
      }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(kFull, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(kFull, tile_max, 2));
    const float m_new = fmaxf(m[r], tile_max);
    const float mc_new = m_new * c;
    float psum = 0.0f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float& s = sc[n][2 * r + j];
        s = live[n][j] ? exp2_fast(__fmaf_rn(s, c, -mc_new)) : 0.0f;
        psum += s;
      }
    const float corr = exp2_fast(mc[r] - mc_new);
    l[r] = l[r] * corr + psum;
    m[r] = m_new;
    mc[r] = mc_new;
    if (__any_sync(kFull, corr != 1.0f)) {
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        acc[d][2 * r] *= corr;
        acc[d][2 * r + 1] *= corr;
      }
    }
  }
}

// O += P.V for one 16 x BK tile: A fragment of keys n*8 + {2t, 2t+1}:
// a0 = p(g, 2t), a1 = p(g+8, 2t), a2 = p(g, 2t+1), a3 = p(g+8, 2t+1)
// (the scores' registers, no shuffles); B fragment b0 = V[n*8 + 2t][d*8 +
// g], b1 = V[n*8 + 2t + 1][d*8 + g].
template <int VD, int BK, typename T>
__device__ __forceinline__ void pv_tile(const float (&sc)[BK / 8][4],
                                        const T* vt, float (&acc)[VD / 8][4],
                                        int gq, int tq) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kRowV = VD + kPad<T>;
#pragma unroll
  for (int n = 0; n < BK / 8; ++n) {
    const float pa[4] = {sc[n][0], sc[n][2], sc[n][1], sc[n][3]};
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split(pa[i], ph[i], pl[i]);
#pragma unroll
    for (int d = 0; d < VD / 8; ++d) {
      const T* at = vt + (n * 8 + 2 * tq) * kRowV + d * 8 + gq;
      uint32_t bh[2], bl[2];
      fragment(at, bh[0], bl[0]);
      fragment(at + kRowV, bh[1], bl[1]);
      mma(acc[d], pl, bh);
      if (kF32) mma(acc[d], ph, bl);
      mma(acc[d], ph, bh);
    }
  }
}

// A warp's 16 rows of O (rows past sq are not stored): acc / max(l,
// 1e-30), l summed over the quad.
template <int VD, typename T>
__device__ __forceinline__ void store_rows(T* op, long long oss,
                                           const float (&acc)[VD / 8][4],
                                           const float (&l)[2],
                                           const int (&rq)[2], int sq,
                                           int tq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    if (rq[r] >= sq) continue;
    const float denom = fmaxf(sum, 1e-30f);
    T* orow = op + rq[r] * oss + 2 * tq;
#pragma unroll
    for (int d = 0; d < VD / 8; ++d) {
      narrow(orow + d * 8, acc[d][2 * r] / denom);
      narrow(orow + d * 8 + 1, acc[d][2 * r + 1] / denom);
    }
  }
}

// A block of NW warps on one item: query tile blockIdx.x (heaviest first
// when causal) of the (b, kv head, chunk of hb heads) pair blockIdx.y.
template <int HD, int VD, typename T, int NW>
__global__ void __launch_bounds__(NW * 32, 1)
flash_tf32x3_kernel(const T* __restrict__ q, Strides qs,
                    const T* __restrict__ k, Strides ks,
                    const T* __restrict__ v, Strides vs,
                    T* __restrict__ o, Strides os, int batch, int n_kv,
                    int group, int hb, int sq, int sk, int causal,
                    float scale) {
  using S = Smem<HD, VD, T, NW>;
  static_assert(S::kFits, "shared memory");
  constexpr int kBk = S::Tl::kBk, kStages = S::Tl::kStages;
  constexpr int kD = HD / 8;       // Q.K^T k-steps
  constexpr int kDv = VD / 8;      // P.V n-tiles
  constexpr int kN = kBk / 8;      // Q.K^T n-tiles; P.V k-steps
  constexpr int kTile = S::kTile;  // elements of a stage
  extern __shared__ uint4 smem4[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint4* qf = smem4 + warp * kD * 32 + lane;   // [d * 32]: this lane's
  // [kStages][K [kBk][kRowK], V [kBk][kRowV]]
  T* ring = reinterpret_cast<T*>(reinterpret_cast<char*>(smem4) + S::kQ);
  (void)batch;   // the persistent kernel's: here the grid gives the pair

  const int gq = lane / 4, tq = lane % 4;  // the mma's groupID, thread
  const int slabs = NW / hb;               // 16-row slabs a head
  const int rows = 16 * slabs;             // query rows a block
  const int chunks = group / hb;
  const int chunk = blockIdx.y % chunks;
  const int kvh = blockIdx.y / chunks % n_kv;
  const int b = blockIdx.y / chunks / n_kv;
  const int h = kvh * group + chunk * hb + warp / slabs;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * rows;
  const int row0 = q0 + warp % slabs * 16;   // the warp's first row
  const int rq[2] = {row0 + gq, row0 + gq + 8};

  // A fragments of Q as f32, in shared memory (each lane reads back only
  // its own): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4) of each
  // 8-dim k-step. Rows past sq are 0 and never stored.
  const T* qp = q + b * qs.b + h * qs.h;
#pragma unroll
  for (int d = 0; d < kD; ++d) {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rq[i & 1];
      x[i] = r < sq ? widen(qp[r * qs.s + d * 8 + tq + (i & 2) * 2]) : 0.0f;
    }
    qf[d * 32] = make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                            __float_as_uint(x[2]), __float_as_uint(x[3]));
  }
  // O: c0, c1 at (g, 2t), (g, 2t+1) and c2, c3 at (g+8, ...) of each
  // 8-dim n-tile.
  float acc[kDv][4];
#pragma unroll
  for (int d = 0; d < kDv; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[d][i] = 0.0f;
  // A row's running max of the raw scores, the same times c, its sum.
  const float c = scale * 1.4426950408889634f;
  float m[2] = {kNeg, kNeg}, mc[2] = {kNeg * c, kNeg * c};
  float l[2] = {0.0f, 0.0f};

  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  // Keys past the block's last query row are masked for every row.
  const int k_end = causal ? min(sk, q0 + rows) : sk;
  const int n_tiles = (k_end + kBk - 1) / kBk;
  // kStages - 1 tiles in flight; at tile it, tile it + kStages - 1 is
  // loaded into the stage that tile it - 1 held.
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles)
      load_tile<HD, VD, T, NW>(ring + t * kTile, kb, ks.s, vb, vs.s,
                               t * kBk, sk);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait<kStages - 2>();   // tile it has landed (this thread's part)
    __syncthreads();                // ... everyone's; tile it - 1 is consumed
    const int next = it + kStages - 1;
    if (next < n_tiles)
      load_tile<HD, VD, T, NW>(ring + next % kStages * kTile, kb, ks.s, vb,
                               vs.s, next * kBk, sk);
    cp_async_commit();
    const T* kt = ring + it % kStages * kTile;
    const T* vt = kt + kBk * S::kRowK;
    float sc[kN][4];
    scores<HD, kBk, T>(kt, qf, gq, tq, sc);
    // Only the tiles that cross sk or a row's diagonal are masked.
    const int k0 = it * kBk;
    if (k0 + kBk <= sk && (!causal || k0 + kBk - 1 <= row0))
      online_softmax<false, kDv, kBk>(sc, acc, m, mc, l, rq, k0, tq, sk,
                                      causal, c);
    else
      online_softmax<true, kDv, kBk>(sc, acc, m, mc, l, rq, k0, tq, sk,
                                     causal, c);
    pv_tile<VD, kBk, T>(sc, vt, acc, gq, tq);
  }
  cp_async_wait<0>();
  store_rows<VD, T>(o + b * os.b + h * os.h, os.s, acc, l, rq, sq, tq);
}

// The items of a launch: (b, kv head, chunk of hb query heads) pairs x
// query tiles of `rows` rows. Item j of a pair is its j-th heaviest query
// tile when causal (the last first), else the j-th.
struct Items {
  int n_pairs, n_q, rows, sq, sk, causal;
};

template <int BK>
__device__ __forceinline__ int item_qt(const Items& w, int j) {
  return w.causal ? w.n_q - 1 - j : j;
}

// Key tiles item j of a pair walks: keys past its last query row are
// masked for every row when causal. An item of no key (sk = 0) walks one
// tile of masked keys, so that its rows come out 0.
template <int BK>
__device__ __forceinline__ int item_tiles(const Items& w, int j) {
  const int k_end = w.causal ? min(w.sk, (item_qt<BK>(w, j) + 1) * w.rows)
                             : w.sk;
  return max((k_end + BK - 1) / BK, 1);
}

// A walk over a block's items tile by tile: the item (pair p, rank j), its
// tile and tile count, and the items left, this one included.
template <int BK>
struct Cursor {
  int p, j, tile, n, left;
  __device__ __forceinline__ void start(const Items& w, int p0, int j0,
                                        int items) {
    p = p0;
    j = j0;
    tile = 0;
    left = items;
    n = item_tiles<BK>(w, j);
  }
  __device__ __forceinline__ void next(const Items& w) {
    if (++tile < n) return;
    tile = 0;
    --left;
    if (++j == w.n_q) {
      j = 0;
      ++p;
    }
    n = item_tiles<BK>(w, j);
  }
};

// A persistent block's items: every pair's items in order, their key tiles
// laid end to end and cut into n_c runs of equal work; block c takes the
// items that start in run c, a contiguous range of `items` items from
// (p0, j0). kernels/flash_attention/ops.py::block_items is the same in
// Python.
template <int BK>
__device__ __forceinline__ void block_items(const Items& w, int c, int n_c,
                                            int& p0, int& j0, int& items) {
  long long per_pair = 0;
  for (int j = 0; j < w.n_q; ++j) per_pair += item_tiles<BK>(w, j);
  const long long total = per_pair * w.n_pairs;
  const long long lo = total * c / n_c, hi = total * (c + 1) / n_c;
  p0 = static_cast<int>(lo / per_pair);
  j0 = 0;
  long long s = p0 * per_pair;
  while (s < lo) {
    s += item_tiles<BK>(w, j0);
    if (++j0 == w.n_q) {
      j0 = 0;
      ++p0;
    }
  }
  items = 0;
  for (int j = j0; s < hi; ++items) {
    s += item_tiles<BK>(w, j);
    if (++j == w.n_q) j = 0;
  }
}

// The persistent instance (f32): a block an SM, walking the items of its
// run (block_items) tile by tile. The ring of K/V tiles runs on across
// items; each warp copies the next item's Q once its last scores are
// taken, and skips the tiles whose keys all lie past its last row.
template <int HD, int VD, int NW>
__global__ void __launch_bounds__(NW * 32, 1)
flash_tf32x3_persistent_kernel(const float* __restrict__ q, Strides qs,
                               const float* __restrict__ k, Strides ks,
                               const float* __restrict__ v, Strides vs,
                               float* __restrict__ o, Strides os, int batch,
                               int n_kv, int group, int hb, int sq, int sk,
                               int causal, float scale) {
  using S = Smem<HD, VD, float, NW>;
  static_assert(S::kFits, "shared memory");
  constexpr int kBk = S::Tl::kBk, kStages = S::Tl::kStages;
  constexpr int kD = HD / 8;       // Q.K^T k-steps
  constexpr int kDv = VD / 8;      // P.V n-tiles
  constexpr int kN = kBk / 8;      // Q.K^T n-tiles; P.V k-steps
  constexpr int kTile = S::kTile;  // elements of a stage
  extern __shared__ uint4 smem4[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  uint4* qf = smem4 + warp * kD * 32 + lane;   // [d * 32]: this lane's
  // [kStages][K [kBk][kRowK], V [kBk][kRowV]]
  float* ring =
      reinterpret_cast<float*>(reinterpret_cast<char*>(smem4) + S::kQ);

  const int gq = lane / 4, tq = lane % 4;  // the mma's groupID, thread
  const int slabs = NW / hb;               // 16-row slabs a head
  const int chunks = group / hb;
  const int rows = 16 * slabs;             // query rows an item
  const Items w{batch * n_kv * chunks, (sq + rows - 1) / rows, rows, sq, sk,
                causal};
  // The tile consumed and the tile loaded, kStages - 1 ahead of it.
  Cursor<kBk> cc, lc;
  {
    int p0, j0, items;
    block_items<kBk>(w, blockIdx.x, gridDim.x, p0, j0, items);
    cc.start(w, p0, j0, items);
  }
  lc = cc;
  // Pair p: its batch, kv head, and this warp's query head.
  auto batch_of = [&](int p) { return p / chunks / n_kv; };
  auto kv_of = [&](int p) { return p / chunks % n_kv; };
  auto head_of = [&](int p) {
    return kv_of(p) * group + p % chunks * hb + warp / slabs;
  };
  // Item j's first row for this warp.
  auto row_of = [&](int j) {
    return item_qt<kBk>(w, j) * rows + warp % slabs * 16;
  };
  // The load cursor's tile into stage `slot`, then the cursor on; one
  // group of copies, empty past the run's last tile.
  const float* kb = nullptr;
  const float* vb = nullptr;
  int kb_pair = -1;
  auto issue = [&](int slot) {
    if (lc.left > 0) {
      if (lc.p != kb_pair) {
        kb_pair = lc.p;
        kb = k + batch_of(lc.p) * ks.b + kv_of(lc.p) * ks.h;
        vb = v + batch_of(lc.p) * vs.b + kv_of(lc.p) * vs.h;
      }
      load_tile<HD, VD, float, NW>(ring + slot * kTile, kb, ks.s, vb, vs.s,
                                   lc.tile * kBk, sk);
      lc.next(w);
    }
    cp_async_commit();
  };
  // Item (p, j)'s Q into this warp's slots: one group of copies.
  auto fetch_q = [&](int p, int j) {
    copy_q<HD>(qf, q + batch_of(p) * qs.b + head_of(p) * qs.h, qs.s,
               row_of(j), sq, gq, tq);
    cp_async_commit();
  };

  const float c = scale * 1.4426950408889634f;
  float acc[kDv][4];
  float m[2], mc[2], l[2];
  int row0 = 0, rq[2] = {0, 0};

  // kStages - 1 tiles in flight, then the first item's Q: the copies of a
  // block's first tiles and of its Q overlap.
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) issue(t);
  fetch_q(cc.p, cc.j);
  // At tile it, tile it + kStages - 1 is loaded into the stage that tile
  // it - 1 held.
  for (int it = 0; cc.left > 0; ++it) {
    if (cc.tile == 0) {
      cp_async_wait<0>();           // this item's Q and tile have landed
      row0 = row_of(cc.j);
      rq[0] = row0 + gq;
      rq[1] = row0 + gq + 8;
#pragma unroll
      for (int d = 0; d < kDv; ++d)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[d][i] = 0.0f;
      m[0] = m[1] = kNeg;
      mc[0] = mc[1] = kNeg * c;
      l[0] = l[1] = 0.0f;
    } else {
      cp_async_wait<kStages - 2>();   // tile it has landed (this thread's part)
    }
    __syncthreads();                // ... everyone's; tile it - 1 is consumed
    issue((it + kStages - 1) % kStages);
    const bool last = cc.tile == cc.n - 1;
    const int k0 = cc.tile * kBk;
    // A tile whose keys all lie past this warp's last row adds nothing.
    if (!causal || k0 <= row0 + 15) {
      const float* kt = ring + it % kStages * kTile;
      float sc[kN][4];
      scores<HD, kBk, float>(kt, qf, gq, tq, sc);
      if (last && cc.left > 1)   // the next item's Q, behind this P.V
        fetch_q(cc.j + 1 == w.n_q ? cc.p + 1 : cc.p,
                cc.j + 1 == w.n_q ? 0 : cc.j + 1);
      // Only the tiles that cross sk or a row's diagonal are masked.
      if (k0 + kBk <= sk && (!causal || k0 + kBk - 1 <= row0))
        online_softmax<false, kDv, kBk>(sc, acc, m, mc, l, rq, k0, tq, sk,
                                        causal, c);
      else
        online_softmax<true, kDv, kBk>(sc, acc, m, mc, l, rq, k0, tq, sk,
                                       causal, c);
      pv_tile<VD, kBk, float>(sc, kt + kBk * S::kRowK, acc, gq, tq);
    } else if (last && cc.left > 1) {
      fetch_q(cc.j + 1 == w.n_q ? cc.p + 1 : cc.p,
              cc.j + 1 == w.n_q ? 0 : cc.j + 1);
    }
    if (last)
      store_rows<VD, float>(o + batch_of(cc.p) * os.b + head_of(cc.p) * os.h,
                            os.s, acc, l, rq, sq, tq);
    cc.next(w);
  }
  cp_async_wait<0>();
}

int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }

// A block per item, or, for a persistent instance, as many blocks as fit
// on the card at once (at most one an item), each walking a run of items.
template <int HD, int VD, typename T, int NW>
int launch_nw(const void* q, const void* k, const void* v, void* o,
              const long long* st, int batch, int n_heads, int n_kv_heads,
              int sq, int sk, int causal, float scale, cudaStream_t stream) {
  constexpr int kSmem = Smem<HD, VD, T, NW>::kBytes;
  constexpr bool kPersistent = Tiling<HD, VD, T>::kPersistent;
  auto kernel = [] {
    if constexpr (kPersistent)
      return flash_tf32x3_persistent_kernel<HD, VD, NW>;
    else
      return flash_tf32x3_kernel<HD, VD, T, NW>;
  }();
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int group = n_heads / n_kv_heads, hb = gcd(group, NW);
  const int rows = 16 * NW / hb;
  const int n_q = (sq + rows - 1) / rows;
  const int pairs = batch * n_kv_heads * (group / hb);
  dim3 grid(n_q, pairs);
  if constexpr (kPersistent) {
    int dev = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          NW * 32, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    grid = dim3(static_cast<unsigned>(
                    std::min(static_cast<long long>(n_q) * pairs,
                             static_cast<long long>(per_sm) * sms)),
                1);
  }
  kernel<<<grid, NW * 32, kSmem, stream>>>(
      static_cast<const T*>(q), Strides{st[0], st[1], st[2]},
      static_cast<const T*>(k), Strides{st[3], st[4], st[5]},
      static_cast<const T*>(v), Strides{st[6], st[7], st[8]},
      static_cast<T*>(o), Strides{st[9], st[10], st[11]}, batch, n_kv_heads,
      group, hb, sq, sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// 8 warps a block, or 4 where a grid of 8-warp blocks would not give
// every SM one, or where 8 warps' shared memory does not fit.
template <int HD, int VD, typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int batch, int n_heads, int n_kv_heads,
           int sq, int sk, int causal, float scale, cudaStream_t stream) {
  if constexpr (!Smem<HD, VD, T, 8>::kFits) {
    return launch_nw<HD, VD, T, 4>(q, k, v, o, st, batch, n_heads,
                                   n_kv_heads, sq, sk, causal, scale, stream);
  } else {
    int sms = 132, dev = 0;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int group = n_heads / n_kv_heads, hb = gcd(group, 8);
    const long long blocks8 = static_cast<long long>((sq + 128 / hb - 1) /
                                                     (128 / hb)) *
                              batch * n_kv_heads * (group / hb);
    return blocks8 >= sms
        ? launch_nw<HD, VD, T, 8>(q, k, v, o, st, batch, n_heads, n_kv_heads,
                                  sq, sk, causal, scale, stream)
        : launch_nw<HD, VD, T, 4>(q, k, v, o, st, batch, n_heads, n_kv_heads,
                                  sq, sk, causal, scale, stream);
  }
}

}  // namespace

// q (B,H,SQ,hd), k (B,KV,SK,hd), v (B,KV,SK,vd), o (B,H,SQ,vd), each
// through element strides st = {q: b,h,s, k: b,h,s, v: b,h,s, o: b,h,s}
// with the head dim contiguous and every base and stride 16-byte aligned.
// is_bf16 selects bf16 for all four, else f32. vd = hd at hd 16, 32, 64 or
// 128 (f32), 16 or 32 (bf16); f32 also at (hd, vd) = (192, 128) and
// (24, 16) (MLA), bf16 at (24, 16). H is a multiple of KV.
MOBY_API int moby_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, const long long* st, int batch,
                                  int n_heads, int n_kv_heads, int sq, int sk,
                                  int head_dim, int value_dim, int causal,
                                  int is_bf16, float scale, void* stream) {
  if (batch * n_heads == 0 || sq == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  if (value_dim != head_dim) {
    if (is_bf16)   // deepseek-v2's SMOKE config in its own dtype
      return head_dim == 24 && value_dim == 16
          ? launch<24, 16, __nv_bfloat16>(q, k, v, o, st, batch, n_heads,
                                          n_kv_heads, sq, sk, causal, scale,
                                          s)
          : static_cast<int>(cudaErrorInvalidValue);
    if (head_dim == 192 && value_dim == 128)
      return launch<192, 128, float>(q, k, v, o, st, batch, n_heads,
                                     n_kv_heads, sq, sk, causal, scale, s);
    if (head_dim == 24 && value_dim == 16)
      return launch<24, 16, float>(q, k, v, o, st, batch, n_heads,
                                   n_kv_heads, sq, sk, causal, scale, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (is_bf16) {
    switch (head_dim) {
      case 16: return launch<16, 16, __nv_bfloat16>(q, k, v, o, st, batch,
                   n_heads, n_kv_heads, sq, sk, causal, scale, s);
      case 32: return launch<32, 32, __nv_bfloat16>(q, k, v, o, st, batch,
                   n_heads, n_kv_heads, sq, sk, causal, scale, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (head_dim) {
    case 16: return launch<16, 16, float>(q, k, v, o, st, batch, n_heads,
                                          n_kv_heads, sq, sk, causal, scale,
                                          s);
    case 32: return launch<32, 32, float>(q, k, v, o, st, batch, n_heads,
                                          n_kv_heads, sq, sk, causal, scale,
                                          s);
    case 64: return launch<64, 64, float>(q, k, v, o, st, batch, n_heads,
                                          n_kv_heads, sq, sk, causal, scale,
                                          s);
    case 128: return launch<128, 128, float>(q, k, v, o, st, batch, n_heads,
                                             n_kv_heads, sq, sk, causal,
                                             scale, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
