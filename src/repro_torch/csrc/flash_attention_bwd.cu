// Backward pass of blocked softmax attention (prefill), GQA-aware, f32-
// accurate on the tensor cores by a 3xTF32 split: dQ, dK and dV from Q, K,
// V, the forward's output O and its cotangent dO.
//
// Replaces the VJP around the TPU kernel: repro/ops/api.py (_flash_bwd),
// jax.vjp of repro/models/layers.py::_chunked_attention, which recomputes
// the scores a query block at a time, and at MLA's head dims (qk 192 /
// value 128, SMOKE's 24 / 16) jax.vjp of JAX's plain attention
// (_dense_attention, _chunked_attention). Its plain version is
// kernels/flash_attention/ref.py::flash_attention_bwd_ref:
//   A = softmax(scale Q.K^T) with the forward's masking (masked keys give
//   p = 0, the causal limit kj <= qi, keys past sk masked),
//   dV = A^T dO, dP = dO V^T, dS = A * (dP - rowsum(dO * O)),
//   dQ = scale dS K, dK = scale dS^T Q,
// with the G = H / KV query heads of a kv head summed into its dK and dV.
// This is the "tf32x3" route of kernels/flash_attention/ops.py::route: f32
// at head dims 16-128 and at MLA's (192, 128) and (24, 16), bf16 at head
// dims 16 and 32 and at (24, 16) (the SMOKE configs). bf16 at head dims 64
// and 128 and at (192, 128) (training's route at full width) runs
// flash_attention_bwd_tc.cu; the bf16 hd-64 instance this kernel had
// until then is gone (its times stay in PERF.md). The value head dim VD
// may differ from the qk head dim QK: S, dQ and dK run over QK, dP and dV
// over VD, and the scale is QK^-0.5.
//
// What bounds it on an H100: operations. At the training shape (B=1,
// H=16, KV=2, S=4096, hd=128, causal) the five products of the gradient
// are 1.7e11 flops on ~40 MB of inputs and outputs: 2.6 ms of float32
// arithmetic outside the tensor cores at 67 TFLOP/s, against 0.012 ms of
// memory. The tensor cores take TF32 at 495 TFLOP/s; three TF32 products
// a product keep f32 accuracy, so the floor is 3 x 1.7e11 / 495e12 = 1.04
// ms (mma.sync reaches only part of that rate: tools/mma_sync_rate.py).
// This kernel executes seven products a (query tile, key tile) pair: S and
// dP in both of its first two kernels, dQ in the first, dV and dK in the
// second.
//
// The 3xTF32 split of tf32x3.cuh: hi = x rounded to TF32
// (nearest, ties away from zero, by two integer operations on the bits)
// and lo = x - hi, exact in f32, which the tensor core reads truncated to
// TF32; a product is lo_a*hi_b + hi_a*lo_b + hi_a*hi_b by
// mma.sync.m16n8k8 (TF32 in, f32 accumulators), the small products in
// accumulators of their own; lo_a*lo_b is dropped. bf16 values are exact
// in TF32: for bf16 S and dP take one product, dQ, dK and dV two (P and dS
// are f32 values the kernel computes). P and dS go from the S and dP
// accumulators into the next product's A fragments without shuffles (k
// index t stands for column 2t and t + 4 for 2t + 1, and the B fragment
// reads its rows in that order), split in registers on the way.
//
// Why mma.sync and not wgmma: wgmma transposes only 16-bit operands, and
// dQ = dS K, dK = dS^T Q and dV = P^T dO each read an operand MN-major (K,
// Q and dO with the head dim contiguous). With mma.sync every thread loads
// its own B fragment from shared memory in any layout.
//
// Accumulation: a thread holds dQ (or dK and dV) for the whole walk, but
// no tensor-core accumulation chain reaches it: each group of four
// 8-column tiles of a product sums one walk tile's k-steps in fresh
// accumulators (big and small products apart), which are then added to
// the running sum by f32 adds (round to nearest). So at most 16 mma
// accumulations (8 k-steps of 2 small products) round into a partial sum,
// whatever rounding the tensor core's own accumulation uses, and the long
// sums over S / 64 key or S / 32 query tiles round to nearest, as the
// plain version's.
//
// Design, deterministic and without float atomics (three launches of one
// entry point, in stream order; two at G = 1), blocks of 8 warps (the
// Tiling of an instance; (192, 128) below):
// * dq_kernel, a block per (16 * 8 / hb query rows, b, hb query heads of
//   one kv head), hb = gcd(H / KV, 8), the heaviest causal blocks first
//   (grid y, slowest); each warp takes 16 rows of one head, so a K/V tile
//   serves all of them. Q and dO stay in shared memory as f32 A fragments
//   (fragment order: one 16-byte load a k-step); D = rowsum(dO * O) is the
//   diagonal of dO.O^T, taken as dP is (a row whose one live key j has O =
//   V_j then gets dS = 0 exactly, as in the exact gradient). One walk over
//   the 64-key tiles, online as the forward:
//   S = Q.K^T, the rows' running max m and sum l, P~ = 2^(S c - m c) (c =
//   scale log2 e; the SFU's ex2.approx), dP = dO.V^T, dS~ = P~ (dP - D),
//   dQ~ += dS~.K, dQ~ rescaled when a row's max moves; dQ = scale dQ~ / l.
//   K tiles arrive by 16-byte cp.async in two buffers, V in one: tile
//   it + 1's K is in flight for all of tile it, its V from the moment
//   every warp has read tile it's (a barrier after dP) while dQ is
//   computed. At hd 128 in f32: 128 KB of fragments + 3 x 33 KB of tiles =
//   the 227 KB a block may hold. Writes dQ and the rows' (m, l, D), m the
//   raw max of q.k;
// * dkv_kernel, a block per (b, query head, 128 keys), heaviest first (grid
//   y); each warp takes 16 keys, whose K and V stay in shared memory as f32
//   A fragments, and walks the 32-row query tiles that see them: a 2-stage
//   cp.async ring brings each tile's Q, dO and (m, l, D). S^T = K.Q^T,
//   P^T = 2^(S^T c - m c) / l, dP^T = V.dO^T, dS^T = P^T (dP^T - D), dV +=
//   P^T.dO, dK += dS^T.Q; a warp whose keys all lie above a causal tile
//   (or past sk) skips it. One block a query head keeps the card busy at
//   GQA; each writes f32 partials of its query head: 128 KB of fragments
//   + 2 x 34 KB of ring at hd 128 in f32;
// * reduce_kernel sums the G partials of each kv head in head order and
//   rounds once to the input type. At G = 1 (MLA, moonshot) dkv_kernel
//   rounds dK and dV once itself (+0 added, as the sum's start does, so
//   the two agree bit for bit) and no partials exist: at MLA B's shape the
//   pass took 0.114 ms of 0.941 (chip_smoke.py, PERF.md).
// MLA's f32 (192, 128), where 8 warps' Q and dO fragments are 160 KB and
// a dkv warp holds dK and dV (160 floats a thread): dq blocks of 8 warps
// (128 query rows) over 32-key tiles (226 KB: fragments 160 KB, two K
// tiles and a V tile, the warps' O rows staged unpadded over all three),
// each warp skipping the key tiles that lie wholly above its last row (at
// MLA B's S = 256 a third of a 128-row block's tiles: they would add
// zeros), dkv blocks of 8 warps over 16-query tiles (206 KB: fragments
// 160 KB, 2 stages of 21 KB), products summing 2 output tiles at once.
// At MLA B's shape the 8-warp dq took the call from 0.873 to 0.837 ms and
// the skip to 0.802, under SDPA's 0.832 (tools/mla_bwd_probe.py). Tried
// and left out there: dkv warps in pairs over 32-query tiles, one warp
// holding dV (S^T, P^T, dV), the other dK (dP^T, dS^T from the first's
// P^T, dK), 0.52 ms against 0.47 (the second waits on the first); a
// 3-stage dkv ring, 0.48 against 0.47; dq over 16-key tiles, 0.83 ms a
// call against 0.80. ptxas gives both kernels 255 registers and 8 (dq) and
// 24 (dkv) bytes of spill stores (the 4-warp dq spilled 12; the hd-128
// instance's dkv kernel spills 44 bytes): hoisted addresses of the walk's
// copies, reloaded outside the products (cuobjdump -sass).
// Tile rows in shared memory are padded by 16 bytes, so B fragments, read
// either way (X[n][k] for S and dP, X[k][n] for the others), fall on
// distinct banks. Masking is applied only to the tiles that cross sk, sq
// or a diagonal. Inputs are read through their strides by 16-byte copies
// (the wrapper checks 16-byte aligned bases and strides). The library
// builds with -fmad=false: every intended fused multiply-add is an
// explicit __fmaf_rn, and divisions are IEEE.
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "moby_kernels.cuh"
#include "tf32x3.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
// Dynamic shared memory a block may use on an H100 (227 KB).
constexpr int kMaxSmem = 232448;

// An instance's tiling at (qk, value) head dims (QK, VD): the warps of a
// dq block and of a dkv block, keys a tile of the dq walk, queries a tile
// of the dkv walk, 8-column output tiles a product sums at once, and
// whether a dq warp skips the key tiles that lie wholly above its rows
// (kSkipDead; the products it leaves out would add only zeros).
template <int QK, int VD, typename T>
struct Tiling {
  static constexpr int kDqWarps = 8, kDkvWarps = 8;
  static constexpr int kBk = 64, kBq = 32, kNG = 4;
  static constexpr bool kSkipDead = false;
};

// MLA's f32 (192, 128). dq: 8 warps (128 query rows) over 32-key tiles:
// Q's and dO's fragments (160 KB), two K tiles and a V tile fit in 226 KB,
// the O rows staged unpadded over all three, each warp skipping the key
// tiles past its last row (at MLA B's S = 256 a third of the 128-row
// blocks' tiles); dkv: 8 warps (K's and V's fragments: 160 KB) over
// 16-query tiles, two output tiles summed at once, since dK and dV hold
// 160 floats a thread over the walk.
template <>
struct Tiling<192, 128, float> {
  static constexpr int kDqWarps = 8, kDkvWarps = 8;
  static constexpr int kBk = 32, kBq = 16, kNG = 2;
  static constexpr bool kSkipDead = true;
};

struct Strides {                    // in elements; the head dim has stride 1
  long long b, h, s;
};

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float* stats;                     // (3, B*H, SQ): m, l, D
  float* part;                      // (B*H, SK, QK) dK, (B*H, SK, VD) dV
  Strides sq_, sk_, sv_, so_, sdo_, sdq_, sdk_, sdv_;
  int batch, h, kv, sq, sk;
  int causal;
  float scale;
  int hb;                           // query heads a dq block: gcd(H/KV,
                                    // the dq block's warps)
};

// dq_kernel's shared memory: every warp's Q fragments, then every warp's
// dO fragments (f32, [warp][dim / 8][32 lanes] of 16 bytes), two K tiles
// ([kBk][QK + pad] of T) and one V tile ([kBk][VD + pad] of T). The
// warps' O rows ([16][VD + pad] each) are staged where K tile 1 and V
// will be, or, where they do not fit there (8 warps at (192, 128)),
// unpadded ([16][VD]) from K tile 0 on.
template <int QK, int VD, typename T>
struct DqSmem {
  using Tl = Tiling<QK, VD, T>;
  static constexpr int kWarps = Tl::kDqWarps;
  static constexpr int kRowK = QK + kPad<T>;
  static constexpr int kRowV = VD + kPad<T>;
  static constexpr int kFragQ = kWarps * (QK / 8) * 32 * 16;
  static constexpr int kFragDo = kWarps * (VD / 8) * 32 * 16;
  static constexpr int kTileK = Tl::kBk * kRowK * static_cast<int>(sizeof(T));
  static constexpr int kTileV = Tl::kBk * kRowV * static_cast<int>(sizeof(T));
  static constexpr int kBytes = kFragQ + kFragDo + 2 * kTileK + kTileV;
  static constexpr bool kOPadded =
      kWarps * 16 * kRowV * static_cast<int>(sizeof(T)) <= kTileK + kTileV;
  static constexpr int kRowO = kOPadded ? kRowV : VD;
  // Elements from K tile 0 to the staged O rows.
  static constexpr int kOAt = kOPadded ? Tl::kBk * kRowK : 0;
  static_assert(kWarps * 16 * kRowO * static_cast<int>(sizeof(T)) <=
                    2 * kTileK + kTileV - kOAt * static_cast<int>(sizeof(T)),
                "O rows");
};

// dkv_kernel's: every warp's K fragments, then every warp's V fragments,
// then two stages of [Q tile ([kBq][QK + pad] of T), dO tile ([kBq][VD +
// pad] of T), m, l, D ([3][kBq] f32)].
template <int QK, int VD, typename T>
struct DkvSmem {
  using Tl = Tiling<QK, VD, T>;
  static constexpr int kWarps = Tl::kDkvWarps;
  static constexpr int kRowK = QK + kPad<T>;
  static constexpr int kRowV = VD + kPad<T>;
  static constexpr int kFragK = kWarps * (QK / 8) * 32 * 16;
  static constexpr int kFragV = kWarps * (VD / 8) * 32 * 16;
  static constexpr int kTileQ = Tl::kBq * kRowK * static_cast<int>(sizeof(T));
  static constexpr int kTileDo =
      Tl::kBq * kRowV * static_cast<int>(sizeof(T));
  static constexpr int kStage = kTileQ + kTileDo + 3 * Tl::kBq * 4;
  static constexpr int kBytes = kFragK + kFragV + 2 * kStage;
  static_assert(kStage % 16 == 0, "16-byte aligned stages");
};

// Rows [r0, r0 + R) of an operand (row r at src + r * rs, the head dim
// contiguous) into dst ([R][kRow] of T) by 16-byte cp.async, issued by
// `threads` threads (the block's, or the lanes of a warp), this one being
// `tid`; rows >= n are zero-filled.
template <int R, int HD, typename T, int kRow = HD + kPad<T>>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long rs,
                                          int r0, int n, int tid,
                                          int threads) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = HD / kVec;
  for (int c = tid; c < R * kChunks; c += threads) {
    const int r = c / kChunks, col = c % kChunks * kVec;
    const bool ok = r0 + r < n;
    cp_async16(dst + r * kRow + col,
               src + (ok ? r0 + r : 0) * rs + col, ok);
  }
}

// A fragments of rows [r0, r0 + 16) of an operand (rows >= n are 0) as
// f32 in fragment order: at frag[d * 32] (frag at this lane's slot) the
// lane (g, t) keeps x[g][8d + t], x[g + 8][8d + t], x[g][8d + t + 4],
// x[g + 8][8d + t + 4]. Each lane reads back only its own slots.
template <int HD, typename T>
__device__ __forceinline__ void store_frags(uint4* frag, const T* src,
                                            long long rs, int r0, int n,
                                            int gq, int tq) {
#pragma unroll 4
  for (int d = 0; d < HD / 8; ++d) {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + gq + (i & 1) * 8;
      x[i] = r < n ? widen(src[r * rs + d * 8 + tq + (i & 2) * 2]) : 0.0f;
    }
    frag[d * 32] = make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                              __float_as_uint(x[2]), __float_as_uint(x[3]));
  }
}

// A B fragment element of a tile, split (f32); bf16 is exact in TF32 (lo
// unused).
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

// sc = A.B^T for one warp's 16 rows and kNt * 8 columns: A from the
// warp's fragments af (f32; split per k-step), B the rows of tile bt
// ([kNt * 8][kRow] of T): b0 = B[n*8 + g][d*8 + t], b1 at dim t + 4.
// For f32 the small products (lo.hi + hi.lo) go to accumulators of their
// own, added to the big ones (hi.hi) at the end.
template <int HD, int kNt, typename T, int kRow = HD + kPad<T>>
__device__ __forceinline__ void product_nt(const T* bt, const uint4* af,
                                           int gq, int tq,
                                           float (&sc)[kNt][4]) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  float small[kNt][4];
#pragma unroll
  for (int n = 0; n < kNt; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[n][i] = small[n][i] = 0.0f;
#pragma unroll
  for (int d = 0; d < HD / 8; ++d) {
    const uint4 a4 = af[d * 32];
    uint32_t ah[4] = {a4.x, a4.y, a4.z, a4.w}, al[4];
    if (kF32) {
#pragma unroll
      for (int i = 0; i < 4; ++i) split(__uint_as_float(ah[i]), ah[i], al[i]);
    }
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      const T* at = bt + (n * 8 + gq) * kRow + d * 8 + tq;
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
    for (int n = 0; n < kNt; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] += small[n][i];
  }
}

// acc += X.B for one warp's 16 rows: X (16 x kK * 8) from accumulator
// fragments x[k] of a previous product (rows g: c0, c1 and g + 8: c2, c3,
// columns k*8 + 2t, 2t + 1), taken as A fragments with k index t for
// column 2t and t + 4 for 2t + 1; B = bt[k*8 + 2t (+1)][d*8 + g] of tile
// bt ([kK * 8][HD + pad] of T). X is split once; each group of kG (NG,
// or all HD / 8 when fewer) 8-column output tiles sums its kK k-steps in
// fresh accumulators (small products apart), then adds them to acc in f32.
template <int HD, int kK, int NG, typename T>
__device__ __forceinline__ void product_nn(const float (&x)[kK][4],
                                           const T* bt, int gq, int tq,
                                           float (&acc)[HD / 8][4]) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kRow = HD + kPad<T>;
  constexpr int kG = NG < HD / 8 ? NG : HD / 8;
  static_assert(HD / 8 % kG == 0, "output tile groups");
  uint32_t xh[kK][4], xl[kK][4];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const float xa[4] = {x[k][0], x[k][2], x[k][1], x[k][3]};
#pragma unroll
    for (int i = 0; i < 4; ++i) split(xa[i], xh[k][i], xl[k][i]);
  }
#pragma unroll
  for (int d0 = 0; d0 < HD / 8; d0 += kG) {
    float big[kG][4], small[kG][4];
#pragma unroll
    for (int j = 0; j < kG; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) big[j][i] = small[j][i] = 0.0f;
#pragma unroll
    for (int k = 0; k < kK; ++k)
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        const T* at = bt + (k * 8 + 2 * tq) * kRow + (d0 + j) * 8 + gq;
        uint32_t bh[2], bl[2];
        fragment(at, bh[0], bl[0]);
        fragment(at + kRow, bh[1], bl[1]);
        mma(small[j], xl[k], bh);
        if (kF32) mma(small[j], xh[k], bl);
        mma(big[j], xh[k], bh);
      }
#pragma unroll
    for (int j = 0; j < kG; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[d0 + j][i] += big[j][i] + small[j][i];
  }
}

// p = 2^(s c - m c) in place of one 16 x BK tile of raw scores sc (rows
// g: c0, c1 and g + 8: c2, c3; key k0 + n*8 + 2t + c), c = scale * log2(e),
// masked keys 0. Each row's running max m (mc = m c) and its thread's
// share of the sum l take the tile in first, and corr is the factor by
// which earlier tiles' sums rescale; returns whether any row of the warp
// has corr != 1. kMask: the tile holds keys past sk or above a row's
// diagonal.
template <bool kMask, int BK>
__device__ __forceinline__ bool softmax_tile(
    float (&sc)[BK / 8][4], float (&m)[2], float (&mc)[2], float (&l)[2],
    float (&corr)[2], const int (&rq)[2], int k0, int tq, int sk,
    int causal, float c) {
  bool moved = false;
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
    corr[r] = exp2_fast(mc[r] - mc_new);
    m[r] = m_new;
    mc[r] = mc_new;
    float psum = 0.0f;
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float& s = sc[n][2 * r + j];
        s = live[n][j] ? exp2_fast(__fmaf_rn(s, c, -mc[r])) : 0.0f;
        psum += s;
      }
    l[r] = l[r] * corr[r] + psum;
    moved = moved || corr[r] != 1.0f;
  }
  return __any_sync(kFull, moved);
}

template <int QK, int VD, typename T>
__global__ void __launch_bounds__(32 * Tiling<QK, VD, T>::kDqWarps, 1)
dq_kernel(Args a) {
  using S = DqSmem<QK, VD, T>;
  static_assert(S::kBytes <= kMaxSmem, "shared memory");
  constexpr int kWarps = S::kWarps, kThreads = 32 * kWarps;
  constexpr int kBk = S::Tl::kBk, kNG = S::Tl::kNG;
  constexpr int kD = QK / 8;         // k-steps of S; dQ's n-tiles
  constexpr int kDv = VD / 8;        // k-steps of dP
  constexpr int kN = kBk / 8;        // n-tiles of S and dP; dQ's k-steps
  constexpr int kTile = kBk * S::kRowK;   // elements of a K tile
  extern __shared__ uint4 smem4[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;  // the mma's groupID, thread
  uint4* qf = smem4 + warp * kD * 32 + lane;
  uint4* df = smem4 + kWarps * kD * 32 + warp * kDv * 32 + lane;
  // [K buffer 0, K buffer 1 ([kBk][QK + pad] each), V ([kBk][VD + pad])]
  T* kbuf = reinterpret_cast<T*>(reinterpret_cast<char*>(smem4) +
                                 S::kFragQ + S::kFragDo);
  T* vbuf = kbuf + 2 * kTile;

  const int group = a.h / a.kv, chunks = group / a.hb;
  const int slabs = kWarps / a.hb;         // 16-row slabs a head
  const int rows = 16 * slabs;             // query rows a block
  const int chunk = blockIdx.x % chunks;
  const int kvh = blockIdx.x / chunks % a.kv;
  const int b = blockIdx.x / chunks / a.kv;
  const int h = kvh * group + chunk * a.hb + warp / slabs;
  const int qt = a.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * rows;
  const int row0 = q0 + warp % slabs * 16;   // the warp's first row
  const int rq[2] = {row0 + gq, row0 + gq + 8};

  const T* qp = static_cast<const T*>(a.q) + b * a.sq_.b + h * a.sq_.h;
  const T* dop = static_cast<const T*>(a.dout) + b * a.sdo_.b +
                 h * a.sdo_.h;
  const T* op = static_cast<const T*>(a.o) + b * a.so_.b + h * a.so_.h;
  store_frags<QK>(qf, qp, a.sq_.s, row0, a.sq, gq, tq);
  store_frags<VD>(df, dop, a.sdo_.s, row0, a.sq, gq, tq);
  // D = rowsum(dO * O), O as the forward stored it, as the diagonal of
  // dO.O^T over the warp's 16 rows: the products and sums of dP = dO.V^T,
  // so a row whose one live key j has O = V_j (every such row in bf16)
  // gets dP - D = 0 exactly, as in the exact gradient, here and in the dkv
  // kernel (whose dP^T takes the same products). The warp's O rows are
  // staged where K buffer 1 and V will be (S::kOAt): kWarps x 16 rows.
  float dsum[2];
  {
    T* orows = kbuf + S::kOAt + warp * 16 * S::kRowO;
    load_rows<16, VD, T, S::kRowO>(orows, op, a.so_.s, row0, a.sq, lane,
                                   32);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    float od[2][4];
    product_nt<VD, 2, T, S::kRowO>(orows, df, gq, tq, od);
    // (g, g) is c0 or c1 of n-tile 0 at lane (g, g / 2); (g + 8, g + 8)
    // c2 or c3 of n-tile 1.
    const int src = gq * 4 + gq / 2;
    dsum[0] = __shfl_sync(kFull, gq % 2 ? od[0][1] : od[0][0], src);
    dsum[1] = __shfl_sync(kFull, gq % 2 ? od[1][3] : od[1][2], src);
    __syncthreads();   // every warp's O is read before K and V arrive
  }

  const T* kb = static_cast<const T*>(a.k) + b * a.sk_.b + kvh * a.sk_.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv_.b + kvh * a.sv_.h;
  // Keys past the block's last query row are masked for every row.
  const int k_end = a.causal ? min(a.sk, q0 + rows) : a.sk;
  const int n_tiles = (k_end + kBk - 1) / kBk;
  const float c = a.scale * 1.4426950408889634f;
  // A row's running max of the raw scores, the same times c, its sum.
  float m[2] = {kNeg, kNeg}, mc[2] = {kNeg * c, kNeg * c};
  float l[2] = {0.0f, 0.0f}, corr[2];
  // Only the tiles that cross sk or one of the warp's rows' diagonal mask.
  auto masked = [&](int k0) {
    return k0 + kBk > a.sk || (a.causal && k0 + kBk - 1 > row0);
  };

  float dq[kD][4];
#pragma unroll
  for (int d = 0; d < kD; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) dq[d][i] = 0.0f;
  if (n_tiles > 0) {
    load_rows<kBk, QK>(kbuf, kb, a.sk_.s, 0, a.sk, threadIdx.x, kThreads);
    load_rows<kBk, VD>(vbuf, vb, a.sv_.s, 0, a.sk, threadIdx.x, kThreads);
  }
  cp_async_commit();
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBk;
    T* kt = kbuf + it % 2 * kTile;
    cp_async_wait<0>();   // K and V of tile it (this thread's part)
    __syncthreads();       // ... everyone's; tile it - 1 is consumed
    if (it + 1 < n_tiles)
      load_rows<kBk, QK>(kbuf + (it + 1) % 2 * kTile, kb, a.sk_.s,
                         k0 + kBk, a.sk, threadIdx.x, kThreads);
    cp_async_commit();

    // kSkipDead: every key of the tile above the warp's last row (causal),
    // whose products would add zeros and leave m and l as they are.
    const bool dead = S::Tl::kSkipDead && a.causal && k0 > row0 + 15;
    float sc[kN][4], ds[kN][4];
    if (!dead) {
      product_nt<QK, kN>(kt, qf, gq, tq, sc);         // S = Q.K^T
      const bool moved = masked(k0)
          ? softmax_tile<true, kBk>(sc, m, mc, l, corr, rq, k0, tq, a.sk,
                                    a.causal, c)
          : softmax_tile<false, kBk>(sc, m, mc, l, corr, rq, k0, tq, a.sk,
                                     a.causal, c);
      if (moved) {
#pragma unroll
        for (int d = 0; d < kD; ++d)
#pragma unroll
          for (int i = 0; i < 4; ++i) dq[d][i] *= corr[i / 2];
      }
      product_nt<VD, kN>(vbuf, df, gq, tq, ds);       // dP = dO.V^T
#pragma unroll
      for (int n = 0; n < kN; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          ds[n][i] = sc[n][i] * (ds[n][i] - dsum[i / 2]);   // dS~
    }
    __syncthreads();       // every warp has read V
    if (it + 1 < n_tiles)
      load_rows<kBk, VD>(vbuf, vb, a.sv_.s, k0 + kBk, a.sk, threadIdx.x,
                         kThreads);
    cp_async_commit();
    if (!dead) product_nn<QK, kN, kNG>(ds, kt, gq, tq, dq);   // dQ~ += dS~.K
  }
  cp_async_wait<0>();

  T* dqp = static_cast<T*>(a.dq) + b * a.sdq_.b + h * a.sdq_.h;
  const long long plane = static_cast<long long>(a.batch) * a.h * a.sq;
  const long long bh = static_cast<long long>(b) * a.h + h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float sum = l[r];
    sum += __shfl_xor_sync(kFull, sum, 1);
    sum += __shfl_xor_sync(kFull, sum, 2);
    if (rq[r] >= a.sq) continue;
    const float f = a.scale / fmaxf(sum, 1e-30f);
    T* row = dqp + rq[r] * a.sdq_.s + 2 * tq;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      narrow(row + d * 8, dq[d][2 * r] * f);
      narrow(row + d * 8 + 1, dq[d][2 * r + 1] * f);
    }
    if (tq == 0) {
      const long long at = bh * a.sq + rq[r];
      a.stats[at] = m[r];
      a.stats[plane + at] = sum;
      a.stats[2 * plane + at] = dsum[r];
    }
  }
}

template <int QK, int VD, typename T>
__global__ void __launch_bounds__(32 * Tiling<QK, VD, T>::kDkvWarps, 1)
dkv_kernel(Args a) {
  using S = DkvSmem<QK, VD, T>;
  static_assert(S::kBytes <= kMaxSmem, "shared memory");
  constexpr int kWarps = S::kWarps, kThreads = 32 * kWarps;
  constexpr int kBq = S::Tl::kBq, kNG = S::Tl::kNG;
  constexpr int kKeys = 16 * kWarps;  // keys a block
  constexpr int kD = QK / 8;         // k-steps of S^T; dK's n-tiles
  constexpr int kDv = VD / 8;        // k-steps of dP^T; dV's n-tiles
  constexpr int kN = kBq / 8;        // their n-tiles; dV's and dK's k-steps
  extern __shared__ uint4 smem4[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane / 4, tq = lane % 4;
  uint4* kf = smem4 + warp * kD * 32 + lane;
  uint4* vf = smem4 + kWarps * kD * 32 + warp * kDv * 32 + lane;
  char* ring = reinterpret_cast<char*>(smem4) + S::kFragK + S::kFragV;

  const int bh = blockIdx.x, b = bh / a.h, h = bh % a.h;
  const int kvh = h / (a.h / a.kv);
  const int k0 = blockIdx.y * kKeys;
  const int kw = k0 + 16 * warp;        // the warp's first key
  store_frags<QK>(kf, static_cast<const T*>(a.k) + b * a.sk_.b +
                  kvh * a.sk_.h, a.sk_.s, kw, a.sk, gq, tq);
  store_frags<VD>(vf, static_cast<const T*>(a.v) + b * a.sv_.b +
                  kvh * a.sv_.h, a.sv_.s, kw, a.sk, gq, tq);
  const T* qp = static_cast<const T*>(a.q) + b * a.sq_.b + h * a.sq_.h;
  const T* dop = static_cast<const T*>(a.dout) + b * a.sdo_.b +
                 h * a.sdo_.h;
  const long long plane = static_cast<long long>(a.batch) * a.h * a.sq;
  const float* st = a.stats + static_cast<long long>(bh) * a.sq;

  // Stage: Q rows, dO rows, then m, l and D of the tile's queries.
  auto load_stage = [&](char* stage, int q0) {
    load_rows<kBq, QK>(reinterpret_cast<T*>(stage), qp, a.sq_.s, q0, a.sq,
                       threadIdx.x, kThreads);
    load_rows<kBq, VD>(reinterpret_cast<T*>(stage + S::kTileQ), dop,
                       a.sdo_.s, q0, a.sq, threadIdx.x, kThreads);
    if (threadIdx.x < 3 * kBq) {
      const int p = threadIdx.x / kBq, r = threadIdx.x % kBq;
      const bool ok = q0 + r < a.sq;
      cp_async4(reinterpret_cast<float*>(stage + S::kTileQ + S::kTileDo) +
                    threadIdx.x,
                st + p * plane + (ok ? q0 + r : 0), ok);
    }
  };

  float dk[kD][4], dv[kDv][4];
#pragma unroll
  for (int d = 0; d < kD; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[d][i] = 0.0f;
#pragma unroll
  for (int d = 0; d < kDv; ++d)
#pragma unroll
    for (int i = 0; i < 4; ++i) dv[d][i] = 0.0f;
  const float c = a.scale * 1.4426950408889634f;
  const int n_qt = (a.sq + kBq - 1) / kBq;
  // Causal: query rows below k0 see none of these keys.
  const int qt0 = a.causal ? min(k0 / kBq, n_qt) : 0;
  const int n = n_qt - qt0;
  if (n > 0) load_stage(ring, qt0 * kBq);
  cp_async_commit();
  for (int it = 0; it < n; ++it) {
    const int q0 = (qt0 + it) * kBq;
    char* stage = ring + it % 2 * S::kStage;
    cp_async_wait<0>();   // tile it has landed (this thread's part)
    __syncthreads();       // ... everyone's; tile it - 1 is consumed
    if (it + 1 < n)
      load_stage(ring + (it + 1) % 2 * S::kStage, q0 + kBq);
    cp_async_commit();
    // Every key of the warp past sk or above every query of the tile:
    // nothing to store, or nothing live.
    if (kw >= a.sk || (a.causal && kw > q0 + kBq - 1)) continue;
    const T* qs = reinterpret_cast<const T*>(stage);
    const T* dos = reinterpret_cast<const T*>(stage + S::kTileQ);
    const float* sm =
        reinterpret_cast<const float*>(stage + S::kTileQ + S::kTileDo);

    // Thread (g, t): keys kw + g (c0, c1) and kw + g + 8 (c2, c3), queries
    // q0 + n*8 + 2t (c0, c2) and + 1 (c1, c3) of each n-tile.
    float sc[kN][4];
    product_nt<QK, kN>(qs, kf, gq, tq, sc);            // S^T = K.Q^T
    const bool masked = (a.causal && kw + 15 > q0) || q0 + kBq > a.sq;
#pragma unroll
    for (int nn = 0; nn < kN; ++nn)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = nn * 8 + 2 * tq + j, qi = q0 + col;
        const float mcq = sm[col] * c;
        const float il = 1.0f / fmaxf(sm[kBq + col], 1e-30f);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int kj = kw + gq + 8 * r;
          const bool live = !masked ||
                            (qi < a.sq && (!a.causal || kj <= qi));
          float& s = sc[nn][2 * r + j];
          s = live ? exp2_fast(__fmaf_rn(s, c, -mcq)) * il : 0.0f;   // P^T
        }
      }
    float ds[kN][4];
    product_nt<VD, kN>(dos, vf, gq, tq, ds);           // dP^T = V.dO^T
#pragma unroll
    for (int nn = 0; nn < kN; ++nn)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ds[nn][i] = sc[nn][i] *      // dS^T = P^T (dP^T - D)
                    (ds[nn][i] - sm[2 * kBq + nn * 8 + 2 * tq + i % 2]);
    product_nn<VD, kN, kNG>(sc, dos, gq, tq, dv);      // dV += P^T.dO
    product_nn<QK, kN, kNG>(ds, qs, gq, tq, dk);       // dK += dS^T.Q
  }
  cp_async_wait<0>();

  if (a.h == a.kv) {
    // One query head a kv head: dK and dV rounded once to the input type
    // here, no partials and no group sum. The sum starts from +0, so it
    // turns a -0 partial into +0; adding +0 here does the same, so the two
    // agree bit for bit.
    T* dkp = static_cast<T*>(a.dk) + b * a.sdk_.b + kvh * a.sdk_.h;
    T* dvp = static_cast<T*>(a.dv) + b * a.sdv_.b + kvh * a.sdv_.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = kw + gq + 8 * r;
      if (key >= a.sk) continue;
#pragma unroll
      for (int d = 0; d < kD; ++d)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          narrow(dkp + key * a.sdk_.s + d * 8 + 2 * tq + j,
                 dk[d][2 * r + j] * a.scale + 0.0f);
#pragma unroll
      for (int d = 0; d < kDv; ++d)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          narrow(dvp + key * a.sdv_.s + d * 8 + 2 * tq + j,
                 dv[d][2 * r + j] + 0.0f);
    }
    return;
  }
  // Partials of this query head, f32: dK (B*H, SK, QK), then dV (B*H, SK,
  // VD).
  float* out_k = a.part + static_cast<long long>(bh) * a.sk * QK;
  float* out_v = a.part + static_cast<long long>(a.batch) * a.h * a.sk * QK +
                 static_cast<long long>(bh) * a.sk * VD;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = kw + gq + 8 * r;
    if (key >= a.sk) continue;
#pragma unroll
    for (int d = 0; d < kD; ++d)
      *reinterpret_cast<float2*>(out_k + static_cast<long long>(key) * QK +
                                 d * 8 + 2 * tq) =
          make_float2(dk[d][2 * r] * a.scale, dk[d][2 * r + 1] * a.scale);
#pragma unroll
    for (int d = 0; d < kDv; ++d)
      *reinterpret_cast<float2*>(out_v + static_cast<long long>(key) * VD +
                                 d * 8 + 2 * tq) =
          make_float2(dv[d][2 * r], dv[d][2 * r + 1]);
  }
}

// dK, dV of each kv head: its G query heads' partials summed in head order
// (a head dim a thread: of dK, and of dV where the value dim reaches it).
template <int QK, int VD, typename T>
__global__ void reduce_kernel(Args a) {
  const int g = a.h / a.kv;
  const long long n = static_cast<long long>(a.batch) * a.kv * a.sk * QK;
  const float* part_v =
      a.part + static_cast<long long>(a.batch) * a.h * a.sk * QK;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int d = static_cast<int>(i % QK);
    const long long row = i / QK;
    const int c = static_cast<int>(row % a.sk);
    const int bkv = static_cast<int>(row / a.sk);
    const int b = bkv / a.kv, kvh = bkv % a.kv;
    const long long head0 =
        (static_cast<long long>(b) * a.h + kvh * g) * a.sk + c;
    const float* src_k = a.part + head0 * QK + d;
    const float* src_v = part_v + head0 * VD + d;
    float sk = 0.f, sv = 0.f;
    for (int j = 0; j < g; ++j) {
      sk += src_k[j * static_cast<long long>(a.sk) * QK];
      if (d < VD) sv += src_v[j * static_cast<long long>(a.sk) * VD];
    }
    narrow(static_cast<T*>(a.dk) + b * a.sdk_.b + kvh * a.sdk_.h +
           c * a.sdk_.s + d, sk);
    if (d < VD)
      narrow(static_cast<T*>(a.dv) + b * a.sdv_.b + kvh * a.sdv_.h +
             c * a.sdv_.s + d, sv);
  }
}

int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }

template <int QK, int VD, typename T>
int launch(Args a, cudaStream_t s) {
  using Tl = Tiling<QK, VD, T>;
  constexpr int kDq = DqSmem<QK, VD, T>::kBytes;
  constexpr int kDkv = DkvSmem<QK, VD, T>::kBytes;
  constexpr int kKeys = 16 * Tl::kDkvWarps;   // keys a dkv block
  auto dq_fn = dq_kernel<QK, VD, T>;
  auto dkv_fn = dkv_kernel<QK, VD, T>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kDq);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dkv_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kDkv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int group = a.h / a.kv;
  a.hb = gcd(group, Tl::kDqWarps);
  // No keys: dQ is 0 (the walk runs no tile); no queries: dK and dV are 0
  // (no query tile reaches a key block).
  const int rows = 16 * Tl::kDqWarps / a.hb;
  const int n_qt = (a.sq + rows - 1) / rows;
  const int n_kt = (a.sk + kKeys - 1) / kKeys;
  if (n_qt > 65535 || n_kt > 65535) return static_cast<int>(
      cudaErrorInvalidConfiguration);
  if (n_qt) {
    dq_fn<<<dim3(a.batch * a.kv * (group / a.hb), n_qt), 32 * Tl::kDqWarps,
            kDq, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (!n_kt) return 0;
  dkv_fn<<<dim3(a.batch * a.h, n_kt), 32 * Tl::kDkvWarps, kDkv, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.h == a.kv) return static_cast<int>(err);
  const long long rows_out = static_cast<long long>(a.batch) * a.kv * a.sk *
                             QK / kMobyThreads + 1;
  const int blocks = static_cast<int>(rows_out < 132 * kMobyBlocksPerSm
                                          ? rows_out
                                          : 132 * kMobyBlocksPerSm);
  reduce_kernel<QK, VD, T><<<blocks, kMobyThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dq (B,H,SQ,hd), o, dout (B,H,SQ,vd), k, dk (B,KV,SK,hd) and v, dv
// (B,KV,SK,vd) through strides st[3 t .. 3 t + 2] = {b, head, s} for t =
// q, k, v, o, dout, dq, dk, dv; the head dim contiguous; the inputs 16-byte
// aligned. Scratch: stats (3, B*H, SQ) and, where H > KV, part
// (B*H*SK*(hd + vd): dK's partials, then dV's; at H = KV it is not read),
// f32. Inputs and outputs bf16 if is_bf16 ((hd, vd)
// = (16, 16), (32, 32), (24, 16)), else f32 (equal dims 16, 32, 64, 128,
// and (192, 128), (24, 16)).
MOBY_API int moby_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* stats, void* part,
    const long long* st, int batch, int n_heads, int n_kv_heads, int sq,
    int sk, int head_dim, int value_dim, int causal, int is_bf16,
    float scale, void* stream) {
  if (batch * n_heads == 0) return 0;
  Args a{q, k, v, o, dout, dq, dk, dv, static_cast<float*>(stats),
         static_cast<float*>(part),
         {st[0], st[1], st[2]}, {st[3], st[4], st[5]},
         {st[6], st[7], st[8]}, {st[9], st[10], st[11]},
         {st[12], st[13], st[14]}, {st[15], st[16], st[17]},
         {st[18], st[19], st[20]}, {st[21], st[22], st[23]},
         batch, n_heads, n_kv_heads, sq, sk, causal, scale, 1};
  const auto s = static_cast<cudaStream_t>(stream);
  if (head_dim == 24 && value_dim == 16)
    return is_bf16 ? launch<24, 16, __nv_bfloat16>(a, s)
                   : launch<24, 16, float>(a, s);
  if (head_dim == 192 && value_dim == 128 && !is_bf16)
    return launch<192, 128, float>(a, s);
  if (head_dim != value_dim) return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16) {
    switch (head_dim) {
      case 16: return launch<16, 16, __nv_bfloat16>(a, s);
      case 32: return launch<32, 32, __nv_bfloat16>(a, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (head_dim) {
    case 16: return launch<16, 16, float>(a, s);
    case 32: return launch<32, 32, float>(a, s);
    case 64: return launch<64, 64, float>(a, s);
    case 128: return launch<128, 128, float>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
