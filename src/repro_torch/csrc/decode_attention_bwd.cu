// Backward pass of single-token decode attention over a KV cache: dq, and
// the cotangents of the two caches, from q, the caches, the forward's
// output o and its cotangent do.
//
// Replaces the VJP around the TPU kernel: repro/ops/api.py (_decode_bwd),
// jax.vjp of repro/kernels/decode_attention/ref.py::decode_attention_ref
// (the int positions get no cotangent). Its plain version is
// kernels/decode_attention/ref.py::decode_attention_bwd_ref. For request
// b and query head h of kv head k (G = H / KV heads a kv head), over the
// live positions j < len = min(cache_pos[b], S):
//   a_j = softmax_j(scale q.k_j), D = do.o,
//   dV_j = sum_h a_hj do_h, dK_j = scale sum_h a_hj (do_h.v_j - D_h) q_h,
//   dq_h = scale sum_j a_hj (do_h.v_j - D_h) k_j,
// and dK_j = dV_j = 0 at positions j >= len (so a request with
// cache_pos = 0 gets zeros everywhere, as its forward gives 0).
//
// What bounds it on an H100: bytes. It reads the live part of both caches
// and writes two cache-sized cotangents: at the decode shape (B=16, H=16,
// KV=2, S=32768, hd=128, bf16, ragged positions) 0.31 GB read and 0.54 GB
// written, 0.254 ms at 3.35 TB/s, against ~6 GFLOP (~0.1 ms of f32 on the
// SIMT cores). The softmax statistics need every live score before any
// gradient, and the forward does not save them, so K is read twice: 0.16
// GB more, ~0.05 ms.
//
// Design, deterministic and without atomics (three launches of one entry
// point, in stream order), the S axis split in chunks of kChunk positions,
// a block per (chunk, b, kv head), a chunk's kv heads side by side in the
// grid (the caches' (B, S, KV, hd) rows read, and dK and dV written, in
// whole spans):
// * stats_kernel: each of the G heads' max and sum of exp over the chunk's
//   live scores. K streams as the forward streams the cache
//   (csrc/decode_attention.cu): in its own type, by 16-byte cp.async into
//   a ring of 3 stages of 32 positions (two tiles in flight while one is
//   computed; only live tiles are read), rows padded by 16 bytes so that
//   eight lanes' reads of eight rows fall in distinct banks. S of a tile
//   for 8 heads at a time, then warp g keeps head g's running max and sum
//   by shuffles.
// * main_kernel: the heads' (m, l) combined from every live chunk's (a warp
//   a head, lanes over chunks, each lane's loads in flight together),
//   D = do.o; then the chunk's live tiles through the same ring, K and V
//   both: S and dP, then P and dS = P (dP - D) into shared memory (warp g,
//   head g, lane j position j); then lanes over head dims, 4 a thread,
//   each thread a run of consecutive positions (4 at hd 128): dK and dV of
//   its positions summed over the heads in registers, and dq's partial
//   (sum_j dS_hj k_j) of its dims in registers across the chunk, the
//   runs' partials summed in shared memory once at the end (once a head
//   group and a tile where G > 8). dK and dV leave as whole rows by 16-byte
//   stores (bf16 at hd >= 64: two neighbouring lanes swap halves by a
//   shuffle, so that each stores 8 dims of one row); positions past len
//   (the chunk's dead tail, and whole dead chunks) get 16-byte stores of
//   zeros, each block its own chunk's, so the zeros spread over the grid.
// * dq_kernel sums each (b, h)'s partial dq over the live chunks (in a
//   fixed order: 256 / hd interleaved parts, then the parts) and rounds
//   once to the input type.
// S and dP: in bf16 on the tensor cores, mma.sync m16n8k16 with the 8
// heads of a group as rows 0-7 of A (rows 8-15 zero), a tile's 32
// positions as four 8-column tiles (a warp each, 4 warps for S and 4 for
// dP), A's fragments built once a block, B read straight from the ring's
// rows: bf16 products are exact in the f32 accumulators, so S and dP keep
// f32 accuracy. In f32 on the SIMT cores: lane j takes position j and
// warp w a slice of hd / 8 dims, each K (V) value widened once for the 8
// heads, the warps' partials summed in shared memory. Everything after S
// and dP is f32 on the SIMT cores (explicit fmaf: the library builds with
// -fmad=false; IEEE expf and division). Query heads go 8 at a time (a head
// group; a last partial group's missing heads are zero rows, skipped by
// block-uniform branches); any G whose shared memory fits
// (moby_decode_attention_bwd_smem; the wrapper checks). q, o and do come
// through element strides (the head dim contiguous) by scalar loads; the
// caches by 16-byte copies, so their bases and strides must be 16-byte
// aligned (the wrapper checks); dK and dV are the wrapper's own
// allocations, aligned.
//
// Measured (tools/decode_bwd_probe.py; PERF.md): the call moves its bytes
// at ~2.3 TB/s; a build without the arithmetic (the copies, barriers and
// stores alone) takes 94% of its time. ptxas (sm_90a): the bf16 main
// kernel 85-126 registers (at most 128 for 2 blocks an SM), the f32 one
// 96-167, the stats kernel 40-76, no spills.
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

#include "moby_kernels.cuh"
#include "tf32x3.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kChunk = 512;        // positions a block
constexpr int kTile = 32;          // positions a ring stage: one a lane
constexpr int kStages = 3;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kHeads = 8;          // query heads a pass: one a warp
constexpr unsigned kFull = 0xffffffffu;
static_assert(kHeads == kWarps && kTile == 32, "warp g takes head g");

struct Args {
  const void *q, *k, *v, *o, *dout;
  const int* pos;
  void *dq, *dk, *dv;
  float *part_m, *part_l, *part_dq;
  // In elements, the head dim contiguous: q, o, dout, dq {b, h};
  // k, v, dk, dv {b, kv, s}.
  long long q_b, q_h, o_b, o_h, do_b, do_h, dq_b, dq_h;
  long long k_b, k_h, k_s, v_b, v_h, v_s, dk_b, dk_h, dk_s, dv_b, dv_h, dv_s;
  int h, kv, s_len, n_chunks;
  float scale;
};

__device__ __forceinline__ int live_len(const Args& a, int b) {
  return min(max(a.pos[b], 0), a.s_len);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// N consecutive T values from shared memory, widened to f32, by loads of
// up to 16 bytes (a bf16 is the high half of an f32).
template <typename T, int N>
__device__ __forceinline__ void load_widen(const uint8_t* p, float* out) {
  if constexpr (sizeof(T) == 4) {
    static_assert(N % 4 == 0 || N < 4, "whole float4s");
    if constexpr (N >= 4) {
#pragma unroll
      for (int i = 0; i < N; i += 4) {
        const float4 w = *reinterpret_cast<const float4*>(p + 4 * i);
        out[i] = w.x; out[i + 1] = w.y; out[i + 2] = w.z; out[i + 3] = w.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i)
        out[i] = reinterpret_cast<const float*>(p)[i];
    }
  } else {
    uint32_t w[(N + 1) / 2];
    if constexpr (N >= 8) {
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
        const uint4 x = *reinterpret_cast<const uint4*>(p + 16 * i);
        w[4 * i] = x.x; w[4 * i + 1] = x.y; w[4 * i + 2] = x.z;
        w[4 * i + 3] = x.w;
      }
    } else if constexpr (N == 4) {
      const uint2 x = *reinterpret_cast<const uint2*>(p);
      w[0] = x.x; w[1] = x.y;
    } else if constexpr (N == 2) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      static_assert(N == 1, "1, 2, 4 or a multiple of 8 bf16");
      w[0] = *reinterpret_cast<const uint16_t*>(p);
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
      out[i] = __uint_as_float(i % 2 ? w[i / 2] & 0xffff0000u
                                     : w[i / 2] << 16);
  }
}

// An instance's shared tiles. A ring stage holds kTile rows of K (then of
// V in the main kernel), each row padded by 16 bytes, so that the 16-byte
// reads of eight lanes (a row each) fall in eight distinct bank groups.
template <int HD, typename T>
struct Tiles {
  static constexpr int kRow = HD * static_cast<int>(sizeof(T));   // bytes
  static constexpr int kRowP = kRow + 16;
  static constexpr int kPieces = kRow / 16;      // 16-byte copies a row
  static constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  static constexpr int kRows = kTile * kRowP;    // bytes of K (or V)
  // S and dP: warp w takes dims [w, w+1) * kSlice of every position.
  static constexpr int kSlice = HD / kWarps;
  static constexpr int kLoad = kSlice < kPer ? kSlice : kPer;
  // dK and dV: a thread takes 4 dims (kLr threads a row) of kIt
  // consecutive positions; kSets such runs a tile.
  static constexpr int kLr = HD / 4;
  static constexpr int kIt = HD >= 32 ? HD / 32 : 1;
  static constexpr int kSets = kTile / kIt;
  static_assert(kSets * kLr <= kThreads, "a run a thread");
  // S and dP in bf16 on the tensor cores (bf16 products are exact in the
  // f32 accumulators): whole dot products; in f32 on the SIMT cores: a
  // partial a warp.
  static constexpr bool kMma = sizeof(T) == 2;
  static constexpr int kParts = kMma ? 1 : kWarps;
  // A head group's mma A fragments of q (or do): [HD / 16][32 lanes] uint2.
  static constexpr int kFrag = kMma ? HD / 16 * 32 * 8 : 0;     // bytes
  // Scratch: the dot products (or partials) of S and dP, [2][kParts]
  // [kHeads][kTile], or the runs' partial dq of a head group, [kSets]
  // [kHeads][HD].
  static constexpr int kRedPart = kParts * kHeads * kTile;
  static constexpr int kRed = 2 * kRedPart > kSets * kHeads * HD
                                  ? 2 * kRedPart : kSets * kHeads * HD;
};

// G rounded up to whole head groups.
__host__ __device__ __forceinline__ int padded_heads(int g) {
  return (g + kHeads - 1) / kHeads * kHeads;
}

// Main kernel: a ring of K and V stages, the mma fragments of q and do
// (bf16), then f32 q, do and the partial dq [Gpad][HD] each, the scratch,
// P and dS [kHeads][kTile] each, and m, l, D [Gpad].
template <int HD, typename T>
int main_smem(int g) {
  using L = Tiles<HD, T>;
  const int gp = padded_heads(g);
  return kStages * 2 * L::kRows + 2 * gp / kHeads * L::kFrag +
         (3 * gp * HD + L::kRed + 2 * kHeads * kTile + 3 * gp) * 4;
}

// Stats kernel: a ring of K stages, the mma fragments of q (bf16), f32 q
// [Gpad][HD], the dot products of S (or partials) [kParts][kHeads][kTile],
// m and l [Gpad].
template <int HD, typename T>
int stats_smem(int g) {
  using L = Tiles<HD, T>;
  const int gp = padded_heads(g);
  return kStages * L::kRows + gp / kHeads * L::kFrag +
         (gp * HD + L::kRedPart + 2 * gp) * 4;
}

// The G query heads of (b, kv head) from N (B, H, hd) tensors into f32
// shared rows (Gpad x HD each; the padding heads are zero): a head group's
// loads all in flight before the first is used.
struct Heads {
  const void* src;
  long long sb, sh;
  float* dst;
};

template <int HD, typename T, int N>
__device__ __forceinline__ void load_heads(const Heads (&x)[N], int b, int h0,
                                           int g, int gp) {
  constexpr int kN = kHeads * HD;              // values of a head group
  constexpr int kPer = (kN + kThreads - 1) / kThreads;
  for (int hg = 0; hg < gp; hg += kHeads) {
    float v[N][kPer];
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int i = threadIdx.x + r * kThreads, h = hg + i / HD;
        const T* p = static_cast<const T*>(x[n].src) + b * x[n].sb +
                     (h0 + h) * x[n].sh + i % HD;
        v[n][r] = i < kN && h < g ? widen(*p) : 0.f;
      }
#pragma unroll
    for (int n = 0; n < N; ++n)
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const int i = threadIdx.x + r * kThreads;
        if (i < kN) x[n].dst[hg * HD + i] = v[n][r];
      }
  }
}

// Tile t (kTile positions from t0) of `n_arrays` caches into ring stage
// `stage` (K rows, then V rows), by 16-byte cp.async; positions at or past
// `end` are zero-filled by the copy.
template <int HD, typename T, int N_ARRAYS>
__device__ __forceinline__ void issue_tile(uint8_t* stage, const T* kb,
                                           long long ks, const T* vb,
                                           long long vs, int t0, int end) {
  using L = Tiles<HD, T>;
  constexpr int kN = kTile * L::kPieces;          // copies an array
#pragma unroll
  for (int r = 0; r < (kN + kThreads - 1) / kThreads; ++r) {
    const int e = threadIdx.x + r * kThreads;
    if (kN % kThreads && e >= kN) break;
    const int j = e / L::kPieces, pc = e % L::kPieces;
    const bool ok = t0 + j < end;
    const long long sj = ok ? t0 + j : 0;   // a valid address when !ok
    cp_async16(stage + j * L::kRowP + pc * 16, kb + sj * ks + pc * L::kPer,
               ok);
    if constexpr (N_ARRAYS == 2)
      cp_async16(stage + L::kRows + j * L::kRowP + pc * 16,
                 vb + sj * vs + pc * L::kPer, ok);
  }
}

// The ring's schedule: kStages - 1 tiles in flight, tile t waited for
// (every thread's part) before the stage it lands in is read.
template <int HD, typename T, int N_ARRAYS>
struct Ring {
  uint8_t* base;
  const T *kb, *vb;
  long long ks, vs;
  int c0, end, n_tiles;
  static constexpr int kStage = N_ARRAYS * Tiles<HD, T>::kRows;

  __device__ __forceinline__ void issue(int t) const {
    issue_tile<HD, T, N_ARRAYS>(base + t % kStages * kStage, kb, ks, vb, vs,
                                c0 + t * kTile, end);
  }
  __device__ __forceinline__ void prologue() const {
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < n_tiles) issue(t);
      cp_async_commit();
    }
  }
  // Tile t's stage, landed for every thread.
  __device__ __forceinline__ const uint8_t* wait(int t) const {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // ... and tile t - 1 consumed: its stage reused
    if (t + kStages - 1 < n_tiles) issue(t + kStages - 1);
    cp_async_commit();
    return base + t % kStages * kStage;
  }
};

// The partial dot products of S = q.k (and dP = do.v where DP) for heads
// [0, hn) of the group whose q rows start at qg (do rows at dg): lane j
// takes position j, warp w its slice of dims; into red[w][h][j] (and
// red[kRedPart + ...] for dP). Each K (V) value is widened once for the
// group's heads.
template <int HD, typename T, bool DP>
__device__ __forceinline__ void partial_dots(const uint8_t* stage,
                                             const float* qg, const float* dg,
                                             float* red, int hn) {
  using L = Tiles<HD, T>;
  constexpr int kS = L::kSlice;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint8_t* kr = stage + lane * L::kRowP + warp * kS * sizeof(T);
  float kx[kS], vx[DP ? kS : 1];
#pragma unroll
  for (int c = 0; c < kS; c += L::kLoad) {
    load_widen<T, L::kLoad>(kr + c * sizeof(T), kx + c);
    if constexpr (DP)
      load_widen<T, L::kLoad>(kr + L::kRows + c * sizeof(T), vx + c);
  }
#pragma unroll
  for (int h = 0; h < kHeads; ++h) {
    if (h >= hn) break;   // block-uniform
    const float* qh = qg + h * HD + warp * kS;
    const float* dh = DP ? dg + h * HD + warp * kS : nullptr;
    float s = 0.f, dp = 0.f;
    if constexpr (kS % 4 == 0) {   // broadcast float4 reads
#pragma unroll
      for (int d = 0; d < kS; d += 4) {
        const float4 qq = *reinterpret_cast<const float4*>(qh + d);
        s = fmaf(qq.x, kx[d], s);
        s = fmaf(qq.y, kx[d + 1], s);
        s = fmaf(qq.z, kx[d + 2], s);
        s = fmaf(qq.w, kx[d + 3], s);
        if constexpr (DP) {
          const float4 oo = *reinterpret_cast<const float4*>(dh + d);
          dp = fmaf(oo.x, vx[d], dp);
          dp = fmaf(oo.y, vx[d + 1], dp);
          dp = fmaf(oo.z, vx[d + 2], dp);
          dp = fmaf(oo.w, vx[d + 3], dp);
        }
      }
    } else {
#pragma unroll
      for (int d = 0; d < kS; ++d) {
        s = fmaf(qh[d], kx[d], s);
        if constexpr (DP) dp = fmaf(dh[d], vx[d], dp);
      }
    }
    red[(warp * kHeads + h) * kTile + lane] = s;
    if constexpr (DP)
      red[L::kRedPart + (warp * kHeads + h) * kTile + lane] = dp;
  }
}

__device__ __forceinline__ uint32_t pack2(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += a (16x16, row) . b (16x8, col), bf16 in, f32 accumulators.
// Fragments (g = lane / 4, t = lane % 4): a0 (g, 2t..2t+1), a1 (g+8, ..),
// a2 (g, 2t+8..2t+9), a3 (g+8, ..); b0 (k 2t..2t+1, n g), b1 (k 2t+8..,
// n g); d0, d1 (g, 2t), (g, 2t+1), d2, d3 (g+8, ..).
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The mma A fragments (a0, a2) of every head group of f32 rows src
// (Gpad x HD, bf16 values: exact) into frag [group][HD / 16][lane]; the
// heads are the rows 0-7, rows 8-15 are zero (a1, a3).
template <int HD>
__device__ __forceinline__ void build_frags(uint2* frag, const float* src,
                                            int gp) {
  constexpr int kSteps = HD / 16;
  for (int i = threadIdx.x; i < gp / kHeads * kSteps * 32; i += kThreads) {
    const int lane = i % 32, ks = i / 32 % kSteps, grp = i / 32 / kSteps;
    const float* r = src + (grp * kHeads + lane / 4) * HD + ks * 16 +
                     2 * (lane % 4);
    frag[i] = make_uint2(pack2(r[0], r[1]), pack2(r[8], r[9]));
  }
}

// S = q.k (warps 0-3) and, where DP, dP = do.v (warps 4-7) of a tile for a
// head group, bf16 on the tensor cores: warp w takes positions
// [w % 4, w % 4 + 1) * 8, m16n8k16 over the head dims, A the group's
// fragments (fq, fd), B K's (V's) rows as the stage holds them; into
// red[p][h][j] (p = 0 S, 1 dP).
template <int HD, bool DP>
__device__ __forceinline__ void mma_dots(const uint8_t* stage,
                                         const uint2* fq, const uint2* fd,
                                         float* red) {
  using L = Tiles<HD, __nv_bfloat16>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int prod = warp / 4, nt = warp % 4;
  if (!DP && prod == 1) return;
  const int g = lane / 4, t = lane % 4;
  const uint2* f = prod ? fd : fq;
  const uint8_t* row = stage + prod * L::kRows + (nt * 8 + g) * L::kRowP +
                       4 * t;
  float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    const uint2 a = f[ks * 32 + lane];
    const uint32_t af[4] = {a.x, 0u, a.y, 0u};
    const uint32_t bf[2] = {
        *reinterpret_cast<const uint32_t*>(row + ks * 32),
        *reinterpret_cast<const uint32_t*>(row + ks * 32 + 16)};
    mma_bf16(c, af, bf);
  }
  *reinterpret_cast<float2*>(red + (prod * kHeads + g) * kTile + nt * 8 +
                             2 * t) = make_float2(c[0], c[1]);
}

// Head h's dot product at its lane's position (the sum of kParts
// partials), scaled.
template <int kParts>
__device__ __forceinline__ float score(const float* red, int h, int lane,
                                       float scale) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kParts; ++w) s += red[(w * kHeads + h) * kTile + lane];
  return s * scale;
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 3 : 2)
stats_kernel(Args a) {
  using L = Tiles<HD, T>;
  extern __shared__ float4 smem4[];
  const int g = a.h / a.kv, gp = padded_heads(g);
  const int chunk = blockIdx.x / a.kv, kvh = blockIdx.x % a.kv,
            b = blockIdx.y;
  const int len = live_len(a, b), c0 = chunk * kChunk;
  if (c0 >= len) return;                   // a dead chunk: never read
  const int end = min(c0 + kChunk, len);
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem4);
  uint2* fq = reinterpret_cast<uint2*>(ring + kStages * L::kRows);
  float* qs = reinterpret_cast<float*>(ring + kStages * L::kRows +
                                       gp / kHeads * L::kFrag);
  float* red = qs + gp * HD;               // [kParts][kHeads][kTile]
  float* mg = red + L::kRedPart;           // [Gpad]
  float* lg = mg + gp;                     // [Gpad]
  const Ring<HD, T, 1> rg{ring,
                          static_cast<const T*>(a.k) + b * a.k_b + kvh * a.k_h,
                          nullptr, a.k_s, 0, c0, end,
                          (end - c0 + kTile - 1) / kTile};
  rg.prologue();
  const int h0 = kvh * g;
  load_heads<HD, T, 1>({Heads{a.q, a.q_b, a.q_h, qs}}, b, h0, g, gp);
  for (int i = threadIdx.x; i < gp; i += kThreads) {
    mg[i] = kNeg;
    lg[i] = 0.f;
  }
  if constexpr (L::kMma) {
    __syncthreads();
    build_frags<HD>(fq, qs, gp);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = 0; t < rg.n_tiles; ++t) {
    const uint8_t* stage = rg.wait(t);
    const bool live = c0 + t * kTile + lane < end;
    for (int hg = 0; hg < gp; hg += kHeads) {
      const int hn = min(kHeads, g - hg);
      if (hg > 0) __syncthreads();   // the last group's partials are read
      if constexpr (L::kMma) {
        mma_dots<HD, false>(stage, fq + hg / kHeads * (HD / 16) * 32,
                            nullptr, red);
      } else {
        partial_dots<HD, T, false>(stage, qs + hg * HD, nullptr, red, hn);
      }
      __syncthreads();
      if (warp < hn) {
        const float s =
            live ? score<L::kParts>(red, warp, lane, a.scale) : kNeg;
        float* m = mg + hg + warp;
        float* l = lg + hg + warp;
        const float m_old = *m;
        const float m_new = fmaxf(m_old, warp_max(s));
        const float sum = warp_sum(live ? expf(s - m_new) : 0.f);
        __syncwarp();   // every lane has read m
        if (lane == 0) {
          *l = *l * expf(m_old - m_new) + sum;
          *m = m_new;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  const long long rows = static_cast<long long>(gridDim.y) * a.h;
  for (int gi = threadIdx.x; gi < g; gi += kThreads) {
    const long long at = chunk * rows + b * a.h + h0 + gi;
    a.part_m[at] = mg[gi];
    a.part_l[at] = lg[gi];
  }
}

// Rows [r0, r1) of a (kv head's) dK and dV set to zero, by 16-byte stores.
template <int HD, typename T>
__device__ __forceinline__ void zero_rows(T* dk, long long dks, T* dv,
                                          long long dvs, int r0, int r1) {
  using L = Tiles<HD, T>;
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < (r1 - r0) * L::kPieces; i += kThreads) {
    const long long r = r0 + i / L::kPieces;
    const int col = i % L::kPieces * L::kPer;
    *reinterpret_cast<uint4*>(dk + r * dks + col) = z;
    *reinterpret_cast<uint4*>(dv + r * dvs + col) = z;
  }
}

__device__ __forceinline__ uint2 pack_bf16(const float (&x)[4]) {
  return make_uint2(pack2(x[0], x[1]), pack2(x[2], x[3]));
}

// A thread's dims [col, col + 4) of rows row0 .. row0 + kIt - 1 of one
// cotangent (x[i] for row row0 + i; rows at or past `end` are not
// stored), as whole rows of 16-byte stores: f32 stores its 16 bytes; bf16
// at an even kIt swaps halves with the neighbouring lane (the next 4
// dims), so that the even lane stores 8 dims of row i and the odd one 8
// dims of row i + 1.
template <int HD, typename T>
__device__ __forceinline__ void store_rows(T* p, long long ps,
                                           const float (&x)[Tiles<HD, T>::kIt]
                                                           [4],
                                           int row0, int col, int end) {
  constexpr int kIt = Tiles<HD, T>::kIt;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int i = 0; i < kIt; ++i)
      if (row0 + i < end)
        *reinterpret_cast<float4*>(p + (row0 + i) * ps + col) =
            make_float4(x[i][0], x[i][1], x[i][2], x[i][3]);
  } else if constexpr (kIt % 2 == 0) {
    const bool odd = (col / 4) % 2;
#pragma unroll
    for (int i = 0; i < kIt; i += 2) {
      const uint2 mine0 = pack_bf16(x[i]), mine1 = pack_bf16(x[i + 1]);
      const uint2 send = odd ? mine0 : mine1;
      const uint2 got = make_uint2(__shfl_xor_sync(kFull, send.x, 1),
                                   __shfl_xor_sync(kFull, send.y, 1));
      const uint4 out = odd ? make_uint4(got.x, got.y, mine1.x, mine1.y)
                            : make_uint4(mine0.x, mine0.y, got.x, got.y);
      const int row = row0 + i + odd;
      if (row < end)
        *reinterpret_cast<uint4*>(p + row * ps + (odd ? col - 4 : col)) = out;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kIt; ++i)
      if (row0 + i < end)
        *reinterpret_cast<uint2*>(p + (row0 + i) * ps + col) = pack_bf16(x[i]);
  }
}

// N consecutive floats of shared memory (N-aligned) in one load.
template <int N>
__device__ __forceinline__ void load_run(const float* p, float (&out)[N]) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
    static_assert(N == 1, "runs of 1, 2 or 4");
    out[0] = *p;
  }
}

// The threads' partial dq of heads [hg, hg + hn), dims [col, col + 4),
// summed over the tile's runs (red: [kSets][kHeads][HD]) into dqs, in run
// order; the partials start again from 0.
template <int HD>
__device__ __forceinline__ void flush_dq(float (&dq)[kHeads][4], float* red,
                                         float* dqs, int set, int col,
                                         bool active, int hg, int hn) {
  constexpr int kSets = Tiles<HD, float>::kSets;
  if (active) {
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
      *reinterpret_cast<float4*>(red + (set * kHeads + h) * HD + col) =
          make_float4(dq[h][0], dq[h][1], dq[h][2], dq[h][3]);
#pragma unroll
      for (int c = 0; c < 4; ++c) dq[h][c] = 0.f;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < hn * HD; i += kThreads) {
    float sum = 0.f;
    for (int s = 0; s < kSets; ++s) sum += red[s * kHeads * HD + i];
    dqs[hg * HD + i] += sum;
  }
}

// kMulti: G > 8, several head groups a tile (dK and dV summed over them in
// registers, dq's partials summed a group and a tile).
template <int HD, typename T, bool kMulti>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 2 : 1)
main_kernel(Args a) {
  using L = Tiles<HD, T>;
  constexpr int kIt = L::kIt;
  extern __shared__ float4 smem4[];
  const int g = a.h / a.kv, gp = padded_heads(g);
  const int chunk = blockIdx.x / a.kv, kvh = blockIdx.x % a.kv,
            b = blockIdx.y;
  const int len = live_len(a, b), c0 = chunk * kChunk;
  const int stop = min(c0 + kChunk, a.s_len);
  T* dkp = static_cast<T*>(a.dk) + b * a.dk_b + kvh * a.dk_h;
  T* dvp = static_cast<T*>(a.dv) + b * a.dv_b + kvh * a.dv_h;
  if (c0 >= len) {                         // a dead chunk: zeros
    zero_rows<HD, T>(dkp, a.dk_s, dvp, a.dv_s, c0, stop);
    return;
  }
  const int end = min(stop, len);
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem4);
  uint2* fq = reinterpret_cast<uint2*>(ring + kStages * 2 * L::kRows);
  uint2* fd = fq + gp / kHeads * L::kFrag / 8;
  float* qs = reinterpret_cast<float*>(ring + kStages * 2 * L::kRows +
                                       2 * gp / kHeads * L::kFrag);
  float* dos = qs + gp * HD;               // [Gpad][HD]
  float* dqs = dos + gp * HD;              // [Gpad][HD]
  float* red = dqs + gp * HD;              // kRed
  float* ps = red + L::kRed;               // [kHeads][kTile]
  float* dss = ps + kHeads * kTile;        // [kHeads][kTile]
  float* mg = dss + kHeads * kTile;        // [Gpad]
  float* lg = mg + gp;
  float* dg = lg + gp;
  const Ring<HD, T, 2> rg{
      ring, static_cast<const T*>(a.k) + b * a.k_b + kvh * a.k_h,
      static_cast<const T*>(a.v) + b * a.v_b + kvh * a.v_h, a.k_s, a.v_s, c0,
      end, (end - c0 + kTile - 1) / kTile};
  rg.prologue();
  const int h0 = kvh * g;
  load_heads<HD, T, 2>({Heads{a.q, a.q_b, a.q_h, qs},
                        Heads{a.dout, a.do_b, a.do_h, dos}}, b, h0, g, gp);
  for (int i = threadIdx.x; i < gp * HD; i += kThreads) dqs[i] = 0.f;
  zero_rows<HD, T>(dkp, a.dk_s, dvp, a.dv_s, end, stop);   // the dead tail
  __syncthreads();
  if constexpr (L::kMma) {
    build_frags<HD>(fq, qs, gp);
    build_frags<HD>(fd, dos, gp);
  }
  // Each head's (m, l) from the live chunks' partials (lanes over chunks,
  // merged online, then across the lanes), and D = do.o (lanes over dims):
  // warp w takes heads w, w + 8, ...; each lane's loads in flight together.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long rows = static_cast<long long>(gridDim.y) * a.h;
  const int n_live = (len + kChunk - 1) / kChunk;
  const T* op = static_cast<const T*>(a.o) + b * a.o_b;
  constexpr int kDl = HD >= 32 ? HD / 32 : 1;   // dims a lane
  for (int gi = warp; gi < g; gi += kWarps) {
    const long long row = b * a.h + h0 + gi;
    float ov[kDl];
#pragma unroll
    for (int i = 0; i < kDl; ++i)
      ov[i] = lane + 32 * i < HD ? widen(op[(h0 + gi) * a.o_h + lane + 32 * i])
                                 : 0.f;
    float m = kNeg, l = 0.f;
#pragma unroll 4
    for (int c = lane; c < n_live; c += 32) {
      const float pm = a.part_m[c * rows + row];
      const float pl = a.part_l[c * rows + row];
      const float mn = fmaxf(m, pm);
      l = l * expf(m - mn) + pl * expf(pm - mn);
      m = mn;
    }
    const float m_all = warp_max(m);
    l = warp_sum(l * expf(m - m_all));
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < kDl; ++i)
      if (lane + 32 * i < HD)
        d = fmaf(dos[gi * HD + lane + 32 * i], ov[i], d);
    d = warp_sum(d);
    if (lane == 0) {
      mg[gi] = m_all;
      lg[gi] = l;
      dg[gi] = d;
    }
  }
  // dK and dV: the thread's dims [col, col + 4) of positions j0 ..
  // j0 + kIt - 1 of a tile (set `set`); idle where a tile has fewer runs
  // than the block threads (hd 16).
  const int col = threadIdx.x % L::kLr * 4, set = threadIdx.x / L::kLr;
  const bool active = set < L::kSets;
  const int j0 = set * kIt;
  float dq[kHeads][4];                     // this thread's partial dq
#pragma unroll
  for (int h = 0; h < kHeads; ++h)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[h][c] = 0.f;
  for (int t = 0; t < rg.n_tiles; ++t) {
    const uint8_t* stage = rg.wait(t);
    const int t0 = c0 + t * kTile;
    float dk[kIt][4], dv[kIt][4];
#pragma unroll
    for (int i = 0; i < kIt; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) dk[i][c] = dv[i][c] = 0.f;
    for (int hg = 0; hg < (kMulti ? gp : kHeads); hg += kHeads) {
      const int hn = min(kHeads, g - hg);
      if (kMulti && hg > 0) __syncthreads();   // the last group's scratch
      if constexpr (L::kMma) {
        const int f0 = hg / kHeads * (HD / 16) * 32;
        mma_dots<HD, true>(stage, fq + f0, fd + f0, red);
      } else {
        partial_dots<HD, T, true>(stage, qs + hg * HD, dos + hg * HD, red,
                                  hn);
      }
      __syncthreads();
      // P and dS: warp h takes head h, lane j position j.
      {
        float p = 0.f, ds = 0.f;
        if (warp < hn && t0 + lane < end) {
          const int gi = hg + warp;
          const float s = score<L::kParts>(red, warp, lane, a.scale);
          const float dp = score<L::kParts>(red + L::kRedPart, warp, lane,
                                            1.f);
          p = expf(s - mg[gi]) / lg[gi];
          ds = p * (dp - dg[gi]);
        }
        ps[warp * kTile + lane] = p;
        dss[warp * kTile + lane] = ds;
      }
      __syncthreads();
      if (active) {
        // The thread's K values for dq: dims [col, col + 4) of its
        // positions.
        float kj[kIt][4];
#pragma unroll
        for (int i = 0; i < kIt; ++i)
          load_widen<T, 4>(stage + (j0 + i) * L::kRowP + col * sizeof(T),
                           kj[i]);
#pragma unroll
        for (int h = 0; h < kHeads; ++h) {
          if (h >= hn) break;   // block-uniform
          const float4 qq =
              *reinterpret_cast<const float4*>(qs + (hg + h) * HD + col);
          const float4 oo =
              *reinterpret_cast<const float4*>(dos + (hg + h) * HD + col);
          const float qv[4] = {qq.x, qq.y, qq.z, qq.w};
          const float ov[4] = {oo.x, oo.y, oo.z, oo.w};
          float pv[kIt], dv_s[kIt];   // broadcast reads
          load_run<kIt>(ps + h * kTile + j0, pv);
          load_run<kIt>(dss + h * kTile + j0, dv_s);
#pragma unroll
          for (int i = 0; i < kIt; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              dk[i][c] = fmaf(dv_s[i], qv[c], dk[i][c]);
              dv[i][c] = fmaf(pv[i], ov[c], dv[i][c]);
              dq[h][c] = fmaf(dv_s[i], kj[i][c], dq[h][c]);
            }
        }
      }
      if constexpr (kMulti)
        flush_dq<HD>(dq, red, dqs, set, col, active, hg, hn);
    }
#pragma unroll
    for (int i = 0; i < kIt; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) dk[i][c] *= a.scale;
    if (active) {
      store_rows<HD, T>(dkp, a.dk_s, dk, t0 + j0, col, end);
      store_rows<HD, T>(dvp, a.dv_s, dv, t0 + j0, col, end);
    }
  }
  cp_async_wait<0>();
  if constexpr (!kMulti) flush_dq<HD>(dq, red, dqs, set, col, active, 0, g);
  __syncthreads();
  for (int i = threadIdx.x; i < g * HD; i += kThreads)
    a.part_dq[(chunk * rows + b * a.h + h0 + i / HD) * HD + i % HD] = dqs[i];
}

// A block a (b, h) row: thread (part, d) sums dim d of the live chunks
// c = part, part + kParts, ... in order, then the parts are added in
// order: the loads of 256 threads in flight, the sum's order fixed.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) dq_kernel(Args a) {
  constexpr int kParts = kThreads / HD;
  __shared__ float part_s[kParts][HD];
  const int row = blockIdx.x, b = row / a.h, h = row % a.h;
  const long long rows = static_cast<long long>(gridDim.x);
  const int n_live = (live_len(a, b) + kChunk - 1) / kChunk;
  const int d = threadIdx.x % HD, part = threadIdx.x / HD;
  float acc = 0.f;
#pragma unroll 8
  for (int c = part; c < n_live; c += kParts)
    acc += a.part_dq[(c * rows + row) * HD + d];
  part_s[part][d] = acc;
  __syncthreads();
  if (part == 0) {
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kParts; ++i) sum += part_s[i][d];
    narrow(static_cast<T*>(a.dq) + b * a.dq_b + h * a.dq_h + d,
           sum * a.scale);
  }
}

template <int HD, typename T>
int launch(const Args& a, int batch, cudaStream_t s) {
  const int g = a.h / a.kv;
  const int main_bytes = main_smem<HD, T>(g);
  const int stats_bytes = stats_smem<HD, T>(g);
  auto stats_fn = stats_kernel<HD, T>;
  auto main_fn = g > kHeads ? main_kernel<HD, T, true>
                            : main_kernel<HD, T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      main_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, main_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        stats_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, stats_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.n_chunks > 0) {
    // A chunk's kv heads side by side: the caches' rows (B, S, KV, hd)
    // are read, and dK and dV written, in whole spans.
    const dim3 grid(a.n_chunks * a.kv, batch);
    stats_fn<<<grid, kThreads, stats_bytes, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    main_fn<<<grid, kThreads, main_bytes, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dq_kernel<HD, T><<<batch * a.h, kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int head_dim, const Args& a, int batch, cudaStream_t s) {
  switch (head_dim) {
    case 16: return launch<16, T>(a, batch, s);
    case 32: return launch<32, T>(a, batch, s);
    case 64: return launch<64, T>(a, batch, s);
    case 128: return launch<128, T>(a, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int smem_of(int g, int head_dim) {
  switch (head_dim) {
    case 16: return std::max(main_smem<16, T>(g), stats_smem<16, T>(g));
    case 32: return std::max(main_smem<32, T>(g), stats_smem<32, T>(g));
    case 64: return std::max(main_smem<64, T>(g), stats_smem<64, T>(g));
    case 128: return std::max(main_smem<128, T>(g), stats_smem<128, T>(g));
    default: return 0;
  }
}

}  // namespace

// Positions a block takes; the wrapper sizes the scratch as
// ceil(S / chunk) chunks of (B*H) rows.
MOBY_API int moby_decode_attention_bwd_chunk() { return kChunk; }

// Dynamic shared memory of the larger of the two kernels' blocks for G
// query heads a kv head at head dim hd, in bf16 (is_bf16) or f32.
MOBY_API int moby_decode_attention_bwd_smem(int heads_per_kv, int head_dim,
                                            int is_bf16) {
  return is_bf16 ? smem_of<__nv_bfloat16>(heads_per_kv, head_dim)
                 : smem_of<float>(heads_per_kv, head_dim);
}

// q, o, dout, dq (B,H,hd) through strides {b, h}; k, v, dk, dv (B,KV,S,hd)
// through strides {b, kv, s}: st = q(2), o(2), dout(2), dq(2), k(3), v(3),
// dk(3), dv(3); the head dim contiguous; k, v, dk and dv 16-byte aligned
// (bases and strides). pos (B,) int32 on the card. Scratch f32: part_m,
// part_l (n_chunks, B*H), part_dq (n_chunks, B*H, hd), n_chunks =
// ceil(S / moby_decode_attention_bwd_chunk()).
MOBY_API int moby_decode_attention_bwd(
    const void* q, const void* k, const void* v, const void* pos,
    const void* o, const void* dout, void* dq, void* dk, void* dv,
    void* part_m, void* part_l, void* part_dq, const long long* st,
    int batch, int n_heads, int n_kv_heads, int s_len, int head_dim,
    int is_bf16, float scale, void* stream) {
  if (batch * n_heads == 0) return 0;
  const Args a{q, k, v, o, dout, static_cast<const int*>(pos), dq, dk, dv,
               static_cast<float*>(part_m), static_cast<float*>(part_l),
               static_cast<float*>(part_dq),
               st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
               st[8], st[9], st[10], st[11], st[12], st[13], st[14], st[15],
               st[16], st[17], st[18], st[19],
               n_heads, n_kv_heads, s_len, (s_len + kChunk - 1) / kChunk,
               scale};
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(head_dim, a, batch, s)
                 : dispatch<float>(head_dim, a, batch, s);
}
