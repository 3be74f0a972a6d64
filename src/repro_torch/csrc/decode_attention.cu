// Single-token decode attention over a KV cache (the serving step).
//
// Replaces the TPU kernel
// repro/kernels/decode_attention/decode_attention.py
// (decode_attention_pallas).
//
// What bounds it on an H100: bytes. Each request's G = H/KV query heads
// read the first cache_pos positions of their kv head's K and V once:
// at the serving shape (B=16, H=16, KV=2, hd=128, bf16, cache_pos ~20k on
// average) ~335 MB a call, 0.10 ms at 3.35 TB/s, against ~0.08 GFLOP. So
// the design is about keeping enough bytes in flight: by Little's law,
// 3.35 TB/s over 132 SMs at ~1 us of latency needs ~25 KB in flight per SM.
//
// Design (flash-decoding): B*KV (b, kv-head) pairs alone would fill 32 of
// the 132 SMs, so the cache's S axis is also split, into chunks of 512
// positions: one block of 256 threads per (chunk, b, kv head, group of up
// to 8 of its query heads); a block whose chunk starts at or past the
// request's cache_pos (read on the device, no host sync) returns at once.
// At the serving shape that is 1,280 live blocks, ~3 waves at 3 blocks an
// SM.
// * K and V stay in the input type in shared memory (bf16: half the bytes
//   of f32 tiles) and arrive by 16-byte `cp.async.cg` copies (8 bf16 a
//   thread; a thread copies the same piece of two rows of K and of V a
//   tile, with 32-bit offsets: no per-element index arithmetic) into a
//   ring of 3 stages of 32 positions: two tiles (32 KB in bf16) are in
//   flight while one is computed. Positions past the chunk's live end are
//   zero-filled by the copy itself.
// * K rows are padded by 16 bytes, so the 16-byte reads of eight lanes
//   (one row each) fall in eight distinct bank groups.
// * At hd 128 in bf16 a block takes 64 KB of shared memory (the ring
//   50 KB; q, the partial scores, p and the softmax state 14 KB): 3 blocks
//   an SM, 96 KB of loads in flight on each SM.
// * The arithmetic is f32 on the SIMT cores, and each K and V value is
//   widened to f32 once for all 8 heads of the block, not once a head:
//   scores: lane j takes position j of the tile and warp w a slice of 16
//   head dims, for every head (q read as broadcast float4), and the 8
//   warps' partial dot products meet in shared memory; softmax: warp g
//   takes head g (max and sum by warp shuffles; the running max and sum
//   in shared memory); P.V: warp w takes 4 heads over 8 positions and
//   each lane 4 contiguous head dims. Three __syncthreads a tile.
// With the loads in flight, what is left to bound it is its f32 SIMT
// instructions (a widen and an fma a value and head) more than the bytes.
// The block writes its unnormalised partial (m, l, acc) to scratch the
// wrapper allocates; a second small kernel combines the live chunks of
// each (b, head) row and divides by max(l, 1e-30). Scores past cache_pos
// (and past S) are the Pallas kernel's finite -1e30 and add p = 0, so a
// request with cache_pos = 0 gives 0, as the Pallas kernel does. Operands
// come through element strides (the head dim contiguous): the caller
// passes (B, KV, S, hd) views of its (B, S, KV, hd) cache, and nothing is
// copied or padded; the caches' base addresses and strides must be
// 16-byte aligned, and S * stride below 2^31 (the wrapper checks). Inputs
// f32 or bf16 are widened to f32; the output is cast back to the input
// type.
//
// G = 1 in bf16 (whisper-small's self and cross caches at hd 64,
// moonshot's at hd 128; hd 16 and 32 too) takes a layout of its own,
// chosen by the wrapper from the shapes before the launch (`ops.layout`);
// every other instance (f32, G > 1) the one above.
// At G = 1 the one above fills one of a block's 8 head slots and still
// does the SIMT work of 8 heads, through three block barriers a tile.
// decode_g1_kernel instead:
// * no empty head slot: a block of 4 warps takes a work unit (positions
//   of one (b, head) row), its 32-position tiles dealt to the warps in
//   turn. For the scores lane j takes position j, the query row in
//   registers and its K row by 16-byte reads (rows padded by 16 bytes);
//   for P.V kLv = hd / 8 lanes span a V row, 8 head dims each, and take
//   p by shuffle, so each K and V value is widened and used once;
// * no block barrier in the tile loop: each warp streams its own tiles
//   through its own 3-stage cp.async ring (2 tiles in flight) and keeps
//   its own online softmax (max by shuffles, each lane its share of the
//   sum); the warps merge (m, l, acc) once, in shared memory, at the end;
// * S split by the grid, not by 512: the wrapper's plan (`ops.g1_plan`,
//   from S and B*H alone) gives a row as many units as fill the card's
//   blocks once (at hd 64 two 102 KB blocks an SM, 128 KB of loads in
//   flight), at most 4,096 positions a unit; a row of one unit (whisper:
//   192 rows, 264 blocks) is written by the kernel itself, otherwise the
//   combine below merges the units.
//
// On an NVIDIA H100 80GB HBM3 at 700.00 W the G = 1 layout is within 2-4%
// of its copies alone at whisper's cross caches and moonshot's
// (tools/decode_g1_probe.py).
//
// ptxas (-Xptxas -v, sm_90a): the bf16 partial kernel 71-80 registers a
// thread (at most 80 for 3 blocks an SM), the f32 one 75-131, the combine
// 32, decode_g1_kernel 64 / 96 / 127 / 168 at hd 16 / 32 / 64 / 128; no
// spills. chip_smoke.py prints the build log.
#include <cuda_bf16.h>
#include <stdint.h>

#include "moby_kernels.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kChunk = 512;    // cache positions per block
constexpr int kTile = 32;      // positions per stage: one a lane
constexpr int kStages = 3;     // ring depth: kStages - 1 tiles in flight
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

// 16 bytes global -> shared, asynchronously; zero-filled when !ok.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 32-bit words of T values -> f32 (a bf16 is the high half of an f32).
template <typename T>
__device__ __forceinline__ void unpack(uint32_t w, float* out) {
  if constexpr (sizeof(T) == 4) {
    out[0] = __uint_as_float(w);
  } else {
    out[0] = __uint_as_float(w << 16);
    out[1] = __uint_as_float(w & 0xffff0000u);
  }
}

// N consecutive T values from shared memory, in one load, widened to f32.
template <typename T, int N>
__device__ __forceinline__ void load_widen(const uint8_t* p,
                                           float (&out)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  constexpr int kPer = 4 / static_cast<int>(sizeof(T));   // values a word
  if constexpr (kBytes == 16) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    unpack<T>(w.x, out);
    unpack<T>(w.y, out + kPer);
    unpack<T>(w.z, out + 2 * kPer);
    unpack<T>(w.w, out + 3 * kPer);
  } else if constexpr (kBytes == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    unpack<T>(w.x, out);
    unpack<T>(w.y, out + kPer);
  } else if constexpr (kBytes == 4) {
    unpack<T>(*reinterpret_cast<const uint32_t*>(p), out);
  } else {
    static_assert(kBytes == 2, "one bf16");
    out[0] = __uint_as_float(
        static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(p)) << 16);
  }
}

struct Args {
  long long q_b, q_h;            // q (B, H, hd)
  long long k_b, k_h, k_s;       // cache_k (B, KV, S, hd)
  long long v_b, v_h, v_s;       // cache_v (B, KV, S, hd)
  int n_heads, n_kv_heads, s_len, n_chunks;
  float scale;
  int chunk;                     // positions a partial covers
};

// Heads a block serves: one kv head's query heads, at most kHeads of them
// (a group of G > kHeads heads takes ceil(G / kHeads) blocks).
constexpr int kHeads = 8;

// Shared memory of a partial block: a ring of kStages tiles, each K
// [kTile][row + 16 bytes] then V [kTile][row], in the input type; then f32
// q [kHeads][HD], the scores' partial sums [kWarps][kHeads][kTile], p
// [kHeads][kTile], and the rescale factors, running maxima and sums
// [kHeads] each. After the last tile the ring holds the position groups'
// partial accumulators [kWarps / 2][kHeads][HD].
template <int HD, typename T>
struct Ring {
  static constexpr int kRow = HD * static_cast<int>(sizeof(T));   // bytes
  static constexpr int kKRow = kRow + 16;
  static constexpr int kPieces = kRow / 16;        // 16-byte copies a row
  static constexpr int kStage = kTile * (kKRow + kRow);
  static constexpr int kBytes = kStages * kStage;
  static constexpr int kFloats = kHeads * HD + kWarps * kHeads * kTile +
                                 kHeads * kTile + 3 * kHeads;
  static constexpr int kSmem = kBytes + kFloats * 4;
  static_assert(kWarps / 2 * kHeads * HD * 4 <= kBytes, "accumulators fit");
};

// bf16: 3 blocks an SM (shared memory allows 3); f32 tiles take twice the
// ring, so 1 block an SM, and its registers are not capped.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads, sizeof(T) == 2 ? 3 : 1)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ pos,
                      Args a, float* __restrict__ part_m,
                      float* __restrict__ part_l,
                      float* __restrict__ part_acc) {
  using R = Ring<HD, T>;
  constexpr int kSlice = HD / kWarps;          // head dims a warp scores
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));   // values a piece
  constexpr int kLoad = kSlice < kPer ? kSlice : kPer;     // values a load
  constexpr int kDpl = HD >= 32 ? HD / 32 : 1;  // head dims a lane sums
  // P.V: warp w sums heads [w%2, w%2 + 1) * kHalf over positions
  // [w/2, w/2 + 1) * kPos.
  constexpr int kHalf = kHeads / 2;
  constexpr int kGroups = kWarps / 2;           // position groups
  constexpr int kPos = kTile / kGroups;
  static_assert(kWarps % 2 == 0 && kTile % kGroups == 0, "warp split");
  const int group = a.n_heads / a.n_kv_heads;
  const int n_grp = (group + kHeads - 1) / kHeads;
  const int chunk = blockIdx.x;
  const int grp = blockIdx.y % n_grp;
  const int bk = blockIdx.y / n_grp;
  const int b = bk / a.n_kv_heads, kvh = bk % a.n_kv_heads;
  const int limit = min(pos[b], a.s_len);
  const int start = chunk * kChunk;
  if (start >= limit) return;   // the combine reads only live chunks
  const int end = min(start + kChunk, limit);
  const int h0 = kvh * group + grp * kHeads;    // first head of the block
  const int hg = min(kHeads, group - grp * kHeads);

  extern __shared__ float4 smem4[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(smem4);
  float* q_s = reinterpret_cast<float*>(ring + R::kBytes);   // [kHeads][HD]
  float* red_s = q_s + kHeads * HD;          // [kWarps][kHeads][kTile]
  float* p_s = red_s + kWarps * kHeads * kTile;               // [kHeads][kTile]
  float* corr_s = p_s + kHeads * kTile;                       // [kHeads]
  // Head g's running max and sum, kept by warp g's lane 0.
  float* m_s = corr_s + kHeads;                               // [kHeads]
  float* l_s = m_s + kHeads;                                  // [kHeads]
  if (threadIdx.x < kHeads) {
    m_s[threadIdx.x] = kNeg;
    l_s[threadIdx.x] = 0.0f;
  }

  const T* qb = q + b * a.q_b + h0 * a.q_h;
  for (int e = threadIdx.x; e < kHeads * HD; e += kThreads) {
    const int g = e / HD, d = e % HD;
    q_s[e] = g < hg ? widen(qb[g * a.q_h + d]) : 0.0f;
  }
  const T* kb = k + b * a.k_b + kvh * a.k_h;
  const T* vb = v + b * a.v_b + kvh * a.v_h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_tiles = (end - start + kTile - 1) / kTile;

  // Tile t of the chunk into its stage, in 16-byte pieces: a thread
  // copies piece pc of rows pj, pj + kRowStep, ... of K and of V (32-bit
  // offsets: the wrapper checks that S * stride fits).
  constexpr int kRowStep = kThreads / R::kPieces;
  constexpr int kRowsPer = (kTile + kRowStep - 1) / kRowStep;
  const int pc = threadIdx.x % R::kPieces, pj = threadIdx.x / R::kPieces;
  const int ks = static_cast<int>(a.k_s), vs = static_cast<int>(a.v_s);
  auto issue = [&](int t) {
    uint8_t* stage = ring + (t % kStages) * R::kStage + pc * 16;
    const int t0 = start + t * kTile;
#pragma unroll
    for (int r = 0; r < kRowsPer; ++r) {
      const int j = pj + r * kRowStep;
      if (kRowStep * kRowsPer > kTile && j >= kTile) break;
      const bool ok = t0 + j < end;
      const int sj = ok ? t0 + j : start;   // a valid address when !ok
      cp_async16(stage + j * R::kKRow, kb + sj * ks + pc * kPer, ok);
      cp_async16(stage + kTile * R::kKRow + j * R::kRow,
                 vb + sj * vs + pc * kPer, ok);
    }
  };

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) issue(t);
    cp_async_commit();
  }
  // A lane's accumulators: its warp's kHalf heads, head dims d0 .. d0 +
  // kDpl - 1 (at HD 16 lanes 16-31 repeat lane 0's and do not store).
  const int hh = warp % 2, pg = warp / 2;
  float acc[kHalf][kDpl];
#pragma unroll
  for (int g = 0; g < kHalf; ++g)
#pragma unroll
    for (int d = 0; d < kDpl; ++d) acc[g][d] = 0.0f;
  const bool owner = lane * kDpl < HD;
  const int d0 = owner ? lane * kDpl : 0;
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();   // tile t has landed (this thread's part)
    __syncthreads();                // ... every thread's; tile t-1 consumed
    if (t + kStages - 1 < n_tiles) issue(t + kStages - 1);
    cp_async_commit();
    const uint8_t* stage = ring + (t % kStages) * R::kStage;

    // Scores: lane j takes position j, warp w head dims [w, w+1) * kSlice,
    // for every head: each K value is widened once and used kHeads times.
    {
      const uint8_t* kr = stage + lane * R::kKRow + warp * kSlice * sizeof(T);
      // Two passes of kHeads / 2 heads keep the live registers down.
#pragma unroll 1
      for (int half = 0; half < 2; ++half) {
        float part[kHeads / 2];
#pragma unroll
        for (int g = 0; g < kHeads / 2; ++g) part[g] = 0.0f;
#pragma unroll
        for (int c = 0; c < kSlice / kLoad; ++c) {
          float kx[kLoad];
          load_widen<T>(kr + c * kLoad * sizeof(T), kx);
#pragma unroll
          for (int g = 0; g < kHeads / 2; ++g) {
            const float* qg = q_s + (half * (kHeads / 2) + g) * HD +
                              warp * kSlice + c * kLoad;
            if constexpr (kLoad % 4 == 0) {   // broadcast float4 reads
#pragma unroll
              for (int e = 0; e < kLoad; e += 4) {
                const float4 qq = *reinterpret_cast<const float4*>(qg + e);
                part[g] = fmaf(qq.x, kx[e], part[g]);
                part[g] = fmaf(qq.y, kx[e + 1], part[g]);
                part[g] = fmaf(qq.z, kx[e + 2], part[g]);
                part[g] = fmaf(qq.w, kx[e + 3], part[g]);
              }
            } else {
#pragma unroll
              for (int e = 0; e < kLoad; ++e)
                part[g] = fmaf(qg[e], kx[e], part[g]);
            }
          }
        }
#pragma unroll
        for (int g = 0; g < kHeads / 2; ++g)
          red_s[(warp * kHeads + half * (kHeads / 2) + g) * kTile + lane] =
              part[g];
      }
    }
    __syncthreads();

    // Softmax: warp g takes head g, lane j position j.
    if (warp < kHeads) {
      const int g = warp;
      float dot = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        dot += red_s[(w * kHeads + g) * kTile + lane];
      const bool live = g < hg && start + t * kTile + lane < end;
      const float s = live ? dot * a.scale : kNeg;
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float corr = expf(m_old - m_new);
      const float p = live ? expf(s - m_new) : 0.0f;
      const float psum = warp_sum(p);
      p_s[g * kTile + lane] = p;
      __syncwarp();   // every lane has read m_s[g]
      if (lane == 0) {
        corr_s[g] = corr;
        m_s[g] = m_new;
        l_s[g] = l_s[g] * corr + psum;
      }
    }
    __syncthreads();

    // P.V: lane its head dims; each V value is widened once and used kHalf
    // times.
#pragma unroll
    for (int g = 0; g < kHalf; ++g) {
      const float c = corr_s[hh * kHalf + g];
#pragma unroll
      for (int d = 0; d < kDpl; ++d) acc[g][d] *= c;
    }
    const uint8_t* vt = stage + kTile * R::kKRow;
#pragma unroll
    for (int jj = 0; jj < kPos; ++jj) {
      const int j = pg * kPos + jj;
      float vx[kDpl];
      load_widen<T>(vt + j * R::kRow + d0 * sizeof(T), vx);
#pragma unroll
      for (int g = 0; g < kHalf; ++g) {
        const float pj = p_s[(hh * kHalf + g) * kTile + j];
#pragma unroll
        for (int d = 0; d < kDpl; ++d) acc[g][d] = fmaf(pj, vx[d], acc[g][d]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: the warps' accumulators go there
  float* acc_s = reinterpret_cast<float*>(ring);   // [kGroups][kHeads][HD]
  if (owner) {
#pragma unroll
    for (int g = 0; g < kHalf; ++g)
#pragma unroll
      for (int d = 0; d < kDpl; ++d)
        acc_s[(pg * kHeads + hh * kHalf + g) * HD + d0 + d] = acc[g][d];
  }
  __syncthreads();
  const int bh0 = b * a.n_heads + h0;
  const long long rows = static_cast<long long>(gridDim.y / n_grp) * group;
  for (int e = threadIdx.x; e < hg * HD; e += kThreads) {
    const int g = e / HD, d = e % HD;
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < kGroups; ++w) sum += acc_s[(w * kHeads + g) * HD + d];
    part_acc[(chunk * rows + bh0 + g) * HD + d] = sum;
  }
  if (warp < hg && lane == 0) {
    part_m[chunk * rows + bh0 + warp] = m_s[warp];
    part_l[chunk * rows + bh0 + warp] = l_s[warp];
  }
}

// One block per (b, head) row: rescale the live chunks' partials to their
// common max and normalise. A row without a live chunk gives 0. Warp 0
// takes the max, the chunks' weights exp(m_c - m) (into shared memory) and
// the sum; then each thread sums its head dims over the chunks, the
// chunks' loads independent of each other.
constexpr int kCombineThreads = 128;

template <int HD, typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const int* __restrict__ pos, Args a,
                      const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const float* __restrict__ part_acc,
                      T* __restrict__ out) {
  extern __shared__ float w_s[];   // [n_chunks]
  __shared__ float denom_s;
  const int row = blockIdx.x;
  const long long rows = gridDim.x;
  const int limit = min(pos[row / a.n_heads], a.s_len);
  const int live = limit > 0 ? (limit + a.chunk - 1) / a.chunk : 0;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float m = kNeg;
    for (int c = lane; c < live; c += 32)
      m = fmaxf(m, part_m[c * rows + row]);
    m = warp_max(m);
    float l = 0.0f;
    for (int c = lane; c < live; c += 32) {
      const float w = expf(part_m[c * rows + row] - m);
      w_s[c] = w;
      l += part_l[c * rows + row] * w;
    }
    l = warp_sum(l);
    if (lane == 0) denom_s = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const float denom = denom_s;
  for (int d = threadIdx.x; d < HD; d += kCombineThreads) {
    float acc = 0.0f;
#pragma unroll 4
    for (int c = 0; c < live; ++c)
      acc += part_acc[(c * rows + row) * HD + d] * w_s[c];
    narrow(out + row * static_cast<long long>(HD) + d, acc / denom);
  }
}

// ---------------------------------------------------------------------------
// G = 1 in bf16: one query head a kv head (whisper-small, moonshot).
//
// A block of kG1Warps warps takes a work unit, `span` positions of one
// (b, head) row (the wrapper's plan: as many units a row as fill the
// card once, from S and B*H alone). Its 32-position tiles go to the warps
// in turn (warp w: tiles w, w + kG1Warps, ...). Each warp streams its own
// tiles through its own cp.async ring and runs its own online softmax:
// no block barrier in the tile loop. The warps merge their (m, l, acc)
// once, in shared memory, at the end; a unit that is its row's only one
// writes the output itself, else its partial goes to the combine.
constexpr int kG1Warps = 4;
constexpr int kG1Threads = 32 * kG1Warps;
constexpr int kG1Stages = 3;   // a warp's ring: kG1Stages - 1 tiles in flight

template <int HD>
struct G1 {
  static constexpr int kRow = 2 * HD;            // bytes of a bf16 row
  static constexpr int kKRow = kRow + 16;        // K rows padded: 8 lanes
                                                 // reading 16 bytes of 8
                                                 // rows hit 8 bank groups
  static constexpr int kPieces = kRow / 16;      // 16-byte pieces a row
  static constexpr int kCopies = kTile * kPieces / 32;   // a lane's a tile
  static constexpr int kStage = kTile * (kKRow + kRow);  // K then V
  static constexpr int kWarpBytes = kG1Stages * kStage;
  static constexpr int kSmem = kG1Warps * kWarpBytes;
  // P.V: kLv lanes over a V row, 8 head dims (16 bytes) each; kPv
  // positions a step.
  static constexpr int kLv = HD / 8;
  static constexpr int kPv = 32 / kLv;
  static_assert(HD % 16 == 0 && HD <= kG1Threads, "head dims");
  static_assert((HD + 2) * 4 <= kWarpBytes, "a warp's merge state fits");
};

template <int HD>
__global__ void __launch_bounds__(kG1Threads)
decode_g1_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ pos, Args a,
                 float* __restrict__ part_m, float* __restrict__ part_l,
                 float* __restrict__ part_acc,
                 __nv_bfloat16* __restrict__ out) {
  using L = G1<HD>;
  const int row = blockIdx.y;                  // b * H + head
  const int b = row / a.n_heads, h = row % a.n_heads;
  const int limit = min(pos[b], a.s_len);
  const bool direct = gridDim.x == 1;          // the row's only unit
  const int start = blockIdx.x * a.chunk;
  if (start >= limit && !direct) return;   // the combine reads only live units
  const int end = max(min(start + a.chunk, limit), start);
  const int n_tiles = (end - start + kTile - 1) / kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  extern __shared__ float4 smem4[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem4);
  uint8_t* ring = smem + warp * L::kWarpBytes;

  // The query row in registers, in f32, the same in every lane.
  float qf[HD];
  const __nv_bfloat16* qr = q + b * a.q_b + h * a.q_h;
#pragma unroll
  for (int d = 0; d < HD; ++d) qf[d] = __bfloat162float(qr[d]);

  // Tile t of the unit into stage `stage` of the warp's ring, in 16-byte
  // pieces (lane + 32 r: 8 lanes cover 128 contiguous bytes); rows past
  // the unit's end are zero-filled by the copy.
  const __nv_bfloat16* kb = k + b * a.k_b + h * a.k_h;
  const __nv_bfloat16* vb = v + b * a.v_b + h * a.v_h;
  const int ks = static_cast<int>(a.k_s), vs = static_cast<int>(a.v_s);
  auto issue = [&](int t, int stage) {
    uint8_t* st = ring + stage * L::kStage;
    const int t0 = start + t * kTile;
#pragma unroll
    for (int r = 0; r < L::kCopies; ++r) {
      const int i = lane + 32 * r;
      const int j = i / L::kPieces, pc = i % L::kPieces;
      const bool ok = t0 + j < end;
      const int sj = ok ? t0 + j : start;   // a valid address when !ok
      cp_async16(st + j * L::kKRow + pc * 16, kb + sj * ks + pc * 8, ok);
      cp_async16(st + kTile * L::kKRow + j * L::kRow + pc * 16,
                 vb + sj * vs + pc * 8, ok);
    }
  };

  // The warp's tiles: warp, warp + kG1Warps, ...
  const int my_n = n_tiles > warp ? (n_tiles - 1 - warp) / kG1Warps + 1 : 0;
#pragma unroll
  for (int i = 0; i < kG1Stages - 1; ++i) {
    if (i < my_n) issue(warp + i * kG1Warps, i);
    cp_async_commit();
  }
  float m = kNeg;   // the running max, the same in every lane
  float l = 0.0f;   // the lane's share of the running sum
  float acc[8];     // head dims (lane % kLv) * 8 .. + 8, the lane's positions
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
  for (int i = 0; i < my_n; ++i) {
    cp_async_wait<kG1Stages - 2>();   // this lane's copies of tile i landed
    __syncwarp();   // every lane's; the stage of tile i - 1 is free
    if (i + kG1Stages - 1 < my_n)
      issue(warp + (i + kG1Stages - 1) * kG1Warps,
            (i + kG1Stages - 1) % kG1Stages);
    cp_async_commit();
    const uint8_t* st = ring + (i % kG1Stages) * L::kStage;
    const int t0 = start + (warp + i * kG1Warps) * kTile;

    // Scores: lane j takes position t0 + j, its K row by 16-byte reads,
    // over four chains of products.
    float dot4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    const uint8_t* kr = st + lane * L::kKRow;
#pragma unroll
    for (int c = 0; c < L::kPieces; ++c) {
      float kx[8];
      load_widen<__nv_bfloat16>(kr + c * 16, kx);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dot4[e % 4] = __fmaf_rn(qf[c * 8 + e], kx[e], dot4[e % 4]);
    }
    const float dot = (dot4[0] + dot4[1]) + (dot4[2] + dot4[3]);
    const bool live = t0 + lane < end;
    const float s = live ? dot * a.scale : kNeg;

    // The warp's online softmax: max by shuffles; each lane keeps its
    // own share of the sum (the factor is the same in every lane).
    const float m_new = fmaxf(m, warp_max(s));
    const float corr = expf(m - m_new);
    const float p = live ? expf(s - m_new) : 0.0f;
    l = l * corr + p;
    m = m_new;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] *= corr;

    // P.V: kLv lanes a row, kPv positions a step, p by shuffle.
    const uint8_t* vt = st + kTile * L::kKRow + (lane % L::kLv) * 16;
#pragma unroll
    for (int step = 0; step < L::kLv; ++step) {
      const int j = step * L::kPv + lane / L::kLv;
      const float pj = __shfl_sync(0xffffffffu, p, j);
      float vx[8];
      load_widen<__nv_bfloat16>(vt + j * L::kRow, vx);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = __fmaf_rn(pj, vx[e], acc[e]);
    }
  }
  cp_async_wait<0>();
  // The lanes of a head-dim slice sum their positions; the lanes' sums.
#pragma unroll
  for (int o = L::kLv; o < 32; o <<= 1)
#pragma unroll
    for (int e = 0; e < 8; ++e)
      acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], o);
  l = warp_sum(l);
  __syncwarp();   // the warp's ring is read: its state goes there
  float* mine = reinterpret_cast<float*>(ring);   // acc [HD], m, l
  if (lane < L::kLv) {
    *reinterpret_cast<float4*>(mine + lane * 8) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
    *reinterpret_cast<float4*>(mine + lane * 8 + 4) =
        make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
  if (lane == 0) {
    mine[HD] = m;
    mine[HD + 1] = l;
  }
  __syncthreads();

  // The warps' merge: thread d takes head dim d.
  if (threadIdx.x < HD) {
    const int d = threadIdx.x;
    float mw[kG1Warps];
    float mx = kNeg;
#pragma unroll
    for (int w = 0; w < kG1Warps; ++w) {
      mw[w] = reinterpret_cast<const float*>(smem + w * L::kWarpBytes)[HD];
      mx = fmaxf(mx, mw[w]);
    }
    float sum = 0.0f, lsum = 0.0f;
#pragma unroll
    for (int w = 0; w < kG1Warps; ++w) {
      const float* st = reinterpret_cast<const float*>(smem +
                                                       w * L::kWarpBytes);
      const float wt = expf(mw[w] - mx);
      sum += st[d] * wt;
      lsum += st[HD + 1] * wt;
    }
    if (direct) {
      narrow(out + row * static_cast<long long>(HD) + d,
             sum / fmaxf(lsum, 1e-30f));
    } else {
      const long long at = static_cast<long long>(blockIdx.x) * gridDim.y +
                           row;
      part_acc[at * HD + d] = sum;
      if (d == 0) {
        part_m[at] = mx;
        part_l[at] = lsum;
      }
    }
  }
}

template <int HD>
int launch_g1(const void* q, const void* k, const void* v, const void* pos,
              void* out, float* part_m, float* part_l, float* part_acc,
              int batch, const Args& a, cudaStream_t stream) {
  auto kernel = decode_g1_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G1<HD>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.n_chunks, batch * a.n_heads);
  kernel<<<grid, kG1Threads, G1<HD>::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(pos), a,
      part_m, part_l, part_acc, static_cast<__nv_bfloat16*>(out));
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_chunks == 1) return static_cast<int>(err);
  decode_combine_kernel<HD, __nv_bfloat16>
      <<<batch * a.n_heads, kCombineThreads, a.n_chunks * sizeof(float),
         stream>>>(static_cast<const int*>(pos), a, part_m, part_l, part_acc,
                   static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* out, float* part_m, float* part_l, float* part_acc,
           int batch, const Args& a, cudaStream_t stream) {
  const int group = a.n_heads / a.n_kv_heads;
  const int smem = Ring<HD, T>::kSmem;
  auto partial = decode_partial_kernel<HD, T>;
  if (a.n_chunks > 0) {   // an empty cache has no partials
    cudaError_t err = cudaFuncSetAttribute(
        partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(a.n_chunks,
                    batch * a.n_kv_heads * ((group + kHeads - 1) / kHeads));
    partial<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(pos), a, part_m,
        part_l, part_acc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_combine_kernel<HD, T><<<batch * a.n_heads, kCombineThreads,
                                 a.n_chunks * sizeof(float), stream>>>(
      static_cast<const int*>(pos), a, part_m, part_l, part_acc,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int head_dim, const void* q, const void* k, const void* v,
             const void* pos, void* out, float* pm, float* pl, float* pa,
             int batch, const Args& a, cudaStream_t s) {
  switch (head_dim) {
    case 16: return launch<16, T>(q, k, v, pos, out, pm, pl, pa, batch, a, s);
    case 32: return launch<32, T>(q, k, v, pos, out, pm, pl, pa, batch, a, s);
    case 64: return launch<64, T>(q, k, v, pos, out, pm, pl, pa, batch, a, s);
    case 128: return launch<128, T>(q, k, v, pos, out, pm, pl, pa, batch, a,
                                    s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Positions per chunk of the split S axis: the wrapper sizes the scratch
// as ceil(S / chunk) chunks of (B*H) rows.
MOBY_API int moby_decode_attention_chunk() { return kChunk; }

// q (B,H,hd) through strides st[0..1] = {b, h}; cache_k/v (B,KV,S,hd)
// through st[2..4] and st[5..7] = {b, kv, s}; the head dim contiguous.
// pos (B,) int32 positions attended per request ([0, pos)). out (B,H,hd)
// contiguous, of the inputs' type (bf16 if is_bf16, else f32). Scratch:
// part_m, part_l (n_chunks, B*H) and part_acc (n_chunks, B*H, hd) f32,
// n_chunks = ceil(S / moby_decode_attention_chunk()).
MOBY_API int moby_decode_attention(const void* q, const void* k,
                                   const void* v, const void* pos, void* out,
                                   void* part_m, void* part_l, void* part_acc,
                                   const long long* st, int batch,
                                   int n_heads, int n_kv_heads, int s_len,
                                   int head_dim, int is_bf16, float scale,
                                   void* stream) {
  if (batch * n_heads == 0) return 0;
  const Args a{st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
               n_heads, n_kv_heads, s_len, (s_len + kChunk - 1) / kChunk,
               scale, kChunk};
  const auto s = static_cast<cudaStream_t>(stream);
  auto* pm = static_cast<float*>(part_m);
  auto* pl = static_cast<float*>(part_l);
  auto* pa = static_cast<float*>(part_acc);
  return is_bf16 ? dispatch<__nv_bfloat16>(head_dim, q, k, v, pos, out, pm,
                                           pl, pa, batch, a, s)
                 : dispatch<float>(head_dim, q, k, v, pos, out, pm, pl, pa,
                                   batch, a, s);
}

// G = 1 in bf16 (decode_g1_kernel): q (B,H,hd) through st[0..1], the
// caches (B,H,S,hd) through st[2..4] and st[5..7], as above. The wrapper's
// plan gives `span` positions a work unit and n_units = ceil(S / span)
// units a row (at least 1). With one unit the kernel writes out itself;
// else part_m, part_l (n_units, B*H) and part_acc (n_units, B*H, hd) f32
// take the units' partials and the combine writes out.
MOBY_API int moby_decode_attention_g1(const void* q, const void* k,
                                      const void* v, const void* pos,
                                      void* out, void* part_m, void* part_l,
                                      void* part_acc, const long long* st,
                                      int batch, int n_heads, int s_len,
                                      int head_dim, int span, int n_units,
                                      float scale, void* stream) {
  if (batch * n_heads == 0) return 0;
  const Args a{st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
               n_heads, n_heads, s_len, n_units, scale, span};
  const auto s = static_cast<cudaStream_t>(stream);
  auto* pm = static_cast<float*>(part_m);
  auto* pl = static_cast<float*>(part_l);
  auto* pa = static_cast<float*>(part_acc);
  switch (head_dim) {
    case 16: return launch_g1<16>(q, k, v, pos, out, pm, pl, pa, batch, a, s);
    case 32: return launch_g1<32>(q, k, v, pos, out, pm, pl, pa, batch, a, s);
    case 64: return launch_g1<64>(q, k, v, pos, out, pm, pl, pa, batch, a, s);
    case 128: return launch_g1<128>(q, k, v, pos, out, pm, pl, pa, batch, a,
                                    s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
