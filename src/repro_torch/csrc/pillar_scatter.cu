// Point -> pillar scatter-max (the PointPillars encoder's max-pool) and its
// gradient.
//
// Replaces the TPU kernel repro/kernels/pillar_scatter/pillar_scatter.py
// (pillar_scatter_pallas) and the VJP of repro/ops/api.py:96-112, whose
// gradient splits a pillar's cotangent equally among the points that tie
// for its maximum (each takes ct * (1 / count)).
//
// What bounds it on an H100: bytes. At KITTI size (N = 122,880 points,
// 108,010 of them kept in 9,072 of G = 16,384 pillars, C = 32 channels) the
// forward reads 13.8 MB of the kept points' features and 0.6 MB of ids and
// mask and writes a 2.1 MB grid (~4.9 us at 3.35 TB/s); the backward reads
// the kept features, the ids and mask and the occupied pillars' rows of the
// grid and its cotangent, and writes 15.7 MB of gradient (~9.7 us). The
// work is one compare a value.
//
// The TPU has no atomics, so its kernel turns the loop inside out: every
// pillar tile streams every point. Hopper has them, so each point is
// visited once, and a max is exact and order-free: atomicMax on keys that
// order like the floats gives the plain version's result value for value,
// whatever the order of the atomics.
//
// Forward design. Three passes: clearing the grid, the scatter (most of
// the time: it reads the kept rows; on the card, points sorted by pillar,
// with 9x fewer atomics, scatter only ~10% faster), and decoding the keys:
//   * keys are unsigned and never 0: f >= 0 maps to bits | 0x80000000,
//     f < 0 to ~bits (so -0 sorts just below +0), NaN to the positive NaN
//     first (it sorts above +inf, and the pillar reads 0). Zero means
//     empty, so one cudaMemsetAsync on the stream clears the grid, in
//     place of a fill kernel writing the key of -inf;
//   * a warp takes 8 points (scatter_max_kernel): their ids in one load,
//     their rows all in flight before the first is used, runs of
//     consecutive points in one pillar folded in registers, one atomicMax
//     (no return value) a run and channel; a warp a batch, so every batch's
//     loads are in flight at once;
//   * the decode pass reads the keys as 16-byte vectors and writes only
//     the occupied cells back; an empty cell keeps the memset's +0.0, as
//     the plain version writes it; non-finite maxima read 0.
// Rows are read 4 bytes a lane, so any C and any 4-byte aligned base take
// the same path.
//
// Backward design. Two passes after a cudaMemsetAsync of the tie counts
// (zero is the empty count), so each kept row and its pillar's output row
// are read once:
//   * tie_mask_kernel takes 4 points a warp, as the forward takes 8: their
//     ids in one load, then for each 32-channel word every row and output
//     row of the batch in flight before the first compare. A kept point
//     ties where it equals the output: an atomicAdd counts the tie of its
//     (pillar, channel), an atomicOr of kPoison marks a channel whose raw
//     maximum was +inf or NaN (it reads 0 and passes no gradient), and the
//     warp's __ballot_sync of the ties is the point's mask word, one for
//     each 32 channels (0 for a dropped point);
//   * tie_grad_kernel writes every point's gradient from the mask words:
//     a clear bit is 0, with no read of the features, the output, the
//     counts or the cotangent; a set bit reads its cell's count and
//     cotangent and writes ct * (1.0f / count), or 0 if poisoned, with
//     IEEE division and no FMA (-fmad=false), as the plain version
//     (repro_torch/kernels/pillar_scatter/ref.py) computes it. A thread
//     takes 4 values of a row (one float4 store, one 16-byte load each of
//     the 4 cells' counts and cotangents) where C % 4 == 0, else one.
// Ties are many: the detector's features are ReLU'd, so a pillar channel
// whose maximum is 0 ties every point of the pillar. At Det B's frame 45%
// of the gradient's values tie (1.78 M of 3.93 M; chip_smoke), so pass 1
// sends that many atomicAdds and pass 2 gathers most quads' cells.
#include <cstdint>

#include "moby_kernels.cuh"

namespace {

constexpr int kLanes = 32;
// Points a warp takes at a time. 8 keeps a warp's registers low enough for
// 7 resident blocks an SM; on the card 32-point (84 registers) and
// 16-point batches read the rows slower, 2-point ones too.
constexpr int kBatch = 8;
// Points a warp of the backward's first pass takes: it loads each point's
// row and its pillar's output row, so 4 points hold as many loads in
// flight as the forward's 8 (32 registers; 8 points took 64 and ran ~2%
// slower on the card).
constexpr int kMaskBatch = 4;
constexpr unsigned kFull = 0xffffffffu;
// Set in a tie count whose pillar's raw maximum was +inf or NaN; the tie
// counts stay below it (the wrapper bounds N).
constexpr int kPoison = 1 << 30;

__device__ __forceinline__ unsigned float_key(float f) {
  const unsigned u = isnan(f) ? 0x7fc00000u : __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k ^ 0x80000000u) : ~k);
}

__device__ __forceinline__ bool kept(const int* idx, const bool* valid,
                                     long long p, int g, int* id) {
  *id = idx[p];
  return valid[p] && *id >= 0 && *id < g;
}

// One warp takes kBatch consecutive points at a time. Lane i < kBatch
// reads point i's id and mask; the rows are then read lanes over channels
// (a 128-byte coalesced load a row at C = 32), all of them issued before
// any is used. A run of consecutive points in one pillar is folded into
// its first point by a max in registers, and the first point of each run
// sends one atomicMax a channel: 32 consecutive words of a row, 4 sectors,
// no return value awaited.
__global__ void __launch_bounds__(kMobyThreads)
scatter_max_kernel(const float* __restrict__ feats,
                   const int* __restrict__ idx,
                   const bool* __restrict__ valid, long long n, int c, int g,
                   unsigned* __restrict__ keys) {
  const int lane = threadIdx.x % kLanes;
  const long long warps =
      static_cast<long long>(gridDim.x) * blockDim.x / kLanes;
  for (long long p0 = (blockIdx.x * static_cast<long long>(blockDim.x) +
                       threadIdx.x) / kLanes * kBatch;
       p0 < n; p0 += warps * kBatch) {
    int id = -1, at;
    if (lane < kBatch && p0 + lane < n && kept(idx, valid, p0 + lane, g, &at))
      id = at;
    int pid[kBatch];   // the batch's pillar ids, -1 for a dropped point
#pragma unroll
    for (int r = 0; r < kBatch; ++r) pid[r] = __shfl_sync(kFull, id, r);
    for (int ch = lane; ch - lane < c; ch += kLanes) {
      const bool in_row = ch < c;
      unsigned key[kBatch];
#pragma unroll
      for (int r = 0; r < kBatch; ++r)
        key[r] = pid[r] >= 0 && in_row
            ? float_key(feats[(p0 + r) * c + ch]) : 0u;
#pragma unroll
      for (int r = kBatch - 1; r > 0; --r)
        if (pid[r] >= 0 && pid[r] == pid[r - 1])
          key[r - 1] = max(key[r - 1], key[r]);
#pragma unroll
      for (int r = 0; r < kBatch; ++r)
        if (pid[r] >= 0 && (r == 0 || pid[r] != pid[r - 1]) && in_row)
          atomicMax(keys + static_cast<long long>(pid[r]) * c + ch, key[r]);
    }
  }
}

// Decodes the keys in place (non-finite to 0), 4 channels a thread where
// rows are whole 16-byte vectors. An empty cell (key 0) keeps the memset's
// +0.0 and is not written.
__global__ void decode_kernel(float* __restrict__ grid, long long cells,
                              int vec) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (vec) {
    uint4* grid4 = reinterpret_cast<uint4*>(grid);
    for (long long i = first; i < cells / 4; i += stride) {
      const uint4 k = grid4[i];
      if (!(k.x | k.y | k.z | k.w)) continue;
      float4 f;
      f.x = key_float(k.x);
      f.y = key_float(k.y);
      f.z = key_float(k.z);
      f.w = key_float(k.w);
      f.x = isfinite(f.x) ? f.x : 0.0f;
      f.y = isfinite(f.y) ? f.y : 0.0f;
      f.z = isfinite(f.z) ? f.z : 0.0f;
      f.w = isfinite(f.w) ? f.w : 0.0f;
      reinterpret_cast<float4*>(grid)[i] = f;
    }
    return;
  }
  for (long long i = first; i < cells; i += stride) {
    const unsigned k = __float_as_uint(grid[i]);
    if (!k) continue;
    const float x = key_float(k);
    grid[i] = isfinite(x) ? x : 0.0f;
  }
}

// Pass 1 of the backward: one warp a batch of kMaskBatch points, as in
// scatter_max_kernel. For each 32-channel word, every kept row of the
// batch and its pillar's output row are loaded before any is compared;
// then each point's ties are counted and poisons marked with atomics (no
// return value awaited), and lane r keeps the ballot of point r's ties,
// its mask word, written as one coalesced store for the batch.
__global__ void __launch_bounds__(kMobyThreads)
tie_mask_kernel(const float* __restrict__ feats, const int* __restrict__ idx,
                const bool* __restrict__ valid,
                const float* __restrict__ out, long long n, int c, int g,
                int words, int* __restrict__ count,
                unsigned* __restrict__ masks) {
  const int lane = threadIdx.x % kLanes;
  const long long p0 = (blockIdx.x * static_cast<long long>(blockDim.x) +
                        threadIdx.x) / kLanes * kMaskBatch;
  if (p0 >= n) return;
  int id = -1, at;
  if (lane < kMaskBatch && p0 + lane < n &&
      kept(idx, valid, p0 + lane, g, &at))
    id = at;
  int pid[kMaskBatch];   // the batch's pillar ids, -1 for a dropped point
#pragma unroll
  for (int r = 0; r < kMaskBatch; ++r) pid[r] = __shfl_sync(kFull, id, r);
  for (int w = 0; w < words; ++w) {
    const int ch = w * kLanes + lane;
    const bool in_row = ch < c;
    float f[kMaskBatch], o[kMaskBatch];
#pragma unroll
    for (int r = 0; r < kMaskBatch; ++r) {
      const bool live = pid[r] >= 0 && in_row;
      f[r] = live ? feats[(p0 + r) * c + ch] : 0.0f;
      o[r] = live ? out[static_cast<long long>(pid[r]) * c + ch] : 0.0f;
    }
    unsigned mine = 0;
#pragma unroll
    for (int r = 0; r < kMaskBatch; ++r) {
      const bool live = pid[r] >= 0 && in_row;
      const bool tie = live && f[r] == o[r];
      int* cell = count + static_cast<long long>(live ? pid[r] : 0) * c + ch;
      if (tie) atomicAdd(cell, 1);
      if (live && (isnan(f[r]) || f[r] == INFINITY)) atomicOr(cell, kPoison);
      const unsigned m = __ballot_sync(kFull, tie);
      if (lane == r) mine = m;
    }
    if (lane < kMaskBatch && p0 + lane < n)
      masks[(p0 + lane) * words + w] = mine;
  }
}

// A tied value's share of its cell's cotangent, from the cell's tie count
// k (0 in a poisoned cell).
__device__ __forceinline__ float tie_share(int k, float ct) {
  return (k & kPoison) ? 0.0f : ct * (1.0f / static_cast<float>(k));
}

// Pass 2: a thread for each 4 values of the gradient where C % 4 == 0 and
// the cotangent is 16-byte aligned (4 channels of one row, one mask word,
// one float4 store; a set bit's cell and its 3 neighbours come in one
// 16-byte load of the counts and one of the cotangent), else a thread a
// value. The mask word and the point's id are loaded together; the cells
// only where a bit is set (a dropped point's id is never used).
__global__ void __launch_bounds__(kMobyThreads)
tie_grad_kernel(const int* __restrict__ idx,
                const unsigned* __restrict__ masks,
                const float* __restrict__ ct, const int* __restrict__ count,
                int total, int c, int words, int vec,
                float* __restrict__ grad) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (vec) {
    if (t >= total / 4) return;
    const int e = 4 * t, p = e / c, ch = e - p * c;
    const unsigned word = masks[p * words + ch / kLanes];
    const int id = idx[p];
    const unsigned bits = (word >> (ch % kLanes)) & 0xfu;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (bits) {
      const long long cell = static_cast<long long>(id) * c + ch;
      const int4 k = *reinterpret_cast<const int4*>(count + cell);
      const float4 w = *reinterpret_cast<const float4*>(ct + cell);
      if (bits & 1u) v.x = tie_share(k.x, w.x);
      if (bits & 2u) v.y = tie_share(k.y, w.y);
      if (bits & 4u) v.z = tie_share(k.z, w.z);
      if (bits & 8u) v.w = tie_share(k.w, w.w);
    }
    reinterpret_cast<float4*>(grad)[t] = v;
    return;
  }
  if (t >= total) return;
  const int p = t / c, ch = t - p * c;
  const unsigned word = masks[p * words + ch / kLanes];
  const int id = idx[p];
  float v = 0.0f;
  if ((word >> (ch % kLanes)) & 1u) {
    const long long cell = static_cast<long long>(id) * c + ch;
    v = tie_share(count[cell], ct[cell]);
  }
  grad[t] = v;
}

unsigned grid_blocks(long long work_items) {
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (work_items + kMobyThreads - 1) / kMobyThreads;
  const long long cap = static_cast<long long>(sms) * kMobyBlocksPerSm;
  if (blocks > cap) blocks = cap;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

}  // namespace

// feats (N,C) f32, idx (N,) i32, valid (N,) bool -> out (G,C) f32, used as
// the unsigned key grid (zero: empty) until the last pass decodes it.
MOBY_API int moby_pillar_scatter(const void* feats, const void* idx,
                                 const void* valid, long long n, int c,
                                 int g, void* out, void* stream) {
  const long long cells = static_cast<long long>(g) * c;
  if (cells == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, cells * sizeof(float), s);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  // A warp a batch: every batch's loads in flight at once.
  const long long warps = (n + kBatch - 1) / kBatch;
  scatter_max_kernel<<<static_cast<unsigned>(
                           (warps * kLanes + kMobyThreads - 1) / kMobyThreads),
                       kMobyThreads, 0, s>>>(
      static_cast<const float*>(feats), static_cast<const int*>(idx),
      static_cast<const bool*>(valid), n, c, g,
      static_cast<unsigned*>(out));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = c % 4 == 0;   // out is the wrapper's, 16-byte aligned
  decode_kernel<<<grid_blocks(vec ? cells / 4 : cells), kMobyThreads, 0,
                  s>>>(static_cast<float*>(out), cells, vec);
  return static_cast<int>(cudaGetLastError());
}

// feats (N,C), idx (N,), valid (N,), out (G,C) and its cotangent ct (G,C)
// -> grad (N,C); count (G,C) i32 and masks (N, ceil(C/32)) i32 are
// scratch.
MOBY_API int moby_pillar_scatter_bwd(const void* feats, const void* idx,
                                     const void* valid, const void* out,
                                     const void* ct, long long n, int c,
                                     int g, void* count, void* masks,
                                     void* grad, void* stream) {
  if (n == 0 || c == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = static_cast<long long>(g) * c;
  const int words = (c + kLanes - 1) / kLanes;
  if (cells > 0) {
    const cudaError_t err = cudaMemsetAsync(count, 0, cells * sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // Pass 1: a warp a batch.
  const long long warps = (n + kMaskBatch - 1) / kMaskBatch;
  const unsigned blocks = static_cast<unsigned>(
      (warps * kLanes + kMobyThreads - 1) / kMobyThreads);
  tie_mask_kernel<<<blocks, kMobyThreads, 0, s>>>(
      static_cast<const float*>(feats), static_cast<const int*>(idx),
      static_cast<const bool*>(valid), static_cast<const float*>(out), n, c,
      g, words, static_cast<int*>(count), static_cast<unsigned*>(masks));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // count is the wrapper's (16-byte aligned); ct comes from autograd.
  const int total = static_cast<int>(n * c);
  const int vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(ct) % 16 == 0;
  tie_grad_kernel<<<static_cast<unsigned>(
                        (static_cast<long long>(vec ? total / 4 : total) +
                         kMobyThreads - 1) / kMobyThreads),
                    kMobyThreads, 0, s>>>(
      static_cast<const int*>(idx), static_cast<const unsigned*>(masks),
      static_cast<const float*>(ct), static_cast<const int*>(count), total,
      c, words, vec, static_cast<float*>(grad));
  return static_cast<int>(cudaGetLastError());
}
