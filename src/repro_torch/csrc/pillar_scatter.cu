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
// Design. The TPU has no atomics, so its kernel turns the loop inside out:
// every pillar tile streams every point. Hopper has them, so each point is
// visited once:
//   * one warp per point, the lanes over the channels (a 128-byte coalesced
//     row at C = 32; lanes loop for wider C), the id and mask read once;
//   * the grid is kept as order-preserving int32 keys of the floats
//     (non-negative floats keep their bits, negative ones flip the 31 low
//     bits, so int order is float order and -0 sorts just below +0) in the
//     output buffer itself, filled with the key of -inf; atomicMax on the
//     keys is the float max. A max is exact and does not depend on the
//     order of the atomics, so the result is deterministic and equals the
//     plain version value for value;
//   * a last pass decodes the keys in place and writes 0 where the value is
//     not finite (empty pillars), as the Pallas kernel does. NaN is made
//     the positive NaN first, so it sorts above +inf and the pillar reads 0.
// The backward counts the ties of each (pillar, channel) with an int
// atomicAdd (a point ties where it is kept and equals the output), marks a
// pillar whose raw maximum was +inf or NaN (it reads 0 and passes no
// gradient), then writes every point's gradient: ct * (1.0f / count) for a
// tie, 0 otherwise, with IEEE division and no FMA (-fmad=false), as the
// plain version (repro_torch/kernels/pillar_scatter/ref.py) computes it.
// Contention at KITTI size: 11.9 points a pillar on average, 60 at most.
#include "moby_kernels.cuh"

namespace {

constexpr int kLanes = 32;
// Key of -inf: 0xff800000 with its 31 low bits flipped.
constexpr int kNegInfKey = static_cast<int>(0x807fffffu);
// Set in a tie count whose pillar's raw maximum was +inf or NaN; the tie
// counts stay below it (the wrapper bounds N).
constexpr int kPoison = 1 << 30;

__device__ __forceinline__ int float_key(float f) {
  const int i = isnan(f) ? 0x7fc00000 : __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ __forceinline__ float key_float(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

__device__ __forceinline__ bool kept(const int* idx, const bool* valid,
                                     long long p, int g, int* id) {
  *id = idx[p];
  return valid[p] && *id >= 0 && *id < g;
}

__global__ void fill_kernel(int* __restrict__ dst, long long total,
                            int value) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x)
    dst[i] = value;
}

__global__ void scatter_max_kernel(const float* __restrict__ feats,
                                   const int* __restrict__ idx,
                                   const bool* __restrict__ valid,
                                   long long n, int c, int g,
                                   int* __restrict__ keys) {
  const int lane = threadIdx.x % kLanes;
  const long long warps =
      static_cast<long long>(gridDim.x) * blockDim.x / kLanes;
  for (long long p = (blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x) / kLanes;
       p < n; p += warps) {
    int id;
    if (!kept(idx, valid, p, g, &id)) continue;
    const float* row = feats + p * c;
    int* cell = keys + static_cast<long long>(id) * c;
    for (int ch = lane; ch < c; ch += kLanes)
      atomicMax(cell + ch, float_key(row[ch]));
  }
}

__global__ void decode_kernel(float* __restrict__ grid, long long total) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float v = key_float(__float_as_int(grid[i]));
    grid[i] = isfinite(v) ? v : 0.0f;
  }
}

__global__ void tie_count_kernel(const float* __restrict__ feats,
                                 const int* __restrict__ idx,
                                 const bool* __restrict__ valid,
                                 const float* __restrict__ out, long long n,
                                 int c, int g, int* __restrict__ count) {
  const int lane = threadIdx.x % kLanes;
  const long long warps =
      static_cast<long long>(gridDim.x) * blockDim.x / kLanes;
  for (long long p = (blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x) / kLanes;
       p < n; p += warps) {
    int id;
    if (!kept(idx, valid, p, g, &id)) continue;
    const float* row = feats + p * c;
    const long long cell = static_cast<long long>(id) * c;
    for (int ch = lane; ch < c; ch += kLanes) {
      const float f = row[ch];
      if (f == out[cell + ch]) atomicAdd(count + cell + ch, 1);
      if (isnan(f) || f == INFINITY) atomicOr(count + cell + ch, kPoison);
    }
  }
}

__global__ void tie_grad_kernel(const float* __restrict__ feats,
                                const int* __restrict__ idx,
                                const bool* __restrict__ valid,
                                const float* __restrict__ out,
                                const float* __restrict__ ct,
                                const int* __restrict__ count, long long n,
                                int c, int g, float* __restrict__ grad) {
  const int lane = threadIdx.x % kLanes;
  const long long warps =
      static_cast<long long>(gridDim.x) * blockDim.x / kLanes;
  for (long long p = (blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x) / kLanes;
       p < n; p += warps) {
    int id;
    const bool keep = kept(idx, valid, p, g, &id);
    const float* row = feats + p * c;
    float* dst = grad + p * c;
    const long long cell = static_cast<long long>(keep ? id : 0) * c;
    for (int ch = lane; ch < c; ch += kLanes) {
      float v = 0.0f;
      if (keep && row[ch] == out[cell + ch]) {
        const int k = count[cell + ch];
        if (!(k & kPoison))
          v = ct[cell + ch] * (1.0f / static_cast<float>(k));
      }
      dst[ch] = v;
    }
  }
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
// the int32 key grid until the last pass decodes it.
MOBY_API int moby_pillar_scatter(const void* feats, const void* idx,
                                 const void* valid, long long n, int c,
                                 int g, void* out, void* stream) {
  const long long cells = static_cast<long long>(g) * c;
  if (cells == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* keys = static_cast<int*>(out);
  fill_kernel<<<grid_blocks(cells), kMobyThreads, 0, s>>>(keys, cells,
                                                          kNegInfKey);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0) {
    scatter_max_kernel<<<grid_blocks(n * kLanes), kMobyThreads, 0, s>>>(
        static_cast<const float*>(feats), static_cast<const int*>(idx),
        static_cast<const bool*>(valid), n, c, g, keys);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_kernel<<<grid_blocks(cells), kMobyThreads, 0, s>>>(
      static_cast<float*>(out), cells);
  return static_cast<int>(cudaGetLastError());
}

// feats (N,C), idx (N,), valid (N,), out (G,C) and its cotangent ct (G,C)
// -> grad (N,C); count (G,C) i32 is scratch.
MOBY_API int moby_pillar_scatter_bwd(const void* feats, const void* idx,
                                     const void* valid, const void* out,
                                     const void* ct, long long n, int c,
                                     int g, void* count, void* grad,
                                     void* stream) {
  if (n == 0 || c == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long cells = static_cast<long long>(g) * c;
  if (cells > 0) {
    fill_kernel<<<grid_blocks(cells), kMobyThreads, 0, s>>>(
        static_cast<int*>(count), cells, 0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    tie_count_kernel<<<grid_blocks(n * kLanes), kMobyThreads, 0, s>>>(
        static_cast<const float*>(feats), static_cast<const int*>(idx),
        static_cast<const bool*>(valid), static_cast<const float*>(out), n,
        c, g, static_cast<int*>(count));
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  tie_grad_kernel<<<grid_blocks(n * kLanes), kMobyThreads, 0, s>>>(
      static_cast<const float*>(feats), static_cast<const int*>(idx),
      static_cast<const bool*>(valid), static_cast<const float*>(out),
      static_cast<const float*>(ct), static_cast<const int*>(count), n, c, g,
      static_cast<float*>(grad));
  return static_cast<int>(cudaGetLastError());
}
