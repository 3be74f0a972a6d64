// RANSAC plane-hypothesis inlier counting.
//
// Replaces the TPU kernel repro/kernels/ransac_score/ransac_score.py
// (ransac_score_pallas).
//
// For each object o and plane k: the number of points p with valid[o, p]
// and |n_k . x_p + d_k| < thresh.
//
// What bounds it on an H100: launch latency at the serving shapes. At
// (O, K, P) = (12, 30, 256) it reads ~40 KB and does ~0.6 M flops —
// nanoseconds against a launch of microseconds; the work grows as O*K*P,
// and only at thousands of objects would the 67 TFLOP/s f32 rate matter.
//
// Design: a warp for each (object, plane), 4 warps a block on a grid of
// (O, ceil(K/4)) blocks: 360 warps at the serving shape, so no warp walks
// planes one after another. Each lane loads its plane's normal and offset
// once, then tests 32 points a step straight from device memory (one
// object's points, 3 KB at P = 256, stay in L1 and L2 for its planes):
// kSteps steps' loads are issued before the first compare, and the count
// is the sum of __popc(__ballot_sync(...)) over the steps — an exact
// integer, with no shared memory, no __syncthreads, no atomics and no
// padding planes (the TPU wrapper padded K to 128 with offset-1e9 planes).
// P is unbounded; K is bounded by the grid's y extent (65,535 blocks of 4
// planes). The distance is evaluated as in the plain version
// (repro_torch/kernels/ransac_score/ref.py): ((x*nx + y*ny) + z*nz) + d,
// no FMA (-fmad=false), so the comparisons, and the counts, are exact.
#include "moby_kernels.cuh"

namespace {

constexpr int kLanes = 32;
// Planes (warps) a block.
constexpr int kWarps = 4;
// 32-point steps a warp has in flight at once: the serving shape's 256
// points in one group.
constexpr int kSteps = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * kLanes)
ransac_score_kernel(const float* __restrict__ points,
                    const bool* __restrict__ valid,
                    const float* __restrict__ normals,
                    const float* __restrict__ offsets, int p, int k,
                    float thresh, int* __restrict__ counts) {
  const int lane = threadIdx.x % kLanes;
  const int kk = blockIdx.y * kWarps + threadIdx.x / kLanes;
  if (kk >= k) return;
  const long long o = blockIdx.x;
  const long long h = o * k + kk;
  const float nx = normals[3 * h], ny = normals[3 * h + 1],
              nz = normals[3 * h + 2];
  const float d = offsets[h];
  const float* pts = points + o * p * 3;
  const bool* val = valid + o * p;
  int count = 0;
  for (int base = 0; base < p; base += kSteps * kLanes) {
    float x[kSteps], y[kSteps], z[kSteps];
    bool v[kSteps];
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const int i = base + s * kLanes + lane;
      const bool in = i < p;
      const float* q = pts + 3 * static_cast<long long>(in ? i : 0);
      v[s] = in && val[i];
      x[s] = in ? q[0] : 0.0f;
      y[s] = in ? q[1] : 0.0f;
      z[s] = in ? q[2] : 0.0f;
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      const bool inlier =
          v[s] && fabsf(((x[s] * nx + y[s] * ny) + z[s] * nz) + d) < thresh;
      count += __popc(__ballot_sync(kFull, inlier));
    }
  }
  if (lane == 0) counts[h] = count;
}

}  // namespace

// points (O,P,3) f32, valid (O,P) bool, normals (O,K,3) f32, offsets (O,K)
// f32 -> counts (O,K) i32.
MOBY_API int moby_ransac_score(const void* points, const void* valid,
                               const void* normals, const void* offsets,
                               int o, int p, int k, float thresh, void* counts,
                               void* stream) {
  if (o > 0 && k > 0) {
    const dim3 grid(o, (k + kWarps - 1) / kWarps);
    ransac_score_kernel<<<grid, kWarps * kLanes, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(points), static_cast<const bool*>(valid),
        static_cast<const float*>(normals), static_cast<const float*>(offsets),
        p, k, thresh, static_cast<int*>(counts));
  }
  return static_cast<int>(cudaGetLastError());
}
