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
// Design: one block per object. The block stages the object's P points
// (as x, y, z planes) and their valid mask in shared memory (13 B/point:
// 3.3 KB at P = 256). Each warp takes planes k, k + W, ... and tests 32
// points per step; the per-plane count is the sum of
// __popc(__ballot_sync(...)) over the steps — an exact integer, with no
// atomics and no padding planes (the TPU wrapper padded K to 128 with
// offset-1e9 planes). The distance is evaluated as in the plain version
// (repro_torch/kernels/ransac_score/ref.py): ((x*nx + y*ny) + z*nz) + d,
// no FMA (-fmad=false), so the comparisons, and the counts, are exact.
#include "moby_kernels.cuh"

namespace {

constexpr int kWarps = 8;

__global__ void ransac_score_kernel(const float* __restrict__ points,
                                    const bool* __restrict__ valid,
                                    const float* __restrict__ normals,
                                    const float* __restrict__ offsets, int p,
                                    int k, float thresh,
                                    int* __restrict__ counts) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = xs + p;
  float* zs = ys + p;
  bool* vs = reinterpret_cast<bool*>(zs + p);
  const int o = blockIdx.x;
  const float* pts = points + static_cast<long long>(o) * p * 3;
  const bool* val = valid + static_cast<long long>(o) * p;
  for (int i = threadIdx.x; i < p; i += blockDim.x) {
    xs[i] = pts[3 * i];
    ys[i] = pts[3 * i + 1];
    zs[i] = pts[3 * i + 2];
    vs[i] = val[i];
  }
  __syncthreads();
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int kk = warp; kk < k; kk += kWarps) {
    const long long h = static_cast<long long>(o) * k + kk;
    const float nx = normals[3 * h], ny = normals[3 * h + 1],
                nz = normals[3 * h + 2];
    const float d = offsets[h];
    int count = 0;
    for (int base = 0; base < p; base += 32) {
      const int i = base + lane;
      bool inlier = false;
      if (i < p && vs[i]) {
        const float dist = fabsf(((xs[i] * nx + ys[i] * ny) + zs[i] * nz) + d);
        inlier = dist < thresh;
      }
      count += __popc(__ballot_sync(0xffffffffu, inlier));
    }
    if (lane == 0) counts[h] = count;
  }
}

// Dynamic shared memory the kernel stages for P points (13 bytes each).
size_t smem_bytes(int p) {
  return static_cast<size_t>(p) * (3 * sizeof(float) + sizeof(bool));
}

}  // namespace

// points (O,P,3) f32, valid (O,P) bool, normals (O,K,3) f32, offsets (O,K)
// f32 -> counts (O,K) i32.
MOBY_API int moby_ransac_score(const void* points, const void* valid,
                               const void* normals, const void* offsets,
                               int o, int p, int k, float thresh, void* counts,
                               void* stream) {
  if (o > 0 && k > 0) {
    ransac_score_kernel<<<o, kWarps * 32, smem_bytes(p),
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(points), static_cast<const bool*>(valid),
        static_cast<const float*>(normals), static_cast<const float*>(offsets),
        p, k, thresh, static_cast<int*>(counts));
  }
  return static_cast<int>(cudaGetLastError());
}
