// Pairwise axis-aligned 2D IoU (the tracking-association cost matrix).
//
// Replaces the TPU kernel repro/kernels/iou2d/iou2d.py (iou2d_pallas).
//
// What bounds it on an H100: launch latency. On the serving path the matrix
// is T = 2*max_obj predicted tracks by D = max_obj detections (24 x 12 in
// kitti-urban): 1.5 KB in, 1.2 KB out and ~4k flops, nanoseconds of memory
// or arithmetic time against microseconds of launch.
//
// Design: one thread per (n, m) output in a 2-D grid of 32 x 8 blocks; the
// ragged edges are masked, so unlike the TPU kernel nothing is padded to
// 128 x 128 tiles. Each thread evaluates the plain version's formula
// (repro_torch/kernels/iou2d/ref.py) in the same order, with IEEE division
// and no FMA.
#include "moby_kernels.cuh"

namespace {

constexpr int kTileM = 32;
constexpr int kTileN = 8;

__global__ void iou2d_kernel(const float* __restrict__ a, int n,
                             const float* __restrict__ b, int m,
                             float* __restrict__ out) {
  const int j = blockIdx.x * kTileM + threadIdx.x;
  const int i = blockIdx.y * kTileN + threadIdx.y;
  if (i >= n || j >= m) return;
  const float4 p = reinterpret_cast<const float4*>(a)[i];
  const float4 q = reinterpret_cast<const float4*>(b)[j];
  const float ix = fmaxf(fminf(p.z, q.z) - fmaxf(p.x, q.x), 0.0f);
  const float iy = fmaxf(fminf(p.w, q.w) - fmaxf(p.y, q.y), 0.0f);
  const float inter = ix * iy;
  const float aa = fmaxf((p.z - p.x) * (p.w - p.y), 0.0f);
  const float ab = fmaxf((q.z - q.x) * (q.w - q.y), 0.0f);
  const float uni = aa + ab - inter;
  out[static_cast<long long>(i) * m + j] = uni > 1e-9f ? inter / uni : 0.0f;
}

}  // namespace

// a (N,4) f32, b (M,4) f32, both 16-byte aligned -> out (N,M) f32.
MOBY_API int moby_iou2d(const void* a, int n, const void* b, int m, void* out,
                        void* stream) {
  if (n > 0 && m > 0) {
    const dim3 block(kTileM, kTileN);
    const dim3 grid((m + kTileM - 1) / kTileM, (n + kTileN - 1) / kTileN);
    iou2d_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), n, static_cast<const float*>(b), m,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
