// Pairwise axis-aligned 2D IoU (the tracking-association cost matrix).
//
// Replaces the TPU kernel repro/kernels/iou2d/iou2d.py (iou2d_pallas).
//
// What bounds it on an H100: launch latency. On the serving path the matrix
// is T = 2*max_obj predicted tracks by D = max_obj detections (24 x 12 in
// kitti-urban): 1.5 KB in, 1.2 KB out and ~5k flops, nanoseconds of memory
// or arithmetic time against a microsecond of launch. What a design can
// still win is the time one thread takes above the launch: one round trip
// of loads (~0.3 us in the probes of tools/k1_k2_probes.py), the
// arithmetic, one store, and blocks that do not work.
//
// Design: a 1-D grid, a thread an output (i, j) of the row-major (N, M)
// matrix. A matrix of at most 1024 outputs is one CTA of as many threads,
// rounded to whole warps (the serving shape: one CTA of 288 threads, all
// working); a larger one takes CTAs of 256 threads. Each thread issues its
// two boxes' 16-byte read-only loads together at entry, then evaluates the
// plain version's formula (repro_torch/kernels/iou2d/ref.py) in the same
// order, with IEEE division and no FMA, so the result equals the plain
// version bit for bit. Most pairs of boxes do not overlap, so the division
// is skipped where the intersection is 0 (0.06 us less in the probes): the
// quotient is then that zero, sign and all, as the union is positive. The
// ragged edge is masked, so unlike the TPU kernel nothing is padded to
// 128 x 128 tiles. Indices are 32-bit: the wrapper takes fewer than 2^31
// outputs.
#include "moby_kernels.cuh"

namespace {

constexpr int kOneCta = 1024;
constexpr int kThreads = 256;

__global__ void iou2d_kernel(const float4* __restrict__ a,
                             const float4* __restrict__ b, unsigned n,
                             unsigned m, unsigned total,
                             float* __restrict__ out) {
  const unsigned k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= total) return;
  // Stream blockIdx.y's boxes and matrix.
  a += static_cast<size_t>(blockIdx.y) * n;
  b += static_cast<size_t>(blockIdx.y) * m;
  out += static_cast<size_t>(blockIdx.y) * total;
  const unsigned i = k / m;
  const float4 p = __ldg(a + i);
  const float4 q = __ldg(b + (k - i * m));
  const float ix = fmaxf(fminf(p.z, q.z) - fmaxf(p.x, q.x), 0.0f);
  const float iy = fmaxf(fminf(p.w, q.w) - fmaxf(p.y, q.y), 0.0f);
  const float inter = ix * iy;
  const float aa = fmaxf((p.z - p.x) * (p.w - p.y), 0.0f);
  const float ab = fmaxf((q.z - q.x) * (q.w - q.y), 0.0f);
  const float uni = aa + ab - inter;
  out[k] = uni > 1e-9f ? (inter != 0.0f ? inter / uni : inter) : 0.0f;
}

}  // namespace

// a (S,N,4) f32, b (S,M,4) f32, both 16-byte aligned, N*M < 2^31,
// S < 2^16 -> out (S,N,M) f32.
MOBY_API int moby_iou2d(const void* a, int n, const void* b, int m, int s,
                        void* out, void* stream) {
  const unsigned total = static_cast<unsigned>(n) * static_cast<unsigned>(m);
  if (total > 0 && s > 0) {
    const unsigned threads = total <= kOneCta ? (total + 31) / 32 * 32
                                              : kThreads;
    const dim3 grid((total + threads - 1) / threads, static_cast<unsigned>(s));
    iou2d_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(a), static_cast<const float4*>(b),
        static_cast<unsigned>(n), static_cast<unsigned>(m), total,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
