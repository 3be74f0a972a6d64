// LiDAR -> pixel projection, and the same projection with the
// instance-label gather in place of its outputs.
//
// Replaces the TPU kernel repro/kernels/point_proj/point_proj.py
// (point_proj_pallas) and the XLA gather that followed it
// (repro/kernels/point_proj/ops.py::label_points).
//
// Two instances of one kernel template:
// * full (moby_point_proj): uv, depth, visible and flat, the TPU kernel's
//   outputs. ~29 bytes a point.
// * labels (moby_point_proj_labels): xyz and the label image in, the (N,)
//   int32 labels out, nothing else: what the serving path's
//   project_and_label keeps. ~16 bytes a point plus the gathers. It takes
//   a stream axis: points (S,N,3) and label images (S,H,W) with one
//   calibration -> labels (S,N), the grid's y dimension the stream (block
//   (x, s) projects block x of stream s's points into stream s's image),
//   so a fleet frame is one launch, as vmap made of the Pallas call. The
//   2-D call is S = 1, the same blocks doing the same arithmetic.
//
// What bounds it on an H100: latency. At N = 122,880 the full instance
// moves ~3.6 MB (1.1 us at 3.35 TB/s), the labels instance ~2.3 MB
// (0.7 us), and every thread does one chain: its point's loads, ~100
// dependent instructions (two IEEE divisions among them), the label
// gather, the store. Probes (tools/k1_k2_probes.py) put ~0.7 us of the
// labels instance above a one-element launch in a load-then-store kernel
// of the same shape, ~0.4 in the arithmetic and ~0.6 in the gather.
// The design keeps the chain short and the code to one path:
// * a point a thread, blocks of 128 threads, a grid of ceil(N / 128)
//   blocks, no grid-stride loop and no device query. Four points a thread
//   (16-byte loads and stores) gained 0.04-0.12 us in the probes, within
//   the run-to-run spread, for a second path; eight were slower;
// * the point's loads are issued first, then the 24 calibration words by
//   uniform read-only loads (__ldg; they broadcast from L1): no shared
//   memory and no __syncthreads;
// * any points base: an (N, 3) view offset by any number of rows.
//
// The arithmetic follows the plain version (repro_torch/kernels/
// point_proj/ref.py) step for step: two 4-term products (Tr, then P)
// summed pairwise, IEEE division, no FMA (the library is built with
// -fmad=false), rintf (round half to even, like torch.round) and the
// clamp in float before the cast — so every output equals the plain
// version bit for bit.
#include "moby_kernels.cuh"

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float row4(const float* m, float a, float b,
                                      float c) {
  // (a*m0 + b*m1) + (c*m2 + 1*m3): the pairwise order of XLA's 4-term dot.
  return (a * m[0] + b * m[1]) + (c * m[2] + m[3]);
}

// kFull writes uv, depth, visible and flat; otherwise the labels alone
// (label_img at the pixel where the point is visible, else 0).
template <bool kFull>
__global__ void __launch_bounds__(kThreads) point_proj_kernel(
    const float* __restrict__ pts, long long n, const float* __restrict__ tr,
    const float* __restrict__ p, int height, int width,
    const int* __restrict__ label_img, float* __restrict__ uv,
    float* __restrict__ depth, bool* __restrict__ vis,
    int* __restrict__ flat, int* __restrict__ labels) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  // Stream blockIdx.y (always 0 for the full instance).
  pts += static_cast<long long>(blockIdx.y) * n * 3;
  if (!kFull) {
    label_img += static_cast<long long>(blockIdx.y) * height * width;
    labels += static_cast<long long>(blockIdx.y) * n;
  }
  const float x = __ldg(pts + 3 * i), y = __ldg(pts + 3 * i + 1),
              z = __ldg(pts + 3 * i + 2);
  float m[24];  // Tr (3x4) then P (3x4), row-major.
#pragma unroll
  for (int k = 0; k < 12; ++k) {
    m[k] = __ldg(tr + k);
    m[12 + k] = __ldg(p + k);
  }
  const float fw = static_cast<float>(width);
  const float fh = static_cast<float>(height);
  const float c0 = row4(m + 0, x, y, z);
  const float c1 = row4(m + 4, x, y, z);
  const float c2 = row4(m + 8, x, y, z);
  const float q0 = row4(m + 12, c0, c1, c2);
  const float q1 = row4(m + 16, c0, c1, c2);
  const float d = row4(m + 20, c0, c1, c2);
  const float w = fabsf(d) < 1e-6f ? 1e-6f : d;
  const float u = q0 / w;
  const float v = q1 / w;
  const bool visible = (d > 0.1f) & (u >= 0.0f) & (u < fw) & (v >= 0.0f) &
                       (v < fh);
  // Clamp in float before the cast: the same index as a saturating
  // round-then-clip for every finite coordinate.
  const int ui = static_cast<int>(fminf(fmaxf(rintf(u), 0.0f), fw - 1.0f));
  const int vi = static_cast<int>(fminf(fmaxf(rintf(v), 0.0f), fh - 1.0f));
  const int f = vi * width + ui;
  if (kFull) {
    uv[2 * i] = u;
    uv[2 * i + 1] = v;
    depth[i] = d;
    vis[i] = visible;
    flat[i] = f;
  } else {
    labels[i] = visible ? __ldg(label_img + f) : 0;
  }
}

template <bool kFull>
int launch(const void* points, long long n, int s, const void* tr,
           const void* p, int height, int width, const void* label_img,
           void* uv, void* depth, void* vis, void* flat, void* labels,
           void* stream) {
  if (n > 0 && s > 0) {
    const long long blocks = (n + kThreads - 1) / kThreads;
    const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(s));
    point_proj_kernel<kFull><<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(points), n, static_cast<const float*>(tr),
        static_cast<const float*>(p), height, width,
        static_cast<const int*>(label_img), static_cast<float*>(uv),
        static_cast<float*>(depth), static_cast<bool*>(vis),
        static_cast<int*>(flat), static_cast<int*>(labels));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// points (N,3) f32, tr/p (3,4) f32 row-major. Writes uv (N,2) f32,
// depth (N,) f32, vis (N,) bool and flat (N,) i32.
MOBY_API int moby_point_proj(const void* points, long long n, const void* tr,
                             const void* p, int height, int width, void* uv,
                             void* depth, void* vis, void* flat,
                             void* stream) {
  return launch<true>(points, n, 1, tr, p, height, width, nullptr, uv,
                      depth, vis, flat, nullptr, stream);
}

// points (S,N,3) f32, tr/p (3,4) f32 row-major, label_img (S,H,W) i32 ->
// labels (S,N) i32 (0 where a point is not visible); S < 2^16.
MOBY_API int moby_point_proj_labels(const void* points, long long n, int s,
                                    const void* tr, const void* p,
                                    int height, int width,
                                    const void* label_img, void* labels,
                                    void* stream) {
  return launch<false>(points, n, s, tr, p, height, width, label_img,
                       nullptr, nullptr, nullptr, nullptr, labels, stream);
}
