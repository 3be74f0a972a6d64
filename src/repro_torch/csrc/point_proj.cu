// Fused LiDAR -> pixel projection with the instance-label gather.
//
// Replaces the TPU kernel repro/kernels/point_proj/point_proj.py
// (point_proj_pallas) and the XLA gather that followed it
// (repro/kernels/point_proj/ops.py::label_points).
//
// What bounds it on an H100: memory. Per point it reads 12 bytes of xyz and
// one 4-byte label, and writes 8 (uv) + 4 (depth) + 1 (visible) + 4 (flat)
// + 4 (label) bytes, about 37 bytes for ~40 flops; at N = 122,880 that is
// ~4.5 MB, ~1.4 us at 3.35 TB/s, far below the launch cost.
//
// Design: one thread per point in a grid-stride loop. The 24 calibration
// words are staged once per block in shared memory. The label gather the
// TPU kept outside its kernel (per-lane VMEM gathers are slow there) is
// fused in, so project_and_label is one launch. The arithmetic follows the
// plain version (repro_torch/kernels/point_proj/ref.py) step for step:
// two 4-term products (Tr, then P) summed pairwise, IEEE division, no FMA
// (the library is built with -fmad=false), and rintf (round half to even,
// like torch.round) for the pixel index — so `visible`, `flat` and the
// labels equal the plain version bit for bit.
#include "moby_kernels.cuh"

namespace {

__device__ __forceinline__ float row4(const float* m, float a, float b,
                                      float c) {
  // (a*m0 + b*m1) + (c*m2 + 1*m3): the pairwise order of XLA's 4-term dot.
  return (a * m[0] + b * m[1]) + (c * m[2] + m[3]);
}

__global__ void point_proj_kernel(const float* __restrict__ pts, long long n,
                                  const float* __restrict__ tr,
                                  const float* __restrict__ p, int height,
                                  int width, const int* __restrict__ label_img,
                                  float* __restrict__ uv,
                                  float* __restrict__ depth,
                                  bool* __restrict__ vis,
                                  int* __restrict__ flat,
                                  int* __restrict__ labels) {
  __shared__ float m[24];
  if (threadIdx.x < 12) {
    m[threadIdx.x] = tr[threadIdx.x];
    m[12 + threadIdx.x] = p[threadIdx.x];
  }
  __syncthreads();
  const float fw = static_cast<float>(width);
  const float fh = static_cast<float>(height);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float x = pts[3 * i], y = pts[3 * i + 1], z = pts[3 * i + 2];
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
    uv[2 * i] = u;
    uv[2 * i + 1] = v;
    depth[i] = d;
    vis[i] = visible;
    flat[i] = f;
    if (labels != nullptr) labels[i] = visible ? label_img[f] : 0;
  }
}

}  // namespace

// points (N,3) f32, tr/p (3,4) f32 row-major, label_img (H,W) i32 or NULL.
// Writes uv (N,2) f32, depth (N,) f32, vis (N,) bool, flat (N,) i32 and,
// when label_img is given, labels (N,) i32.
MOBY_API int moby_point_proj(const void* points, long long n, const void* tr,
                             const void* p, int height, int width,
                             const void* label_img, void* uv, void* depth,
                             void* vis, void* flat, void* labels,
                             void* stream) {
  if (n > 0) {
    int sms = 132;
    int dev = 0;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    long long blocks = (n + kMobyThreads - 1) / kMobyThreads;
    const long long cap = static_cast<long long>(sms) * kMobyBlocksPerSm;
    if (blocks > cap) blocks = cap;
    point_proj_kernel<<<static_cast<unsigned>(blocks), kMobyThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(points), n, static_cast<const float*>(tr),
        static_cast<const float*>(p), height, width,
        static_cast<const int*>(label_img), static_cast<float*>(uv),
        static_cast<float*>(depth), static_cast<bool*>(vis),
        static_cast<int*>(flat),
        label_img != nullptr ? static_cast<int*>(labels) : nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
