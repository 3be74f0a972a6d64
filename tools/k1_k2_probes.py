#!/usr/bin/env python3
"""Probes that explain where K1 (``point_proj``) and K2 (``iou2d``) spend
the time above their launch: variants of the two kernels, each timed as
``chip_smoke.py`` times the port's kernels, beside those kernels in the
same process.

    python3 tools/k1_k2_probes.py

Needs one CUDA card and ``nvcc``; builds a small library from the source
below into ``build/k1_k2_probes/`` (none of it is part of the port) and
prints, at the serving shapes (K1: 122,880 points, KITTI's calibration, a
375x1242 label image; K2: 24x12 boxes):

* the launch floor (a one-element ``zero_()``) and the port's kernels;
* K1, both instances (``full``: uv, depth, visible and flat; ``labels``:
  the labels alone): 1, 2, 4 and 8 points a thread (16-byte loads and
  stores where a thread takes four or more), 128 against 256 threads a
  block, the calibration staged through shared memory behind a
  ``__syncthreads`` before the points are loaded; the labels instance
  without its gather (``visible ? flat : 0``) and with no arithmetic at
  all (a load-then-store kernel of the same shape);
* K2: the division on every pair, a constant stored with no loads (the
  floor of the port's own launch path), PyTorch's ``zero_()`` of the
  (24, 12) output, a multiply in place of the division, and the division
  skipped where the intersection is 0 (the port's kernel);
* the SM clock over the run (``nvidia-smi`` every 50 ms).

Every probe's output is first held against what it computes (the plain
version's; ``where(visible, flat, 0)`` without the gather), so a probe
that skips work it should do shows. Device ms per call: CUDA-graph
replays of up to 50 calls, the median of 20 (``chip_smoke.graph_ms``).
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "k1_k2_probes"
SOURCE = r'''
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float row4(const float* m, float a, float b,
                                      float c) {
  return (a * m[0] + b * m[1]) + (c * m[2] + m[3]);
}

// Store N 32-bit words at dst (16-byte aligned for N % 4 == 0, 8 for 2).
template <int N>
__device__ __forceinline__ void store_words(uint32_t* dst, const uint32_t* v) {
  if constexpr (N == 1) {
    dst[0] = v[0];
  } else if constexpr (N == 2) {
    *reinterpret_cast<uint2*>(dst) = make_uint2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < N; k += 4)
      *reinterpret_cast<uint4*>(dst + k) =
          make_uint4(v[k], v[k + 1], v[k + 2], v[k + 3]);
  }
}

// PTS consecutive points a thread (N % PTS == 0, an aligned base), each
// projected (and gathered) in turn. FULL: uv, depth, visible and flat;
// else the labels only. STAGED: the calibration through shared memory and
// a __syncthreads, before the points are loaded. CUT: 0 nothing; 1 the
// gather (visible ? flat : 0 in place of the label); 2 the arithmetic (the
// label is the xor of the point's three words).
template <int PTS, bool FULL, bool STAGED, int CUT, int THREADS>
__global__ void __launch_bounds__(THREADS) k1_probe(
    const float* __restrict__ pts, long long groups,
    const float* __restrict__ tr, const float* __restrict__ p, int height,
    int width, const int* __restrict__ label_img, float* __restrict__ uv,
    float* __restrict__ depth, uint8_t* __restrict__ vis,
    int* __restrict__ flat, int* __restrict__ labels) {
  float m[24];
  if constexpr (STAGED) {
    __shared__ float sm[24];
    if (threadIdx.x < 24)
      sm[threadIdx.x] = threadIdx.x < 12 ? tr[threadIdx.x]
                                         : p[threadIdx.x - 12];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 24; ++k) m[k] = sm[k];
  }
  const long long t = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (t >= groups) return;
  float xyz[3 * PTS];
  const float* src = pts + 3 * PTS * t;
  if constexpr (PTS == 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) xyz[k] = __ldg(src + k);
  } else if constexpr (PTS == 2) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(src) + k);
      xyz[2 * k] = v.x;
      xyz[2 * k + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 3 * PTS / 4; ++k) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(src) + k);
      xyz[4 * k] = v.x;
      xyz[4 * k + 1] = v.y;
      xyz[4 * k + 2] = v.z;
      xyz[4 * k + 3] = v.w;
    }
  }
  if constexpr (!STAGED) {
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      m[k] = __ldg(tr + k);
      m[12 + k] = __ldg(p + k);
    }
  }
  const float fw = static_cast<float>(width);
  const float fh = static_cast<float>(height);
  uint32_t u_v[2 * PTS], d_w[PTS], f_w[PTS], l_w[PTS];
  bool vis_b[PTS];
#pragma unroll
  for (int j = 0; j < PTS; ++j) {
    const float x = xyz[3 * j], y = xyz[3 * j + 1], z = xyz[3 * j + 2];
    if constexpr (CUT == 2) {
      l_w[j] = __float_as_uint(x) ^ __float_as_uint(y) ^ __float_as_uint(z);
      continue;
    }
    const float c0 = row4(m + 0, x, y, z);
    const float c1 = row4(m + 4, x, y, z);
    const float c2 = row4(m + 8, x, y, z);
    const float q0 = row4(m + 12, c0, c1, c2);
    const float q1 = row4(m + 16, c0, c1, c2);
    const float d = row4(m + 20, c0, c1, c2);
    const float w = fabsf(d) < 1e-6f ? 1e-6f : d;
    const float u = q0 / w, v = q1 / w;
    const bool visible = (d > 0.1f) & (u >= 0.0f) & (u < fw) & (v >= 0.0f) &
                         (v < fh);
    const int ui = static_cast<int>(fminf(fmaxf(rintf(u), 0.0f), fw - 1.0f));
    const int vi = static_cast<int>(fminf(fmaxf(rintf(v), 0.0f), fh - 1.0f));
    const int f = vi * width + ui;
    u_v[2 * j] = __float_as_uint(u);
    u_v[2 * j + 1] = __float_as_uint(v);
    d_w[j] = __float_as_uint(d);
    f_w[j] = static_cast<uint32_t>(f);
    vis_b[j] = visible;
    if constexpr (!FULL)
      l_w[j] = !visible ? 0u
               : CUT == 1 ? static_cast<uint32_t>(f)
                          : static_cast<uint32_t>(__ldg(label_img + f));
  }
  if constexpr (!FULL) {
    store_words<PTS>(reinterpret_cast<uint32_t*>(labels) + PTS * t, l_w);
  } else {
    store_words<2 * PTS>(reinterpret_cast<uint32_t*>(uv) + 2 * PTS * t, u_v);
    store_words<PTS>(reinterpret_cast<uint32_t*>(depth) + PTS * t, d_w);
    store_words<PTS>(reinterpret_cast<uint32_t*>(flat) + PTS * t, f_w);
    if constexpr (PTS == 1) {
      vis[t] = vis_b[0];
    } else if constexpr (PTS == 2) {
      reinterpret_cast<uint16_t*>(vis)[t] =
          static_cast<uint16_t>(vis_b[0] | vis_b[1] << 8);
    } else {
      uint32_t words[PTS / 4];
#pragma unroll
      for (int k = 0; k < PTS / 4; ++k)
        words[k] = static_cast<uint32_t>(vis_b[4 * k]) |
                   static_cast<uint32_t>(vis_b[4 * k + 1]) << 8 |
                   static_cast<uint32_t>(vis_b[4 * k + 2]) << 16 |
                   static_cast<uint32_t>(vis_b[4 * k + 3]) << 24;
      if constexpr (PTS == 4)
        reinterpret_cast<uint32_t*>(vis)[t] = words[0];
      else
        reinterpret_cast<uint2*>(vis)[t] = make_uint2(words[0], words[1]);
    }
  }
}

// MODE 0: the division on every pair; 1: a constant stored, no loads; 2: a
// multiply in place of the division; 3: the division skipped where the
// intersection is 0 (the quotient is then that 0, sign and all: the
// port's kernel).
template <int MODE>
__global__ void k2_probe(const float4* __restrict__ a,
                         const float4* __restrict__ b, unsigned m,
                         unsigned total, float* __restrict__ out) {
  const unsigned k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= total) return;
  if constexpr (MODE == 1) {
    out[k] = 0.0f;
    return;
  }
  const unsigned i = k / m;
  const float4 p = __ldg(a + i);
  const float4 q = __ldg(b + (k - i * m));
  const float ix = fmaxf(fminf(p.z, q.z) - fmaxf(p.x, q.x), 0.0f);
  const float iy = fmaxf(fminf(p.w, q.w) - fmaxf(p.y, q.y), 0.0f);
  const float inter = ix * iy;
  const float aa = fmaxf((p.z - p.x) * (p.w - p.y), 0.0f);
  const float ab = fmaxf((q.z - q.x) * (q.w - q.y), 0.0f);
  const float uni = aa + ab - inter;
  if constexpr (MODE == 3)
    out[k] = uni > 1e-9f ? (inter != 0.0f ? inter / uni : inter) : 0.0f;
  else
    out[k] = uni > 1e-9f ? (MODE == 2 ? inter * uni : inter / uni) : 0.0f;
}

template <int PTS, bool FULL, bool STAGED, int CUT, int THREADS>
int k1_go(const float* pts, long long n, const float* tr, const float* p,
          int h, int w, const int* lab, float* uv, float* depth,
          uint8_t* vis, int* flat, int* labels, cudaStream_t s) {
  const long long groups = n / PTS;
  const long long blocks = (groups + THREADS - 1) / THREADS;
  k1_probe<PTS, FULL, STAGED, CUT, THREADS>
      <<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
          pts, groups, tr, p, h, w, lab, uv, depth, vis, flat, labels);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// variant: see VARIANTS in k1_k2_probes.py.
extern "C" int k1_probe(int variant, const float* pts, long long n,
                        const float* tr, const float* p, int h, int w,
                        const int* lab, float* uv, float* depth,
                        uint8_t* vis, int* flat, int* labels, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
#define GO(PTS, FULL, STAGED, CUT, THREADS)                                \
  return k1_go<PTS, FULL, STAGED, CUT, THREADS>(pts, n, tr, p, h, w, lab,    \
                                                   uv, depth, vis, flat,     \
                                                   labels, s)
  switch (variant) {
    case 0: GO(1, true, false, 0, 128);
    case 1: GO(1, true, false, 0, 256);
    case 2: GO(4, true, false, 0, 128);
    case 3: GO(1, true, true, 0, 128);
    case 10: GO(1, false, false, 0, 128);
    case 11: GO(1, false, false, 0, 256);
    case 12: GO(2, false, false, 0, 128);
    case 13: GO(4, false, false, 0, 128);
    case 14: GO(8, false, false, 0, 128);
    case 15: GO(1, false, true, 0, 128);
    case 16: GO(1, false, false, 1, 128);
    case 17: GO(4, false, false, 1, 128);
    case 18: GO(1, false, false, 2, 128);
    case 19: GO(4, false, false, 2, 128);
  }
#undef GO
  return -1;
}

extern "C" int k2_probe(int mode, const void* a, int n, const void* b, int m,
                        float* out, void* stream) {
  const unsigned total = static_cast<unsigned>(n) * m;
  const unsigned threads = total <= 1024 ? (total + 31) / 32 * 32 : 256;
  const unsigned blocks = (total + threads - 1) / threads;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* fa = static_cast<const float4*>(a);
  const auto* fb = static_cast<const float4*>(b);
  if (mode == 0) k2_probe<0><<<blocks, threads, 0, s>>>(fa, fb, m, total, out);
  if (mode == 1) k2_probe<1><<<blocks, threads, 0, s>>>(fa, fb, m, total, out);
  if (mode == 2) k2_probe<2><<<blocks, threads, 0, s>>>(fa, fb, m, total, out);
  if (mode == 3) k2_probe<3><<<blocks, threads, 0, s>>>(fa, fb, m, total, out);
  return static_cast<int>(cudaGetLastError());
}
'''

# K1 variant -> (instance, points a thread, staged, cut, threads a block);
# cut as CUT in the source. Variants 0 and 10 repeat the port's design.
VARIANTS = {
    0: ("full", 1, False, 0, 128), 1: ("full", 1, False, 0, 256),
    2: ("full", 4, False, 0, 128), 3: ("full", 1, True, 0, 128),
    10: ("labels", 1, False, 0, 128), 11: ("labels", 1, False, 0, 256),
    12: ("labels", 2, False, 0, 128), 13: ("labels", 4, False, 0, 128),
    14: ("labels", 8, False, 0, 128), 15: ("labels", 1, True, 0, 128),
    16: ("labels", 1, False, 1, 128), 17: ("labels", 4, False, 1, 128),
    18: ("labels", 1, False, 2, 128), 19: ("labels", 4, False, 2, 128),
}
CUTS = {0: "", 1: ", no gather", 2: ", no arithmetic"}


def build() -> ctypes.CDLL:
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "probes.cu").write_text(SOURCE)
    lib = OUT / "probes.so"
    res = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-o", str(lib), str(OUT / "probes.cu")],
                         capture_output=True, text=True)
    if res.returncode:
        sys.exit(f"k1_k2_probes: nvcc failed:\n{res.stdout}{res.stderr}")
    dll = ctypes.CDLL(str(lib))
    dll.k1_probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
                             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_int] + [ctypes.c_void_p] * 7
    dll.k2_probe.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                             ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_void_p]
    return dll


def main() -> None:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("k1_k2_probes: torch sees no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    dll = build()
    dev = torch.device("cuda", 0)
    clocks = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits",
         "-lms", "50"], stdout=subprocess.PIPE, text=True)
    try:
        probe(np, torch, cs, dll, dev)
    finally:
        clocks.terminate()
    mhz = [int(x) for x in clocks.communicate()[0].split() if x.isdigit()]
    if mhz:
        print(f"SM clock over the probes (nvidia-smi every 50 ms, "
              f"{len(mhz)} samples): min {min(mhz)}, median "
              f"{sorted(mhz)[len(mhz) // 2]}, max {max(mhz)} MHz")
    print(cs.nvidia_smi())


def probe(np, torch, cs, dll, dev) -> None:
    """Time the port's K1 and K2 and every probe, each checked first."""
    from repro_torch.data import scenes
    from repro_torch.kernels.iou2d import ops as iou_ops, ref as iou_ref
    from repro_torch.kernels.point_proj import ops as pp_ops, ref as pp_ref

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def timed(fn):
        return cs.graph_ms(fn, torch)

    floor_t = torch.zeros(1, device=dev)
    print(f"launch floor: {timed(floor_t.zero_):.5f} ms (a one-element "
          f"zero_())", flush=True)

    # -- K1 at the serving shape --------------------------------------------
    n, h, w = 122880, 375, 1242
    pts, tr, p, lab = cs.proj_inputs(torch, np, dev, scenes, n, h, w, 0)
    want = pp_ref.point_proj_ref(pts, tr, p, h, w, lab)
    print(f"K1 N={n} image={h}x{w}, {int(want[2].sum())} visible", flush=True)
    print(f"port point_proj: "
          f"{timed(lambda: pp_ops.point_proj(pts, tr, p, h, w)):.5f} ms",
          flush=True)
    print(f"port point_proj_labels: "
          f"{timed(lambda: pp_ops.project_and_label(pts, tr, p, lab)):.5f} ms",
          flush=True)
    uv = torch.empty((n, 2), device=dev)
    depth = torch.empty((n,), device=dev)
    vis = torch.empty((n,), dtype=torch.bool, device=dev)
    flat = torch.empty((n,), dtype=torch.int32, device=dev)
    labels = torch.empty((n,), dtype=torch.int32, device=dev)
    bits = pts.view(torch.int32)
    xor = bits[:, 0] ^ bits[:, 1] ^ bits[:, 2]
    for variant, (inst, per, staged, cut, threads) in VARIANTS.items():
        def run(variant=variant):
            code = dll.k1_probe(variant, pts.data_ptr(), n, tr.data_ptr(),
                                p.data_ptr(), h, w, lab.data_ptr(),
                                uv.data_ptr(), depth.data_ptr(),
                                vis.data_ptr(), flat.data_ptr(),
                                labels.data_ptr(), stream())
            if code:
                sys.exit(f"k1_k2_probes: K1 variant {variant} failed ({code})")
        for t in (uv, depth, flat, labels):
            t.fill_(-7)
        vis.fill_(True)
        run()
        torch.cuda.synchronize()
        # What each probe must have written.
        if inst == "full":
            got, ref = [uv, depth, vis, flat], list(want[:4])
        else:
            got = [labels]
            ref = [{0: want[4], 1: torch.where(want[2], want[3], 0),
                    2: xor}[cut]]
        if not all(torch.equal(g, r) for g, r in zip(got, ref)):
            sys.exit(f"k1_k2_probes: K1 variant {variant} differs from what "
                     f"it computes")
        what = (f"{per} point{'s' if per > 1 else ''} a thread, {threads} "
                f"threads" + (", calibration staged first" if staged else "")
                + CUTS[cut])
        print(f"probe K1 {inst} [{what}]: {timed(run):.5f} ms", flush=True)

    # -- K2 at the serving shape ---------------------------------------------
    rng = np.random.default_rng(0)

    def boxes(cnt):
        xy = rng.uniform(0, 1242, (cnt, 2))
        wh = rng.uniform(1, 200, (cnt, 2))
        return torch.from_numpy(np.concatenate([xy, xy + wh], 1)
                                .astype(np.float32)).to(dev)
    a, b = boxes(24), boxes(12)
    out = torch.empty((24, 12), device=dev)
    iou_want = iou_ref.iou2d_ref(a, b)
    print(f"port iou2d 24x12: {timed(lambda: iou_ops.iou2d(a, b)):.5f} ms",
          flush=True)
    print(f"PyTorch zero_() of the (24, 12) output: {timed(out.zero_):.5f} ms",
          flush=True)
    for mode, what, check in (
            (0, "the division on every pair", iou_want),
            (1, "a constant stored, no loads", torch.zeros_like(iou_want)),
            (2, "a multiply in place of the division", None),
            (3, "the division skipped where the intersection is 0 (the "
             "port's design)", iou_want)):
        def run(mode=mode):
            if dll.k2_probe(mode, a.data_ptr(), 24, b.data_ptr(), 12,
                            out.data_ptr(), stream()):
                sys.exit(f"k1_k2_probes: K2 mode {mode} failed")
        out.fill_(-7)
        run()
        torch.cuda.synchronize()
        if check is not None and not torch.equal(out, check):
            sys.exit(f"k1_k2_probes: K2 mode {mode} wrong")
        if check is None and bool((out == -7).any()):
            sys.exit(f"k1_k2_probes: K2 mode {mode} left outputs unwritten")
        print(f"probe K2 [{what}]: {timed(run):.5f} ms", flush=True)


if __name__ == "__main__":
    main()
