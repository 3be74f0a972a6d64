#!/usr/bin/env python3
"""What mma.sync's TF32 products can reach on the card, and what other
instructions cost beside them: the ceiling of the 3xTF32 flash attention
route (``src/repro_torch/csrc/flash_attention.cu``).

    python3 tools/mma_sync_rate.py

Needs one CUDA card and ``nvcc``; builds a small library into
``build/mma_sync_rate/`` and prints, for 132 blocks of 8 warps each issuing
8 independent chains of ``mma.sync.m16n8k8`` TF32 products (and, for
comparison, ``m16n8k16`` bf16): TFLOP/s; then the cycles a product takes
on a sub-partition (two warps) when each product is followed by k
independent 32-bit integer adds, float adds, or both in the ratio of the
route's splits (two integer operations to one float), at the nominal
1.755 GHz clock.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "build" / "mma_sync_rate"
SOURCE = r'''
#include <cuda_runtime.h>
#include <stdint.h>
// KIND: 0 integer adds, 1 float adds, 2 two integer adds to one float add;
// K of them after each product. BF16: m16n8k16 bf16 products instead.
template <int K, int KIND, bool BF16>
__global__ void bench(float* out, int iters, uint32_t seed) {
  float acc[8][4];
  for (int i = 0; i < 8; ++i) for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const uint32_t a[4] = {seed, seed * 3, seed * 5, seed * 7};
  const uint32_t b[2] = {seed * 11, seed * 13};
  uint32_t x[8];
  float f[8];
  for (int i = 0; i < 8; ++i) {
    x[i] = seed * (i + 17) + threadIdx.x;
    f[i] = __uint_as_float(x[i] & 0x3fffffffu);
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (BF16)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[i][0]), "+f"(acc[i][1]), "+f"(acc[i][2]), "+f"(acc[i][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[i][0]), "+f"(acc[i][1]), "+f"(acc[i][2]), "+f"(acc[i][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (KIND == 1 || (KIND == 2 && k % 3 == 2))
          asm volatile("add.f32 %0, %0, 0f3F800000;" : "+f"(f[k % 8]));
        else
          asm volatile("add.u32 %0, %0, 4096;" : "+r"(x[k % 8]));
      }
    }
  }
  float s = 0;
  for (int i = 0; i < 8; ++i) {
    for (int j = 0; j < 4; ++j) s += acc[i][j];
    s += f[i] + x[i];
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
template <int K, int KIND, bool BF16>
int go(float* out, int blocks, int iters) {
  bench<K, KIND, BF16><<<blocks, 256>>>(out, iters, 0x3f800000u);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int run(int k, int kind, int bf16, float* out, int blocks,
                   int iters) {
  if (bf16) return go<0, 0, true>(out, blocks, iters);
#define CASE(K) if (k == K) return kind == 0 ? go<K, 0, false>(out, blocks, iters) \
    : kind == 1 ? go<K, 1, false>(out, blocks, iters) : go<K, 2, false>(out, blocks, iters);
  CASE(0) CASE(2) CASE(4) CASE(6) CASE(8) CASE(12)
  return -1;
}
'''


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        sys.exit("mma_sync_rate: torch sees no CUDA device")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "bench.cu").write_text(SOURCE)
    nvcc = "/usr/local/cuda/bin/nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o",
                    str(OUT / "bench.so"), str(OUT / "bench.cu")], check=True)
    lib = ctypes.CDLL(str(OUT / "bench.so"))
    lib.run.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] + [ctypes.c_int] * 2
    out = torch.empty(132 * 256, device="cuda")
    blocks, iters = 132, 4096

    def timed(k, kind, bf16):
        if lib.run(k, kind, bf16, out.data_ptr(), blocks, 16):
            sys.exit("mma_sync_rate: launch failed")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        lib.run(k, kind, bf16, out.data_ptr(), blocks, iters)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    products = blocks * 8 * iters * 8            # 8 warps a block
    for bf16, name, flop in ((0, "tf32 m16n8k8", 2 * 16 * 8 * 8),
                             (1, "bf16 m16n8k16", 2 * 16 * 8 * 16)):
        ms = timed(0, 0, bf16)
        print(f"{name}: {products * flop / (ms * 1e-3) / 1e12:.1f} TFLOP/s "
              f"({ms:.3f} ms)")
    for kind, name in ((0, "integer adds"), (1, "float adds"),
                       (2, "2 integer : 1 float")):
        cycles = []
        for k in (0, 2, 4, 6, 8, 12):
            ms = timed(k, kind, 0)
            # two warps a sub-partition issue 2 * iters * 8 products each
            cycles.append(f"{k}: {ms * 1e-3 * 1.755e9 / (iters * 8 * 2):.2f}")
        print(f"tf32 product + k {name}, cycles a product a sub-partition: "
              + ", ".join(cycles))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
