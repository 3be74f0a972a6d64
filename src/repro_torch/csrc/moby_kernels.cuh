// Shared declarations for the hand-written Hopper kernels of repro_torch.
//
// Every entry point has a plain C interface (loaded with ctypes by
// repro_torch/kernels/_build.py): device pointers and the CUDA stream
// arrive as void*, sizes as 64-bit or 32-bit integers. Each entry point
// launches on the given stream, never synchronises, allocates nothing, and
// returns cudaGetLastError() so that a refused launch is reported where it
// happened.
#pragma once

#include <cuda_runtime.h>

#define MOBY_API extern "C" __attribute__((visibility("default")))

// Threads per block for the 1-D elementwise kernels.
constexpr int kMobyThreads = 256;
// Grid-stride kernels never launch more than this many blocks per SM.
constexpr int kMobyBlocksPerSm = 8;
