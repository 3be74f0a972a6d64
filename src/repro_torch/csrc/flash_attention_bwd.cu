// Backward pass of blocked softmax attention (prefill), GQA-aware: dQ, dK
// and dV from Q, K, V, the forward's output O and its cotangent dO.
//
// Replaces the VJP around the TPU kernel: repro/ops/api.py (_flash_bwd),
// jax.vjp of repro/models/layers.py::_chunked_attention, which recomputes
// the scores a query block at a time. Its plain version is
// kernels/flash_attention/ref.py::flash_attention_bwd_ref:
//   A = softmax(scale Q.K^T) with the forward's masking (masked keys give
//   p = 0, the causal limit kj <= qi, keys past sk masked),
//   dV = A^T dO, dP = dO V^T, dS = A * (dP - rowsum(dO * O)),
//   dQ = scale dS K, dK = scale dS^T Q,
// with the G = H / KV query heads of a kv head summed into its dK and dV.
//
// What bounds it on an H100: operations. At the training shape (B=1,
// H=16, KV=2, S=4096, hd=128, causal) the five products of the gradient
// are 1.7e11 flops on ~40 MB of inputs and outputs: 2.6 ms of float32
// arithmetic outside the tensor cores at 67 TFLOP/s (0.17 ms at the bf16
// tensor rate), against 0.012 ms of memory. This kernel is SIMT f32
// (fused multiply-adds on the CUDA cores), accurate to f32 in both input
// types, and recomputes more than the minimum: eight 64x64xhd products a
// (query block, key block) pair instead of five. It takes the "tf32x3"
// route of kernels/flash_attention/ops.py::route: f32 at every head dim,
// bf16 at head dims 16-64. bf16 at head dim 128 (training's route) runs
// flash_attention_bwd_tc.cu on the tensor cores; 3xTF32 tensor-core
// products for f32, as flash_attention.cu, are later work (ROADMAP).
//
// Design, deterministic and without float atomics (three launches of one
// entry point, in stream order):
// * dq_kernel, a block per (query block of 64 rows, b, h), the heaviest
//   causal blocks first: Q and dO tiles in shared memory (f32), D =
//   rowsum(dO * O) from global O; pass 1 walks the key tiles for the rows'
//   max m and sum l (online, as the forward); pass 2 walks them again: S,
//   P = exp(S - m) / l, dP = dO V^T, dS = P (dP - D) into shared memory,
//   dQ += dS K in registers (each key tile's product summed on its own,
//   then added: see add_product). Writes dQ and the rows' (m, l, D);
// * dkv_kernel, a block per (key block, b, query head), heaviest first:
//   K and V tiles stay in shared memory while the block walks the query
//   tiles that see its keys, recomputing S^T and P^T from (m, l), dP^T =
//   V dO^T, and accumulating dV += P^T dO and dK += dS^T Q in registers.
//   One block a query head keeps 8 x the blocks of one a kv head busy at
//   GQA, and the causal imbalance spread; each writes f32 partials;
// * reduce_kernel sums the G partials of each kv head in head order and
//   rounds once to the input type.
// Tiles are 64 x hd f32 in shared memory, rows padded by 4 floats (16-byte
// aligned rows; the float4 reads of a warp then fall on distinct banks).
// 256 threads a block: thread (ty, tx) = (tid / 16, tid % 16) owns rows
// ty + 16 i and columns tx + 16 j of a 64 x 64 tile, so a row's 16 owners
// are one half-warp (its max and sum by four shuffles). Inputs are read
// through their strides by 16-byte loads (the wrapper checks 16-byte
// aligned bases and strides); outputs are written through theirs. The
// library builds with -fmad=false: every multiply-add here is an explicit
// __fmaf_rn, and exp and division are the IEEE-accurate expf and '/'.
#include <cuda_bf16.h>
#include <stdint.h>

#include "moby_kernels.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kB = 64;              // rows of a tile (queries or keys)
constexpr int kThreads = 256;
constexpr int kLdP = kB + 4;        // row stride of the 64 x 64 P/dS tile
constexpr int kMaxSmem = 232448;    // dynamic shared memory a block may use

struct Strides {                    // in elements; the head dim has stride 1
  long long b, h, s;
};

struct Args {
  const void *q, *k, *v, *o, *dout;
  void *dq, *dk, *dv;
  float* stats;                     // (3, B*H, SQ): m, l, D
  float* part;                      // (2, B*H, SK, hd): dK, dV partials
  Strides sq_, sk_, sv_, so_, sdo_, sdq_, sdk_, sdv_;
  int h, kv, sq, sk;
  int causal;
  float scale;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 16 bytes of T widened to f32.
__device__ __forceinline__ void widen16(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
}
__device__ __forceinline__ void widen16(const __nv_bfloat16* src,
                                        float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dst[2 * i] = __uint_as_float(w[i] << 16);
    dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <int D>
__host__ __device__ constexpr int ld() { return D + 4; }

template <int D>
__host__ __device__ constexpr int smem_bytes() {
  return (4 * kB * ld<D>() + kB * kLdP + 3 * kB) * 4;
}

// Rows [0, rows) of a 64 x D tile (row r at src + r * rs) into dst (f32,
// row stride D + 4); rows past `rows` are zero.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long rs, int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int c = threadIdx.x; c < kB * kPerRow; c += kThreads) {
    const int r = c / kPerRow, col = c % kPerRow * kVec;
    float vals[kVec];
    if (r < rows) {
      widen16(src + r * rs + col, vals);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) vals[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; e += 4)
      *reinterpret_cast<float4*>(dst + r * ld<D>() + col + e) =
          make_float4(vals[e], vals[e + 1], vals[e + 2], vals[e + 3]);
  }
}

// c[i][j] += sum_k A[ty + 16 i][k] * B[tx + 16 j][k], k < D (A, B: 64 x D
// tiles, row stride D + 4), summed in k order.
template <int D>
__device__ __forceinline__ void mm_nt(const float* a, const float* b,
                                      float (&c)[4][4], int ty, int tx) {
#pragma unroll 2
  for (int k = 0; k < D; k += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * ld<D>()
                                               + k);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * ld<D>()
                                               + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        c[i][j] = __fmaf_rn(av[i].x, bv[j].x, c[i][j]);
        c[i][j] = __fmaf_rn(av[i].y, bv[j].y, c[i][j]);
        c[i][j] = __fmaf_rn(av[i].z, bv[j].z, c[i][j]);
        c[i][j] = __fmaf_rn(av[i].w, bv[j].w, c[i][j]);
      }
  }
}

// c[i][j] += sum_k A[ty + 16 i][k] * B[k][tx + 16 j], k < 64 (A: the
// 64 x 64 tile, row stride kLdP; B: a 64 x D tile), summed in k order.
template <int D>
__device__ __forceinline__ void mm_nn(const float* a, const float* b,
                                      float (&c)[4][D / 16], int ty,
                                      int tx) {
  constexpr int kN = D / 16;
#pragma unroll 2
  for (int k = 0; k < kB; k += 4) {
    float4 av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty + 16 * i) * kLdP + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float bv[kN];
#pragma unroll
      for (int j = 0; j < kN; ++j) bv[j] = b[(k + kk) * ld<D>() + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = kk == 0 ? av[i].x : kk == 1 ? av[i].y
                        : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
        for (int j = 0; j < kN; ++j) c[i][j] = __fmaf_rn(x, bv[j], c[i][j]);
      }
    }
  }
}

// acc += A.B for one 64-row tile of the sum: the tile's product is summed
// on its own, then added, so a gradient summed over S rows adds S / 64
// tile sums of 64 terms (f32 rounding grows with the longest chain, 64
// and S / 64, not S).
template <int D>
__device__ __forceinline__ void add_product(const float* a, const float* b,
                                            float (&acc)[4][D / 16], int ty,
                                            int tx) {
  float part[4][D / 16] = {};
  mm_nn<D>(a, b, part, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] += part[i][j];
}

// Reductions over the 16 lanes of a half-warp (a tile row's owners).
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int off = 8; off; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ bool live(int qi, int kj, const Args& a) {
  return qi < a.sq && kj < a.sk && (!a.causal || kj <= qi);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* dos = qs + kB * ld<D>();
  float* ks = dos + kB * ld<D>();
  float* vs = ks + kB * ld<D>();
  float* ps = vs + kB * ld<D>();
  constexpr int kN = D / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int n_qb = (a.sq + kB - 1) / kB;
  const int qb = a.causal ? n_qb - 1 - blockIdx.x : blockIdx.x;
  const int bh = blockIdx.y, b = bh / a.h, h = bh % a.h;
  const int kvh = h / (a.h / a.kv);
  const int q0 = qb * kB, rows = min(kB, a.sq - q0);
  const T* qp = static_cast<const T*>(a.q) + b * a.sq_.b + h * a.sq_.h +
                q0 * a.sq_.s;
  const T* dop = static_cast<const T*>(a.dout) + b * a.sdo_.b +
                 h * a.sdo_.h + q0 * a.sdo_.s;
  const T* op = static_cast<const T*>(a.o) + b * a.so_.b + h * a.so_.h +
                q0 * a.so_.s;
  const T* kp = static_cast<const T*>(a.k) + b * a.sk_.b + kvh * a.sk_.h;
  const T* vp = static_cast<const T*>(a.v) + b * a.sv_.b + kvh * a.sv_.h;
  load_tile<D>(qs, qp, a.sq_.s, rows);
  load_tile<D>(dos, dop, a.sdo_.s, rows);
  __syncthreads();

  // D = rowsum(dO * O), O as the forward stored it.
  float dsum[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    float acc = 0.f;
    if (r < rows)
      for (int d = tx; d < D; d += 16)
        acc = __fmaf_rn(dos[r * ld<D>() + d], widen(op[r * a.so_.s + d]),
                        acc);
    dsum[i] = half_sum(acc);
  }

  const int n_kb_all = (a.sk + kB - 1) / kB;
  const int n_kb = a.causal ? min(n_kb_all, (q0 + rows - 1) / kB + 1)
                            : n_kb_all;
  // Pass 1: each row's max and sum over its live keys.
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = kNeg; l[i] = 0.f; }
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kB;
    load_tile<D>(ks, kp + k0 * a.sk_.s, a.sk_.s, min(kB, a.sk - k0));
    __syncthreads();
    float s[4][4] = {};
    mm_nt<D>(qs, ks, s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = live(qi, k0 + tx + 16 * j, a) ? s[i][j] * a.scale : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (live(qi, k0 + tx + 16 * j, a)) sum += expf(s[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + half_sum(sum);
      m[i] = m_new;
    }
    __syncthreads();
  }

  // Pass 2: dQ = sum over key tiles of dS K.
  float dq[4][kN] = {};
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kB, krows = min(kB, a.sk - k0);
    load_tile<D>(ks, kp + k0 * a.sk_.s, a.sk_.s, krows);
    load_tile<D>(vs, vp + k0 * a.sv_.s, a.sv_.s, krows);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mm_nt<D>(qs, ks, s, ty, tx);
    mm_nt<D>(dos, vs, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = live(qi, k0 + tx + 16 * j, a)
                            ? expf(s[i][j] * a.scale - m[i]) / l[i] : 0.f;
        ps[(ty + 16 * i) * kLdP + tx + 16 * j] = p * (dp[i][j] - dsum[i]);
      }
    }
    __syncthreads();
    add_product<D>(ps, ks, dq, ty, tx);
    __syncthreads();
  }

  T* dqp = static_cast<T*>(a.dq) + b * a.sdq_.b + h * a.sdq_.h +
           q0 * a.sdq_.s;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < kN; ++j)
      narrow(dqp + r * a.sdq_.s + tx + 16 * j, dq[i][j] * a.scale);
    if (tx == 0) {
      const long long row = static_cast<long long>(bh) * a.sq + q0 + r;
      const long long plane = static_cast<long long>(gridDim.y) * a.sq;
      a.stats[row] = m[i];
      a.stats[plane + row] = l[i];
      a.stats[2 * plane + row] = dsum[i];
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1) dkv_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + kB * ld<D>();
  float* qs = vs + kB * ld<D>();
  float* dos = qs + kB * ld<D>();
  float* ps = dos + kB * ld<D>();
  float* rm = ps + kB * kLdP;
  float* rl = rm + kB;
  float* rd = rl + kB;
  constexpr int kN = D / 16;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int kb = blockIdx.x, k0 = kb * kB, krows = min(kB, a.sk - k0);
  const int b = blockIdx.y;
  const int h = blockIdx.z, kvh = h / (a.h / a.kv);
  const int bh = b * a.h + h;
  load_tile<D>(ks, static_cast<const T*>(a.k) + b * a.sk_.b +
               kvh * a.sk_.h + k0 * a.sk_.s, a.sk_.s, krows);
  load_tile<D>(vs, static_cast<const T*>(a.v) + b * a.sv_.b +
               kvh * a.sv_.h + k0 * a.sv_.s, a.sv_.s, krows);
  const T* qp = static_cast<const T*>(a.q) + b * a.sq_.b + h * a.sq_.h;
  const T* dop = static_cast<const T*>(a.dout) + b * a.sdo_.b +
                 h * a.sdo_.h;
  const long long plane = static_cast<long long>(gridDim.y) * a.h * a.sq;

  float dk[4][kN] = {}, dv[4][kN] = {};
  const int n_qb = (a.sq + kB - 1) / kB;
  // Causal: query rows below k0 see none of these keys.
  for (int qb = a.causal ? kb : 0; qb < n_qb; ++qb) {
    const int q0 = qb * kB, rows = min(kB, a.sq - q0);
    __syncthreads();    // the previous tile's readers are done
    load_tile<D>(qs, qp + q0 * a.sq_.s, a.sq_.s, rows);
    load_tile<D>(dos, dop + q0 * a.sdo_.s, a.sdo_.s, rows);
    if (threadIdx.x < kB) {
      const int r = threadIdx.x;
      const long long row = static_cast<long long>(bh) * a.sq + q0 + r;
      rm[r] = r < rows ? a.stats[row] : 0.f;
      rl[r] = r < rows ? a.stats[plane + row] : 1.f;
      rd[r] = r < rows ? a.stats[2 * plane + row] : 0.f;
    }
    __syncthreads();
    // Thread (ty, tx): keys k0 + ty + 16 i, queries q0 + tx + 16 j.
    float s[4][4] = {}, dp[4][4] = {};
    mm_nt<D>(ks, qs, s, ty, tx);
    mm_nt<D>(vs, dos, dp, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tx + 16 * j;
        const float p = live(q0 + r, k0 + ty + 16 * i, a)
                            ? expf(s[i][j] * a.scale - rm[r]) / rl[r] : 0.f;
        ps[(ty + 16 * i) * kLdP + r] = p;
        dp[i][j] = p * (dp[i][j] - rd[r]);     // dS^T
      }
    __syncthreads();
    add_product<D>(ps, dos, dv, ty, tx);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(ty + 16 * i) * kLdP + tx + 16 * j] = dp[i][j];
    __syncthreads();
    add_product<D>(ps, qs, dk, ty, tx);
  }

  // Partials of this query head: (2, B*H, SK, D) f32.
  const long long half = static_cast<long long>(gridDim.y) * a.h * a.sk * D;
  float* out = a.part + (static_cast<long long>(bh) * a.sk + k0) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ty + 16 * i;
    if (c >= krows) continue;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      out[c * D + tx + 16 * j] = dk[i][j] * a.scale;
      out[half + c * D + tx + 16 * j] = dv[i][j];
    }
  }
}

// dK, dV of each kv head: its G query heads' partials summed in head order.
template <int D, typename T>
__global__ void reduce_kernel(Args a, int batch) {
  const int g = a.h / a.kv;
  const long long n = static_cast<long long>(batch) * a.kv * a.sk * D;
  const long long half = static_cast<long long>(batch) * a.h * a.sk * D;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int d = static_cast<int>(i % D);
    const long long row = i / D;
    const int c = static_cast<int>(row % a.sk);
    const int bkv = static_cast<int>(row / a.sk);
    const int b = bkv / a.kv, kvh = bkv % a.kv;
    const float* src = a.part +
        ((static_cast<long long>(b) * a.h + kvh * g) * a.sk + c) * D + d;
    float sk = 0.f, sv = 0.f;
    for (int j = 0; j < g; ++j) {
      sk += src[j * static_cast<long long>(a.sk) * D];
      sv += src[half + j * static_cast<long long>(a.sk) * D];
    }
    narrow(static_cast<T*>(a.dk) + b * a.sdk_.b + kvh * a.sdk_.h +
           c * a.sdk_.s + d, sk);
    narrow(static_cast<T*>(a.dv) + b * a.sdv_.b + kvh * a.sdv_.h +
           c * a.sdv_.s + d, sv);
  }
}

template <int D, typename T>
int launch(const Args& a, int batch, cudaStream_t s) {
  constexpr int kBytes = smem_bytes<D>();
  static_assert(kBytes <= kMaxSmem, "shared memory");
  auto dq_fn = dq_kernel<D, T>;
  auto dkv_fn = dkv_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      dq_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        dkv_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // No keys: dQ is 0 (pass 2 runs no tile); no queries: dK and dV are 0
  // (no query tile reaches a key block).
  const int n_qb = (a.sq + kB - 1) / kB, n_kb = (a.sk + kB - 1) / kB;
  if (n_qb) {
    dq_fn<<<dim3(n_qb, batch * a.h), kThreads, kBytes, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (!n_kb) return 0;
  dkv_fn<<<dim3(n_kb, batch, a.h), kThreads, kBytes, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(batch) * a.kv * a.sk * D /
                         kMobyThreads + 1;
  const int blocks = static_cast<int>(rows < 132 * kMobyBlocksPerSm
                                          ? rows : 132 * kMobyBlocksPerSm);
  reduce_kernel<D, T><<<blocks, kMobyThreads, 0, s>>>(a, batch);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int head_dim, const Args& a, int batch, cudaStream_t s) {
  switch (head_dim) {
    case 16: return launch<16, T>(a, batch, s);
    case 32: return launch<32, T>(a, batch, s);
    case 64: return launch<64, T>(a, batch, s);
    case 128: return launch<128, T>(a, batch, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, o, dout, dq (B,H,SQ,hd) and k, v, dk, dv (B,KV,SK,hd) through
// strides st[3 t .. 3 t + 2] = {b, head, s} for t = q, k, v, o, dout, dq,
// dk, dv; the head dim contiguous; the inputs 16-byte aligned. Scratch:
// stats (3, B*H, SQ) and part (2, B*H, SK, hd), f32. Inputs and outputs
// bf16 if is_bf16, else f32.
MOBY_API int moby_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* stats, void* part,
    const long long* st, int batch, int n_heads, int n_kv_heads, int sq,
    int sk, int head_dim, int causal, int is_bf16, float scale,
    void* stream) {
  if (batch * n_heads == 0) return 0;
  Args a{q, k, v, o, dout, dq, dk, dv, static_cast<float*>(stats),
         static_cast<float*>(part),
         {st[0], st[1], st[2]}, {st[3], st[4], st[5]},
         {st[6], st[7], st[8]}, {st[9], st[10], st[11]},
         {st[12], st[13], st[14]}, {st[15], st[16], st[17]},
         {st[18], st[19], st[20]}, {st[21], st[22], st[23]},
         n_heads, n_kv_heads, sq, sk, causal, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(head_dim, a, batch, s)
                 : dispatch<float>(head_dim, a, batch, s);
}
