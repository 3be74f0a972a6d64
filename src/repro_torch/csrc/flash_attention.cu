// Blocked online-softmax attention (prefill), GQA-aware.
//
// Replaces the TPU kernel
// repro/kernels/flash_attention/flash_attention.py (flash_attention_pallas).
// This is the f32 route: f32 inputs, and bf16 at head dims 16, 32 and 64.
// bf16 at head dim 128 (the full-width dense configs) runs on the tensor
// cores in flash_attention_tc.cu; kernels/flash_attention/ops.py::route
// chooses.
//
// What bounds it on an H100: operations. At the serving shape of prefill
// (B=1, H=16, KV=2, S=8192, hd=128, causal) a call does ~2.75e11 flops on
// ~75 MB of q/k/v/o: 4.1 ms of float32 arithmetic outside the tensor cores
// at 67 TFLOP/s, 0.28 ms on bf16 tensor cores, and 0.02 ms of memory.
// This kernel computes in float32 on the SIMT cores (no wgmma, no TMA):
// its floor at that shape would be the 4.1 ms.
//
// Design: one block of 256 threads per (64-row query tile, b*h); four
// threads share a query row, each holding a quarter of the head dims of q
// and of the f32 accumulator in registers, in 4-wide groups so shared
// memory is read as float4. Key/value tiles of 64 positions are staged in
// dynamic shared memory as f32 (64 KB at hd=128, above the 48 KB static
// limit). A row's partial dot products meet through two warp shuffles.
// The loop over key tiles stops at the causal limit of the query tile;
// inside the diagonal tile and past sk the scores are masked to the
// Pallas kernel's finite -1e30, and masked keys contribute p = 0, so a row
// with no live key gives 0 (as the Pallas kernel does). The causal grid
// runs its heaviest query tiles first. Operands are read through element
// strides (the head dim contiguous), so the caller passes transposed views
// of its (B, S, heads, hd) layouts and nothing is copied; ragged edges are
// masked, nothing is padded. Inputs f32 or bf16 are widened to f32;
// scores, the running max and sum and the accumulator are f32; the output
// is cast back to the input type (round to nearest even). Products are
// explicit fmaf (the library builds with -fmad=false).
#include <cuda_bf16.h>

#include "moby_kernels.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kBq = 64;                // query rows per block
constexpr int kBk = 64;                // key positions per shared tile
constexpr int kTpr = 4;                // threads per query row
constexpr int kThreads = kBq * kTpr;   // 256

struct Strides {                       // in elements; the head dim has stride 1
  long long b, h, s;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Thread `part` of a row owns head dims c*16 + part*4 + {0..3}.
__device__ __forceinline__ int dim_of(int c, int part) {
  return c * (4 * kTpr) + part * 4;
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, Strides qs,
                 const T* __restrict__ k, Strides ks,
                 const T* __restrict__ v, Strides vs,
                 T* __restrict__ o, Strides os, int n_heads, int group,
                 int sq, int sk, int causal, float scale) {
  static_assert(HD % (4 * kTpr) == 0, "head dim must be a multiple of 16");
  constexpr int kChunks = HD / (4 * kTpr);   // float4 groups per thread
  extern __shared__ float4 smem4[];
  float* k_tile = reinterpret_cast<float*>(smem4);   // [kBk][HD]
  float* v_tile = k_tile + kBk * HD;                  // [kBk][HD]

  const int bh = blockIdx.y;
  const int b = bh / n_heads, h = bh % n_heads, kvh = h / group;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * kBq;
  const int row = threadIdx.x / kTpr, part = threadIdx.x % kTpr;
  const int qi = q0 + row;
  const bool row_ok = qi < sq;

  float qr[kChunks][4];
  float acc[kChunks][4];
  const T* qp = q + b * qs.b + h * qs.h + (row_ok ? qi : 0) * qs.s;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      qr[c][t] = row_ok ? widen(qp[dim_of(c, part) + t]) : 0.0f;
      acc[c][t] = 0.0f;
    }
  float m = kNeg, l = 0.0f;

  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  // Keys past the tile's last query row are masked for every row.
  const int k_end = causal ? min(sk, q0 + kBq) : sk;
  for (int k0 = 0; k0 < k_end; k0 += kBk) {
    __syncthreads();   // the previous tile is consumed
    for (int e = threadIdx.x; e < kBk * HD; e += kThreads) {
      const int j = e / HD, d = e % HD, kj = k0 + j;
      float kx = 0.0f, vx = 0.0f;
      if (kj < sk) {
        kx = widen(kb[kj * ks.s + d]);
        vx = widen(vb[kj * vs.s + d]);
      }
      k_tile[e] = kx;
      v_tile[e] = vx;
    }
    __syncthreads();

    float s[kBk];
    float tile_max = kNeg;
#pragma unroll
    for (int j = 0; j < kBk; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(k_tile + j * HD);
      float dot = 0.0f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 kk = kr[dim_of(c, part) / 4];
        dot = fmaf(qr[c][0], kk.x, dot);
        dot = fmaf(qr[c][1], kk.y, dot);
        dot = fmaf(qr[c][2], kk.z, dot);
        dot = fmaf(qr[c][3], kk.w, dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kj = k0 + j;
      const bool live = kj < sk && (!causal || kj <= qi);
      s[j] = live ? dot * scale : kNeg;
      tile_max = fmaxf(tile_max, s[j]);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.0f;
#pragma unroll
    for (int j = 0; j < kBk; ++j) {
      const int kj = k0 + j;
      const bool live = kj < sk && (!causal || kj <= qi);
      s[j] = live ? expf(s[j] - m_new) : 0.0f;   // s now holds p
      psum += s[j];
    }
    l = l * corr + psum;
    m = m_new;
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
#pragma unroll
      for (int t = 0; t < 4; ++t) acc[c][t] *= corr;
#pragma unroll
    for (int j = 0; j < kBk; ++j) {
      const float4* vr = reinterpret_cast<const float4*>(v_tile + j * HD);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const float4 vv = vr[dim_of(c, part) / 4];
        acc[c][0] = fmaf(s[j], vv.x, acc[c][0]);
        acc[c][1] = fmaf(s[j], vv.y, acc[c][1]);
        acc[c][2] = fmaf(s[j], vv.z, acc[c][2]);
        acc[c][3] = fmaf(s[j], vv.w, acc[c][3]);
      }
    }
  }

  if (!row_ok) return;
  const float denom = fmaxf(l, 1e-30f);
  T* op = o + b * os.b + h * os.h + qi * os.s;
#pragma unroll
  for (int c = 0; c < kChunks; ++c)
#pragma unroll
    for (int t = 0; t < 4; ++t)
      narrow(op + dim_of(c, part) + t, acc[c][t] / denom);
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int batch, int n_heads, int n_kv_heads,
           int sq, int sk, int causal, float scale, cudaStream_t stream) {
  constexpr int kSmem = 2 * kBk * HD * static_cast<int>(sizeof(float));
  auto kernel = flash_fwd_kernel<HD, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBq - 1) / kBq, batch * n_heads);
  kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), Strides{st[0], st[1], st[2]},
      static_cast<const T*>(k), Strides{st[3], st[4], st[5]},
      static_cast<const T*>(v), Strides{st[6], st[7], st[8]},
      static_cast<T*>(o), Strides{st[9], st[10], st[11]}, n_heads,
      n_heads / n_kv_heads, sq, sk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int head_dim, const void* q, const void* k, const void* v,
             void* o, const long long* st, int batch, int n_heads,
             int n_kv_heads, int sq, int sk, int causal, float scale,
             cudaStream_t stream) {
  switch (head_dim) {
    case 16: return launch<16, T>(q, k, v, o, st, batch, n_heads, n_kv_heads,
                                  sq, sk, causal, scale, stream);
    case 32: return launch<32, T>(q, k, v, o, st, batch, n_heads, n_kv_heads,
                                  sq, sk, causal, scale, stream);
    case 64: return launch<64, T>(q, k, v, o, st, batch, n_heads, n_kv_heads,
                                  sq, sk, causal, scale, stream);
    case 128: return launch<128, T>(q, k, v, o, st, batch, n_heads,
                                    n_kv_heads, sq, sk, causal, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B,H,SQ,hd), k/v (B,KV,SK,hd), o (B,H,SQ,hd), each through element
// strides st = {q: b,h,s, k: b,h,s, v: b,h,s, o: b,h,s} with the head dim
// contiguous. is_bf16 selects bf16 for all four, else f32. hd is 16, 32,
// 64 or 128; H is a multiple of KV.
MOBY_API int moby_flash_attention(const void* q, const void* k, const void* v,
                                  void* o, const long long* st, int batch,
                                  int n_heads, int n_kv_heads, int sq, int sk,
                                  int head_dim, int causal, int is_bf16,
                                  float scale, void* stream) {
  if (batch * n_heads == 0 || sq == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16
      ? dispatch<__nv_bfloat16>(head_dim, q, k, v, o, st, batch, n_heads,
                                n_kv_heads, sq, sk, causal, scale, s)
      : dispatch<float>(head_dim, q, k, v, o, st, batch, n_heads, n_kv_heads,
                        sq, sk, causal, scale, s);
}
