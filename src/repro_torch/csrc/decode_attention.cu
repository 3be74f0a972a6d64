// Single-token decode attention over a KV cache (the serving step).
//
// Replaces the TPU kernel
// repro/kernels/decode_attention/decode_attention.py
// (decode_attention_pallas).
//
// What bounds it on an H100: bytes. Each request's G = H/KV query heads
// read the first cache_pos positions of their kv head's K and V once:
// at the serving shape (B=16, H=16, KV=2, hd=128, bf16, cache_pos ~20k on
// average) ~335 MB a call, 0.10 ms at 3.35 TB/s, against ~0.08 GFLOP.
//
// Design (flash-decoding): B*KV (b, kv-head) pairs alone would fill 32 of
// the 132 SMs, so the cache's S axis is also split, into chunks of 512
// positions, one block of 256 threads per (chunk, b, kv-head). A block
// whose chunk starts at or past the request's cache_pos (read on the
// device, no host sync) returns at once. A live block stages 64-position
// K/V tiles in shared memory as f32 and keeps the online-softmax state
// (m, l, acc) of its G heads in shared memory; warp w serves heads w,
// w+8, ...: lane j scores positions j and j+32 (float4 reads, K rows
// padded by 4 floats so the lanes hit distinct banks), the warp reduces
// the tile's max and sum, then each lane accumulates its head dims over
// the tile. The block writes its unnormalised partial (m, l, acc) to
// scratch the wrapper allocates; a second small kernel combines the live
// chunks of each (b, head) row and divides by max(l, 1e-30). Scores past
// cache_pos (and past S) are the Pallas kernel's finite -1e30 and add
// p = 0, so a request with cache_pos = 0 gives 0, as the Pallas kernel
// does. Operands come through element strides (the head dim contiguous):
// the caller passes (B, KV, S, hd) views of its (B, S, KV, hd) cache, and
// nothing is copied or padded. Inputs f32 or bf16 are widened to f32;
// all softmax state is f32; the output is cast back to the input type.
#include <cuda_bf16.h>

#include "moby_kernels.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kChunk = 512;    // cache positions per block
constexpr int kTile = 64;      // positions staged in shared memory at a time
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void narrow(float* p, float x) { *p = x; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Args {
  long long q_b, q_h;            // q (B, H, hd)
  long long k_b, k_h, k_s;       // cache_k (B, KV, S, hd)
  long long v_b, v_h, v_s;       // cache_v (B, KV, S, hd)
  int n_heads, n_kv_heads, s_len, n_chunks;
  float scale;
};

__host__ __device__ constexpr int k_row(int hd) { return hd + 4; }

// Shared memory of a partial block: q [G][HD], K [kTile][HD+4],
// V [kTile][HD], p [kWarps][kTile], m [G], l [G], acc [G][HD].
__host__ __device__ constexpr int partial_smem_floats(int hd, int g) {
  return g * hd + kTile * k_row(hd) + kTile * hd + kWarps * kTile + 2 * g +
         g * hd;
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const int* __restrict__ pos,
                      Args a, float* __restrict__ part_m,
                      float* __restrict__ part_l,
                      float* __restrict__ part_acc) {
  const int chunk = blockIdx.x;
  const int b = blockIdx.y / a.n_kv_heads, kvh = blockIdx.y % a.n_kv_heads;
  const int limit = min(pos[b], a.s_len);
  const int start = chunk * kChunk;
  if (start >= limit) return;   // the combine reads only live chunks
  const int end = min(start + kChunk, limit);
  const int group = a.n_heads / a.n_kv_heads;

  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + group * HD;
  float* v_s = k_s + kTile * k_row(HD);
  float* p_s = v_s + kTile * HD;
  float* m_s = p_s + kWarps * kTile;
  float* l_s = m_s + group;
  float* acc_s = l_s + group;

  const T* qb = q + b * a.q_b + (kvh * group) * a.q_h;
  for (int e = threadIdx.x; e < group * HD; e += kThreads) {
    const int g = e / HD, d = e % HD;
    q_s[e] = widen(qb[g * a.q_h + d]);
    acc_s[e] = 0.0f;
  }
  for (int g = threadIdx.x; g < group; g += kThreads) {
    m_s[g] = kNeg;
    l_s[g] = 0.0f;
  }
  const T* kb = k + b * a.k_b + kvh * a.k_h;
  const T* vb = v + b * a.v_b + kvh * a.v_h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  for (int t0 = start; t0 < end; t0 += kTile) {
    __syncthreads();   // q/state written, or the previous tile consumed
    for (int e = threadIdx.x; e < kTile * HD; e += kThreads) {
      const int j = e / HD, d = e % HD, sj = t0 + j;
      float kx = 0.0f, vx = 0.0f;
      if (sj < end) {
        kx = widen(kb[sj * a.k_s + d]);
        vx = widen(vb[sj * a.v_s + d]);
      }
      k_s[j * k_row(HD) + d] = kx;
      v_s[e] = vx;
    }
    __syncthreads();

    for (int g = warp; g < group; g += kWarps) {
      const float4* qr = reinterpret_cast<const float4*>(q_s + g * HD);
      float s[kTile / 32];
      float tile_max = kNeg;
#pragma unroll
      for (int r = 0; r < kTile / 32; ++r) {
        const int j = lane + 32 * r;
        const float4* kr =
            reinterpret_cast<const float4*>(k_s + j * k_row(HD));
        float dot = 0.0f;
#pragma unroll
        for (int c = 0; c < HD / 4; ++c) {
          const float4 qq = qr[c], kk = kr[c];
          dot = fmaf(qq.x, kk.x, dot);
          dot = fmaf(qq.y, kk.y, dot);
          dot = fmaf(qq.z, kk.z, dot);
          dot = fmaf(qq.w, kk.w, dot);
        }
        s[r] = t0 + j < end ? dot * a.scale : kNeg;
        tile_max = fmaxf(tile_max, s[r]);
      }
      tile_max = warp_max(tile_max);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, tile_max);
      const float corr = expf(m_old - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int r = 0; r < kTile / 32; ++r) {
        const int j = lane + 32 * r;
        const float p = t0 + j < end ? expf(s[r] - m_new) : 0.0f;
        p_s[warp * kTile + j] = p;
        psum += p;
      }
      psum = warp_sum(psum);
      const float l_old = l_s[g];
      __syncwarp();
      if (lane == 0) {
        m_s[g] = m_new;
        l_s[g] = l_old * corr + psum;
      }
      for (int d = lane; d < HD; d += 32) {
        float acc = acc_s[g * HD + d] * corr;
#pragma unroll 8
        for (int j = 0; j < kTile; ++j)
          acc = fmaf(p_s[warp * kTile + j], v_s[j * HD + d], acc);
        acc_s[g * HD + d] = acc;
      }
      __syncwarp();   // p_s is rewritten for the warp's next head
    }
  }
  __syncthreads();
  const int bh0 = b * a.n_heads + kvh * group;
  const long long rows = static_cast<long long>(gridDim.y) * group;
  for (int e = threadIdx.x; e < group * HD; e += kThreads) {
    const int g = e / HD, d = e % HD;
    part_acc[(chunk * rows + bh0 + g) * HD + d] = acc_s[e];
  }
  for (int g = threadIdx.x; g < group; g += kThreads) {
    part_m[chunk * rows + bh0 + g] = m_s[g];
    part_l[chunk * rows + bh0 + g] = l_s[g];
  }
}

// One block per (b, head) row: rescale the live chunks' partials to their
// common max and normalise. A row without a live chunk gives 0.
template <int HD, typename T>
__global__ void decode_combine_kernel(const int* __restrict__ pos, Args a,
                                      const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_acc,
                                      T* __restrict__ out) {
  const int row = blockIdx.x;
  const long long rows = gridDim.x;
  const int limit = min(pos[row / a.n_heads], a.s_len);
  const int live = limit > 0 ? (limit + kChunk - 1) / kChunk : 0;
  float m = kNeg;
  for (int c = 0; c < live; ++c) m = fmaxf(m, part_m[c * rows + row]);
  float l = 0.0f;
  for (int c = 0; c < live; ++c)
    l += part_l[c * rows + row] * expf(part_m[c * rows + row] - m);
  const float denom = fmaxf(l, 1e-30f);
  for (int d = threadIdx.x; d < HD; d += blockDim.x) {
    float acc = 0.0f;
    for (int c = 0; c < live; ++c)
      acc += part_acc[(c * rows + row) * HD + d] *
             expf(part_m[c * rows + row] - m);
    narrow(out + row * static_cast<long long>(HD) + d, acc / denom);
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* out, float* part_m, float* part_l, float* part_acc,
           int batch, const Args& a, cudaStream_t stream) {
  const int group = a.n_heads / a.n_kv_heads;
  const int smem = partial_smem_floats(HD, group) *
                   static_cast<int>(sizeof(float));
  auto partial = decode_partial_kernel<HD, T>;
  if (a.n_chunks > 0) {   // an empty cache has no partials
    cudaError_t err = cudaFuncSetAttribute(
        partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid(a.n_chunks, batch * a.n_kv_heads);
    partial<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const int*>(pos), a, part_m,
        part_l, part_acc);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_combine_kernel<HD, T><<<batch * a.n_heads, HD < 128 ? HD : 128, 0,
                                 stream>>>(
      static_cast<const int*>(pos), a, part_m, part_l, part_acc,
      static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int head_dim, const void* q, const void* k, const void* v,
             const void* pos, void* out, float* pm, float* pl, float* pa,
             int batch, const Args& a, cudaStream_t s) {
  switch (head_dim) {
    case 16: return launch<16, T>(q, k, v, pos, out, pm, pl, pa, batch, a, s);
    case 32: return launch<32, T>(q, k, v, pos, out, pm, pl, pa, batch, a, s);
    case 64: return launch<64, T>(q, k, v, pos, out, pm, pl, pa, batch, a, s);
    case 128: return launch<128, T>(q, k, v, pos, out, pm, pl, pa, batch, a,
                                    s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Positions per chunk of the split S axis: the wrapper sizes the scratch
// as ceil(S / chunk) chunks of (B*H) rows.
MOBY_API int moby_decode_attention_chunk() { return kChunk; }

// q (B,H,hd) through strides st[0..1] = {b, h}; cache_k/v (B,KV,S,hd)
// through st[2..4] and st[5..7] = {b, kv, s}; the head dim contiguous.
// pos (B,) int32 positions attended per request ([0, pos)). out (B,H,hd)
// contiguous, of the inputs' type (bf16 if is_bf16, else f32). Scratch:
// part_m, part_l (n_chunks, B*H) and part_acc (n_chunks, B*H, hd) f32,
// n_chunks = ceil(S / moby_decode_attention_chunk()).
MOBY_API int moby_decode_attention(const void* q, const void* k,
                                   const void* v, const void* pos, void* out,
                                   void* part_m, void* part_l, void* part_acc,
                                   const long long* st, int batch,
                                   int n_heads, int n_kv_heads, int s_len,
                                   int head_dim, int is_bf16, float scale,
                                   void* stream) {
  if (batch * n_heads == 0) return 0;
  const Args a{st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
               n_heads, n_kv_heads, s_len, (s_len + kChunk - 1) / kChunk,
               scale};
  const auto s = static_cast<cudaStream_t>(stream);
  auto* pm = static_cast<float*>(part_m);
  auto* pl = static_cast<float*>(part_l);
  auto* pa = static_cast<float*>(part_acc);
  return is_bf16 ? dispatch<__nv_bfloat16>(head_dim, q, k, v, pos, out, pm,
                                           pl, pa, batch, a, s)
                 : dispatch<float>(head_dim, q, k, v, pos, out, pm, pl, pa,
                                   batch, a, s);
}
