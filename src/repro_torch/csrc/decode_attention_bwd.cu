// Backward pass of single-token decode attention over a KV cache: dq, and
// the cotangents of the two caches, from q, the caches, the forward's
// output o and its cotangent do.
//
// Replaces the VJP around the TPU kernel: repro/ops/api.py (_decode_bwd),
// jax.vjp of repro/kernels/decode_attention/ref.py::decode_attention_ref
// (the int positions get no cotangent). Its plain version is
// kernels/decode_attention/ref.py::decode_attention_bwd_ref. For request
// b and query head h of kv head k (G = H / KV heads a kv head), over the
// live positions j < len = min(cache_pos[b], S):
//   a_j = softmax_j(scale q.k_j), D = do.o,
//   dV_j = sum_h a_hj do_h, dK_j = scale sum_h a_hj (do_h.v_j - D_h) q_h,
//   dq_h = scale sum_j a_hj (do_h.v_j - D_h) k_j,
// and dK_j = dV_j = 0 at positions j >= len (so a request with
// cache_pos = 0 gets zeros everywhere, as its forward gives 0).
//
// What bounds it on an H100: bytes. It reads the live part of both caches
// and writes two cache-sized cotangents: at the decode shape (B=16, H=16,
// KV=2, S=32768, hd=128, bf16, ragged positions) ~0.3 GB read and 0.54 GB
// written, ~0.25 ms at 3.35 TB/s, against ~7 GFLOP of f32 arithmetic.
//
// Design, deterministic and without atomics (three launches of one entry
// point, in stream order), the S axis split in chunks of kChunk positions
// as the forward splits it:
// * stats_kernel, a block per (chunk, b, kv head): each of the G heads'
//   max and sum of exp over the chunk's live scores (K read once);
// * main_kernel, a block per (chunk, b, kv head): the heads' (m, l)
//   combined from every live chunk in chunk order, D = do.o, then tiles of
//   kTile positions: K and V in shared memory (f32, rows padded by one
//   float so a warp's lanes, one position each, read distinct banks); the
//   G x kTile probabilities and dS = P (dP - D) in shared memory; dK and
//   dV of the tile's positions (lanes across the head dim, the G heads
//   summed in order) written through the cotangents' strides, and the
//   chunk's partial dq (G x hd, f32) accumulated in shared memory;
//   positions past len are written as zeros without arithmetic;
// * dq_kernel sums each (b, h)'s partial dq over the live chunks in chunk
//   order and rounds once to the input type.
// The arithmetic is f32 on the SIMT cores (explicit __fmaf_rn: the library
// builds with -fmad=false; IEEE expf and division). Operands come through
// element strides, the head dim contiguous, read by scalar loads (no
// alignment needed). The wrapper checks that a block's shared memory
// (moby_decode_attention_bwd_smem) fits the card.
#include <cuda_bf16.h>
#include <stdint.h>

#include "moby_kernels.cuh"

namespace {

constexpr float kNeg = -1e30f;
constexpr int kChunk = 256;        // positions a block
constexpr int kTile = 32;          // positions a shared tile
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const void *q, *k, *v, *o, *dout;
  const int* pos;
  void *dq, *dk, *dv;
  float *part_m, *part_l, *part_dq;
  // In elements, the head dim contiguous: q, o, dout, dq {b, h};
  // k, v, dk, dv {b, kv, s}.
  long long q_b, q_h, o_b, o_h, do_b, do_h, dq_b, dq_h;
  long long k_b, k_h, k_s, v_b, v_h, v_s, dk_b, dk_h, dk_s, dv_b, dv_h, dv_s;
  int h, kv, s_len, n_chunks;
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

__device__ __forceinline__ int live_len(const Args& a, int b) {
  return min(max(a.pos[b], 0), a.s_len);
}

// The G query heads of (b, kv head) from a (B, H, hd) tensor into dst
// (G x D f32).
template <int D, typename T>
__device__ __forceinline__ void load_heads(float* dst, const void* src,
                                           long long sb, long long sh,
                                           int b, int h0, int g) {
  const T* p = static_cast<const T*>(src) + b * sb + h0 * sh;
  for (int i = threadIdx.x; i < g * D; i += kThreads)
    dst[i] = widen(p[(i / D) * sh + i % D]);
}

// Positions [t0, t0 + kTile) of one kv head's cache into dst (kTile x
// (D + 1) f32); positions at or past `end` are zero.
template <int D, typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long ss, int t0, int end) {
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int j = i / D, d = i % D;
    dst[j * (D + 1) + d] = t0 + j < end ? widen(src[(t0 + j) * ss + d])
                                        : 0.f;
  }
}

__device__ __forceinline__ float dot(const float* x, const float* y, int n) {
  float acc = 0.f;
  for (int d = 0; d < n; ++d) acc = __fmaf_rn(x[d], y[d], acc);
  return acc;
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads) stats_kernel(Args a) {
  extern __shared__ float smem[];
  const int g = a.h / a.kv;
  float* qs = smem;                        // G x D
  float* ks = qs + g * D;                  // kTile x (D + 1)
  float* ss = ks + kTile * (D + 1);        // G x kTile
  float* mg = ss + g * kTile;              // G
  float* lg = mg + g;                      // G
  const int chunk = blockIdx.x, b = blockIdx.y / a.kv,
            kvh = blockIdx.y % a.kv;
  const int len = live_len(a, b), c0 = chunk * kChunk;
  if (c0 >= len) return;                   // a dead chunk: never read
  const int end = min(c0 + kChunk, len);
  load_heads<D, T>(qs, a.q, a.q_b, a.q_h, b, kvh * g, g);
  for (int i = threadIdx.x; i < g; i += kThreads) {
    mg[i] = kNeg;
    lg[i] = 0.f;
  }
  const T* kp = static_cast<const T*>(a.k) + b * a.k_b + kvh * a.k_h;
  for (int t0 = c0; t0 < end; t0 += kTile) {
    __syncthreads();
    load_rows<D, T>(ks, kp, a.k_s, t0, end);
    __syncthreads();
    for (int i = threadIdx.x; i < g * kTile; i += kThreads) {
      const int gi = i / kTile, j = i % kTile;
      ss[i] = t0 + j < end
                  ? dot(qs + gi * D, ks + j * (D + 1), D) * a.scale : kNeg;
    }
    __syncthreads();
    for (int gi = threadIdx.x; gi < g; gi += kThreads) {
      const int n = min(kTile, end - t0);
      float mx = mg[gi];
      for (int j = 0; j < n; ++j) mx = fmaxf(mx, ss[gi * kTile + j]);
      float sum = 0.f;
      for (int j = 0; j < n; ++j) sum += expf(ss[gi * kTile + j] - mx);
      lg[gi] = lg[gi] * expf(mg[gi] - mx) + sum;
      mg[gi] = mx;
    }
  }
  __syncthreads();
  const long long rows = static_cast<long long>(gridDim.y / a.kv) * a.h;
  for (int gi = threadIdx.x; gi < g; gi += kThreads) {
    const long long at = chunk * rows + b * a.h + kvh * g + gi;
    a.part_m[at] = mg[gi];
    a.part_l[at] = lg[gi];
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads) main_kernel(Args a) {
  extern __shared__ float smem[];
  const int g = a.h / a.kv;
  float* qs = smem;                        // G x D
  float* dos = qs + g * D;                 // G x D
  float* dqp = dos + g * D;                // G x D
  float* ks = dqp + g * D;                 // kTile x (D + 1)
  float* vs = ks + kTile * (D + 1);        // kTile x (D + 1)
  float* ps = vs + kTile * (D + 1);        // G x kTile
  float* dss = ps + g * kTile;             // G x kTile
  float* mg = dss + g * kTile;             // G
  float* lg = mg + g;
  float* dg = lg + g;
  const int chunk = blockIdx.x, b = blockIdx.y / a.kv,
            kvh = blockIdx.y % a.kv;
  const int len = live_len(a, b), c0 = chunk * kChunk;
  const int stop = min(c0 + kChunk, a.s_len);
  T* dkp = static_cast<T*>(a.dk) + b * a.dk_b + kvh * a.dk_h;
  T* dvp = static_cast<T*>(a.dv) + b * a.dv_b + kvh * a.dv_h;
  if (c0 >= len) {                         // a dead chunk: zeros
    for (int i = threadIdx.x; i < (stop - c0) * D; i += kThreads) {
      const int j = c0 + i / D, d = i % D;
      narrow(dkp + j * a.dk_s + d, 0.f);
      narrow(dvp + j * a.dv_s + d, 0.f);
    }
    return;
  }
  const int h0 = kvh * g;
  load_heads<D, T>(qs, a.q, a.q_b, a.q_h, b, h0, g);
  load_heads<D, T>(dos, a.dout, a.do_b, a.do_h, b, h0, g);
  for (int i = threadIdx.x; i < g * D; i += kThreads) dqp[i] = 0.f;
  const long long rows = static_cast<long long>(gridDim.y / a.kv) * a.h;
  const int n_live = (len + kChunk - 1) / kChunk;
  for (int gi = threadIdx.x; gi < g; gi += kThreads) {
    const long long row = b * a.h + h0 + gi;
    float m = kNeg;
    for (int c = 0; c < n_live; ++c) m = fmaxf(m, a.part_m[c * rows + row]);
    float l = 0.f;
    for (int c = 0; c < n_live; ++c)
      l += a.part_l[c * rows + row] * expf(a.part_m[c * rows + row] - m);
    mg[gi] = m;
    lg[gi] = l;
  }
  __syncthreads();
  // D = do.o: warp w takes heads w, w + 8, ...
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* op = static_cast<const T*>(a.o) + b * a.o_b;
  for (int gi = warp; gi < g; gi += kThreads / 32) {
    float acc = 0.f;
    for (int d = lane; d < D; d += 32)
      acc = __fmaf_rn(dos[gi * D + d], widen(op[(h0 + gi) * a.o_h + d]),
                      acc);
#pragma unroll
    for (int off = 16; off; off >>= 1)
      acc += __shfl_xor_sync(kFull, acc, off);
    if (lane == 0) dg[gi] = acc;
  }
  const T* kp = static_cast<const T*>(a.k) + b * a.k_b + kvh * a.k_h;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_b + kvh * a.v_h;
  for (int t0 = c0; t0 < stop; t0 += kTile) {
    const int n = min(kTile, stop - t0);
    __syncthreads();
    if (t0 >= len) {                       // past the live end: zeros
      for (int i = threadIdx.x; i < n * D; i += kThreads) {
        const int j = t0 + i / D, d = i % D;
        narrow(dkp + j * a.dk_s + d, 0.f);
        narrow(dvp + j * a.dv_s + d, 0.f);
      }
      continue;
    }
    load_rows<D, T>(ks, kp, a.k_s, t0, len);
    load_rows<D, T>(vs, vp, a.v_s, t0, len);
    __syncthreads();
    for (int i = threadIdx.x; i < g * kTile; i += kThreads) {
      const int gi = i / kTile, j = i % kTile;
      float p = 0.f, ds = 0.f;
      if (t0 + j < len) {
        const float s = dot(qs + gi * D, ks + j * (D + 1), D) * a.scale;
        const float dp = dot(dos + gi * D, vs + j * (D + 1), D);
        p = expf(s - mg[gi]) / lg[gi];
        ds = p * (dp - dg[gi]);
      }
      ps[i] = p;
      dss[i] = ds;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < n * D; i += kThreads) {
      const int j = i / D, d = i % D;
      float dk = 0.f, dv = 0.f;
      for (int gi = 0; gi < g; ++gi) {
        dk = __fmaf_rn(dss[gi * kTile + j], qs[gi * D + d], dk);
        dv = __fmaf_rn(ps[gi * kTile + j], dos[gi * D + d], dv);
      }
      narrow(dkp + (t0 + j) * a.dk_s + d, dk * a.scale);
      narrow(dvp + (t0 + j) * a.dv_s + d, dv);
    }
    for (int i = threadIdx.x; i < g * D; i += kThreads) {
      const int gi = i / D, d = i % D;
      float acc = dqp[i];
      for (int j = 0; j < kTile; ++j)
        acc = __fmaf_rn(dss[gi * kTile + j], ks[j * (D + 1) + d], acc);
      dqp[i] = acc;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < g * D; i += kThreads)
    a.part_dq[(chunk * rows + b * a.h + h0 + i / D) * D + i % D] = dqp[i];
}

template <int D, typename T>
__global__ void dq_kernel(Args a) {
  const int row = blockIdx.x, b = row / a.h, h = row % a.h;
  const long long rows = static_cast<long long>(gridDim.x);
  const int n_live = (live_len(a, b) + kChunk - 1) / kChunk;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < n_live; ++c)
      acc += a.part_dq[(c * rows + row) * D + d];
    narrow(static_cast<T*>(a.dq) + b * a.dq_b + h * a.dq_h + d,
           acc * a.scale);
  }
}

int smem_bytes(int g, int d) {
  return (3 * g * d + 2 * kTile * (d + 1) + 2 * g * kTile + 3 * g) * 4;
}

template <int D, typename T>
int launch(const Args& a, int batch, cudaStream_t s) {
  const int g = a.h / a.kv;
  const int main_bytes = smem_bytes(g, D);
  const int stats_bytes = (g * D + kTile * (D + 1) + g * kTile + 2 * g) * 4;
  auto stats_fn = stats_kernel<D, T>;
  auto main_fn = main_kernel<D, T>;
  cudaError_t err = cudaFuncSetAttribute(
      main_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, main_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        stats_fn, cudaFuncAttributeMaxDynamicSharedMemorySize, stats_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.n_chunks > 0) {
    const dim3 grid(a.n_chunks, batch * a.kv);
    stats_fn<<<grid, kThreads, stats_bytes, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    main_fn<<<grid, kThreads, main_bytes, s>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dq_kernel<D, T><<<batch * a.h, D, 0, s>>>(a);
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

// Positions a block takes; the wrapper sizes the scratch as
// ceil(S / chunk) chunks of (B*H) rows.
MOBY_API int moby_decode_attention_bwd_chunk() { return kChunk; }

// Dynamic shared memory of the main kernel's block for G query heads a kv
// head at head dim hd (the larger of the two kernels').
MOBY_API int moby_decode_attention_bwd_smem(int heads_per_kv, int head_dim) {
  return smem_bytes(heads_per_kv, head_dim);
}

// q, o, dout, dq (B,H,hd) through strides {b, h}; k, v, dk, dv (B,KV,S,hd)
// through strides {b, kv, s}: st = q(2), o(2), dout(2), dq(2), k(3), v(3),
// dk(3), dv(3); the head dim contiguous. pos (B,) int32 on the card.
// Scratch f32: part_m, part_l (n_chunks, B*H), part_dq (n_chunks, B*H,
// hd), n_chunks = ceil(S / moby_decode_attention_bwd_chunk()).
MOBY_API int moby_decode_attention_bwd(
    const void* q, const void* k, const void* v, const void* pos,
    const void* o, const void* dout, void* dq, void* dk, void* dv,
    void* part_m, void* part_l, void* part_dq, const long long* st,
    int batch, int n_heads, int n_kv_heads, int s_len, int head_dim,
    int is_bf16, float scale, void* stream) {
  if (batch * n_heads == 0) return 0;
  const Args a{q, k, v, o, dout, static_cast<const int*>(pos), dq, dk, dv,
               static_cast<float*>(part_m), static_cast<float*>(part_l),
               static_cast<float*>(part_dq),
               st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
               st[8], st[9], st[10], st[11], st[12], st[13], st[14], st[15],
               st[16], st[17], st[18], st[19],
               n_heads, n_kv_heads, s_len, (s_len + kChunk - 1) / kChunk,
               scale};
  const auto s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(head_dim, a, batch, s)
                 : dispatch<float>(head_dim, a, batch, s);
}
