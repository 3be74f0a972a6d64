// MLA decode attention over the compressed (latent) cache: the absorbed
// form of DeepSeek-V2's decode step.
//
// Replaces no Pallas kernel: the JAX package computes this step with plain
// einsums (repro/models/mla.py::mla_decode_apply, the scores, the masked
// softmax rounded to the cache type and w . ckv). It was added because the
// port runs every attention of its serving paths as a kernel, and because
// K6 (decode_attention.cu) does not suit this shape: it serves at most 8
// query heads a block from SIMT f32 arithmetic, so at 128 heads over one
// latent "kv head" it would read each cache tile 16 times and do ~92
// GFLOP a layer outside the tensor cores.
//
// Contract (kernels/mla_decode_attention/ops.py): q_lat (B, H, R), q_rope
// (B, H, P), ckv (B, S, R), krope (B, S, P), lengths (B,) int32 read on the
// device; o_lat (B, H, R) = softmax((q_lat.ckv + q_rope.krope) * scale)
// . ckv over positions [0, min(lengths[b], S)), in the inputs' type.
// Positions at or past the length add p = 0; masked scores are the finite
// -1e30; a request of length 0 gives 0. ckv is both the first R columns of
// the keys and the values, and is read once for both.
//
// What bounds it on an H100: bytes. At deepseek-v2's serving shape (R 512,
// P 64, H 128, bf16) a live position is 1,152 bytes and 128 x 2 x 1,088 =
// 278,528 flops: 242 flops a byte, under the 295 at which the bf16 tensor
// cores and not the memory would bound it; on the SIMT cores (67 TFLOP/s
// f32) it would be 14x over the memory time.
//
// Design of the bf16 instance at (R, P) = (512, 64): the tensor cores by
// `mma.sync.m16n8k16` (bf16 in, f32 accumulators), heads as the M
// dimension.
// * A block of 256 threads takes 64 heads of one request over one split of
//   its live positions: the wrapper picks n_split so that B x ceil(H / 64)
//   x n_split blocks come to about four an SM, and each block cuts its
//   request's length (read on the device) into n_split runs of whole
//   32-position tiles. A request's two head blocks of a split launch one
//   after the other, so the second mostly reads the cache from L2.
// * Shared memory (206 KB, one block an SM): the 64 heads' queries
//   [q_lat | q_rope] (72 KB), a ring of 3 stages of 32 positions
//   [ckv | krope] (36 KB each: two tiles in flight by 16-byte cp.async,
//   zero-filled past the run's end), the tile's scores (f32) and P (bf16).
//   Rows are padded by 16 bytes, so the 8 rows an ldmatrix reads fall in 8
//   distinct bank groups.
// * S = Q.K^T (64 heads x 32 positions, depth 576): warp w takes heads
//   16 (w % 4) .. +16, all 32 positions, over depth half w / 4 (18
//   k-steps of four mma), fragments by ldmatrix a k-step ahead, even and
//   odd k-steps into accumulators of their own; the two halves' scores go
//   to shared memory and the softmax adds them. A tile's fragment reads
//   (Q once, K 4 times: 221 KB) are what its scores cost.
// * The online softmax: a quad of threads a head, 8 positions a thread;
//   the running max and sum live in the quad's registers; p (f32) is summed
//   into l and rounded to bf16 (nearest even) into P, as every tensor-core
//   flash attention rounds it.
// * O += P.V (64 heads x 512 columns, depth 32): warp w owns columns
//   64w .. 64w + 63 of all 64 heads, 4 x 8 accumulator tiles (128 f32
//   registers a thread; O is 128 KB, past one warpgroup's registers), V
//   fragments by ldmatrix.trans straight from the ckv rows of the stage.
// * Three __syncthreads a tile. The block writes its unnormalised partial
//   (m, l, acc) to scratch the wrapper allocates; a second small kernel
//   combines a row's splits and divides by max(l, 1e-30).
// The f32 instances (both sizes) and bf16 at SMOKE's (16, 8) are a plain
// SIMT kernel (8 heads a block, the tile widened to f32 in shared memory,
// a warp a head's softmax); only correctness runs reach them.
//
// The library builds with -fmad=false: each intended fused multiply-add is
// an explicit fmaf.
#include <cuda_bf16.h>
#include <stdint.h>

#include "moby_kernels.cuh"

// Probe builds (tools/mla_decode_probe.py) leave phases of the tensor-core
// instance out, to time the rest: bit 1 the scores, 2 the softmax, 4 the
// P.V product, 8 the copies of the cache. 0 here: nothing is left out.
#ifndef MOBY_MLA_PROBE_SKIP
#define MOBY_MLA_PROBE_SKIP 0
#endif

namespace {

constexpr int kProbeSkip = MOBY_MLA_PROBE_SKIP;
constexpr float kNeg = -1e30f;
constexpr int kTile = 32;       // positions a stage
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Args {
  long long ql_b, ql_h;         // q_lat (B, H, R)
  long long qr_b, qr_h;         // q_rope (B, H, P)
  long long c_b, c_s;           // ckv (B, S, R)
  long long k_b, k_s;           // krope (B, S, P)
  int n_heads, s_len, n_split;
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

// The run of whole tiles of positions that split `split` of `n_split`
// takes from a request of `len` live positions: [start, end).
__device__ __forceinline__ void split_range(int len, int split, int n_split,
                                            int& start, int& end) {
  const int tiles = (len + kTile - 1) / kTile;
  const int per = (tiles + n_split - 1) / n_split * kTile;
  start = min(split * per, len);
  end = min(start + per, len);
}

// ---- the tensor-core instance: bf16, R 512, P 64 ---------------------------

namespace tc {

constexpr int kR = 512, kP = 64, kK = kR + kP;  // depth of Q.K^T: 576
constexpr int kHeads = 64;                     // heads a block (M)
constexpr int kPieces = kK / 8;                // 16-byte pieces a row: 72
constexpr int kRowBytes = (kK + 8) * 2;        // a padded row: 1,168 bytes
constexpr int kStageBytes = kTile * kRowBytes;
constexpr int kStages = 3;                     // kStages - 1 tiles in flight
constexpr int kSRow = kTile + 4;               // f32 scores a row
constexpr int kPRow = kTile + 8;               // bf16 P a row (80 bytes)
constexpr int kSmemRing = kHeads * kRowBytes;                  // Q first
constexpr int kSmemS = kSmemRing + kStages * kStageBytes;
constexpr int kSmemP = kSmemS + 2 * kHeads * kSRow * 4;   // 2 depth halves
constexpr int kSmemCorr = kSmemP + kHeads * kPRow * 2;
constexpr int kSmemBytes = kSmemCorr + kHeads * 4;
static_assert(kSmemBytes <= 232448, "shared memory");
static_assert(kHeads == 2 * 2 * 16 && kWarps == 8, "warp split");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16x16 bf16, row) . b (16x8 bf16, col), f32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 1)
mla_decode_tc_kernel(const __nv_bfloat16* __restrict__ q_lat,
                     const __nv_bfloat16* __restrict__ q_rope,
                     const __nv_bfloat16* __restrict__ ckv,
                     const __nv_bfloat16* __restrict__ krope,
                     const int* __restrict__ lengths, Args a,
                     float* __restrict__ part_m, float* __restrict__ part_l,
                     float* __restrict__ part_acc) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int n_grp = (a.n_heads + kHeads - 1) / kHeads;
  const int split = blockIdx.x / n_grp, b = blockIdx.y;
  const int h0 = blockIdx.x % n_grp * kHeads;
  const int hg = min(kHeads, a.n_heads - h0);
  const int len = min(max(lengths[b], 0), a.s_len);
  int start, end;
  split_range(len, split, a.n_split, start, end);
  const int n_tiles = (end - start + kTile - 1) / kTile;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;   // the mma's groupID, thread

  // The 64 heads' queries [q_lat | q_rope], zero rows past the last head.
  for (int c = tid; c < kHeads * kPieces; c += kThreads) {
    const int r = c / kPieces, piece = c % kPieces;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < hg) {
      const __nv_bfloat16* src =
          piece < kR / 8
              ? q_lat + b * a.ql_b + (h0 + r) * a.ql_h + piece * 8
              : q_rope + b * a.qr_b + (h0 + r) * a.qr_h + (piece - kR / 8) * 8;
      val = *reinterpret_cast<const uint4*>(src);
    }
    *reinterpret_cast<uint4*>(smem + r * kRowBytes + piece * 16) = val;
  }

  const __nv_bfloat16* cb = ckv + b * a.c_b;
  const __nv_bfloat16* kb = krope + b * a.k_b;
  const uint32_t ring = smem_u32(smem + kSmemRing);
  // Tile t of the run into its stage: row j = [ckv | krope] of position
  // start + 32 t + j, zero-filled past the run's end.
  auto issue = [&](int t) {
    if constexpr ((kProbeSkip & 8) != 0) return;
    const uint32_t stage = ring + (t % kStages) * kStageBytes;
    const int t0 = start + t * kTile;
    for (int c = tid; c < kTile * kPieces; c += kThreads) {
      const int j = c / kPieces, piece = c % kPieces;
      const bool ok = t0 + j < end;
      const long long sj = ok ? t0 + j : start;   // a valid address
      const __nv_bfloat16* src = piece < kR / 8
                                     ? cb + sj * a.c_s + piece * 8
                                     : kb + sj * a.k_s + (piece - kR / 8) * 8;
      cp_async16(stage + j * kRowBytes + piece * 16, src, ok);
    }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) issue(t);
    cp_async_commit();
  }

  float* s_s = reinterpret_cast<float*>(smem + kSmemS);  // [2][64][kSRow]
  float* corr_s = reinterpret_cast<float*>(smem + kSmemCorr);
  const uint32_t q_base = smem_u32(smem);
  const uint32_t p_base = smem_u32(smem + kSmemP);          // [64][kPRow]
  // ldmatrix rows: for an A operand (16 rows x 16 of depth) lane l gives
  // row (l % 8) + 8 ((l / 8) % 2) at column 8 (l / 16); for a pair of B
  // operands of Q.K^T (16 positions x 16 of depth) position (l % 8) +
  // 8 (l / 16) at column 8 ((l / 8) % 2); for a pair of V operands
  // (16 positions x 16 columns, transposed) position (l % 8) + 8 ((l / 8)
  // % 2) at column 8 (l / 16).
  const int a_row = (lane % 8) + 8 * ((lane / 8) % 2), a_col = 8 * (lane / 16);
  const int b_row = (lane % 8) + 8 * (lane / 16), b_col = 8 * ((lane / 8) % 2);
  // Q.K^T: this warp's 16 heads and half of the depth.
  constexpr int kHalfSteps = kK / 32;       // 18 k-steps of 16
  const int mt = warp % 4, dh = warp / 4;
  const uint32_t qk_a = q_base + (mt * 16 + a_row) * kRowBytes + a_col * 2 +
                        dh * kHalfSteps * 32;

  float acc[4][8][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.0f;
  // Head tid / 4: running max and sum (the same in the quad's 4 threads).
  float m_run = kNeg, l_run = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();   // tile t has landed (this thread's part)
    __syncthreads();                // ... every thread's; tile t-1 consumed
    if (t + kStages - 1 < n_tiles) issue(t + kStages - 1);
    cp_async_commit();
    const uint32_t stage = ring + (t % kStages) * kStageBytes;

    // S = Q.K^T: heads 16 mt .. +16 x the tile's 32 positions over depth
    // half dh (18 k-steps), into scores buffer dh; the softmax adds the
    // halves. Each Q value is read once a tile and each K value 4 times
    // (16 x 16 tiles over the whole depth would read both twice as often).
    // The fragments of k-step kk + 1 are loaded before kk's products issue,
    // and even and odd k-steps sum into accumulators of their own.
    if constexpr ((kProbeSkip & 1) == 0) {
      float sc[2][4][4];
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[e][n][i] = 0.0f;
      const uint32_t qk_b = stage + b_row * kRowBytes + b_col * 2 +
                            dh * kHalfSteps * 32;
      uint32_t af[2][4], bf[2][2][4];
      ldmatrix_x4(af[0], qk_a);
      ldmatrix_x4(bf[0][0], qk_b);
      ldmatrix_x4(bf[0][1], qk_b + 16 * kRowBytes);
#pragma unroll
      for (int kk = 0; kk < kHalfSteps; ++kk) {
        const int cur = kk % 2;
        if (kk + 1 < kHalfSteps) {
          ldmatrix_x4(af[cur ^ 1], qk_a + (kk + 1) * 32);
          ldmatrix_x4(bf[cur ^ 1][0], qk_b + (kk + 1) * 32);
          ldmatrix_x4(bf[cur ^ 1][1], qk_b + 16 * kRowBytes + (kk + 1) * 32);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
          mma(sc[cur][n], af[cur], bf[cur][n / 2][2 * (n % 2)],
              bf[cur][n / 2][2 * (n % 2) + 1]);
      }
      float* sd = s_s + dh * kHeads * kSRow;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        float* lo = sd + (mt * 16 + g) * kSRow + n * 8 + 2 * tq;
        *reinterpret_cast<float2*>(lo) =
            make_float2(sc[0][n][0] + sc[1][n][0], sc[0][n][1] + sc[1][n][1]);
        *reinterpret_cast<float2*>(lo + 8 * kSRow) =
            make_float2(sc[0][n][2] + sc[1][n][2], sc[0][n][3] + sc[1][n][3]);
      }
    }
    __syncthreads();

    // Online softmax: a quad of threads a head (head tid / 4), each thread
    // 8 positions (8 (tid % 4) .. +8); the head's max and sum by two quad
    // shuffles each.
    if constexpr ((kProbeSkip & 2) == 0) {
      const int hh = tid / 4, q8 = (tid % 4) * 8;
      const int live = end - (start + t * kTile) - q8;   // live of the 8
      const float* s_lo = s_s + hh * kSRow + q8;          // depth half 0
      const float* s_hi = s_lo + kHeads * kSRow;          // depth half 1
      const float4 s0 = *reinterpret_cast<const float4*>(s_lo);
      const float4 s1 = *reinterpret_cast<const float4*>(s_lo + 4);
      const float4 t0 = *reinterpret_cast<const float4*>(s_hi);
      const float4 t1 = *reinterpret_cast<const float4*>(s_hi + 4);
      float sv[8] = {s0.x + t0.x, s0.y + t0.y, s0.z + t0.z, s0.w + t0.w,
                     s1.x + t1.x, s1.y + t1.y, s1.z + t1.z, s1.w + t1.w};
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sv[j] = j < live ? sv[j] * a.scale : kNeg;
        mx = fmaxf(mx, sv[j]);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run, mx);
      float sum = 0.0f;
      uint32_t pk[4];
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const float p0 = j < live ? expf(sv[j] - m_new) : 0.0f;
        const float p1 = j + 1 < live ? expf(sv[j + 1] - m_new) : 0.0f;
        sum += p0 + p1;
        const __nv_bfloat162 pb = __floats2bfloat162_rn(p0, p1);
        pk[j / 2] = *reinterpret_cast<const uint32_t*>(&pb);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float corr = expf(m_run - m_new);
      l_run = fmaf(l_run, corr, sum);
      m_run = m_new;
      *reinterpret_cast<uint4*>(smem + kSmemP + (hh * kPRow + q8) * 2) =
          make_uint4(pk[0], pk[1], pk[2], pk[3]);
      if (tid % 4 == 0) corr_s[hh] = corr;
    }
    __syncthreads();

    // O += P.V: this warp's columns 64 warp .. +64 of all 64 heads.
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const float c_lo = corr_s[mi * 16 + g], c_hi = corr_s[mi * 16 + g + 8];
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        acc[mi][ni][0] *= c_lo;
        acc[mi][ni][1] *= c_lo;
        acc[mi][ni][2] *= c_hi;
        acc[mi][ni][3] *= c_hi;
      }
    }
#pragma unroll
    for (int ks = 0; ks < ((kProbeSkip & 4) ? 0 : kTile / 16); ++ks) {
      uint32_t pa[4][4], vb[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(pa[mi], p_base + (mi * 16 + a_row) * kPRow * 2 +
                                (ks * 16 + a_col) * 2);
#pragma unroll
      for (int np = 0; np < 4; ++np)
        ldmatrix_x4_trans(vb[np], stage + (ks * 16 + a_row) * kRowBytes +
                                      (warp * 64 + np * 16 + a_col) * 2);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          mma(acc[mi][2 * np], pa[mi], vb[np][0], vb[np][1]);
          mma(acc[mi][2 * np + 1], pa[mi], vb[np][2], vb[np][3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // The unnormalised partial of this split.
  const long long rows = static_cast<long long>(gridDim.y) * a.n_heads;
  const long long row0 = split * rows + static_cast<long long>(b) *
                         a.n_heads + h0;
  float* pacc = part_acc + row0 * kR;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int lo = mi * 16 + g, hi = lo + 8;
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const int col = warp * 64 + ni * 8 + 2 * tq;
      if (lo < hg)
        *reinterpret_cast<float2*>(pacc + lo * kR + col) =
            make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      if (hi < hg)
        *reinterpret_cast<float2*>(pacc + hi * kR + col) =
            make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
  if (tid % 4 == 0 && tid / 4 < hg) {
    part_m[row0 + tid / 4] = m_run;
    part_l[row0 + tid / 4] = l_run;
  }
}

}  // namespace tc

// ---- the SIMT instances: f32 (both sizes), bf16 at (16, 8) ----------------

namespace simt {

constexpr int kHeads = 8;   // heads a block: a warp each in the softmax

template <int R, int P>
struct Smem {
  static constexpr int kK = R + P;
  static constexpr int kRow = kK + 1;   // f32 a tile row: lanes' rows apart
  static constexpr int kFloats = kHeads * kK + kTile * kRow +
                                 kHeads * kTile + kHeads;
  static constexpr int kBytes = kFloats * 4;
  static_assert(kBytes <= 232448, "shared memory");
};

template <int R, int P, typename T>
__global__ void __launch_bounds__(kThreads)
mla_decode_simt_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_rope,
                       const T* __restrict__ ckv, const T* __restrict__ krope,
                       const int* __restrict__ lengths, Args a,
                       float* __restrict__ part_m, float* __restrict__ part_l,
                       float* __restrict__ part_acc) {
  using S = Smem<R, P>;
  constexpr int kK = S::kK, kRow = S::kRow;
  constexpr int kCols = (R + kThreads - 1) / kThreads;   // columns a thread
  extern __shared__ float smemf[];
  float* q_s = smemf;                          // [kHeads][kK]
  float* tile = q_s + kHeads * kK;             // [kTile][kRow]
  float* p_s = tile + kTile * kRow;            // [kHeads][kTile]
  float* corr_s = p_s + kHeads * kTile;        // [kHeads]
  const int n_grp = (a.n_heads + kHeads - 1) / kHeads;
  const int split = blockIdx.x / n_grp, b = blockIdx.y;
  const int h0 = blockIdx.x % n_grp * kHeads;
  const int hg = min(kHeads, a.n_heads - h0);
  const int len = min(max(lengths[b], 0), a.s_len);
  int start, end;
  split_range(len, split, a.n_split, start, end);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  for (int e = tid; e < kHeads * kK; e += kThreads) {
    const int g = e / kK, d = e % kK;
    float x = 0.0f;
    if (g < hg)
      x = widen(d < R ? q_lat[b * a.ql_b + (h0 + g) * a.ql_h + d]
                      : q_rope[b * a.qr_b + (h0 + g) * a.qr_h + d - R]);
    q_s[e] = x;
  }
  float acc[kHeads][kCols];
#pragma unroll
  for (int g = 0; g < kHeads; ++g)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[g][c] = 0.0f;
  float m_run = kNeg, l_run = 0.0f;   // warp g's head g

  for (int t0 = start; t0 < end; t0 += kTile) {
    __syncthreads();   // the previous tile is consumed (and q_s written)
    for (int e = tid; e < kTile * kK; e += kThreads) {
      const int j = e / kK, d = e % kK;
      const long long sj = t0 + j;
      float x = 0.0f;
      if (sj < end)
        x = widen(d < R ? ckv[b * a.c_b + sj * a.c_s + d]
                        : krope[b * a.k_b + sj * a.k_s + d - R]);
      tile[j * kRow + d] = x;
    }
    __syncthreads();
    // Scores and softmax: warp g takes head g, lane j position j.
    {
      const float* qg = q_s + warp * kK;
      const float* kr = tile + lane * kRow;
      float dot = 0.0f;
#pragma unroll 8
      for (int d = 0; d < kK; ++d) dot = fmaf(qg[d], kr[d], dot);
      const bool live = t0 + lane < end;
      const float s = live ? dot * a.scale : kNeg;
      const float m_new = fmaxf(m_run, warp_max(s));
      const float p = live ? expf(s - m_new) : 0.0f;
      const float corr = expf(m_run - m_new);
      l_run = fmaf(l_run, corr, warp_sum(p));
      m_run = m_new;
      p_s[warp * kTile + lane] = p;
      if (lane == 0) corr_s[warp] = corr;
    }
    __syncthreads();
    // P.V: thread its columns tid, tid + 256, ... of every head.
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = tid + c * kThreads;
      if (col >= R) break;
#pragma unroll
      for (int g = 0; g < kHeads; ++g) {
        float x = acc[g][c] * corr_s[g];
#pragma unroll 8
        for (int j = 0; j < kTile; ++j)
          x = fmaf(p_s[g * kTile + j], tile[j * kRow + col], x);
        acc[g][c] = x;
      }
    }
  }

  const long long rows = static_cast<long long>(gridDim.y) * a.n_heads;
  const long long row0 = split * rows + static_cast<long long>(b) *
                         a.n_heads + h0;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = tid + c * kThreads;
    if (col >= R) break;
#pragma unroll
    for (int g = 0; g < kHeads; ++g)
      if (g < hg) part_acc[(row0 + g) * R + col] = acc[g][c];
  }
  if (lane == 0 && warp < hg) {
    part_m[row0 + warp] = m_run;
    part_l[row0 + warp] = l_run;
  }
}

}  // namespace simt

// One block per (b, head) row: rescale its splits' partials to their
// common max and normalise. A row with no live position gives 0.
constexpr int kCombineThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
mla_decode_combine_kernel(int r_dim, int n_split,
                          const float* __restrict__ part_m,
                          const float* __restrict__ part_l,
                          const float* __restrict__ part_acc,
                          T* __restrict__ out) {
  extern __shared__ float w_s[];   // [n_split]
  __shared__ float denom_s;
  const long long row = blockIdx.x, rows = gridDim.x;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    float m = kNeg;
    for (int c = lane; c < n_split; c += 32)
      m = fmaxf(m, part_m[c * rows + row]);
    m = warp_max(m);
    float l = 0.0f;
    for (int c = lane; c < n_split; c += 32) {
      const float w = expf(part_m[c * rows + row] - m);
      w_s[c] = w;
      l = fmaf(part_l[c * rows + row], w, l);
    }
    l = warp_sum(l);
    if (lane == 0) denom_s = fmaxf(l, 1e-30f);
  }
  __syncthreads();
  const float denom = denom_s;
  for (int d = threadIdx.x; d < r_dim; d += kCombineThreads) {
    float acc = 0.0f;
    for (int c = 0; c < n_split; ++c)
      acc = fmaf(part_acc[(c * rows + row) * r_dim + d], w_s[c], acc);
    narrow(out + row * r_dim + d, acc / denom);
  }
}

template <typename T, typename Kernel>
int launch(Kernel partial, int smem, int heads_per_block, int r_dim,
           const void* q_lat, const void* q_rope, const void* ckv,
           const void* krope, const void* lengths, void* out, float* pm,
           float* pl, float* pa, int batch, const Args& a,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      partial, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // A request's head blocks of one split are neighbours in launch order,
  // so they read its cache at about the same time (the second from L2).
  const dim3 grid(a.n_split * ((a.n_heads + heads_per_block - 1) /
                               heads_per_block),
                  batch);
  partial<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_rope),
      static_cast<const T*>(ckv), static_cast<const T*>(krope),
      static_cast<const int*>(lengths), a, pm, pl, pa);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mla_decode_combine_kernel<T><<<batch * a.n_heads, kCombineThreads,
                                 a.n_split * sizeof(float), stream>>>(
      r_dim, a.n_split, pm, pl, pa, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q_lat (B,H,R) and q_rope (B,H,P) through strides st[0..1], st[2..3] =
// {b, h}; ckv (B,S,R) and krope (B,S,P) through st[4..5], st[6..7] =
// {b, s}; the last dim contiguous, and for bf16 at (512, 64) every base and
// stride 16-byte aligned. lengths (B,) int32: positions attended per
// request ([0, lengths)). out (B,H,R) contiguous, of the inputs' type (bf16
// if is_bf16, else f32). Scratch: part_m, part_l (n_split, B*H) and
// part_acc (n_split, B*H, R) f32. (R, P) is (512, 64) or (16, 8); H at
// most 128 (the wrapper's limit).
MOBY_API int moby_mla_decode_attention(
    const void* q_lat, const void* q_rope, const void* ckv, const void* krope,
    const void* lengths, void* out, void* part_m, void* part_l,
    void* part_acc, const long long* st, int batch, int n_heads, int s_len,
    int r_dim, int p_dim, int n_split, int is_bf16, float scale,
    void* stream) {
  if (batch * n_heads == 0) return 0;
  const Args a{st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
               n_heads, s_len, n_split, scale};
  const auto s = static_cast<cudaStream_t>(stream);
  auto* pm = static_cast<float*>(part_m);
  auto* pl = static_cast<float*>(part_l);
  auto* pa = static_cast<float*>(part_acc);
  const bool wide = r_dim == 512 && p_dim == 64;
  if (!wide && !(r_dim == 16 && p_dim == 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16 && wide)
    return launch<__nv_bfloat16>(tc::mla_decode_tc_kernel, tc::kSmemBytes,
                                 tc::kHeads, r_dim, q_lat, q_rope, ckv, krope,
                                 lengths, out, pm, pl, pa, batch, a, s);
  if (is_bf16)
    return launch<__nv_bfloat16>(
        simt::mla_decode_simt_kernel<16, 8, __nv_bfloat16>,
        simt::Smem<16, 8>::kBytes, simt::kHeads, r_dim, q_lat, q_rope, ckv,
        krope, lengths, out, pm, pl, pa, batch, a, s);
  if (wide)
    return launch<float>(simt::mla_decode_simt_kernel<512, 64, float>,
                         simt::Smem<512, 64>::kBytes, simt::kHeads, r_dim,
                         q_lat, q_rope, ckv, krope, lengths, out, pm, pl, pa,
                         batch, a, s);
  return launch<float>(simt::mla_decode_simt_kernel<16, 8, float>,
                       simt::Smem<16, 8>::kBytes, simt::kHeads, r_dim, q_lat,
                       q_rope, ckv, krope, lengths, out, pm, pl, pa, batch, a,
                       s);
}
