// Bertsekas auction with epsilon scaling: the tracking association's
// maximum-benefit assignment on square (n, n) benefit matrices, one
// auction a matrix, every epsilon phase in one launch.
//
// Replaces no Pallas kernel: it is the JAX package's lax.while_loop
// auction (repro/core/association.py, _auction_phase and auction_assign),
// which XLA keeps on the device inside the jitted step. Its plain version
// is repro_torch/kernels/auction/ref.py, the same rounds as masked tensor
// ops with a host check for the end every 8 rounds; that check is a
// synchronisation, which a CUDA graph of the frame cannot hold, and each
// round is ~40 eager launches.
//
// What bounds it on an H100: the chain of dependent rounds. A serving
// frame's auction is n = 2 * max_obj persons (24 in kitti-urban) and a few
// hundred rounds over four phases, so the time is rounds x (the latency of
// a round); the work's bytes and operations are a few ns.
//
// Design: W warps an auction (W = 1, 2 or 4, the template parameter: n <=
// 32 W; the leading dims flattened, so a fleet's S streams run side by
// side), thread i person i and object i, the person's row in registers.
// The instance fixes the row length (32 W columns; the tail beyond n is a
// pad whose price is +inf, so its value is -inf and never wins), so the
// row loop unrolls and no loop runs to n. At W = 1 (n = 2 * max_obj <= 32:
// every preset but dense-traffic, n = 40) the auction is one warp with no
// CTA barrier (__syncwarp between steps, __any_sync for the end); above 32
// persons the threads synchronise with __syncthreads. A round, exactly as
// the plain version computes it:
//   1. person i: values = benefit[i] - prices; top-1 and top-2 over the row
//      (four independent chains over column blocks, merged in index order)
//      then over the plain version's -1e9 pad column (top-2 equals top-1
//      when the maximum repeats), best_j the first index of the maximum,
//      and the bid ((prices[best_j] + top1) - top2) + eps. The prices are
//      read as 16-byte shared-memory broadcasts.
//   2. object j's winner: the highest bid among the unassigned persons
//      whose best object is j, the lowest person among equal bids, with the
//      plain version's strict > order (-0 equals +0: the keys are taken of
//      bid + 0.0f). Each bidder posts its bid's order-preserving key with a
//      32-bit shared-memory atomicMax on its object's slot; the bidders
//      whose key stands there post their person with an atomicMin.
//   3. the gather-based update: person i takes best_j if it won it, is
//      evicted if its object received a bid (above -5e8) this round; the
//      winner writes its bid as the object's price.
// A phase ends when no person is unassigned or after max_iter rounds.
// Built with -fmad=false and IEEE arithmetic, so the prices, the
// assignment and the rounds equal the plain version's bit for bit.
//
// Measured on an H100 (PERF.md's auction findings): the object step by warp
// primitives with a group mask a lane (__match_any_sync on best_j,
// __reduce_max_sync over the group) cost ~2 us a round, as if each group,
// a non-bidder being one of its own, ran by itself; the atomics take it to
// 0.36 us at n = 24.
// One warp carrying 2 or 4 persons a lane (rows in shared memory at an odd
// stride) took 1.02 and 5.7 us a round at n = 33-64 and 128, the 2 and 4
// warps here 0.58 and 0.91.
//
// Above 128 persons (auction_wide_kernel): the rows no longer fit a
// thread's registers, so they stay in global memory (L2-resident: 256 KB
// at n = 256), read by a warp a person, lane l taking columns l, l + 32,
// ...: coalesced, and the prices' shared-memory reads conflict-free. One
// CTA of 32 warps an auction; warp w bids for persons w, w + 32, ... that
// are unassigned. The round is the same three steps:
//   1. a warp a person: top-1 / top-2 over the lane's columns in index
//      order (the first maximum kept by a strict >), then across the lanes
//      by shuffles (the larger value, the lower index among equal ones;
//      top-2 merged as max(t2, t2', min(t1, t1')), so it equals top-1 when
//      the maximum repeats), the -1e9 pad after the merge; lane 0 writes
//      the person's object and bid to the workspace and posts the bid's
//      key with atomicMax;
//   2. a thread a person: the bidders whose key stands post their person
//      with atomicMin;
//   3. a thread a person: the gather-based update, as above.
// Dynamic shared memory holds the prices, the round's best keys and the
// winners: 12 n bytes, opted in above 48 KB, so n is bounded by the card's
// opt-in shared memory a block (19,370 persons on an H100). The per-person
// state (the assignment, the best object and the bid) lives in a workspace
// in global memory that the caller allocates: 12 n bytes an auction.
#include <climits>
#include <cstdint>

#include "moby_kernels.cuh"

namespace {

constexpr int kMaxPhases = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNeg = -1e9f;
constexpr float kHasBid = -5e8f;
// Independent top-1/top-2 chains a row, each over a block of columns.
constexpr int kChains = 4;

struct Phases {
  float eps[kMaxPhases];
};

// a > b as floats (no NaNs; -0 == +0) iff key(a) > key(b); never 0.
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned u = __float_as_uint(x + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The auction's threads: a warp's, or, at W > 1 warps, the CTA's.
template <int W>
__device__ __forceinline__ void sync_all() {
  if constexpr (W == 1)
    __syncwarp();
  else
    __syncthreads();
}

template <int W>
__device__ __forceinline__ bool any_all(bool p) {
  if constexpr (W == 1)
    return __any_sync(kFull, p);
  else
    return __syncthreads_or(p);
}

template <int W>
__global__ void __launch_bounds__(32 * W)
    auction_kernel(const float* __restrict__ benefit, int n, Phases phases,
                   int n_phases, int max_iter, int64_t* __restrict__ p2o_out,
                   float* __restrict__ prices_out,
                   int* __restrict__ rounds_out) {
  constexpr int kCap = 32 * W;
  constexpr int kSpan = kCap / kChains;
  __shared__ __align__(16) float price_s[kCap];
  // The round's best bid on each object as a key (0: none), and its
  // person (the lowest among equal bids; kCap: none).
  __shared__ unsigned best_s[kCap];
  __shared__ int winner_s[kCap];

  const int i = threadIdx.x;
  const bool live = i < n;
  const size_t a = blockIdx.x;
  const float* src = benefit + a * n * n;
  const unsigned has_bid_key = order_key(kHasBid);

  float row[kCap];
#pragma unroll
  for (int j = 0; j < kCap; ++j)
    row[j] = (live && j < n) ? src[i * n + j] : 0.0f;
  price_s[i] = live ? 0.0f : __int_as_float(0x7f800000);

  int rounds = 0;
  int p2o = -1;
  for (int ph = 0; ph < n_phases; ++ph) {
    const float eps = phases.eps[ph];
    p2o = -1;
    int it = 0;
    while (it < max_iter && any_all<W>(live && p2o < 0)) {
      // The last round's prices and bids are written and read.
      sync_all<W>();
      best_s[i] = 0u;
      winner_s[i] = kCap;

      // 1. Person i's best object and bid.
      float t1[kChains], t2[kChains];
      int jb[kChains];
#pragma unroll
      for (int c = 0; c < kChains; ++c) {
        t1[c] = t2[c] = -__int_as_float(0x7f800000);
        jb[c] = c * kSpan;
      }
#pragma unroll
      for (int k = 0; k < kSpan; k += 4)
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          const int j0 = c * kSpan + k;
          const float4 p4 = *reinterpret_cast<const float4*>(price_s + j0);
          const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v = row[j0 + e] - pr[e];
            if (v > t1[c]) jb[c] = j0 + e;
            t2[c] = fmaxf(t2[c], fminf(t1[c], v));
            t1[c] = fmaxf(t1[c], v);
          }
        }
      float top1 = t1[0], top2 = t2[0];
      int bj = jb[0];
#pragma unroll
      for (int c = 1; c < kChains; ++c) {
        if (t1[c] > top1) bj = jb[c];
        top2 = fmaxf(fmaxf(top2, t2[c]), fminf(top1, t1[c]));
        top1 = fmaxf(top1, t1[c]);
      }
      // The -1e9 pad column of the plain version's top-2.
      if (kNeg > top1) {
        top2 = top1;
        top1 = kNeg;
      } else if (kNeg > top2) {
        top2 = kNeg;
      }
      const float bid = ((price_s[bj] + top1) - top2) + eps;

      // 2. Each object's winner: the highest key, then the lowest person.
      const bool bidding = live && p2o < 0;
      const unsigned key = order_key(bid);
      sync_all<W>();
      if (bidding) atomicMax(&best_s[bj], key);
      sync_all<W>();
      const bool tied = bidding && best_s[bj] == key;
      if (tied) atomicMin(&winner_s[bj], i);
      sync_all<W>();

      // 3. The gather-based update.
      const bool won = tied && bid > kHasBid && winner_s[bj] == i;
      const bool evicted = live && p2o >= 0 && best_s[p2o] > has_bid_key;
      if (won) price_s[bj] = bid;
      p2o = won ? bj : (evicted ? -1 : p2o);
      ++it;
    }
    rounds += it;
  }
  sync_all<W>();
  if (live) {
    p2o_out[a * n + i] = p2o;
    prices_out[a * n + i] = price_s[i];
  }
  if (i == 0) rounds_out[a] = rounds;
}

// Threads of the wide instance: one CTA of 32 warps an auction.
constexpr int kWideWarps = 32;
constexpr int kWideThreads = 32 * kWideWarps;

__global__ void __launch_bounds__(kWideThreads)
    auction_wide_kernel(const float* __restrict__ benefit, int n,
                        Phases phases, int n_phases, int max_iter,
                        int* work, int64_t* __restrict__ p2o_out,
                        float* __restrict__ prices_out,
                        int* __restrict__ rounds_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* price_s = reinterpret_cast<float*>(smem);
  // The round's best bid on each object as a key (0: none), and its
  // person (the lowest among equal bids; INT_MAX: none).
  unsigned* best_s = reinterpret_cast<unsigned*>(price_s + n);
  int* winner_s = reinterpret_cast<int*>(best_s + n);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t a = blockIdx.x;
  const float* src = benefit + a * n * n;
  // Per person: the assignment, the best object and the bid (as bits).
  int* p2o = work + a * 3 * n;
  int* best_j = p2o + n;
  float* bid_w = reinterpret_cast<float*>(best_j + n);
  const unsigned has_bid_key = order_key(kHasBid);

  for (int j = tid; j < n; j += kWideThreads) price_s[j] = 0.0f;

  int rounds = 0;
  for (int ph = 0; ph < n_phases; ++ph) {
    const float eps = phases.eps[ph];
    bool open = false;
    for (int i = tid; i < n; i += kWideThreads) {
      p2o[i] = -1;
      open = true;
    }
    int it = 0;
    // The barrier also orders the last round's writes before this one.
    while (it < max_iter && __syncthreads_or(open)) {
      for (int j = tid; j < n; j += kWideThreads) {
        best_s[j] = 0u;
        winner_s[j] = INT_MAX;
      }
      __syncthreads();

      // 1. A warp a person: its best object and bid.
      for (int i = warp; i < n; i += kWideWarps) {
        if (p2o[i] >= 0) continue;
        const float* row = src + static_cast<size_t>(i) * n;
        float t1 = -__int_as_float(0x7f800000), t2 = t1;
        int jb = INT_MAX;
        for (int j = lane; j < n; j += 32) {
          const float v = row[j] - price_s[j];
          if (v > t1) jb = j;
          t2 = fmaxf(t2, fminf(t1, v));
          t1 = fmaxf(t1, v);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float o1 = __shfl_xor_sync(kFull, t1, off);
          const float o2 = __shfl_xor_sync(kFull, t2, off);
          const int oj = __shfl_xor_sync(kFull, jb, off);
          if (o1 > t1 || (o1 == t1 && oj < jb)) jb = oj;
          t2 = fmaxf(fmaxf(t2, o2), fminf(t1, o1));
          t1 = fmaxf(t1, o1);
        }
        if (lane == 0) {
          // The -1e9 pad column of the plain version's top-2.
          if (kNeg > t1) {
            t2 = t1;
            t1 = kNeg;
          } else if (kNeg > t2) {
            t2 = kNeg;
          }
          const float bid = ((price_s[jb] + t1) - t2) + eps;
          best_j[i] = jb;
          bid_w[i] = bid;
          atomicMax(&best_s[jb], order_key(bid));
        }
      }
      __syncthreads();

      // 2. A thread a person: the tied bidders post their person.
      for (int i = tid; i < n; i += kWideThreads) {
        if (p2o[i] >= 0) continue;
        const int j = best_j[i];
        if (best_s[j] == order_key(bid_w[i])) atomicMin(&winner_s[j], i);
      }
      __syncthreads();

      // 3. A thread a person: the gather-based update.
      open = false;
      for (int i = tid; i < n; i += kWideThreads) {
        const int cur = p2o[i];
        if (cur < 0) {
          const int j = best_j[i];
          const float bid = bid_w[i];
          if (best_s[j] == order_key(bid) && bid > kHasBid &&
              winner_s[j] == i) {
            price_s[j] = bid;
            p2o[i] = j;
          } else {
            open = true;
          }
        } else if (best_s[cur] > has_bid_key) {
          p2o[i] = -1;
          open = true;
        }
      }
      ++it;
    }
    rounds += it;
  }
  __syncthreads();
  for (int i = tid; i < n; i += kWideThreads) {
    p2o_out[a * n + i] = p2o[i];
    prices_out[a * n + i] = price_s[i];
  }
  if (tid == 0) rounds_out[a] = rounds;
}

// A probe of what a round costs before any work: an auction's rounds (the
// kernel's own count) of the one-warp instance's synchronisation and end
// test.
__global__ void __launch_bounds__(32)
    auction_skeleton_kernel(const int* __restrict__ rounds,
                            int* __restrict__ out) {
  const int r = rounds[blockIdx.x];
  int it = 0;
  while (__any_sync(kFull, it < r)) {
    __syncwarp();
    __syncwarp();
    __syncwarp();
    __syncwarp();
    ++it;
  }
  if (threadIdx.x == 0) out[blockIdx.x] = it;
}

template <int W>
cudaError_t launch(const float* benefit, int batch, int n, const Phases& ph,
                   int n_phases, int max_iter, int64_t* p2o, float* prices,
                   int* rounds, cudaStream_t stream) {
  auction_kernel<W><<<batch, 32 * W, 0, stream>>>(
      benefit, n, ph, n_phases, max_iter, p2o, prices, rounds);
  return cudaGetLastError();
}

}  // namespace

// benefit (B,n,n) f32 contiguous, eps: n_phases (<= 8) f32 values on the
// host, warps the instance (1, 2 or 4 warps an auction, n <= 32 warps)
// -> person_to_obj (B,n) int64, prices (B,n) f32, rounds (B,) int32.
MOBY_API int moby_auction(const void* benefit, int batch, int n, int warps,
                          const float* eps, int n_phases, int max_iter,
                          void* p2o, void* prices, void* rounds,
                          void* stream) {
  if (n < 1 || n > 32 * warps || n_phases < 1 || n_phases > kMaxPhases)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaGetLastError());
  Phases ph{};
  for (int k = 0; k < n_phases; ++k) ph.eps[k] = eps[k];
  const auto* b = static_cast<const float*>(benefit);
  auto* o = static_cast<int64_t*>(p2o);
  auto* pr = static_cast<float*>(prices);
  auto* r = static_cast<int*>(rounds);
  auto* s = static_cast<cudaStream_t>(stream);
  switch (warps) {
    case 1:
      return launch<1>(b, batch, n, ph, n_phases, max_iter, o, pr, r, s);
    case 2:
      return launch<2>(b, batch, n, ph, n_phases, max_iter, o, pr, r, s);
    case 4:
      return launch<4>(b, batch, n, ph, n_phases, max_iter, o, pr, r, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The wide instance, n > 128: benefit (B,n,n) f32 contiguous, eps as
// above, work (B,3,n) int32 scratch -> person_to_obj (B,n) int64, prices
// (B,n) f32, rounds (B,) int32. Refuses n whose 12 n bytes of shared
// memory exceed the device's opt-in limit a block.
MOBY_API int moby_auction_wide(const void* benefit, int batch, int n,
                               const float* eps, int n_phases, int max_iter,
                               void* work, void* p2o, void* prices,
                               void* rounds, void* stream) {
  if (n < 1 || n_phases < 1 || n_phases > kMaxPhases)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(n) * 12;
  if (smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaGetLastError());
  // Opted in once a device, to the whole limit, so that no later call (a
  // CUDA graph capture among them) changes the function's attributes.
  static bool opted_in[64] = {};
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(auction_wide_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = true;
  }
  Phases ph{};
  for (int k = 0; k < n_phases; ++k) ph.eps[k] = eps[k];
  auction_wide_kernel<<<batch, kWideThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(benefit), n, ph, n_phases, max_iter,
      static_cast<int*>(work), static_cast<int64_t*>(p2o),
      static_cast<float*>(prices), static_cast<int*>(rounds));
  return static_cast<int>(cudaGetLastError());
}

// The device's opt-in shared memory a block, in bytes (negative: the CUDA
// error of the query).
MOBY_API int moby_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? bytes : -static_cast<int>(err);
}

// rounds (B,) int32 on the card -> out (B,) int32, the rounds run.
MOBY_API int moby_auction_skeleton(const void* rounds, int batch, void* out,
                                   void* stream) {
  if (batch > 0)
    auction_skeleton_kernel<<<batch, 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(rounds), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
