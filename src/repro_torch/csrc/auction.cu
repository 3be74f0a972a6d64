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
// thread's registers. One CTA of kWideWarps warps an auction. A round is a
// chain of dependent latencies, and at these n most rounds have a few
// unassigned persons (the tail of each phase), so the design cuts what a
// round waits on rather than its arithmetic:
//   - the rows are resident in shared memory where n^2 floats and 32 bytes
//     a person fit the card's opt-in shared memory a block (the resident
//     tier: n <= 237 on an H100), loaded once a launch; above, they stay in
//     global memory (the streamed tier, L2-resident), read the same way;
//   - a round's work is over its bidders, not over n: a compacted list of
//     the unassigned persons (double-buffered, its count in shared memory)
//     spreads them over the warps, bidder k to warp k mod kWideWarps, and a
//     warp bids for a person: lane l takes columns l, l + 32, ... (coalesced
//     rows, conflict-free prices), eight loads ahead of their compares,
//     top-1 / top-2 in index order (the first maximum kept by a strict >),
//     then across the lanes by three redux.sync on the values' order keys
//     (the lowest index among the lanes holding the maximum; top-2 the
//     maximum again if two lanes hold it, else the largest of those lanes'
//     top-2 and the other lanes' top-1), the -1e9 pad after;
//   - each object's winner is one 64-bit atomicMax a bid of (round tag,
//     the bid's order key, 0xffff - person): the highest key, then the
//     lowest person, as atomicMax of the key then atomicMin of the person
//     give it. The tag (the CTA round's count, mod 2^16) makes any slot of
//     an earlier round lose to this round's, so no pass clears the slots
//     (only when the tag wraps);
//   - the bidders update: a winner (its slot holds its own value, its bid
//     above -5e8) writes its bid as the price, takes the object and evicts
//     its holder (obj_to_person), which is appended to the next round's
//     list, as a loser appends itself (by a ballot; an atomicAdd a warp
//     past 32 bidders). That is the plain version's gather-based rule: a
//     person holds only the object it last won, so `p2o >= 0 &
//     has_bid[p2o]` is its object's holder being evicted. Two CTA barriers
//     a round; the next list's count after the second is the end test;
//   - a round's bidders never outnumber the last round's (each wins,
//     evicting at most one holder, or bids again), so once one is left it
//     stays so to the phase's end: it has no rival, and warp 0 runs those
//     rounds alone with __syncwarp only, counting rounds and stopping at
//     max_iter as the loop does.
// Measured on an H100 (PERF.md, tools/auction_wide_probe.py, which
// rebuilds each design step undone from this file by text edits): each
// dependent shared-memory load, shuffle, redux.sync or CTA barrier costs
// tens to hundreds of cycles, so a round costs its count of dependent
// steps. 32 warps beat 4, 8 and 16 (the rounds with many bidders take one
// bid a warp); leaving up to four bidders to one warp (four rows scanned
// together, the winners settled in registers) was slower than CTA rounds,
// and so were an update without slot atomics (warp 0 settling up to 32
// bids by shuffles) and a count taken from the barrier.
// Dynamic shared memory: the slots (8 n bytes), the prices (4 n) and the
// two list counts (8 bytes): 12 n + 8 bytes in the streamed tier, so n is
// bounded by the card's opt-in shared memory a block (19,370 persons on a
// Hopper card's 232,448 bytes); the resident tier adds the rows (4 n^2),
// the holders, the two lists, the bidders' objects and bids (20 n). The
// streamed tier keeps those five arrays in a workspace in global memory
// that the caller allocates: 20 n bytes an auction.
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

// Warps of the wide instance: one CTA an auction.
constexpr int kWideWarps = 32;
constexpr int kWideThreads = 32 * kWideWarps;

__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// A person's best object (the first index of the maximum) and the top two
// of its row less the prices, with the plain version's -1e9 pad column.
struct Best {
  int j;
  float t1, t2;
};

// A lane's share of a row's top-1 / top-2: lane l takes columns l,
// l + 32, ... in index order, eight loads ahead of their compares.
struct Scan {
  float t1, t2;
  int jb;
};

__device__ __forceinline__ void scan_row(const float* row, const float* price,
                                         int n, int lane, Scan& sc) {
  const float inf = __int_as_float(0x7f800000);
  for (int j0 = lane; j0 < n; j0 += 8 * 32) {
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = j0 + u * 32;
      // A column past n is -inf: it changes neither top-1 nor top-2.
      v[u] = j < n ? row[j] - price[j] : -inf;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (v[u] > sc.t1) sc.jb = j0 + u * 32;
      sc.t2 = fmaxf(sc.t2, fminf(sc.t1, v[u]));
      sc.t1 = fmaxf(sc.t1, v[u]);
    }
  }
}

__device__ __forceinline__ Scan scan_start() {
  const float inf = __int_as_float(0x7f800000);
  return Scan{-inf, -inf, INT_MAX};
}

// The lanes' Scans merged by redux.sync on order keys: the lowest index
// among the lanes holding the maximum; top-2 the maximum again if two
// lanes hold it, else the largest of the top lanes' top-2 and the other
// lanes' top-1 (a lane's top-2 is at most its top-1); then the -1e9 pad.
__device__ __forceinline__ Best merge_lanes(const Scan& sc) {
  const unsigned k1 = order_key(sc.t1);
  const unsigned m1 = __reduce_max_sync(kFull, k1);
  const bool top = k1 == m1;
  Best b;
  b.j = __reduce_min_sync(kFull, top ? sc.jb : INT_MAX);
  const unsigned k2 =
      __reduce_max_sync(kFull, top ? order_key(sc.t2) : k1);
  b.t1 = from_key(m1);
  b.t2 = from_key(__popc(__ballot_sync(kFull, top)) > 1 ? m1 : k2);
  if (kNeg > b.t1) {
    b.t2 = b.t1;
    b.t1 = kNeg;
  } else if (kNeg > b.t2) {
    b.t2 = kNeg;
  }
  return b;
}

// An object's slot value for a bid: the round's tag, the bid's key, then
// the person, so that the maximum is the highest bid and, among equal
// bids, the lowest person (n <= 65,535).
__device__ __forceinline__ unsigned long long slot_value(unsigned tag,
                                                        float bid, int i) {
  return (static_cast<unsigned long long>(tag) << 48) |
         (static_cast<unsigned long long>(order_key(bid)) << 16) |
         static_cast<unsigned>(0xffff - i);
}

// The wide instance's arrays. Shared memory: the slots and the prices; in
// the resident tier also the rows and the rest, which the streamed tier
// keeps in its workspace.
struct Wide {
  unsigned long long* slot;  // n: the round's best slot value an object
  float* price;              // n
  const float* rows;         // n x n
  int* holder;               // n: each object's person (obj_to_person)
  int* lists;                // 2 n: this round's bidders, the next's
  int* bj;                   // n: a list entry's best object
  float* bid;                // n: and its bid
  int* count;                // 2: the lists' lengths (shared)
};

// The rest of a phase once one person (i) is unassigned, run by one warp
// with __syncwarp only: a round's bidders never outnumber the last
// round's, since each wins (evicting at most one holder) or bids again, so
// the one bidder has no rival. It wins its best object if its bid is above
// -5e8 and evicts the object's holder, who bids next. Returns the round
// count.
__device__ __forceinline__ int one_bidder_rounds(const Wide& s, int n,
                                                 float eps, int i, int it,
                                                 int max_iter, int lane) {
  while (it < max_iter) {
    Scan sc = scan_start();
    scan_row(s.rows + static_cast<size_t>(i) * n, s.price, n, lane, sc);
    const Best b = merge_lanes(sc);
    const float bid = ((s.price[b.j] + b.t1) - b.t2) + eps;
    ++it;
    // No winner changes nothing: every round to max_iter is this one.
    if (!(bid > kHasBid)) return max_iter;
    const int held = s.holder[b.j];
    __syncwarp();
    if (lane == 0) {
      s.price[b.j] = bid;
      s.holder[b.j] = i;
    }
    __syncwarp();
    if (held < 0) break;
    i = held;
  }
  return it;
}

template <bool kResident>
__global__ void __launch_bounds__(kWideThreads)
    auction_wide_kernel(const float* __restrict__ benefit, int n,
                        Phases phases, int n_phases, int max_iter,
                        int* work, int64_t* __restrict__ p2o_out,
                        float* __restrict__ prices_out,
                        int* __restrict__ rounds_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t a = blockIdx.x;
  const size_t nn = static_cast<size_t>(n) * n;
  const float* src = benefit + a * nn;

  Wide s;
  s.slot = reinterpret_cast<unsigned long long*>(smem);
  s.price = reinterpret_cast<float*>(s.slot + n);
  int* state;
  if constexpr (kResident) {
    float* rows = s.price + n;
    // Loaded once a launch: 16-byte copies where n % 4 == 0 and the
    // matrix is aligned (the rows then start 16-byte aligned too).
    if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const auto* g = reinterpret_cast<const float4*>(src);
      auto* d = reinterpret_cast<float4*>(rows);
#pragma unroll 4
      for (size_t q = tid; q < nn / 4; q += kWideThreads) d[q] = g[q];
    } else {
#pragma unroll 4
      for (size_t q = tid; q < nn; q += kWideThreads) rows[q] = src[q];
    }
    s.rows = rows;
    state = reinterpret_cast<int*>(rows + nn);
    s.count = state + 5 * n;
  } else {
    s.rows = src;
    state = work + a * 5 * n;
    s.count = reinterpret_cast<int*>(s.price + n);
  }
  s.holder = state;
  s.lists = state + n;
  s.bj = state + 3 * n;
  s.bid = reinterpret_cast<float*>(state + 4 * n);
  for (int j = tid; j < n; j += kWideThreads) {
    s.slot[j] = 0ull;
    s.price[j] = 0.0f;
  }

  unsigned tag_round = 0;
  int cta_rounds = 0, own_rounds = 0;
  for (int ph = 0; ph < n_phases; ++ph) {
    const float eps = phases.eps[ph];
    __syncthreads();
    for (int k = tid; k < n; k += kWideThreads) {
      s.holder[k] = -1;
      s.lists[k] = k;
    }
    // This round's bidders are list[0, c), from lists[cur]; the next
    // round's go to lists[cur ^ 1], counted in count[cur ^ 1].
    int cur = 0, c = n, it = 0;
    __syncthreads();
    while (it < max_iter && c > 1) {
      const unsigned tag = ++tag_round & 0xffffu;
      if (tag == 0) {
        for (int j = tid; j < n; j += kWideThreads) s.slot[j] = 0ull;
        __syncthreads();
      }
      const int* list = s.lists + cur * n;
      int* next = s.lists + (cur ^ 1) * n;
      int* next_count = s.count + (cur ^ 1);
      if (tid == 0) *next_count = 0;
      // 1. A warp a bidder: its best object and bid, posted to the slot.
      for (int k = warp; k < c; k += kWideWarps) {
        const int i = list[k];
        Scan sc = scan_start();
        scan_row(s.rows + static_cast<size_t>(i) * n, s.price, n, lane, sc);
        const Best b = merge_lanes(sc);
        const float bid = ((s.price[b.j] + b.t1) - b.t2) + eps;
        if (lane == 0) {
          s.bj[k] = b.j;
          s.bid[k] = bid;
          atomicMax(&s.slot[b.j], slot_value(tag, bid, i));
        }
      }
      __syncthreads();
      // 2. A lane a bidder: a winner (its slot holds its own value) takes
      // its object and evicts its holder; the evicted and the losers are
      // the next round's bidders.
      for (int k0 = warp * 32; k0 < c; k0 += kWideThreads) {
        const int k = k0 + lane;
        int keep = -1;
        if (k < c) {
          const int i = list[k], j = s.bj[k];
          const float bid = s.bid[k];
          const int held = s.holder[j];
          keep = i;
          if (bid > kHasBid && s.slot[j] == slot_value(tag, bid, i)) {
            s.price[j] = bid;
            keep = held;
            s.holder[j] = i;
          }
        }
        const unsigned m = __ballot_sync(kFull, keep >= 0);
        if (m) {
          // One warp holds every bidder up to 32: no atomic.
          int at = 0;
          if (c > 32) {
            if (lane == 0) at = atomicAdd(next_count, __popc(m));
            at = __shfl_sync(kFull, at, 0);
          } else if (lane == 0) {
            *next_count = __popc(m);
          }
          if (keep >= 0) next[at + __popc(m & ((1u << lane) - 1u))] = keep;
        }
      }
      __syncthreads();
      c = *next_count;
      cur ^= 1;
      ++it;
    }
    cta_rounds += it;
    if (c > 0 && it < max_iter && warp == 0)
      own_rounds += one_bidder_rounds(s, n, eps, s.lists[cur * n], it,
                                      max_iter, lane) - it;
  }
  __syncthreads();

  // person_to_obj from the holders (a list as scratch), the prices, and
  // the rounds: the CTA's and those warp 0 ran alone.
  int* p2o = s.lists;
  for (int i = tid; i < n; i += kWideThreads) p2o[i] = -1;
  __syncthreads();
  for (int j = tid; j < n; j += kWideThreads)
    if (s.holder[j] >= 0) p2o[s.holder[j]] = j;
  __syncthreads();
  for (int i = tid; i < n; i += kWideThreads) {
    p2o_out[a * n + i] = p2o[i];
    prices_out[a * n + i] = s.price[i];
  }
  int* total = reinterpret_cast<int*>(s.slot);
  if (tid == 0) *total = cta_rounds;
  __syncthreads();
  if (lane == 0 && own_rounds) atomicAdd(total, own_rounds);
  __syncthreads();
  if (tid == 0) rounds_out[a] = *total;
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

// The same for the wide instance: an auction's rounds of its CTA round's
// two barriers, the second one counting as its end test does.
__global__ void __launch_bounds__(kWideThreads)
    auction_wide_skeleton_kernel(const int* __restrict__ rounds,
                                 int* __restrict__ out) {
  const int r = rounds[blockIdx.x];
  const int lane = threadIdx.x & 31;
  int it = 0, code = 2;
  while (it < r && code > 1) {
    __syncthreads();
    code = __syncthreads_count(lane < 2 && it + 1 < r);
    ++it;
  }
  if (threadIdx.x == 0) out[blockIdx.x] = it;
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
// above, resident (1: the rows in shared memory, 4 n^2 + 32 n + 8 bytes;
// 0: streamed, 12 n + 8 bytes and work (B,5,n) int32 scratch) ->
// person_to_obj (B,n) int64, prices (B,n) f32, rounds (B,) int32. Refuses
// n whose shared memory exceeds the device's opt-in limit a block.
MOBY_API int moby_auction_wide(const void* benefit, int batch, int n,
                               const float* eps, int n_phases, int max_iter,
                               int resident, void* work, void* p2o,
                               void* prices, void* rounds, void* stream) {
  if (n < 1 || n > 0xffff || n_phases < 1 || n_phases > kMaxPhases ||
      (!resident && work == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = resident ? static_cast<size_t>(n) * n * 4 + n * 32 + 8
                               : static_cast<size_t>(n) * 12 + 8;
  if (smem > static_cast<size_t>(optin))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return static_cast<int>(cudaGetLastError());
  // Opted in once a device, to the whole limit, so that no later call (a
  // CUDA graph capture among them) changes the functions' attributes.
  static bool opted_in[64] = {};
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!opted_in[dev]) {
    err = cudaFuncSetAttribute(auction_wide_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(auction_wide_kernel<false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 optin);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in[dev] = true;
  }
  Phases ph{};
  for (int k = 0; k < n_phases; ++k) ph.eps[k] = eps[k];
  const auto* b = static_cast<const float*>(benefit);
  auto* w = static_cast<int*>(work);
  auto* o = static_cast<int64_t*>(p2o);
  auto* pr = static_cast<float*>(prices);
  auto* r = static_cast<int*>(rounds);
  auto* s = static_cast<cudaStream_t>(stream);
  if (resident)
    auction_wide_kernel<true><<<batch, kWideThreads, smem, s>>>(
        b, n, ph, n_phases, max_iter, w, o, pr, r);
  else
    auction_wide_kernel<false><<<batch, kWideThreads, smem, s>>>(
        b, n, ph, n_phases, max_iter, w, o, pr, r);
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

// The wide form: rounds (B,) int32 -> out (B,) int32, a CTA of the wide
// instance's warps an auction.
MOBY_API int moby_auction_skeleton_wide(const void* rounds, int batch,
                                        void* out, void* stream) {
  if (batch > 0)
    auction_wide_skeleton_kernel<<<batch, kWideThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(rounds), static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}
