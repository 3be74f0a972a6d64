// The auction's wide instance with its design steps undone, for timing
// only (tools/auction_wide_probe.py; not part of the port). The probe
// splices this file into a copy of src/repro_torch/csrc/auction.cu just
// before auction_wide_kernel (inside its anonymous namespace, so it uses
// that file's Wide, Scan, scan_row, merge_lanes, one_bidder_rounds and
// constants) and edits the kernel to call what it needs:
//   - dense_phase<kOneWarp>: the first version's round, over n (a warp a
//     person over every unassigned person, 32-bit keys and winners cleared
//     by a pass, an atomicMin pass, an n-wide update evicting by p2o);
//     with kOneWarp, one_bidder_rounds once one person is unassigned;
//   - few_bidder_rounds<kFew>: up to kFew bidders left to one warp, their
//     rows scanned in one pass and the winners settled in registers;
//   - Stamps: thread 0's clock cycles by segment of the round, summed
//     over the CTAs into g_stamps.

// Thread 0's cycles by segment: the CTA round's bids past the merge (0),
// first barrier (1), update (2), second barrier and count (3); the
// one-warp rounds (4); the rest: a phase's start, the round's tag (5); the
// CTA round's row scans (6) and lane merges (7).
constexpr int kSegments = 8;
struct Stamps {
  static __device__ __forceinline__ unsigned now_cycles() {
#ifdef __CUDA_ARCH__
    return static_cast<unsigned>(clock());
#else
    return 0;
#endif
  }
  unsigned last, cycles[kSegments];
  __device__ __forceinline__ Stamps() : last(now_cycles()), cycles{} {}
  __device__ __forceinline__ void mark(int seg) {
    const unsigned now = now_cycles();
    cycles[seg] += now - last;
    last = now;
  }
};
// The segments' cycles, the CTA and one-warp rounds, the launches'
// globaltimer ns and their cycles, summed over thread 0 of every CTA.
constexpr int kStampSums = kSegments + 4;
__device__ unsigned long long g_stamps[kStampSums];

__device__ __forceinline__ void add_stamps(const Stamps& stamps,
                                           int cta_rounds, int all_rounds,
                                           unsigned long long ns,
                                           long long cycles) {
  for (int k = 0; k < kSegments; ++k)
    atomicAdd(&g_stamps[k],
              static_cast<unsigned long long>(stamps.cycles[k]));
  atomicAdd(&g_stamps[kSegments],
            static_cast<unsigned long long>(cta_rounds));
  atomicAdd(&g_stamps[kSegments + 1],
            static_cast<unsigned long long>(all_rounds - cta_rounds));
  atomicAdd(&g_stamps[kSegments + 2], ns);
  atomicAdd(&g_stamps[kSegments + 3],
            static_cast<unsigned long long>(cycles));
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long ns = 0;
#ifdef __CUDA_ARCH__
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
#endif
  return ns;
}

// A phase of the first version's rounds, over n: p2o in lists[0, n); the
// winners also keep the holders, which the kernel's end reads. Returns the
// phase's CTA rounds; the one-warp rounds, if any, are added to *own by
// warp 0.
template <bool kOneWarp>
__device__ __forceinline__ int dense_phase(const Wide& s, int n, float eps,
                                           int max_iter, int* own) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned* best_s = reinterpret_cast<unsigned*>(s.slot);
  int* winner_s = reinterpret_cast<int*>(best_s + n);
  int* p2o = s.lists;
  const unsigned has_bid_key = order_key(kHasBid);
  int open = 0;
  for (int i = tid; i < n; i += kWideThreads) {
    p2o[i] = -1;
    s.holder[i] = -1;
    ++open;
  }
  int it = 0;
  while (it < max_iter) {
    const int c = __syncthreads_count(open > 0);
    if (c == 0) break;
    if (kOneWarp && c == 1 && !__syncthreads_or(open > 1)) {
      if (warp == 0) {
        int who = -1;
        for (int j0 = 0; j0 < n && who < 0; j0 += 32) {
          const unsigned m =
              __ballot_sync(kFull, j0 + lane < n && p2o[j0 + lane] < 0);
          if (m) who = j0 + __ffs(m) - 1;
        }
        *own += one_bidder_rounds(s, n, eps, who, it, max_iter, lane) - it;
      }
      return it;
    }
    for (int j = tid; j < n; j += kWideThreads) {
      best_s[j] = 0u;
      winner_s[j] = INT_MAX;
    }
    __syncthreads();
    for (int i = warp; i < n; i += kWideWarps) {
      if (p2o[i] >= 0) continue;
      Scan sc = scan_start();
      scan_row(s.rows + static_cast<size_t>(i) * n, s.price, n, lane, sc);
      const Best b = merge_lanes(sc);
      const float bid = ((s.price[b.j] + b.t1) - b.t2) + eps;
      if (lane == 0) {
        s.bj[i] = b.j;
        s.bid[i] = bid;
        atomicMax(&best_s[b.j], order_key(bid));
      }
    }
    __syncthreads();
    for (int i = tid; i < n; i += kWideThreads) {
      if (p2o[i] >= 0) continue;
      const int j = s.bj[i];
      if (best_s[j] == order_key(s.bid[i])) atomicMin(&winner_s[j], i);
    }
    __syncthreads();
    open = 0;
    for (int i = tid; i < n; i += kWideThreads) {
      const int cur = p2o[i];
      if (cur < 0) {
        const int j = s.bj[i];
        const float bid = s.bid[i];
        if (best_s[j] == order_key(bid) && bid > kHasBid &&
            winner_s[j] == i) {
          s.price[j] = bid;
          s.holder[j] = i;
          p2o[i] = j;
        } else {
          ++open;
        }
      } else if (best_s[cur] > has_bid_key) {
        p2o[i] = -1;
        ++open;
      }
    }
    ++it;
  }
  return it;
}

// The rest of a phase once at most kFew persons are unassigned (list[0,
// c)), run by one warp with __syncwarp only. The warp scans kFew rows in
// one pass (the bidders', the first one's again in the unused places): the
// prices are loaded once for all, the loads and compare chains are
// independent and so are the lane merges. Every lane then holds every bid
// and settles each object's winner itself (the highest key, then the
// lowest person); lane k writes bidder k's price and holder, and the next
// round's bidders are gathered in registers. Returns the round count.
template <int kFew>
__device__ __forceinline__ int few_bidder_rounds(const Wide& s, int n,
                                                 float eps, const int* list,
                                                 int c, int it, int max_iter,
                                                 int lane) {
  const float inf = __int_as_float(0x7f800000);
  int who[kFew];
#pragma unroll
  for (int k = 0; k < kFew; ++k) who[k] = list[k < c ? k : 0];
  while (it < max_iter) {
    Scan sc[kFew];
    const float* row[kFew];
#pragma unroll
    for (int k = 0; k < kFew; ++k) {
      sc[k] = scan_start();
      row[k] = s.rows + static_cast<size_t>(who[k]) * n;
    }
    for (int j0 = lane; j0 < n; j0 += 8 * 32) {
      float pr[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = j0 + u * 32;
        pr[u] = j < n ? s.price[j] : inf;
      }
      float v[kFew][8];
#pragma unroll
      for (int k = 0; k < kFew; ++k)
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int j = j0 + u * 32;
          v[k][u] = j < n ? row[k][j] - pr[u] : -inf;
        }
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int k = 0; k < kFew; ++k) {
          if (v[k][u] > sc[k].t1) sc[k].jb = j0 + u * 32;
          sc[k].t2 = fmaxf(sc[k].t2, fminf(sc[k].t1, v[k][u]));
          sc[k].t1 = fmaxf(sc[k].t1, v[k][u]);
        }
    }
    int j[kFew];
    float bid[kFew];
    unsigned key[kFew];
#pragma unroll
    for (int k = 0; k < kFew; ++k) {
      j[k] = -1;
      bid[k] = 0.0f;
      key[k] = 0u;
      if (k < c) {
        const Best b = merge_lanes(sc[k]);
        j[k] = b.j;
        bid[k] = ((s.price[b.j] + b.t1) - b.t2) + eps;
        key[k] = order_key(bid[k]);
      }
    }
    ++it;
    bool won[kFew], any = false;
    int held[kFew];
#pragma unroll
    for (int k = 0; k < kFew; ++k) {
      won[k] = k < c && bid[k] > kHasBid;
#pragma unroll
      for (int h = 0; h < kFew; ++h)
        if (h != k && h < c && j[h] == j[k] &&
            (key[h] > key[k] || (key[h] == key[k] && who[h] < who[k])))
          won[k] = false;
      any |= won[k];
      held[k] = won[k] ? s.holder[j[k]] : -1;
    }
    // No winner changes nothing: every round to max_iter is this one.
    if (!any) return max_iter;
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kFew; ++k)
      if (won[k] && lane == k) {
        s.price[j[k]] = bid[k];
        s.holder[j[k]] = who[k];
      }
    int next[kFew], m = 0;
#pragma unroll
    for (int k = 0; k < kFew; ++k) next[k] = -1;
#pragma unroll
    for (int k = 0; k < kFew; ++k) {
      const int x = won[k] ? held[k] : who[k];
      if (k < c && x >= 0) {
#pragma unroll
        for (int t = 0; t < kFew; ++t)
          if (t == m) next[t] = x;
        ++m;
      }
    }
    c = m;
#pragma unroll
    for (int k = 0; k < kFew; ++k) who[k] = k < c ? next[k] : next[0];
    __syncwarp();
    if (c == 0) break;
  }
  return it;
}
