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
// round is ~40 eager launches. Here the whole auction stays in one CTA.
//
// What bounds it on an H100: the chain of dependent rounds. A serving
// frame's auction is n = 2 * max_obj persons (24 in kitti-urban) and a few
// hundred rounds over four phases; each round is three barriers and two
// O(n) scans in shared memory per thread, so the time is rounds x (round
// latency), with the launch floor as the bound for the work's bytes.
//
// Design: one CTA an auction (the leading dims flattened: a fleet's S
// streams run side by side), one thread a person and, in the second step
// of a round, an object. The (n, n) benefits, the prices, both assignment
// vectors and the round's bids live in shared memory. A round, exactly as
// the plain version computes it:
//   1. person i: values = benefit[i] - prices; top-1 and top-2 over the
//      row padded with -1e9 (top-2 equals top-1 when the maximum repeats),
//      best_j the first index of the maximum, and the bid
//      ((prices[best_j] + top1) - top2) + eps;
//   2. object j: the highest bid among the unassigned persons whose best
//      object is j, the lowest person index among tied bids (argmax over
//      the -1e9-filled bid column: person 0 when nobody bids);
//   3. the gather-based update: person i takes best_j if it won it, is
//      evicted if its object went to someone else; an object with a bid
//      (best bid > -5e8) takes the winner and its bid as the price.
// A phase ends when no person is unassigned (__syncthreads_or) or after
// max_iter rounds. Built with -fmad=false and IEEE arithmetic, so the
// prices, the assignment and the rounds equal the plain version's bit for
// bit.
#include <cstdint>

#include "moby_kernels.cuh"

namespace {

constexpr int kMaxN = 128;
constexpr int kMaxPhases = 8;
constexpr float kNeg = -1e9f;
constexpr float kHasBid = -5e8f;

struct Phases {
  float eps[kMaxPhases];
};

__host__ __device__ constexpr size_t smem_bytes(int n) {
  // benefit (n*n), prices, bids, best bids (f32); best_j, winner,
  // person_to_obj, obj_to_person (i32).
  return (static_cast<size_t>(n) * n + 3 * n) * sizeof(float) +
         4 * static_cast<size_t>(n) * sizeof(int);
}

__global__ void __launch_bounds__(kMaxN)
    auction_kernel(const float* __restrict__ benefit, int n, Phases phases,
                   int n_phases, int max_iter, int64_t* __restrict__ p2o_out,
                   float* __restrict__ prices_out,
                   int* __restrict__ rounds_out) {
  extern __shared__ float smem[];
  float* b = smem;
  float* price = b + n * n;
  float* bid = price + n;
  float* best_bid = bid + n;
  int* best = reinterpret_cast<int*>(best_bid + n);
  int* winner = best + n;
  int* p2o = winner + n;
  int* o2p = p2o + n;

  const int i = threadIdx.x;
  const bool live = i < n;
  const size_t a = blockIdx.x;
  const float* src = benefit + a * n * n;
  for (int k = i; k < n * n; k += blockDim.x) b[k] = src[k];
  if (live) price[i] = 0.0f;

  int rounds = 0;
  for (int ph = 0; ph < n_phases; ++ph) {
    const float eps = phases.eps[ph];
    if (live) {
      p2o[i] = -1;
      o2p[i] = -1;
    }
    __syncthreads();
    int it = 0;
    while (it < max_iter && __syncthreads_or(live && p2o[i] < 0)) {
      // 1. Person i's best object and bid.
      if (live) {
        const float* row = b + i * n;
        float top1 = row[0] - price[0];
        float top2 = -__int_as_float(0x7f800000);  // -inf
        int bj = 0;
        for (int j = 1; j < n; ++j) {
          const float v = row[j] - price[j];
          if (v > top1) {
            top2 = top1;
            top1 = v;
            bj = j;
          } else if (v > top2) {
            top2 = v;
          }
        }
        // The -1e9 pad column of the plain version's top-2.
        if (kNeg > top1) {
          top2 = top1;
          top1 = kNeg;
        } else if (kNeg > top2) {
          top2 = kNeg;
        }
        best[i] = bj;
        bid[i] = ((price[bj] + top1) - top2) + eps;
      }
      __syncthreads();
      // 2. Object i's best bid among the unassigned bidders.
      if (live) {
        float bb = kNeg;
        int w = 0;
        for (int k = 0; k < n; ++k) {
          const float v = (p2o[k] < 0 && best[k] == i) ? bid[k] : kNeg;
          if (v > bb) {
            bb = v;
            w = k;
          }
        }
        best_bid[i] = bb;
        winner[i] = w;
      }
      __syncthreads();
      // 3. The gather-based update (person i and object i).
      if (live) {
        const int cur_p = p2o[i];
        const int bj = best[i];
        const bool won =
            cur_p < 0 && best_bid[bj] > kHasBid && winner[bj] == i;
        const int cur = min(max(cur_p, 0), n - 1);
        const bool evicted =
            cur_p >= 0 && best_bid[cur] > kHasBid && winner[cur] != i;
        p2o[i] = won ? bj : (evicted ? -1 : cur_p);
        if (best_bid[i] > kHasBid) {
          o2p[i] = winner[i];
          price[i] = best_bid[i];
        }
      }
      ++it;
    }
    rounds += it;
  }
  __syncthreads();
  if (live) {
    p2o_out[a * n + i] = p2o[i];
    prices_out[a * n + i] = price[i];
  }
  if (i == 0) rounds_out[a] = rounds;
}

}  // namespace

// benefit (B,n,n) f32 contiguous, 1 <= n <= 128, eps: n_phases (<= 8) f32
// values on the host -> person_to_obj (B,n) int64, prices (B,n) f32,
// rounds (B,) int32.
MOBY_API int moby_auction(const void* benefit, int batch, int n,
                          const float* eps, int n_phases, int max_iter,
                          void* p2o, void* prices, void* rounds,
                          void* stream) {
  if (n < 1 || n > kMaxN || n_phases < 1 || n_phases > kMaxPhases)
    return static_cast<int>(cudaErrorInvalidValue);
  // Above 48 KB a block's shared memory must be opted into, once.
  static const cudaError_t attr = cudaFuncSetAttribute(
      auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes(kMaxN)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  if (batch > 0) {
    Phases ph{};
    for (int k = 0; k < n_phases; ++k) ph.eps[k] = eps[k];
    const int threads = (n + 31) / 32 * 32;
    auction_kernel<<<batch, threads, smem_bytes(n),
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(benefit), n, ph, n_phases, max_iter,
        static_cast<int64_t*>(p2o), static_cast<float*>(prices),
        static_cast<int*>(rounds));
  }
  return static_cast<int>(cudaGetLastError());
}
