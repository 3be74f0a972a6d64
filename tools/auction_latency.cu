// Latencies of the auction's wide instance's building blocks on one warp
// (tools/auction_wide_probe.py builds and runs it; not part of the port).
// It includes the kernel's own source, so the row scan and the lane merge
// timed here are the ones the kernel runs. Each case is a dependent chain:
// iteration r + 1 reads what iteration r produced, so cycles / iters is
// the latency of one step.
#include <utility>

#include "auction.cu"

namespace {

enum Case {
  kLds = 0,       // one shared-memory load (its address the last value)
  kRedux = 1,     // one redux.sync max
  kShfl = 2,      // one shfl.sync
  kScan = 3,      // scan_row of one row (the next row from its top-1)
  kMerge = 4,     // merge_lanes of a fixed Scan
  kBid = 5,       // scan_row + merge_lanes + the bid's price load
  kScan4 = 6,     // four rows in one pass (the probe's few_bidder_rounds<4>)
  kBarrier = 7,   // one __syncthreads of the CTA (all warps loop)
  kCases = 8
};

template <int which>
__global__ void latency_kernel(const float* __restrict__ benefit, int n,
                               int iters,
                               unsigned long long* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  float* rows = sm;
  float* price = sm + static_cast<size_t>(n) * n;
  for (size_t q = threadIdx.x; q < static_cast<size_t>(n) * n;
       q += blockDim.x)
    rows[q] = benefit[q];
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    price[j] = 0.001f * static_cast<float>(j % 7);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  if (which != kBarrier && threadIdx.x >= 32) return;
  unsigned acc = lane;
  int i = 0;
  const long long t0 = clock64();
  for (int r = 0; r < iters; ++r) {
    switch (which) {  // a constant: one case a kernel
      case kLds:
        acc = __float_as_uint(price[acc]) & 0x7u;
        break;
      case kRedux:
        acc = __reduce_max_sync(kFull, acc + lane) & 0xffu;
        break;
      case kShfl:
        acc = __shfl_sync(kFull, acc, (acc + 1) & 31) + 1u;
        break;
      case kScan: {
        Scan sc = scan_start();
        scan_row(rows + static_cast<size_t>(i) * n, price, n, lane, sc);
        i += 1 + static_cast<int>(__float_as_uint(sc.t1) & 1u);
        if (i >= n) i -= n;
        break;
      }
      case kMerge: {
        const Scan sc{static_cast<float>(acc & 3u), -1.0f, lane};
        const Best b = merge_lanes(sc);
        acc = static_cast<unsigned>(b.j) & 3u;
        break;
      }
      case kBid: {
        Scan sc = scan_start();
        scan_row(rows + static_cast<size_t>(i) * n, price, n, lane, sc);
        const Best b = merge_lanes(sc);
        const float bid = ((price[b.j] + b.t1) - b.t2) + 0.1f;
        i += 1 + static_cast<int>(__float_as_uint(bid) & 1u);
        if (i >= n) i -= n;
        break;
      }
      case kScan4: {
        constexpr int kRows = 4;
        Scan sc[kRows];
        for (int k = 0; k < kRows; ++k) sc[k] = scan_start();
        const float inf = __int_as_float(0x7f800000);
        for (int j0 = lane; j0 < n; j0 += 8 * 32) {
          float pr[8];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            pr[u] = j0 + u * 32 < n ? price[j0 + u * 32] : inf;
#pragma unroll
          for (int k = 0; k < kRows; ++k) {
            const float* row =
                rows + static_cast<size_t>(i + k < n ? i + k : i + k - n) * n;
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              const int j = j0 + u * 32;
              const float v = j < n ? row[j] - pr[u] : -inf;
              if (v > sc[k].t1) sc[k].jb = j;
              sc[k].t2 = fmaxf(sc[k].t2, fminf(sc[k].t1, v));
              sc[k].t1 = fmaxf(sc[k].t1, v);
            }
          }
        }
        float t = 0.0f;
        for (int k = 0; k < kRows; ++k) t += sc[k].t1;
        i += 1 + static_cast<int>(__float_as_uint(t) & 1u);
        if (i >= n) i -= n;
        break;
      }
      case kBarrier:
        __syncthreads();
        break;
    }
  }
  const long long t1 = clock64();
  if (threadIdx.x == 0)
    // acc's and i's low bits keep every case's chain live (the count is
    // off by at most 2 cycles).
    out[which] = static_cast<unsigned long long>(t1 - t0) + (acc & 1u) +
                 static_cast<unsigned long long>(i & 1);
}

}  // namespace

template <int which>
cudaError_t launch_case(const float* benefit, int n, int iters, int warps,
                        unsigned long long* out, size_t smem,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      latency_kernel<which>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  latency_kernel<which><<<1, 32 * warps, smem, stream>>>(benefit, n, iters,
                                                          out);
  return cudaGetLastError();
}

template <int... cases>
cudaError_t launch_all(std::integer_sequence<int, cases...>,
                       const float* benefit, int n, int iters, int warps,
                       unsigned long long* out, size_t smem,
                       cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  ((err = err == cudaSuccess
              ? launch_case<cases>(benefit, n, iters, warps, out, smem,
                                   stream)
              : err),
   ...);
  return err;
}

// benefit (n, n) f32 on the card -> out[case] the cycles of `iters` steps
// of each case, one CTA of `warps` warps (the barrier case uses them all).
MOBY_API int moby_auction_latency(const void* benefit, int n, int iters,
                                  int warps, void* out, void* stream) {
  const size_t smem = (static_cast<size_t>(n) * n + n) * 4;
  return static_cast<int>(launch_all(
      std::make_integer_sequence<int, kCases>{},
      static_cast<const float*>(benefit), n, iters, warps,
      static_cast<unsigned long long*>(out), smem,
      static_cast<cudaStream_t>(stream)));
}
