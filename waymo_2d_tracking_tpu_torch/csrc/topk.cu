// Exact k-th largest value by radix select, one CTA per score vector.
//
// Replaces the Pallas TPU kernel _threshold_kernel of the JAX package's
// ops/topk.py (launched by pallas_topk_threshold, used by topk_mask). Same
// contract: kth = the exact k-th largest score, and the count of scores
// strictly above it as an exact int32. On the domain the system produces --
// finite scores, no NaN, |s| < 2^127, N < 2^24 -- this is the function the
// Pallas kernel's binary search (40 halvings of (lo + hi) * 0.5, snap to a
// data value, verify, at most 16 rounds) computes: each round narrows the
// interval by 2^40, so it reaches adjacent floats well inside 16 rounds.
// Outside that domain the two differ (lo + hi overflows near +-FLT_MAX and
// the binary search no longer returns the k-th largest value); the wrapper
// does not check, as a check would cost a host sync. -0.0 and +0.0 rank as
// equal, so a k-th value of zero may come back as either sign.
//
// What bounds it on Hopper: neither bytes (N floats read once) nor operations
// (one compare per score), but the chain of dependent block-wide steps. The
// binary search needed 42 or more block reductions per round; a radix select
// needs 3 digit passes:
//
//   - every score maps to its order-preserving 32-bit key (all bits flipped
//     for a negative value, only the sign bit for a positive one, -0.0 -> the
//     key of +0.0), so the k-th largest key is the k-th largest score and no
//     float compare or midpoint rounding is involved;
//   - the keys are staged once in dynamic shared memory when the vector fits
//     (kMaxStagedBytes; N = 14112 is 56 KB, opt-in above 48 KB), else every
//     pass recomputes them from global memory (L2-resident after the first);
//   - passes of 11, 11 and 10 bits, most significant first: each builds a
//     shared histogram of the digit of the keys that match the prefix chosen
//     so far. FCOS scores fall in a few exponent bins, so a warp first groups
//     equal digits with __match_any_sync and one leader adds the group's
//     count: one shared atomic per distinct digit per warp, not per key;
//   - a suffix scan over the 2048 bins (2 per thread, warp shuffles, then
//     the 32 warp totals scanned by shuffles in every warp) finds the bin that
//     holds the k-th key; the counts of the higher bins add to the count
//     above. Two histogram buffers alternate, so a pass costs three barriers.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 2048;                    // 11-bit digits, two per thread
constexpr int kMaxStagedBytes = 200 * 1024;    // of the 227 KB a block may use
constexpr int kMaxDevices = 64;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ uint32_t order_key(float x) {
  uint32_t u = __float_as_uint(x);
  if (u == 0x80000000u) u = 0u;   // -0.0 ranks with +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(uint32_t key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

__global__ void __launch_bounds__(kThreads)
topk_threshold_kernel(const float* __restrict__ scores, float* __restrict__ kth_out,
                      int* __restrict__ cnt_out, int n, int k, int staged) {
  extern __shared__ uint32_t stage[];
  __shared__ uint32_t hist[2][kBins];
  __shared__ uint32_t wsum[kWarps];
  __shared__ uint32_t sel_prefix, sel_above, sel_rank;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const float* src = scores + (size_t)blockIdx.x * n;
  for (int i = t; i < 2 * kBins; i += kThreads) (&hist[0][0])[i] = 0u;
  if (staged) {
#pragma unroll 8
    for (int i = t; i < n; i += kThreads) stage[i] = order_key(src[i]);
  }
  __syncthreads();

  uint32_t prefix = 0u, above = 0u, rank = (uint32_t)k;
  for (int pass = 0; pass < 3; ++pass) {
    const int shift = pass == 0 ? 21 : (pass == 1 ? 10 : 0);
    const int width = pass == 2 ? 10 : 11;
    uint32_t* h = hist[pass & 1];
    // histogram of this digit over the keys that match the prefix
    for (int base = warp * 32; base < n; base += kThreads) {
      const int i = base + lane;
      uint32_t digit = kAll;                  // no bin: out of range or off the prefix
      if (i < n) {
        const uint32_t key = staged ? stage[i] : order_key(src[i]);
        if (pass == 0 || (key >> (shift + width)) == prefix)
          digit = (key >> shift) & ((1u << width) - 1u);
      }
      const uint32_t peers = __match_any_sync(kAll, digit);
      if (digit != kAll && lane == __ffs(peers) - 1) atomicAdd(&h[digit], (uint32_t)__popc(peers));
    }
    __syncthreads();
    // suffix sums: bins 2t and 2t+1 belong to thread t
    const uint32_t h0 = h[2 * t], h1 = h[2 * t + 1];
    uint32_t incl = h0 + h1;                  // this thread's bins and every higher one in its warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t y = __shfl_down_sync(kAll, incl, off);
      if (lane + off < 32) incl += y;
    }
    if (lane == 0) wsum[warp] = incl;
    if (pass == 1) {                          // pass 2 reuses pass 0's buffer
      hist[0][2 * t] = 0u;
      hist[0][2 * t + 1] = 0u;
    }
    __syncthreads();
    uint32_t w = wsum[lane];                  // warp totals, suffix-scanned in every warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t y = __shfl_down_sync(kAll, w, off);
      if (lane + off < 32) w += y;
    }
    uint32_t higher = __shfl_sync(kAll, w, (warp + 1) & 31);
    if (warp == 31) higher = 0u;
    higher += incl - (h0 + h1);               // keys in bins above 2t+1
    // exactly one thread holds the bin of the rank-th key
    int digit = -1;
    if (higher < rank && higher + h1 >= rank) {
      digit = 2 * t + 1;
    } else if (higher + h1 < rank && higher + h1 + h0 >= rank) {
      digit = 2 * t;
      higher += h1;
    }
    if (digit >= 0) {
      sel_prefix = (prefix << width) | (uint32_t)digit;
      sel_above = above + higher;
      sel_rank = rank - higher;
    }
    __syncthreads();
    prefix = sel_prefix;
    above = sel_above;
    rank = sel_rank;
  }
  if (t == 0) {
    kth_out[blockIdx.x] = key_value(prefix);
    cnt_out[blockIdx.x] = (int)above;
  }
}

}  // namespace

extern "C" int w2t_topk_threshold(const float* scores, float* kth, int* cnt,
                                  int batch, int n, int k, void* stream) {
  static size_t opted_in[kMaxDevices];   // dynamic shared memory allowed so far, per device
  if (batch <= 0) return 0;
  if (n <= 0 || k <= 0 || k > n) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)n * sizeof(uint32_t);
  const int staged = bytes <= (size_t)kMaxStagedBytes;
  const size_t smem = staged ? bytes : 0;
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (opted_in[dev] < (size_t)kMaxStagedBytes) {   // once per process and device
      err = cudaFuncSetAttribute(topk_threshold_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxStagedBytes);
      if (err != cudaSuccess) return (int)err;
      opted_in[dev] = kMaxStagedBytes;
    }
  }
  topk_threshold_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      scores, kth, cnt, n, k, staged);
  return (int)cudaGetLastError();
}
