// Exact k-th largest value by binary search, one CTA per score vector.
//
// Replaces the Pallas TPU kernel _threshold_kernel of the JAX package's
// ops/topk.py (launched by pallas_topk_threshold, used by topk_mask). Same
// contract and the same steps, so the result is equal to the bit:
//
//   lo = min(s) - 1, hi = max(s); 40 halvings of mid = (lo + hi) * 0.5 in
//   f32, count(s >= mid) >= k ? lo = mid : hi = mid; snap kth = min{s >= lo};
//   verified when count(s > kth) < k, else restart from lo = kth (hi kept),
//   at most 16 rounds; out: kth and count(s > kth).
//
// What bounds it on Hopper: neither bytes (N floats read once) nor operations
// (~N compares per halving), but the chain of 40+ dependent block-wide
// reductions per round: every halving needs the whole CTA's count before the
// next mid exists. The design keeps each link short:
//
//   - the vector is staged once in dynamic shared memory when it fits (N = 14112
//     f32 is 56 KB; opt-in above 48 KB), else every pass re-reads global
//     memory (L2-resident after the first);
//   - a count is one __ballot_sync + __popc per 32 elements (a warp's count
//     is ready in every lane without a shuffle tree), then one shared-memory
//     sum over the warps; partial buffers alternate, so a reduction costs a
//     single __syncthreads.
//
// Rounding: mid and lo0 use _rn intrinsics (the build also passes
// -fmad=false); counts are exact 32-bit integers (the Pallas kernel counts in
// f32, exact below 2^24 elements, which the wrapper enforces).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxWarps = kThreads / 32;
constexpr int kIters = 40;
constexpr int kRounds = 16;
constexpr int kMaxStagedBytes = 200 * 1024;   // of the 227 KB a block may use

struct Reducer {
  int* ibuf;      // [2][kMaxWarps]
  float* fbuf;    // [2][kMaxWarps]
  int parity;
  int lane, warp, nwarps;

  // count of s[i] OP v over the vector, in every thread
  template <bool kStrict>
  __device__ __forceinline__ int count(const float* s, int n, float v) {
    int c = 0;
    for (int base = warp * 32; base < n; base += nwarps * 32) {
      const int i = base + lane;
      const bool hit = i < n && (kStrict ? s[i] > v : s[i] >= v);
      c += __popc(__ballot_sync(0xffffffffu, hit));
    }
    int* buf = ibuf + parity * kMaxWarps;
    parity ^= 1;
    if (lane == 0) buf[warp] = c;
    __syncthreads();
    int total = 0;
    for (int w = 0; w < nwarps; ++w) total += buf[w];
    return total;
  }

  // min (kMax = false) or max (kMax = true) of x over the CTA, in every thread
  template <bool kMax>
  __device__ __forceinline__ float reduce(float x) {
    for (int o = 16; o > 0; o >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x, o);
      x = kMax ? fmaxf(x, y) : fminf(x, y);
    }
    float* buf = fbuf + parity * kMaxWarps;
    parity ^= 1;
    if (lane == 0) buf[warp] = x;
    __syncthreads();
    float r = buf[0];
    for (int w = 1; w < nwarps; ++w) r = kMax ? fmaxf(r, buf[w]) : fminf(r, buf[w]);
    return r;
  }
};

__global__ void __launch_bounds__(kThreads)
topk_threshold_kernel(const float* __restrict__ scores, float* __restrict__ kth_out,
                      int* __restrict__ cnt_out, int n, int k, int staged) {
  extern __shared__ float stage[];
  __shared__ int ibuf[2 * kMaxWarps];
  __shared__ float fbuf[2 * kMaxWarps];

  const float* src = scores + (size_t)blockIdx.x * n;
  const float* s = src;
  if (staged) {
    for (int i = threadIdx.x; i < n; i += blockDim.x) stage[i] = src[i];
    __syncthreads();
    s = stage;
  }
  Reducer red{ibuf, fbuf, 0, (int)(threadIdx.x & 31), (int)(threadIdx.x >> 5),
              (int)(blockDim.x >> 5)};

  float mn = INFINITY, mx = -INFINITY;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    mn = fminf(mn, s[i]);
    mx = fmaxf(mx, s[i]);
  }
  float lo = __fsub_rn(red.reduce<false>(mn), 1.0f);
  float hi = red.reduce<true>(mx);

  float kth = lo;
  int above = 0;
  for (int round = 0; round < kRounds; ++round) {
    for (int it = 0; it < kIters; ++it) {
      const float mid = __fmul_rn(__fadd_rn(lo, hi), 0.5f);
      if (red.count<false>(s, n, mid) >= k) lo = mid; else hi = mid;
    }
    float m = INFINITY;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      if (s[i] >= lo) m = fminf(m, s[i]);
    kth = red.reduce<false>(m);
    above = red.count<true>(s, n, kth);
    lo = kth;
    if (above < k) break;          // uniform: every thread holds the same count
  }
  if (threadIdx.x == 0) {
    kth_out[blockIdx.x] = kth;
    cnt_out[blockIdx.x] = above;
  }
}

}  // namespace

extern "C" int w2t_topk_threshold(const float* scores, float* kth, int* cnt,
                                  int batch, int n, int k, void* stream) {
  if (batch <= 0) return 0;
  if (n <= 0 || k > n) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)n * sizeof(float);
  const int staged = bytes <= (size_t)kMaxStagedBytes;
  const size_t smem = staged ? bytes : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        topk_threshold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int threads = ((n + 31) / 32) * 32;
  threads = threads > kThreads ? kThreads : threads;
  topk_threshold_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(
      scores, kth, cnt, n, k, staged);
  return (int)cudaGetLastError();
}
