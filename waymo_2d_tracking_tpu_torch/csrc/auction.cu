// Eps-scaled Jacobi auction for square benefit matrices, one CTA per problem.
//
// Replaces the Pallas TPU kernel _auction_kernel of the JAX package's
// ops/assign.py (launched by _pallas_auction). The schedule is the same,
// step for step, so the row -> column result is identical:
//   - outer loop while eps > 0: e = max(eps, eps_min); run one phase at e;
//     eps <- 0 once e <= eps_min * 1.000001, else eps * eps_scale;
//   - each phase resets the assignment (every row unassigned, no owners),
//     keeps the prices, and bids until every row holds a column or
//     max_iters rounds have run;
//   - a round: every unassigned row finds its best column (the lowest index
//     among equal maxima of benefit - price) and second-best value v2 (-1e30
//     when there is none) and bids b_best - v2 + e; every column takes the
//     highest bid, ties to the lowest row; row -> column follows the owners.
//   - padding rows bid like real ones: all n rows take part (r = n). With
//     phase resets, a column whose stale price exceeds every real row's
//     willingness is reclaimed only by the indifferent padding rows.
// New here: a problem flagged infeasible (no valid pair) exits at once with
// all -1, the skip that JAX made with lax.cond around the kernel; keeping it
// in the kernel spares the tracker a host sync per step. A batch of problems
// is one launch, one CTA each.
//
// What bounds it: the rounds are serial (hundreds per problem), so the
// latency of one round, not bytes (the benefit is read once, n^2 * 4 bytes)
// or arithmetic. The design keeps all state on chip -- the benefit in shared
// memory, prices, owners, bids and row -> column as shared vectors -- and
// cuts a round to two CTA barriers with warp-wide reductions:
//   - row phase: a warp per row, each lane scanning every 32nd column; the
//     (best, lowest index of best, second best) triple is combined by
//     butterfly shuffles. Max is exact and the tie rule is symmetric, so the
//     result does not depend on the reduction order;
//   - column phase: a warp per column, each lane scanning every 32nd row's
//     bid, reduced to (highest bid, lowest row);
//   - row -> column is updated in place where a column changes hands (the
//     old owner loses it, the winner takes it). A row owns at most one
//     column -- only unassigned rows bid, one column each -- so this equals
//     rebuilding it from the owners, and no other row is written.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 128;
constexpr int kThreads = 1024;
constexpr float kBig = 1e30f;

__device__ __forceinline__ void take_best(float& v1, int& j1, float& v2,
                                          float o1, int oj, float o2) {
  // merge two (best, index of best, second best) triples
  if (o1 > v1 || (o1 == v1 && oj < j1)) {
    v2 = fmaxf(v1, o2);
    v1 = o1;
    j1 = oj;
  } else {
    v2 = fmaxf(v2, o1);
  }
}

__global__ void __launch_bounds__(kThreads)
auction_kernel(const float* __restrict__ benefit, const float* __restrict__ eps0,
               const uint8_t* __restrict__ feasible, int32_t* __restrict__ out,
               int n, float eps_scale, float eps_min, float eps_stop, int max_iters) {
  extern __shared__ float smem[];
  float* b = smem;                                   // n * n
  float* price = b + n * n;                          // n
  float* bid = price + n;                            // n
  int* jbest = reinterpret_cast<int*>(bid + n);      // n
  int* owner = jbest + n;                            // n
  int* rtc = owner + n;                              // n
  __shared__ int unassigned;

  const int prob = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  int32_t* outp = out + (size_t)prob * n;
  if (!feasible[prob]) {   // uniform over the CTA, before any barrier
    for (int i = t; i < n; i += blockDim.x) outp[i] = -1;
    return;
  }
  const float* bp = benefit + (size_t)prob * n * n;
  for (int k = t; k < n * n; k += blockDim.x) b[k] = bp[k];
  for (int i = t; i < n; i += blockDim.x) {
    price[i] = 0.f;
    rtc[i] = -1;
  }
  float eps = eps0[prob];
  __syncthreads();

  while (eps > 0.f) {
    const float e = fmaxf(eps, eps_min);
    __syncthreads();   // every thread has read the last loop test of the previous phase
    for (int i = t; i < n; i += blockDim.x) {
      rtc[i] = -1;
      owner[i] = -1;
    }
    if (t == 0) unassigned = n;
    __syncthreads();
    for (int it = 0; it < max_iters && unassigned > 0; ++it) {
      // row phase: a warp per row
      for (int i = warp; i < n; i += nwarps) {
        if (rtc[i] >= 0) {
          if (lane == 0) jbest[i] = -1;
          continue;
        }
        const float* row = b + i * n;
        float v1 = -INFINITY, v2 = -kBig;
        int j1 = n;
        for (int j = lane; j < n; j += 32) {
          const float v = __fsub_rn(row[j], price[j]);
          if (v > v1) {
            v2 = fmaxf(v2, v1);
            v1 = v;
            j1 = j;
          } else if (v > v2) {
            v2 = v;
          }
        }
        for (int off = 16; off > 0; off >>= 1) {
          const float o1 = __shfl_xor_sync(0xffffffffu, v1, off);
          const int oj = __shfl_xor_sync(0xffffffffu, j1, off);
          const float o2 = __shfl_xor_sync(0xffffffffu, v2, off);
          take_best(v1, j1, v2, o1, oj, o2);
        }
        if (lane == 0) {
          jbest[i] = j1;
          bid[i] = __fadd_rn(__fsub_rn(row[j1], v2), e);
        }
      }
      __syncthreads();
      // column phase: a warp per column; highest bid, ties to the lowest row
      for (int j = warp; j < n; j += nwarps) {
        float best = -kBig;
        int win = n;
        for (int i = lane; i < n; i += 32) {
          if (jbest[i] == j && bid[i] > best) {
            best = bid[i];
            win = i;
          }
        }
        for (int off = 16; off > 0; off >>= 1) {
          const float ob = __shfl_xor_sync(0xffffffffu, best, off);
          const int ow = __shfl_xor_sync(0xffffffffu, win, off);
          if (ob > best || (ob == best && ow < win)) {
            best = ob;
            win = ow;
          }
        }
        if (lane == 0 && best > -kBig * 0.5f) {
          const int old = owner[j];
          if (old >= 0) {
            rtc[old] = -1;
          } else {
            atomicSub(&unassigned, 1);
          }
          price[j] = best;
          owner[j] = win;
          rtc[win] = j;
        }
      }
      __syncthreads();
    }
    eps = (e <= eps_stop) ? 0.f : __fmul_rn(eps, eps_scale);
  }
  for (int i = t; i < n; i += blockDim.x) outp[i] = rtc[i];
}

}  // namespace

extern "C" int w2t_auction(const float* benefit, const float* eps0, const uint8_t* feasible,
                           int32_t* out, int batch, int n, float eps_scale, float eps_min,
                           float eps_stop, int max_iters, void* stream) {
  if (batch <= 0) return 0;
  if (n <= 0 || n > kMaxN || n % 32 != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n * n * 4 + (size_t)n * 5 * 4;
  cudaError_t err = cudaFuncSetAttribute(
      auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = n * 32 < kThreads ? n * 32 : kThreads;   // a warp per row
  auction_kernel<<<batch, threads, smem, (cudaStream_t)stream>>>(
      benefit, eps0, feasible, out, n, eps_scale, eps_min, eps_stop, max_iters);
  return (int)cudaGetLastError();
}
