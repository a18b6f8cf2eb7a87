// Eps-scaled Jacobi auction for square benefit matrices, one warp per problem.
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
//     among equal maxima of benefit - price, against the prices as they stood
//     at the start of the round) and second-best value v2 (-1e30 when there
//     is none; v2 = v1 when the maximum is tied) and bids
//     (b_best - v2) + e; every column takes the highest bid, ties to the
//     lowest row; row -> column follows the owners.
//   - padding rows bid like real ones: all n rows take part (r = n). With
//     phase resets, a column whose stale price exceeds every real row's
//     willingness is reclaimed only by the indifferent padding rows.
// New here: a problem flagged infeasible (no valid pair) exits at once with
// all -1, the skip that JAX made with lax.cond around the kernel; keeping it
// in the kernel spares the tracker a host sync per step.
//
// What bounds it: the rounds are serial (about 530 per n=64 tracker problem),
// so the latency of one round, not bytes (the benefit is read once, n^2 * 4
// bytes) or arithmetic (the bids the schedule needs). A single warp issues a
// dependent chain at several cycles an instruction, so a round costs about
// its instruction count: the design keeps that count small, branch-free and
// in registers, with no barrier but __syncwarp.
//   - One warp per problem. The benefit sits in shared memory at a padded
//     row stride n + 1. Lane l holds the price and the owner of columns l,
//     l + 32, ... in registers; the unassigned rows are a bit mask that every
//     lane holds, so the bidders come in ascending row order.
//   - How a round runs depends on its bidder count. In tracker problems at
//     n = 64 over two rounds in five have one bidder and about seven in ten
//     at most four (chip_smoke.py prints the shares); the first round of
//     each eps phase has all n.
//       * Up to four bidders (in tiers of 1 and 4, so few lanes idle): all
//         32 lanes work on each bidder, the bidders' chains interleaved.
//         Each lane takes benefit - price over its columns; v1 is a
//         __reduce_max_sync over order-preserving keys of the lanes' maxima,
//         j1 the lowest column holding v1 (a __ballot_sync per register), v2
//         a second __reduce_max_sync over the other columns (so v2 = v1 when
//         the maximum is tied). The column phase walks the bidders in
//         ascending row order: the lane that owns the column keeps a bid only
//         if it is strictly greater, so ties go to the lowest row.
//       * More: one lane per bidder (32 at a time) scans the n columns in two
//         interleaved chains, the price of each column broadcast by a shuffle
//         from the lane that holds it. The scan is branch-free: v1 = max,
//         v2 = max(v2, min(v1, v)), and j1 moves only on a strictly greater
//         value, so it is the lowest column among equal maxima. Each bid goes
//         to its column as one 64-bit shared atomicMax of (order-preserving
//         key of the bid, ~row): the highest bid, ties to the lowest row, as
//         the ascending walk gives.
//     Max is exact and the keys preserve order, so either way is the plain
//     version's argmax and column winner, bit for bit.
//   - Where a column changes hands its old owner becomes unassigned and the
//     winner assigned: each lane sets the rows' bits of its columns, and
//     __reduce_or_sync merges them into every lane's mask. A row owns at most
//     one column, so this equals rebuilding row -> column from the owners,
//     which is written out once at the end.
// A batch of problems is one launch: several warps per CTA once the batch
// exceeds the SM count, each warp its own problem and its own shared region.
//
// Past n = 128 (kMaxN) the benefit no longer fits a warp's shared region (a
// 256 x 256 one is 256 KB) and the row masks no longer fit two scalars. There
// a second kernel runs one CTA of 8 warps per problem, with the same
// schedule and the same tie rules: the benefit is read from global memory
// (L2-resident), the prices, owners and bid slots of the columns sit in
// shared memory (16 B a column), the unassigned rows are a word array there.
// Each round, warp w takes the unassigned rows of the words w, w + 8, ...,
// one bidder at a time with all 32 lanes on it: each lane scans its columns
// in ascending order (the branch-free scan of the many-bidder path), a
// butterfly of shuffles merges the lanes' (v1, lowest j1, v2), and lane 0
// posts the bid by the same 64-bit atomicMax of (bid key, ~row). After a
// barrier every column that took a bid changes hands; a row loses or wins at
// most one column a round, so the word updates never collide on a row.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 128;                 // the one-warp kernel; larger n runs auction_wide
constexpr int kWideThreads = 256;
constexpr int kFew = 4;                    // most bidders a round handles with all lanes on each
constexpr int kMaxWarpsPerCta = 8;
constexpr int kMaxSmem = 227 * 1024;       // what one block may use on Hopper
constexpr int kMaxDevices = 64;
constexpr float kBig = 1e30f;
constexpr unsigned kAll = 0xffffffffu;

// one problem's shared region, in 4-byte words: the benefit (n rows of
// n + 1), the bidder rows (n), the column slots (n of 8 bytes)
template <int NQ>
struct Region {
  static constexpr int n = 32 * NQ;
  static constexpr int ld = n + 1;
  static constexpr int words = n * ld + 3 * n;
};

// order-preserving key of a float (-0.0 as +0.0), and back
__device__ __forceinline__ unsigned order_key(float x) {
  unsigned u = __float_as_uint(x);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// A set of rows 0..n-1 as 64-bit words (hi only for n > 64). Kept in scalars,
// not in an array indexed by row / 32: the compiler turns such an index into
// branches around chains of predicated moves.
template <int NQ>
struct RowSet {
  unsigned long long lo = 0ull, hi = 0ull;

  __device__ __forceinline__ void fill() {
    lo = NQ >= 2 ? ~0ull : 0xffffffffull;
    hi = NQ == 4 ? ~0ull : (NQ == 3 ? 0xffffffffull : 0ull);
  }

  __device__ __forceinline__ int count() const { return __popcll(lo) + __popcll(hi); }

  __device__ __forceinline__ bool has(int row) const {
    return (((NQ > 2 && row >= 64) ? hi : lo) >> (row & 63)) & 1ull;
  }

  // how many rows of the set lie below row
  __device__ __forceinline__ int rank(int row) const {
    const unsigned long long below = (1ull << (row & 63)) - 1ull;
    return (NQ > 2 && row >= 64) ? __popcll(lo) + __popcll(hi & below) : __popcll(lo & below);
  }

  // the lowest row, removed from the set; -1 when the set is empty
  __device__ __forceinline__ int pop() {
    if (NQ <= 2) {
      const int row = __ffsll(lo) - 1;   // __ffsll(0) = 0
      lo &= lo - 1ull;
      return row;
    }
    const int row = lo ? __ffsll(lo) - 1 : (hi ? 63 + __ffsll(hi) : -1);
    if (lo) lo &= lo - 1ull; else hi &= hi - 1ull;
    return row;
  }

  __device__ __forceinline__ void add(int row, bool on) {
    const unsigned long long bit = on ? 1ull << (row & 63) : 0ull;
    if (NQ > 2 && row >= 64) hi |= bit; else lo |= bit;
  }

  // the union over the warp's lanes
  __device__ __forceinline__ void warp_union() {
    lo = (unsigned long long)__reduce_or_sync(kAll, (unsigned)(lo >> 32)) << 32
         | __reduce_or_sync(kAll, (unsigned)lo);
    if (NQ > 2)
      hi = (unsigned long long)__reduce_or_sync(kAll, (unsigned)(hi >> 32)) << 32
           | __reduce_or_sync(kAll, (unsigned)hi);
  }
};

// (best value, lowest column holding it, best value over the other columns)
// of a scan in ascending column order. Branch-free: v1 and v2 are a max and
// a min-max, so only j1 waits on a compare.
struct Best {
  float v1 = -INFINITY;
  int j1 = 0;
  float v2 = -kBig;

  __device__ __forceinline__ void step(float v, int j) {
    j1 = v > v1 ? j : j1;
    v2 = fmaxf(v2, fminf(v1, v));
    v1 = fmaxf(v1, v);
  }

  // merge with the scan of other columns: the lower column wins a tie
  __device__ __forceinline__ void merge(const Best& o) {
    j1 = (o.v1 > v1 || (o.v1 == v1 && o.j1 < j1)) ? o.j1 : j1;
    v2 = fmaxf(fminf(v1, o.v1), fmaxf(v2, o.v2));
    v1 = fmaxf(v1, o.v1);
  }
};

// The bids of a round with at most B bidders, all 32 lanes on each bidder;
// the highest bid on each of this lane's columns, ties to the lowest row.
template <int NQ, int B>
__device__ __forceinline__ void bid_few(const float* b, const float (&price)[NQ],
                                        RowSet<NQ> rem, float e, int lane,
                                        float (&best)[NQ], int (&win)[NQ]) {
  constexpr int n = Region<NQ>::n;
  constexpr int ld = Region<NQ>::ld;
  int row[B], j1[B];
  float v[B][NQ];
  unsigned key[B];
#pragma unroll
  for (int k = 0; k < B; ++k) {
    row[k] = rem.pop();                     // -1 past the last bidder
    const float* r = b + (row[k] < 0 ? 0 : row[k]) * ld;
    float m = -INFINITY;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      v[k][q] = __fsub_rn(r[q * 32 + lane], price[q]);
      m = fmaxf(m, v[k][q]);
    }
    key[k] = order_key(m);
  }
#pragma unroll
  for (int k = 0; k < B; ++k) key[k] = __reduce_max_sync(kAll, key[k]);
#pragma unroll
  for (int k = 0; k < B; ++k) {
    const float v1 = key_value(key[k]);
    j1[k] = n;
#pragma unroll
    for (int q = NQ - 1; q >= 0; --q) {
      const unsigned hit = __ballot_sync(kAll, v[k][q] == v1);
      j1[k] = hit ? q * 32 + __ffs(hit) - 1 : j1[k];
    }
    float m2 = -kBig;
#pragma unroll
    for (int q = 0; q < NQ; ++q) m2 = q * 32 + lane != j1[k] ? fmaxf(m2, v[k][q]) : m2;
    key[k] = order_key(m2);
  }
#pragma unroll
  for (int k = 0; k < B; ++k) key[k] = __reduce_max_sync(kAll, key[k]);
  // column phase, bidders in ascending row order: strictly greater wins
#pragma unroll
  for (int k = 0; k < B; ++k) {
    const float b1 = b[(row[k] < 0 ? 0 : row[k]) * ld + j1[k]];
    const float bid = __fadd_rn(__fsub_rn(b1, key_value(key[k])), e);
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const bool take = row[k] >= 0 && j1[k] == q * 32 + lane && bid > best[q];
      best[q] = take ? bid : best[q];
      win[q] = take ? row[k] : win[q];
    }
  }
}

// The bids of a round with many bidders, one lane per bidder; the highest
// bid on each of this lane's columns, ties to the lowest row.
template <int NQ>
__device__ __forceinline__ void bid_many(const float* b, const float (&price)[NQ],
                                         const RowSet<NQ>& un, int nb, float e, int lane,
                                         int* rows, unsigned long long* slot,
                                         float (&best)[NQ], int (&win)[NQ]) {
  constexpr int n = Region<NQ>::n;
  constexpr int ld = Region<NQ>::ld;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int i = q * 32 + lane;
    if (un.has(i)) rows[un.rank(i)] = i;   // row i: the bidders in ascending order
    slot[i] = 0ull;                        // column i: no bid yet
  }
  __syncwarp();
  for (int base = 0; base < nb; base += 32) {
    const int t = base + lane;
    const int row = rows[t < nb ? t : base];
    const float* r = b + row * ld;
    Best even, odd;
#pragma unroll
    for (int j = 0; j < n; j += 2) {
      even.step(__fsub_rn(r[j], __shfl_sync(kAll, price[j >> 5], j & 31)), j);
      odd.step(__fsub_rn(r[j + 1], __shfl_sync(kAll, price[(j + 1) >> 5], (j + 1) & 31)), j + 1);
    }
    even.merge(odd);
    const float bid = __fadd_rn(__fsub_rn(r[even.j1], even.v2), e);
    if (t < nb)
      atomicMax(&slot[even.j1], (unsigned long long)order_key(bid) << 32 | (unsigned)~row);
  }
  __syncwarp();
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const unsigned long long s = slot[q * 32 + lane];
    best[q] = s ? key_value((unsigned)(s >> 32)) : best[q];
    win[q] = s ? (int)~(unsigned)s : win[q];
  }
}

template <int NQ>
__global__ void __launch_bounds__(kMaxWarpsPerCta * 32)
auction_kernel(const float* __restrict__ benefit, const float* __restrict__ eps0,
               const uint8_t* __restrict__ feasible, int32_t* __restrict__ out, int batch,
               float eps_scale, float eps_min, float eps_stop, int max_iters) {
  constexpr int n = Region<NQ>::n;
  constexpr int ld = Region<NQ>::ld;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int prob = blockIdx.x * (blockDim.x >> 5) + warp;
  if (prob >= batch) return;   // the whole warp; nothing below waits on other warps
  int32_t* outp = out + (size_t)prob * n;
  if (!feasible[prob]) {
#pragma unroll
    for (int q = 0; q < NQ; ++q) outp[q * 32 + lane] = -1;
    return;
  }
  float* b = smem + (size_t)warp * Region<NQ>::words;
  int* rows = reinterpret_cast<int*>(b + n * ld);
  unsigned long long* slot = reinterpret_cast<unsigned long long*>(rows + n);
  const float4* bp = reinterpret_cast<const float4*>(benefit + (size_t)prob * n * n);
#pragma unroll 8
  for (int k4 = lane; k4 < n * n / 4; k4 += 32) {
    const float4 x = bp[k4];
    float* d = b + (k4 * 4 / n) * ld + (k4 * 4) % n;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
  __syncwarp();

  float price[NQ];   // of column q * 32 + lane
  int own[NQ];       // its owner row, -1 for none
  RowSet<NQ> un;     // unassigned rows, the same in every lane
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    price[q] = 0.f;
    own[q] = -1;
  }
  un.fill();
  float eps = eps0[prob];

  while (eps > 0.f) {
    const float e = fmaxf(eps, eps_min);
#pragma unroll
    for (int q = 0; q < NQ; ++q) own[q] = -1;
    un.fill();
    for (int it = 0; it < max_iters; ++it) {
      const int nb = un.count();
      if (nb == 0) break;
      float best[NQ];
      int win[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        best[q] = -kBig;
        win[q] = n;
      }
      if (nb == 1)
        bid_few<NQ, 1>(b, price, un, e, lane, best, win);
      else if (nb <= kFew)
        bid_few<NQ, kFew>(b, price, un, e, lane, best, win);
      else
        bid_many<NQ>(b, price, un, nb, e, lane, rows, slot, best, win);
      // columns that took a bid change hands: the winner is assigned, the
      // old owner unassigned
      RowSet<NQ> won, lost;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const bool has = best[q] > -kBig * 0.5f;
        won.add(win[q], has);
        lost.add(own[q], has && own[q] >= 0);
        price[q] = has ? best[q] : price[q];
        own[q] = has ? win[q] : own[q];
      }
      won.warp_union();
      lost.warp_union();
      un.lo = (un.lo & ~won.lo) | lost.lo;
      un.hi = (un.hi & ~won.hi) | lost.hi;
    }
    eps = (e <= eps_stop) ? 0.f : __fmul_rn(eps, eps_scale);
  }
  // row -> column: -1 for the unassigned rows, else the column each owns
#pragma unroll
  for (int q = 0; q < NQ; ++q)
    if (un.has(q * 32 + lane)) outp[q * 32 + lane] = -1;
#pragma unroll
  for (int q = 0; q < NQ; ++q)
    if (own[q] >= 0) outp[own[q]] = q * 32 + lane;
}

// One problem of any n (a multiple of 32) on one CTA of kWideThreads threads:
// the schedule of auction_kernel, with the benefit in global memory.
__global__ void __launch_bounds__(kWideThreads)
auction_wide(const float* __restrict__ benefit, const float* __restrict__ eps0,
             const uint8_t* __restrict__ feasible, int32_t* __restrict__ out, int n,
             float eps_scale, float eps_min, float eps_stop, int max_iters) {
  extern __shared__ unsigned long long wsmem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int nwarps = kWideThreads / 32;
  const int prob = blockIdx.x;
  const int words = n >> 5;
  int32_t* outp = out + (size_t)prob * n;
  if (!feasible[prob]) {
    for (int j = tid; j < n; j += kWideThreads) outp[j] = -1;
    return;
  }
  const float* b = benefit + (size_t)prob * n * n;
  unsigned long long* slot = wsmem;                             // n: best (bid key, ~row)
  float* price = reinterpret_cast<float*>(slot + n);            // n
  int* own = reinterpret_cast<int*>(price + n);                 // n: owner row, -1 for none
  unsigned* un = reinterpret_cast<unsigned*>(own + n);          // n / 32: unassigned rows
  for (int j = tid; j < n; j += kWideThreads) price[j] = 0.f;
  float eps = eps0[prob];

  while (eps > 0.f) {
    const float e = fmaxf(eps, eps_min);
    for (int j = tid; j < n; j += kWideThreads) own[j] = -1;
    for (int w = tid; w < words; w += kWideThreads) un[w] = kAll;
    __syncthreads();
    for (int it = 0; it < max_iters; ++it) {
      bool any = false;
      for (int w = tid; w < words; w += kWideThreads) any |= un[w] != 0u;
      if (!__syncthreads_or(any)) break;
      for (int j = tid; j < n; j += kWideThreads) slot[j] = 0ull;
      __syncthreads();
      for (int w = warp; w < words; w += nwarps) {
        unsigned m = un[w];
        while (m) {
          const int row = (w << 5) + __ffs(m) - 1;
          m &= m - 1u;
          const float* r = b + (size_t)row * n;
          Best best;
          for (int j = lane; j < n; j += 32) best.step(__fsub_rn(__ldg(r + j), price[j]), j);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            Best o;
            o.v1 = __shfl_xor_sync(kAll, best.v1, off);
            o.j1 = __shfl_xor_sync(kAll, best.j1, off);
            o.v2 = __shfl_xor_sync(kAll, best.v2, off);
            best.merge(o);
          }
          if (lane == 0) {
            const float bid = __fadd_rn(__fsub_rn(__ldg(r + best.j1), best.v2), e);
            atomicMax(&slot[best.j1], (unsigned long long)order_key(bid) << 32 | (unsigned)~row);
          }
        }
      }
      __syncthreads();
      // columns that took a bid change hands: the winner is assigned, the old
      // owner unassigned
      for (int j = tid; j < n; j += kWideThreads) {
        const unsigned long long s = slot[j];
        if (!s) continue;
        const int win = (int)~(unsigned)s;
        const int old = own[j];
        price[j] = key_value((unsigned)(s >> 32));
        own[j] = win;
        if (old >= 0) atomicOr(&un[old >> 5], 1u << (old & 31));
        atomicAnd(&un[win >> 5], ~(1u << (win & 31)));
      }
      __syncthreads();
    }
    eps = (e <= eps_stop) ? 0.f : __fmul_rn(eps, eps_scale);
  }
  __syncthreads();
  // row -> column: -1 for the unassigned rows, else the column each owns
  for (int r = tid; r < n; r += kWideThreads)
    if ((un[r >> 5] >> (r & 31)) & 1u) outp[r] = -1;
  for (int j = tid; j < n; j += kWideThreads)
    if (own[j] >= 0) outp[own[j]] = j;
}

constexpr size_t wide_smem(int n) { return (size_t)n * 16 + (size_t)(n / 32) * 4; }

int launch_wide(const float* benefit, const float* eps0, const uint8_t* feasible, int32_t* out,
                int batch, int n, float eps_scale, float eps_min, float eps_stop, int max_iters,
                cudaStream_t stream) {
  const size_t smem = wide_smem(n);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  static bool opted_in[kMaxDevices];
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!opted_in[dev]) {
      err = cudaFuncSetAttribute(auction_wide, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxSmem);
      if (err != cudaSuccess) return (int)err;
      opted_in[dev] = true;
    }
  }
  auction_wide<<<batch, kWideThreads, smem, stream>>>(benefit, eps0, feasible, out, n, eps_scale,
                                                     eps_min, eps_stop, max_iters);
  return (int)cudaGetLastError();
}

template <int NQ>
int launch(const float* benefit, const float* eps0, const uint8_t* feasible, int32_t* out,
           int batch, float eps_scale, float eps_min, float eps_stop, int max_iters,
           cudaStream_t stream) {
  // per process and device: the SM count, and whether this instantiation may
  // use more than 48 KB of dynamic shared memory
  static int sms[kMaxDevices];
  static bool opted_in[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  constexpr size_t per_warp = (size_t)Region<NQ>::words * 4;
  int warps = (batch + sms[dev] - 1) / sms[dev];   // one warp per CTA until every SM has one
  const int fit = (int)(kMaxSmem / per_warp);
  warps = warps < fit ? warps : fit;
  warps = warps < kMaxWarpsPerCta ? warps : kMaxWarpsPerCta;
  const size_t smem = (size_t)warps * per_warp;
  if (smem > 48 * 1024 && !opted_in[dev]) {
    err = cudaFuncSetAttribute(auction_kernel<NQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    opted_in[dev] = true;
  }
  const int grid = (batch + warps - 1) / warps;
  auction_kernel<NQ><<<grid, warps * 32, smem, stream>>>(
      benefit, eps0, feasible, out, batch, eps_scale, eps_min, eps_stop, max_iters);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int w2t_auction(const float* benefit, const float* eps0, const uint8_t* feasible,
                           int32_t* out, int batch, int n, float eps_scale, float eps_min,
                           float eps_stop, int max_iters, void* stream) {
  if (batch <= 0) return 0;
  if (n <= 0 || n % 32 != 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(benefit) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n > kMaxN)
    return launch_wide(benefit, eps0, feasible, out, batch, n, eps_scale, eps_min, eps_stop,
                       max_iters, s);
  switch (n / 32) {
    case 1: return launch<1>(benefit, eps0, feasible, out, batch, eps_scale, eps_min, eps_stop, max_iters, s);
    case 2: return launch<2>(benefit, eps0, feasible, out, batch, eps_scale, eps_min, eps_stop, max_iters, s);
    case 3: return launch<3>(benefit, eps0, feasible, out, batch, eps_scale, eps_min, eps_stop, max_iters, s);
    default: return launch<4>(benefit, eps0, feasible, out, batch, eps_scale, eps_min, eps_stop, max_iters, s);
  }
}
