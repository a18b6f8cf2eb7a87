// Greedy NMS keep-mask over score-sorted boxes, one CTA per image.
//
// Replaces the Pallas TPU kernel _nms_kernel of the JAX package's ops/nms.py
// (launched by pallas_nms_mask_batched). Same contract: boxes (B, N, 4) xyxy
// already sorted by descending score, valid (B, N); keep[i] = valid[i] and no
// kept j < i has IoU(i, j) > thr. The result is exact greedy NMS, bit for bit,
// for any N: up to kSharedN (8192) the boxes of one image stay in shared
// memory; above it the same schedule keeps them, the in-block words, the kept
// words and a dead byte per box in a global scratch of the caller's (25 B a
// box, L2-resident at the sizes TTA makes: 250 KB at N = 10240).
//
// What bounds it on Hopper: neither bytes (18 per box) nor the IoUs the
// function needs (a kept box against the later boxes still alive, ~150 K
// pairs an image at N = 1024) but the greedy dependency: whether box i is
// kept is known only after every kept box before it has been applied. The
// TPU kernel cut that chain into 128-box blocks (a vectorised pass against
// the boxes kept so far, then an in-block fixpoint). The same idea in this
// card's terms, with blocks of 32 boxes = one warp = one ballot word:
//
//   0. warp w owns the blocks w, w + nwarps, ...: lane l of it holds box
//      32 * block + l and that box's "dead" bit (invalid or removed) in a
//      register; coordinates sit in shared memory;
//   1. up front, in parallel over all warps, lane j computes one word: which
//      earlier live boxes of its own block would remove box j;
//   2. block t in order, run by the block's owner warp: a ballot gives the
//      live word, and the in-block greedy is the TPU kernel's fixpoint
//      kept' = live & ~(some kept earlier box of the block removes me), one
//      ballot a round, exact after (longest chain + 1) rounds, 1-3 on
//      detector boxes; it publishes the kept word and a compact list of the
//      kept boxes with their areas. One barrier a block;
//   3. every lane that holds a live box of a later block tests it against the
//      boxes just kept, four at a time without a branch, and sets its dead
//      bit on a hit; the owner of block t+1 does so for that block first.
//
// No N x N storage exists, rows of removed or invalid boxes are never
// computed, and beyond the in-block pairs of step 1 a pair is computed only
// while its later box is still alive.
//
// The division stays off the common path without moving a bit: a pair whose
// inter lies below thr * (1 - 2^-20) * max(union, 1e-7) cannot have a rounded
// quotient above thr (the two products and the quotient are each within 2^-24
// of exact; a pair that does not intersect has inter = 0), and only the other
// pairs, a hit or a near miss, take __fdiv_rn. A box is hit once in its life,
// so that is rare. A threshold below 2^-20 (or NaN) always divides; a
// negative one makes every pair a hit, intersecting or not.
//
// Past kSharedN a warp owns more than 32 blocks, so its dead bits no longer
// fit one register word: each lane keeps a byte per box in the scratch, which
// only that lane reads or writes. The step-1 list (the warp's own block) is
// staged through shared memory, so every box a lane compares comes from
// shared memory in both variants.
//
// Rounding: the IoU is inter / max(union, 1e-7) with union = area_i + area_j -
// inter, each operation rounded on its own (explicit _rn intrinsics; the
// build also passes -fmad=false). A fused multiply-add in the union would
// move ties at the threshold, and the class offset (1e5 * class added to the
// coordinates) makes any such difference visible. Boxes are finite.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSharedN = 8192;    // 20 bytes of shared memory a box, 227 KB a CTA
constexpr int kMaxThreads = 1024;
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;

constexpr size_t smem_bytes(int nblk) {
  // per box: float4 + 1 word; per block: the kept word; 2 lists of kept boxes
  return (size_t)nblk * 32 * 20 + (size_t)(nblk + (nblk & 1)) * 4 + 2 * 32 * 20 + 16;
}

// past kSharedN: shared memory holds the two kept lists, a 32-box staging
// area per warp and the timing words; the scratch holds per image the boxes,
// the in-block words, the kept words and the dead bytes, 16-byte aligned
constexpr size_t smem_bytes_global() {
  return 2 * 32 * 20 + (size_t)(kMaxThreads / 32) * 32 * 16 + 16;
}

__host__ __device__ constexpr size_t scratch_bytes(int n) {
  const size_t nblk = (size_t)(n + 31) / 32, npad = nblk * 32;
  return (npad * 16 + npad * 4 + nblk * 4 + npad + 15) / 16 * 16;
}

__device__ __forceinline__ float box_area(const float4 v) {
  return __fmul_rn(fmaxf(__fsub_rn(v.z, v.x), 0.f), fmaxf(__fsub_rn(v.w, v.y), 0.f));
}

struct Threshold {
  float thr;
  float below;     // thr * (1 - 2^-20), or 0 when every pair divides (thr < 2^-20)
  bool zero_hits;  // 0 > thr: every pair is a hit, intersecting or not
};

__device__ __forceinline__ Threshold make_threshold(const float thr) {
  return Threshold{thr, thr >= 0x1p-20f ? __fmul_rn(thr, 1.0f - 0x1p-20f) : 0.f, 0.f > thr};
}

// Bit k of the result: k is in cand and list[k] removes box me, that is
// inter / max(area_k + area_me - inter, 1e-7) > thr. Four boxes of the list a
// round, without a branch unless one of the four comes near or over thr.
// areas may be null (then computed). The list is readable up to a multiple of
// 4 past count; entries outside cand are ignored.
__device__ __forceinline__ uint32_t hits(const float4* __restrict__ list,
                                         const float* __restrict__ areas, const int count,
                                         const uint32_t cand, const float4 me,
                                         const Threshold t) {
  if (t.zero_hits) return cand;
  const float am = box_area(me);
  uint32_t m = 0;
  for (int i = 0; i < count; i += 4) {
    float inter[4], uni[4];
    bool near = false;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 o = list[i + u];
      const float ao = areas ? areas[i + u] : box_area(o);
      const float iw = fmaxf(__fsub_rn(fminf(o.z, me.z), fmaxf(o.x, me.x)), 0.f);
      const float ih = fmaxf(__fsub_rn(fminf(o.w, me.w), fmaxf(o.y, me.y)), 0.f);
      inter[u] = __fmul_rn(iw, ih);
      uni[u] = fmaxf(__fsub_rn(__fadd_rn(ao, am), inter[u]), 1e-7f);
      near |= inter[u] >= __fmul_rn(t.below, uni[u]);
    }
    if (near) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (inter[u] >= __fmul_rn(t.below, uni[u]) && __fdiv_rn(inter[u], uni[u]) > t.thr)
          m |= 1u << (i + u);
    }
  }
  return m & cand;
}

// kTimed also writes, per image, clock64 cycles of {the whole CTA, the
// prologue (load + the in-block words), the owners' turns summed} and the
// number of fixpoint rounds.
// kGlobal: the variant past kSharedN, with its per-box state in scratch.
template <bool kTimed, bool kGlobal>
__global__ void __launch_bounds__(kMaxThreads)
nms_mask_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                uint8_t* __restrict__ keep, int n, float thr, int aligned,
                long long* __restrict__ cycles, uint8_t* scratch) {
  extern __shared__ float4 smem[];
  const int nblk = (n + 31) >> 5;
  const int npad = nblk << 5;
  float4* sbox;                                               // npad
  float4* klist;                                              // 2 x 32: kept boxes of a block
  float* karea;                                               // 2 x 32: their areas
  uint32_t* own;                                              // npad: earlier boxes of my block
  uint32_t* keptw;                                            // nblk kept words
  unsigned long long* timing;
  float4* stage = nullptr;                                    // kGlobal: 32 boxes a warp
  uint8_t* deadb = nullptr;                                   // kGlobal: a dead byte a box
  if constexpr (kGlobal) {
    klist = smem;
    karea = reinterpret_cast<float*>(klist + 64);
    stage = reinterpret_cast<float4*>(karea + 64);
    timing = reinterpret_cast<unsigned long long*>(stage + kMaxThreads);
    uint8_t* img = scratch + (size_t)blockIdx.x * scratch_bytes(n);
    sbox = reinterpret_cast<float4*>(img);
    own = reinterpret_cast<uint32_t*>(sbox + npad);
    keptw = own + npad;
    deadb = reinterpret_cast<uint8_t*>(keptw + nblk);
  } else {
    sbox = smem;
    klist = sbox + npad;
    karea = reinterpret_cast<float*>(klist + 64);
    own = reinterpret_cast<uint32_t*>(karea + 64);
    keptw = own + npad;
    timing = reinterpret_cast<unsigned long long*>(keptw + nblk + (nblk & 1));
  }

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int owned = (nblk + nwarps - 1) / nwarps;             // blocks a warp owns (<= 32 unless kGlobal)
  const size_t base = (size_t)blockIdx.x * n;
  // this lane's box of its q-th block: dead (invalid, removed or past the
  // last block)?
  uint32_t dead = kFull;
  auto is_dead = [&](int q) -> bool {
    if constexpr (kGlobal) {
      const int blk = q * nwarps + warp;
      return blk >= nblk || deadb[(blk << 5) + lane];
    } else {
      return (dead >> q) & 1u;
    }
  };
  auto kill = [&](int q) {
    if constexpr (kGlobal) deadb[((q * nwarps + warp) << 5) + lane] = 1;
    else dead |= 1u << q;
  };
  const Threshold t = make_threshold(thr);
  long long t_start = 0;
  if (kTimed) {
    if (tid == 0) timing[0] = timing[1] = 0;
    t_start = clock64();
  }
  for (int j = tid; j < 64; j += nthreads) {                  // no stale bits in the lists
    klist[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    karea[j] = 0.f;
  }

  // 0. boxes into shared memory; this lane's dead bits
  for (int j = tid; j < npad; j += nthreads) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < n) {
      const float* p = boxes + (base + j) * 4;
      v = aligned ? __ldg(reinterpret_cast<const float4*>(p))
                  : make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
    }
    sbox[j] = v;
  }
  for (int q = 0; q < owned; ++q) {
    const int j = ((q * nwarps + warp) << 5) + lane;
    const bool live = j < n && valid[base + j];
    if constexpr (kGlobal) {
      if (j < npad) deadb[j] = !live;
    } else if (live) {
      dead &= ~(1u << q);
    }
  }
  __syncthreads();

  // 1. per live box: the earlier live boxes of its block that would remove it
  for (int q = 0; q < owned; ++q) {
    const int blk = q * nwarps + warp;
    if (blk >= nblk) break;
    const bool live = !is_dead(q);
    const uint32_t earlier = __ballot_sync(kFull, live) & ((1u << lane) - 1u);
    const int j = (blk << 5) + lane;
    const float4* block = sbox + (blk << 5);
    if constexpr (kGlobal) {
      stage[(warp << 5) + lane] = sbox[j];
      __syncwarp();
      block = stage + (warp << 5);
    }
    own[j] = live ? hits(block, nullptr, lane, earlier, block[lane], t) : 0u;
    if constexpr (kGlobal) __syncwarp();                      // the stage is reused
  }
  long long t_prologue = 0;
  if (kTimed) t_prologue = clock64();

  // 2 + 3. Round blk: every warp tests its blocks from blk on against the
  // boxes kept in block blk - 1; the owner of block blk does that block
  // first, walks it and publishes it before it goes on to its others.
  int ow = 0, qo = 0;                                         // owner warp of blk, its q
  for (int blk = 0; blk < nblk; ++blk) {
    if (blk > 0) __syncthreads();                             // block blk - 1 is published
    const uint32_t kw = blk > 0 ? keptw[blk - 1] : 0u;
    const float4* list = klist + (((blk - 1) & 1) << 5);
    const float* areas = karea + (((blk - 1) & 1) << 5);
    const int count = __popc(kw);
    const uint32_t all = count ? kFull >> (32 - count) : 0u;
    int q = qo + (warp < ow ? 1 : 0);                         // my first block from blk on
    if (warp == ow) {
      long long w0 = 0;
      if (kTimed) w0 = clock64();
      const int j = (blk << 5) + lane;
      const float4 me = sbox[j];
      bool live = !is_dead(q);
      if (live && hits(list, areas, count, all, me, t)) {
        live = false;
        kill(q);
      }
      const uint32_t mine = own[j];
      uint32_t kept = __ballot_sync(kFull, live);
      int rounds = 1;
      for (; rounds <= 32; ++rounds) {
        const uint32_t next = __ballot_sync(kFull, live && !(mine & kept));
        if (next == kept) break;
        kept = next;
      }
      if ((kept >> lane) & 1u) {
        const int slot = ((blk & 1) << 5) + __popc(kept & ((1u << lane) - 1u));
        klist[slot] = me;
        karea[slot] = box_area(me);
      }
      if (lane == 0) {
        keptw[blk] = kept;
        if (kTimed) {
          atomicAdd(&timing[0], (unsigned long long)(clock64() - w0));
          atomicAdd(&timing[1], (unsigned long long)rounds);
        }
      }
      ++q;
    }
    if (count) {
      for (; q < owned; ++q) {
        if (is_dead(q)) continue;
        const int j = ((q * nwarps + warp) << 5) + lane;
        if (hits(list, areas, count, all, sbox[j], t)) kill(q);
      }
    }
    if (++ow == nwarps) {
      ow = 0;
      ++qo;
    }
  }

  __syncthreads();                                            // the last block is published
  for (int j = tid; j < n; j += nthreads) keep[base + j] = (keptw[j >> 5] >> (j & 31)) & 1u;
  if (kTimed) {
    __syncthreads();
    if (tid == 0) {
      long long* c = cycles + (size_t)blockIdx.x * 4;
      c[0] = clock64() - t_start;
      c[1] = t_prologue - t_start;
      c[2] = (long long)timing[0];
      c[3] = (long long)timing[1];
    }
  }
}

template <bool kTimed>
int launch_global(const float* boxes, const uint8_t* valid, uint8_t* keep, int batch, int n,
                  float thr, long long* cycles, uint8_t* scratch, cudaStream_t stream) {
  if (scratch == nullptr || reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int aligned = reinterpret_cast<uintptr_t>(boxes) % 16 == 0;
  nms_mask_kernel<kTimed, true><<<batch, kMaxThreads, smem_bytes_global(), stream>>>(
      boxes, valid, keep, n, thr, aligned, cycles, scratch);
  return (int)cudaGetLastError();
}

template <bool kTimed>
int launch(const float* boxes, const uint8_t* valid, uint8_t* keep, int batch, int n, float thr,
           long long* cycles, uint8_t* scratch, cudaStream_t stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (n > kSharedN) return launch_global<kTimed>(boxes, valid, keep, batch, n, thr, cycles,
                                                 scratch, stream);
  const int nblk = (n + 31) / 32;
  const int threads = nblk * 32 < kMaxThreads ? nblk * 32 : kMaxThreads;
  const size_t smem = smem_bytes(nblk);
  // per process and device: whether this instantiation may use more than
  // 48 KB of dynamic shared memory (N > 2368)
  static bool opted_in[kMaxDevices];
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
    if (!opted_in[dev]) {
      err = cudaFuncSetAttribute(nms_mask_kernel<kTimed, false>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_bytes(kSharedN / 32));
      if (err != cudaSuccess) return (int)err;
      opted_in[dev] = true;
    }
  }
  const int aligned = reinterpret_cast<uintptr_t>(boxes) % 16 == 0;
  nms_mask_kernel<kTimed, false><<<batch, threads, smem, stream>>>(
      boxes, valid, keep, n, thr, aligned, cycles, nullptr);
  return (int)cudaGetLastError();
}

}  // namespace

// N <= 8192, no scratch: the entry point every earlier build of this kernel
// has, kept for tools/compare_builds.py (larger N returns cudaErrorInvalidValue).
extern "C" int w2t_nms_mask(const float* boxes, const uint8_t* valid, uint8_t* keep,
                            int batch, int n, float thr, void* stream) {
  if (n > kSharedN) return (int)cudaErrorInvalidValue;
  return launch<false>(boxes, valid, keep, batch, n, thr, nullptr, nullptr, (cudaStream_t)stream);
}

// Bytes of scratch per image that any N needs (0 up to 8192, where the
// shared-memory variant runs).
extern "C" long long w2t_nms_scratch_bytes(int n) {
  return n > kSharedN ? (long long)scratch_bytes(n) : 0;
}

// Any N: scratch holds batch * w2t_nms_scratch_bytes(n) bytes, 16-byte
// aligned (null up to 8192). cycles null runs the untimed build; else the
// timed one writes per image cycles (batch, 4) int64 = {whole CTA, prologue,
// owners' turns summed, fixpoint rounds}.
extern "C" int w2t_nms_mask_any(const float* boxes, const uint8_t* valid, uint8_t* keep,
                                int batch, int n, float thr, long long* cycles, void* scratch,
                                void* stream) {
  uint8_t* s = static_cast<uint8_t*>(scratch);
  if (cycles != nullptr)
    return launch<true>(boxes, valid, keep, batch, n, thr, cycles, s, (cudaStream_t)stream);
  return launch<false>(boxes, valid, keep, batch, n, thr, nullptr, s, (cudaStream_t)stream);
}
