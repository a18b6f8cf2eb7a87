// Swin's shifted-window multi-head attention, from the qkv projection of a
// padded map to the attention output, one CTA per (window, head).
//
// Replaces no Pallas kernel: the JAX package has no attention backbone. It
// was added with the Swin-T backbone (models/swin.py), whose every block runs
// it; ops/window_attention.py holds the plain PyTorch version it is held to.
//
// Contract (ops/window_attention.py): qkv (B, Hp, Wp, 3C) in the unshifted,
// padded layout, channels (q | k | v, head, dim); table ((2w-1)^2, heads)
// float32; out (B, Hp, Wp, C), channels (head, dim), in qkv's type. For the
// window (wy, wx) of the map rolled by (-shift, -shift), token t = (ty, tx)
// of the window reads and writes the unshifted position
// ((wy*7 + ty + shift) mod Hp, (wx*7 + tx + shift) mod Wp), so the roll, the
// partition and their reverses are index arithmetic. Per token pair (i, j):
//
//   s_ij = (q_i * 32^-0.5) . k_j + table[(yi - yj + 6) * 13 + (xi - xj + 6)]
//          (+ -100.0 on shifted maps when i and j lie in different regions
//           of the release's img_mask: each axis of the shifted map cut at
//           Hp - 7 and Hp - shift)
//   out_i = sum_j softmax_j(s_ij) v_j
//
// in float32 (the inputs converted exactly, the exponential by __expf), the
// result rounded once to the output type.
//
// What bounds it on Hopper: by what must move, bytes. q, k and v are read
// once and the output written once, 8 C bytes a padded token a block in bf16
// (150.9 MB a 640x960 Swin-T frame, 45 us at 3.35 TB/s), against 196 C
// operations a token (3.7 GFLOP a frame, 3.7 us on the tensor cores). A
// window's 49 x 49 scores never leave the SM. As built the kernel runs its
// products on the CUDA cores in float32, 307 kFLOP a (window, head), so it
// sits nearer the CUDA cores' issue rate than its bytes; a tensor-core
// (mma.sync) form is the next step. What the design does:
//
//   - a CTA of 64 threads takes one (window, head): its threads gather the
//     window's k and v rows (64 contiguous bytes a token and head in bf16,
//     16-byte loads) into shared memory, k transposed, with the table's
//     column for the head and each token's source offset and region label;
//   - thread i < 49 owns query row i: its q in registers, its 49 scores in
//     registers, accumulated over the head's 32 dims with each k^T row read
//     as broadcast float4s (49 independent FMA chains); bias, mask, softmax
//     and the 49 x 32 product with v (broadcast float4 rows) follow in
//     registers, and the row is written once;
//   - explicit fmaf: the build passes -fmad=false for the other kernels,
//     which would split every multiply-add in two.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kW = 7;                        // window side
constexpr int kN = kW * kW;                  // tokens a window
constexpr int kNPad = 52;                    // a k^T row, padded to whole float4s
constexpr int kD = 32;                       // head dim
constexpr int kTableSide = 2 * kW - 1;
constexpr int kTable = kTableSide * kTableSide;
constexpr int kThreads = 64;
constexpr float kMask = -100.0f;             // the release's constant, not -inf

template <typename T> struct Elem;
template <> struct Elem<float> {
  static constexpr int kVec = 4;             // elements a 16-byte load
  __device__ static void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
  __device__ static void store(float* p, const float* f) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <> struct Elem<__nv_bfloat16> {
  static constexpr int kVec = 8;
  __device__ static void load(const __nv_bfloat16* p, float* f) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 v = __bfloat1622float2(h[u]);
      f[2 * u] = v.x;
      f[2 * u + 1] = v.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* f) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int u = 0; u < 4; ++u) h[u] = __floats2bfloat162_rn(f[2 * u], f[2 * u + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const T* __restrict__ qkv, const float* __restrict__ table,
                        T* __restrict__ out, int hp, int wp, int c, int heads, int shift,
                        int nww, int windows_per_image, float scale) {
  constexpr int kVec = Elem<T>::kVec;
  constexpr int kVecs = kD / kVec;           // 16-byte pieces of a token's head
  __shared__ __align__(16) float kt[kD][kNPad];
  __shared__ __align__(16) float vs[kN][kD];
  __shared__ float tab[kTable];
  __shared__ long long src[kN];              // token index in the unshifted map
  __shared__ int lab[kN];

  const int h = blockIdx.x % heads;
  const int win = blockIdx.x / heads;
  const int b = win / windows_per_image;
  const int wi = win % windows_per_image;
  const int wy = wi / nww, wx = wi % nww;
  const int tid = threadIdx.x;
  const long long row = 3LL * c;

  if (tid < kN) {
    const int Y = wy * kW + tid / kW, X = wx * kW + tid % kW;   // shifted map
    int y = Y + shift, x = X + shift;
    if (y >= hp) y -= hp;
    if (x >= wp) x -= wp;
    src[tid] = (static_cast<long long>(b) * hp + y) * wp + x;
    const int rh = Y < hp - kW ? 0 : (Y < hp - shift ? 1 : 2);
    const int rw = X < wp - kW ? 0 : (X < wp - shift ? 1 : 2);
    lab[tid] = shift ? rh * 3 + rw : 0;
  }
  for (int e = tid; e < kTable; e += kThreads) tab[e] = table[e * heads + h];
  for (int e = tid; e < kD * (kNPad - kN); e += kThreads)
    kt[e / (kNPad - kN)][kN + e % (kNPad - kN)] = 0.0f;
  __syncthreads();

  for (int task = tid; task < kN * 2 * kVecs; task += kThreads) {
    const int t = task / (2 * kVecs);
    const int r = task % (2 * kVecs);
    const int which = r / kVecs;             // 0: k, 1: v
    const int d0 = (r % kVecs) * kVec;
    float f[kVec];
    Elem<T>::load(qkv + src[t] * row + (1 + which) * c + h * kD + d0, f);
    if (which == 0) {
#pragma unroll
      for (int u = 0; u < kVec; ++u) kt[d0 + u][t] = f[u];
    } else {
#pragma unroll
      for (int u = 0; u < kVec; ++u) vs[t][d0 + u] = f[u];
    }
  }
  __syncthreads();
  if (tid >= kN) return;

  const int i = tid;
  float s[kNPad];
  {
    float q[kD];
#pragma unroll
    for (int p = 0; p < kVecs; ++p) Elem<T>::load(qkv + src[i] * row + h * kD + p * kVec,
                                                  q + p * kVec);
#pragma unroll
    for (int d = 0; d < kD; ++d) q[d] *= scale;
#pragma unroll
    for (int j = 0; j < kNPad; ++j) s[j] = 0.0f;
#pragma unroll
    for (int d = 0; d < kD; ++d) {
      const float qd = q[d];
#pragma unroll
      for (int j4 = 0; j4 < kNPad / 4; ++j4) {
        const float4 k4 = *reinterpret_cast<const float4*>(&kt[d][4 * j4]);
        s[4 * j4] = fmaf(qd, k4.x, s[4 * j4]);
        s[4 * j4 + 1] = fmaf(qd, k4.y, s[4 * j4 + 1]);
        s[4 * j4 + 2] = fmaf(qd, k4.z, s[4 * j4 + 2]);
        s[4 * j4 + 3] = fmaf(qd, k4.w, s[4 * j4 + 3]);
      }
    }
  }
  const int base = (i / kW + kW - 1) * kTableSide + (i % kW + kW - 1);
  const int li = lab[i];
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    float v = s[j] + tab[base - ((j / kW) * kTableSide + j % kW)];
    if (lab[j] != li) v += kMask;
    s[j] = v;
    m = fmaxf(m, v);
  }
  float l = 0.0f;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    s[j] = __expf(s[j] - m);
    l += s[j];
  }
  float acc[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] = 0.0f;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const float pj = s[j];
#pragma unroll
    for (int d4 = 0; d4 < kD / 4; ++d4) {
      const float4 v4 = *reinterpret_cast<const float4*>(&vs[j][4 * d4]);
      acc[4 * d4] = fmaf(pj, v4.x, acc[4 * d4]);
      acc[4 * d4 + 1] = fmaf(pj, v4.y, acc[4 * d4 + 1]);
      acc[4 * d4 + 2] = fmaf(pj, v4.z, acc[4 * d4 + 2]);
      acc[4 * d4 + 3] = fmaf(pj, v4.w, acc[4 * d4 + 3]);
    }
  }
  const float inv = 1.0f / l;
#pragma unroll
  for (int d = 0; d < kD; ++d) acc[d] *= inv;
  T* dst = out + src[i] * c + h * kD;
#pragma unroll
  for (int p = 0; p < kVecs; ++p) Elem<T>::store(dst + p * kVec, acc + p * kVec);
}

}  // namespace

// qkv, table, out: device pointers, 16-byte aligned; C = heads * 32; Hp and
// Wp multiples of 7; 0 <= shift < 7; bf16 != 0 for bfloat16 qkv and out,
// else float32. Launches on `stream`, allocates nothing; returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a shape it does not
// take).
extern "C" int w2t_window_attention(const void* qkv, const void* table, void* out, int b,
                                    int hp, int wp, int c, int heads, int shift, int bf16,
                                    void* stream) {
  if (b < 0 || hp % kW || wp % kW || heads <= 0 || c != heads * kD || shift < 0 ||
      shift >= kW)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(qkv) | reinterpret_cast<uintptr_t>(table) |
       reinterpret_cast<uintptr_t>(out)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int nww = wp / kW;
  const long long windows = static_cast<long long>(hp / kW) * nww;
  const long long problems = static_cast<long long>(b) * windows * heads;
  if (problems == 0) return 0;
  if (problems > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(static_cast<float>(kD));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(problems));
  if (bf16) {
    window_attention_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(qkv), static_cast<const float*>(table),
        static_cast<__nv_bfloat16*>(out), hp, wp, c, heads, shift, nww,
        static_cast<int>(windows), scale);
  } else {
    window_attention_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(qkv), static_cast<const float*>(table),
        static_cast<float*>(out), hp, wp, c, heads, shift, nww, static_cast<int>(windows),
        scale);
  }
  return static_cast<int>(cudaGetLastError());
}
