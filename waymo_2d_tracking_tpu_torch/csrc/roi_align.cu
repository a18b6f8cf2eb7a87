// RoIAlign (aligned=True, sampling ratio s) as a direct bilinear gather, one
// CTA per (image, RoI, group of output rows), a vector of channels per thread.
//
// Replaces the Pallas TPU kernel _roi_align_kernel of the JAX package's
// ops/roi_align.py (launched by pallas_roi_align). Same contract and the same
// arithmetic per output (pi, qi, c):
//
//   f = box * spatial_scale - 0.5, bin = (f2 - f1) / P;
//   sample y = fy1 + (pi + (a + 0.5) / s) * bin_h, in range when -1 <= y <= H,
//   clipped to [0, H-1], y0 = min(floor(y), H-2), ly = y - y0, weights
//   (1 - ly) / s and ly / s (0 out of range); the same along x;
//   G(x) = sum_a (wlo_a * F[y0_a, x] + whi_a * F[y0_a + 1, x])   (y-blend)
//   out  = sum_b (wlo_b * G(x0_b) + whi_b * G(x0_b + 1))          (x-blend)
//
// accumulated in f32 in that order, each operation rounded on its own (_rn
// intrinsics; the build passes -fmad=false), stored in the features' dtype.
//
// What bounds it on Hopper: by the count of what must move, bytes (the chunk
// of 128 images reads 154 MB of bf16 features and writes 103 MB of pooled
// output, 0.077 ms at 3.35 TB/s). Each output also reads 4 s^2 feature values
// (16 at s = 2) that neighbouring bins share, so beyond the map read once
// everything is L1/L2 traffic, load instructions and, with every product and
// sum rounded on its own, about 56 arithmetic instructions an output channel:
// as built the kernel is nearer its instruction issue than its bytes. The
// TPU kernel staged the map in VMEM and sliced an aligned 32-row window
// because a TPU cannot gather; that layout constraint is not carried over.
// What the design does:
//
//   - a thread owns V consecutive channels of one output bin and keeps their
//     accumulators in registers; every load and store moves V channels at
//     once, 16 bytes where it can (V = 8 bf16 or 4 f32). V is the widest
//     power of two that divides C and that the pointers' alignment allows,
//     down to 1, so any C and any contiguous tensor is taken;
//   - threads are laid out (channel group, output column): consecutive lanes
//     read consecutive 16-byte pieces of one NHWC pixel, so a warp's load is
//     whole 128-byte lines, and no thread divides to find its bin;
//   - a RoI is split over its P output rows (grid (R, N, P)) while that is
//     what fills the card: one image with 64 RoIs launches 448 CTAs. With
//     many RoIs a CTA takes more rows, up to the whole RoI at the chunk shape,
//     so that its rows find their shared feature pixels in L1; a CTA computes
//     the sample tables of its rows and of all columns once into shared
//     memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxSamples = 128;   // P * s per axis
constexpr int kSplitCtas = 2048;   // split RoIs over rows while there are fewer CTAs

struct Sample {
  int lower;
  float w_lo, w_hi;
};

template <int BYTES> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// an element's storage bits and its value as a float
template <typename T> struct Elem;
template <> struct Elem<float> {
  using bits = unsigned int;
  static __device__ __forceinline__ float get(bits b) { return __uint_as_float(b); }
  static __device__ __forceinline__ bits put(float v) { return __float_as_uint(v); }
};
template <> struct Elem<__nv_bfloat16> {
  using bits = unsigned short;
  static __device__ __forceinline__ float get(bits b) {
    return __uint_as_float((unsigned int)b << 16);
  }
  static __device__ __forceinline__ bits put(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

// V consecutive channels at p (aligned to V * sizeof(T)) as floats, one load
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  using R = typename Raw<sizeof(T) * V>::type;
  union {
    R raw;
    typename Elem<T>::bits elem[V];
  } u;
  u.raw = __ldg(reinterpret_cast<const R*>(p));
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = Elem<T>::get(u.elem[k]);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  using R = typename Raw<sizeof(T) * V>::type;
  union {
    R raw;
    typename Elem<T>::bits elem[V];
  } u;
#pragma unroll
  for (int k = 0; k < V; ++k) u.elem[k] = Elem<T>::put(v[k]);
  *reinterpret_cast<R*>(p) = u.raw;
}

// sample j = pi * s + a along one axis of `size` pixels
__device__ __forceinline__ Sample sample(float start, float bin, int j, int s, int size) {
  const int pi = j / s, a = j - pi * s;
  const double inv_s = 1.0 / s;
  const float off = (float)(pi + (a + 0.5) * inv_s);
  const float pos = __fadd_rn(start, __fmul_rn(off, bin));
  const bool in_range = pos >= -1.0f && pos <= (float)size;
  const float posc = fminf(fmaxf(pos, 0.0f), (float)(size - 1));
  const float lower = fminf(floorf(posc), (float)(size - 2));
  const float frac = __fsub_rn(posc, lower);
  Sample out;
  out.lower = (int)lower;
  out.w_lo = in_range ? __fmul_rn(__fsub_rn(1.0f, frac), (float)inv_s) : 0.0f;
  out.w_hi = in_range ? __fmul_rn(frac, (float)inv_s) : 0.0f;
  return out;
}

// blockDim = (channel groups, output columns), either looped over when the
// RoI row has more of them; grid = (RoI, image, group of `rows` output rows)
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
roi_align_kernel(const T* __restrict__ feats, const float* __restrict__ boxes,
                 T* __restrict__ out, int h, int w, int c, int r, int p, int s, int rows,
                 float spatial_scale) {
  __shared__ Sample ys[kMaxSamples];   // the rows * s samples of this CTA's output rows
  __shared__ Sample xs[kMaxSamples];   // the P * s samples of all columns
  const int roi = blockIdx.x, img = blockIdx.y;
  const int pi0 = blockIdx.z * rows;
  const int pi1 = pi0 + rows < p ? pi0 + rows : p;
  const float* box = boxes + ((size_t)img * r + roi) * 4;
  const float fx1 = __fsub_rn(__fmul_rn(box[0], spatial_scale), 0.5f);
  const float fy1 = __fsub_rn(__fmul_rn(box[1], spatial_scale), 0.5f);
  const float fx2 = __fsub_rn(__fmul_rn(box[2], spatial_scale), 0.5f);
  const float fy2 = __fsub_rn(__fmul_rn(box[3], spatial_scale), 0.5f);
  const float bin_w = __fdiv_rn(__fsub_rn(fx2, fx1), (float)p);
  const float bin_h = __fdiv_rn(__fsub_rn(fy2, fy1), (float)p);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int j = tid; j < p * s; j += nthreads) xs[j] = sample(fx1, bin_w, j, s, w);
  for (int j = pi0 * s + tid; j < pi1 * s; j += nthreads)
    ys[j - pi0 * s] = sample(fy1, bin_h, j, s, h);
  __syncthreads();

  const T* f = feats + (size_t)img * h * w * c;
  const size_t row_stride = (size_t)w * c;
  for (int pi = pi0; pi < pi1; ++pi) {
    T* o = out + (((size_t)img * r + roi) * p + pi) * p * c;
    for (int qi = threadIdx.y; qi < p; qi += blockDim.y) {
      for (int ch = threadIdx.x * V; ch < c; ch += blockDim.x * V) {
        float acc[V];
#pragma unroll
        for (int k = 0; k < V; ++k) acc[k] = 0.0f;
        for (int b = 0; b < s; ++b) {
          const Sample sx = xs[qi * s + b];
          float g_lo[V], g_hi[V];
#pragma unroll
          for (int k = 0; k < V; ++k) g_lo[k] = g_hi[k] = 0.0f;
          for (int a = 0; a < s; ++a) {
            const Sample sy = ys[(pi - pi0) * s + a];
            const T* row0 = f + ((size_t)sy.lower * w + sx.lower) * c + ch;
            const T* row1 = row0 + row_stride;
            float f00[V], f10[V], f01[V], f11[V];
            load_vec<T, V>(row0, f00);
            load_vec<T, V>(row1, f10);
            load_vec<T, V>(row0 + c, f01);
            load_vec<T, V>(row1 + c, f11);
#pragma unroll
            for (int k = 0; k < V; ++k) {
              g_lo[k] = __fadd_rn(g_lo[k], __fadd_rn(__fmul_rn(sy.w_lo, f00[k]),
                                                     __fmul_rn(sy.w_hi, f10[k])));
              g_hi[k] = __fadd_rn(g_hi[k], __fadd_rn(__fmul_rn(sy.w_lo, f01[k]),
                                                     __fmul_rn(sy.w_hi, f11[k])));
            }
          }
#pragma unroll
          for (int k = 0; k < V; ++k)
            acc[k] = __fadd_rn(__fadd_rn(acc[k], __fmul_rn(sx.w_lo, g_lo[k])),
                               __fmul_rn(sx.w_hi, g_hi[k]));
        }
        store_vec<T, V>(o + (size_t)qi * c + ch, acc);
      }
    }
  }
}

template <typename T, int V>
int launch(const void* feats, const float* boxes, void* out, int batch, int h, int w, int c,
           int r, int p, int s, float spatial_scale, cudaStream_t stream) {
  const int groups = c / V;
  int bx = groups < kMaxThreads ? groups : kMaxThreads;
  int by = kMaxThreads / bx;
  by = by < p ? by : p;
  // one output row a CTA while that is what fills the card; with many RoIs
  // more rows each, up to the whole RoI, so that a CTA's rows share their
  // feature pixels in L1 and the sample tables are computed once
  int rows = (int)(((long long)r * batch * p) / kSplitCtas);
  rows = rows < 1 ? 1 : (rows > p ? p : rows);
  const dim3 block(bx, by), grid(r, batch, (p + rows - 1) / rows);
  roi_align_kernel<T, V><<<grid, block, 0, stream>>>((const T*)feats, boxes, (T*)out, h, w, c, r,
                                                     p, s, rows, spatial_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int w2t_roi_align(const void* feats, const float* boxes, void* out,
                             int batch, int h, int w, int c, int r, int p, int s,
                             float spatial_scale, int bf16, void* stream) {
  if (batch <= 0 || r <= 0 || c <= 0) return 0;
  if (h < 2 || w < 2 || p < 1 || s < 1 || p * s > kMaxSamples || batch > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  // the widest vector of channels, up to 16 bytes, that divides C and that
  // both pointers are aligned to (every pixel and output bin starts at a
  // multiple of C elements)
  const int elem = bf16 ? 2 : 4;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(feats) | reinterpret_cast<uintptr_t>(out);
  int v = 16 / elem;
  while (v > 1 && (c % v != 0 || addr % (uintptr_t)(v * elem) != 0)) v >>= 1;
  if (bf16) {
    switch (v) {
      case 8: return launch<__nv_bfloat16, 8>(feats, boxes, out, batch, h, w, c, r, p, s, spatial_scale, st);
      case 4: return launch<__nv_bfloat16, 4>(feats, boxes, out, batch, h, w, c, r, p, s, spatial_scale, st);
      case 2: return launch<__nv_bfloat16, 2>(feats, boxes, out, batch, h, w, c, r, p, s, spatial_scale, st);
      default: return launch<__nv_bfloat16, 1>(feats, boxes, out, batch, h, w, c, r, p, s, spatial_scale, st);
    }
  }
  switch (v) {
    case 4: return launch<float, 4>(feats, boxes, out, batch, h, w, c, r, p, s, spatial_scale, st);
    case 2: return launch<float, 2>(feats, boxes, out, batch, h, w, c, r, p, s, spatial_scale, st);
    default: return launch<float, 1>(feats, boxes, out, batch, h, w, c, r, p, s, spatial_scale, st);
  }
}
