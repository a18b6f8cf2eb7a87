// RoIAlign (aligned=True, sampling ratio s) as a direct bilinear gather, one
// CTA per (image, RoI).
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
// What bounds it on Hopper: the gathers. Each output reads 4 s^2 feature
// values (16 at s = 2), which neighbouring bins share, so the bytes from
// device memory are about the features under the RoIs and the rest hits L1/L2;
// the arithmetic is a few operations per load. The TPU kernel staged the map
// in VMEM and sliced an aligned 32-row window because a TPU cannot gather;
// that layout constraint is not carried over. Here threads cover the
// P * P * C outputs with the channel fastest, so the 32 lanes of a warp read
// 32 consecutive channels of one NHWC pixel: every load is coalesced. The
// per-sample indices and weights (2 * P * s of them) are computed once per
// CTA into shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSamples = 128;   // P * s per axis

struct Sample {
  int lower;
  float w_lo, w_hi;
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(p[0]);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
roi_align_kernel(const T* __restrict__ feats, const float* __restrict__ boxes,
                 T* __restrict__ out, int h, int w, int c, int r, int p, int s,
                 float spatial_scale) {
  __shared__ Sample ys[kMaxSamples];
  __shared__ Sample xs[kMaxSamples];
  const int roi = blockIdx.x, img = blockIdx.y;
  const float* box = boxes + ((size_t)img * r + roi) * 4;
  const float fx1 = __fsub_rn(__fmul_rn(box[0], spatial_scale), 0.5f);
  const float fy1 = __fsub_rn(__fmul_rn(box[1], spatial_scale), 0.5f);
  const float fx2 = __fsub_rn(__fmul_rn(box[2], spatial_scale), 0.5f);
  const float fy2 = __fsub_rn(__fmul_rn(box[3], spatial_scale), 0.5f);
  const float bin_w = __fdiv_rn(__fsub_rn(fx2, fx1), (float)p);
  const float bin_h = __fdiv_rn(__fsub_rn(fy2, fy1), (float)p);
  const int ps = p * s;
  for (int j = threadIdx.x; j < ps; j += blockDim.x) {
    ys[j] = sample(fy1, bin_h, j, s, h);
    xs[j] = sample(fx1, bin_w, j, s, w);
  }
  __syncthreads();

  const T* f = feats + (size_t)img * h * w * c;
  T* o = out + ((size_t)img * r + roi) * p * p * c;
  const int total = p * p * c;
  for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
    const int ch = idx % c;
    const int q = idx / c;
    const int pi = q / p, qi = q - pi * p;
    float acc = 0.0f;
    for (int b = 0; b < s; ++b) {
      const Sample sx = xs[qi * s + b];
      float g_lo = 0.0f, g_hi = 0.0f;
      for (int a = 0; a < s; ++a) {
        const Sample sy = ys[pi * s + a];
        const T* row0 = f + ((size_t)sy.lower * w + sx.lower) * c + ch;
        const T* row1 = row0 + (size_t)w * c;
        g_lo = __fadd_rn(g_lo, __fadd_rn(__fmul_rn(sy.w_lo, load(row0)),
                                         __fmul_rn(sy.w_hi, load(row1))));
        g_hi = __fadd_rn(g_hi, __fadd_rn(__fmul_rn(sy.w_lo, load(row0 + c)),
                                         __fmul_rn(sy.w_hi, load(row1 + c))));
      }
      acc = __fadd_rn(__fadd_rn(acc, __fmul_rn(sx.w_lo, g_lo)), __fmul_rn(sx.w_hi, g_hi));
    }
    store(o + idx, acc);
  }
}

}  // namespace

extern "C" int w2t_roi_align(const void* feats, const float* boxes, void* out,
                             int batch, int h, int w, int c, int r, int p, int s,
                             float spatial_scale, int bf16, void* stream) {
  if (batch <= 0 || r <= 0 || c <= 0) return 0;
  if (h < 2 || w < 2 || p < 1 || s < 1 || p * s > kMaxSamples || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(r, batch);
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16) {
    roi_align_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)feats, boxes, (__nv_bfloat16*)out, h, w, c, r, p, s,
        spatial_scale);
  } else {
    roi_align_kernel<float><<<grid, kThreads, 0, st>>>(
        (const float*)feats, boxes, (float*)out, h, w, c, r, p, s, spatial_scale);
  }
  return (int)cudaGetLastError();
}
