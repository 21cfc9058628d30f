// Backward of the integer-factor (2/4/8) bilinear upsample, NHWC bf16.
//
// Replaces the custom VJP of basi_tpu/ops/pallas/upsample_int.py (_bwd): the
// exact adjoint gx = Wh^T . g . Ww with the interpolation matrices of
// basi_tpu/ops/resize.py::_interp_matrix (align_corners=False). The JAX
// package runs it as two XLA einsums with bf16 weights and f32 accumulation,
// rows first, then columns, and one cast to bf16; this kernel keeps that
// order: for each output column p it sums the rows' contributions in f32,
// then adds Ww[p, w] times that sum, and rounds once at the store.
//
// Gather, not scatter: one thread owns one input pixel (n, h, w) and 8
// channels and reads every output pixel whose taps touch it. Per axis those
// are the 2f outputs o in [f*h - f/2, f*h + 3f/2 - 1], clipped to the image;
// each one's taps and weights come from the forward kernel's arithmetic
// (csrc/upsample_int.cu), so the edge clamps fold in exactly as
// _interp_matrix adds them (lo == hi at the bottom edge sums both weights).
// No atomics: the result is deterministic. Weights are multiples of 1/(2f),
// exact in bf16 and f32.
//
// Bound: memory. g is f^2 times the size of gx and is read about 4 times (a
// 16-byte vector per thread per tap, neighbouring threads on neighbouring
// addresses along C); the re-reads hit L1/L2, so HBM traffic is close to one
// pass over g plus one over gx.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Taps {
  int lo, hi;
  float w_lo, w_hi;
};

// The same taps as the forward kernel: f is a power of two, so
// (o + 0.5) * (1 / f) - 0.5 is exact in f32.
__device__ __forceinline__ Taps int_taps(int o, int in, float inv_f) {
  float src = (o + 0.5f) * inv_f - 0.5f;
  src = fminf(fmaxf(src, 0.0f), (float)(in - 1));
  int lo = (int)src;
  int hi = min(lo + 1, in - 1);
  float fr = src - (float)lo;
  return {lo, hi, 1.0f - fr, fr};
}

// Entry of the interpolation matrix at (output o, input i).
__device__ __forceinline__ float weight(int o, int i, int in, float inv_f) {
  const Taps t = int_taps(o, in, inv_f);
  return (t.lo == i ? t.w_lo : 0.0f) + (t.hi == i ? t.w_hi : 0.0f);
}

__device__ __forceinline__ void unpack8(const uint4 &v, float out[8]) {
  const __nv_bfloat162 *p = reinterpret_cast<const __nv_bfloat162 *>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float2 t = __bfloat1622float2(p[k]);
    out[2 * k] = t.x;
    out[2 * k + 1] = t.y;
  }
}

__global__ void upsample_int_bwd_bf16_kernel(const uint4 *__restrict__ g,
                                             uint4 *__restrict__ gx, int h,
                                             int w, int groups, int f,
                                             float inv_f) {
  // grid: (row of w*groups vectors, input row y, image b)
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= w * groups) return;
  const int gi = t % groups;
  const int x = t / groups;
  const int y = blockIdx.y;
  const int b = blockIdx.z;
  const int oh = h * f, ow = w * f;
  const int half = f / 2;
  const int o0 = max(0, f * y - half), o1 = min(oh - 1, f * y + f + half - 1);
  const int p0 = max(0, f * x - half), p1 = min(ow - 1, f * x + f + half - 1);
  const uint4 *img = g + (long long)b * oh * ow * groups + gi;

  float acc[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) acc[k] = 0.0f;
  for (int p = p0; p <= p1; ++p) {
    float col[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) col[k] = 0.0f;
    for (int o = o0; o <= o1; ++o) {
      const float wy = weight(o, y, h, inv_f);
      float v[8];
      unpack8(img[((long long)o * ow + p) * groups], v);
#pragma unroll
      for (int k = 0; k < 8; ++k) col[k] += wy * v[k];
    }
    const float wx = weight(p, x, w, inv_f);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc[k] += wx * col[k];
  }

  uint4 out;
  __nv_bfloat162 *o2 = reinterpret_cast<__nv_bfloat162 *>(&out);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    o2[k] = __floats2bfloat162_rn(acc[2 * k], acc[2 * k + 1]);
  gx[((long long)b * h + y) * w * groups + t] = out;
}

}  // namespace

// g: (n, f*h, f*w, c) bf16 NHWC-contiguous, 16-byte aligned, c % 8 == 0;
// gx: (n, h, w, c) bf16; n and h at most 65535 (grid z/y).
// Returns cudaGetLastError() after the launch.
extern "C" int basi_upsample_int_bwd_bf16(const void *g, void *gx, int n,
                                          int h, int w, int c, int f,
                                          void *stream) {
  const int groups = c / 8;
  const int threads = 256;
  const dim3 grid((w * groups + threads - 1) / threads, h, n);
  upsample_int_bwd_bf16_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint4 *)g, (uint4 *)gx, h, w, groups, f, 1.0f / (float)f);
  return (int)cudaGetLastError();
}
