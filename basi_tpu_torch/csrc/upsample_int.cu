// Integer-factor (2/4/8) bilinear upsample of NHWC bf16 features.
//
// Replaces basi_tpu/ops/pallas/upsample_int.py::upsample_int (both its
// per-image NHWC and whole-batch HWNC Pallas variants, which compute the same
// function). Semantics are those of basi_tpu/ops/resize.py::_interp_matrix
// with align_corners=False: per axis src = (o + 0.5) / f - 0.5 clamped to
// [0, in - 1], taps lo = floor(src), hi = min(lo + 1, in - 1), weights
// (1 - frac, frac). The blend runs in f32 (rows first, then columns, the
// order of the einsum reference) and rounds to bf16 once at the store.
//
// Bound: memory. The kernel reads N*h*w*C*2 bytes and writes f^2 times that;
// there is no reuse worth staging in shared memory (each input pixel feeds at
// most 4*f^2 outputs, all served from L1/L2). The TPU kernel's banded column
// matmul existed to keep the MXU busy and is not carried over: here it would
// only add FLOPs. One thread owns one output pixel and 8 channels, so every
// load and store is a 16-byte vector and neighbouring threads touch
// neighbouring addresses along C.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Taps {
  int lo, hi;
  float w_lo, w_hi;
};

// f is a power of two, so (o + 0.5) * (1 / f) - 0.5 is exact in f32 and the
// weights equal the f32 entries of _interp_matrix bit for bit.
__device__ __forceinline__ Taps int_taps(int o, int in, float inv_f) {
  float src = (o + 0.5f) * inv_f - 0.5f;
  src = fminf(fmaxf(src, 0.0f), (float)(in - 1));
  int lo = (int)src;  // src >= 0: truncation is floor
  int hi = min(lo + 1, in - 1);
  float fr = src - (float)lo;
  return {lo, hi, 1.0f - fr, fr};
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

__global__ void upsample_int_bf16_kernel(const uint4 *__restrict__ x,
                                         uint4 *__restrict__ y, int h, int w,
                                         int groups, int f, float inv_f) {
  // grid: (row of f*w*groups vectors, output row oy, image b) -- no 64-bit
  // division on the index path.
  const int ow = w * f;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= ow * groups) return;
  const int g = t % groups;
  const int ox = t / groups;
  const int oy = blockIdx.y;
  const int b = blockIdx.z;

  const Taps ty = int_taps(oy, h, inv_f);
  const Taps tx = int_taps(ox, w, inv_f);
  const uint4 *img = x + (long long)b * h * w * groups + g;
  float a[8], bb[8], c[8], d[8];
  unpack8(img[((long long)ty.lo * w + tx.lo) * groups], a);
  unpack8(img[((long long)ty.lo * w + tx.hi) * groups], bb);
  unpack8(img[((long long)ty.hi * w + tx.lo) * groups], c);
  unpack8(img[((long long)ty.hi * w + tx.hi) * groups], d);

  uint4 out;
  __nv_bfloat162 *o2 = reinterpret_cast<__nv_bfloat162 *>(&out);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float r[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int q = 2 * k + j;
      const float col_lo = ty.w_lo * a[q] + ty.w_hi * c[q];
      const float col_hi = ty.w_lo * bb[q] + ty.w_hi * d[q];
      r[j] = tx.w_lo * col_lo + tx.w_hi * col_hi;
    }
    o2[k] = __floats2bfloat162_rn(r[0], r[1]);
  }
  y[((long long)b * h * f + oy) * ow * groups + t] = out;
}

}  // namespace

// x: (n, h, w, c) bf16 NHWC-contiguous, 16-byte aligned, c % 8 == 0;
// y: (n, f*h, f*w, c) bf16; n and f*h at most 65535 (grid y/z).
// Returns cudaGetLastError() after the launch.
extern "C" int basi_upsample_int_bf16(const void *x, void *y, int n, int h,
                                      int w, int c, int f, void *stream) {
  const int groups = c / 8;
  const int threads = 256;
  const dim3 grid((w * f * groups + threads - 1) / threads, h * f, n);
  upsample_int_bf16_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint4 *)x, (uint4 *)y, h, w, groups, f, 1.0f / (float)f);
  return (int)cudaGetLastError();
}
