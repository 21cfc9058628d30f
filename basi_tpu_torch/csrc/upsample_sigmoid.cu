// Fused bilinear upsample + sigmoid of low-resolution mask logits.
//
// Replaces basi_tpu/ops/pallas/upsample_sigmoid.py::upsample_sigmoid, which
// computes sigmoid(Wh @ x @ Ww) per mask as two f32 matmuls at HIGHEST
// precision (a reduced-precision pass cost 2.4e-3 against a 1e-3 budget).
// Each output pixel depends on 4 input pixels, so a direct gather in f32 is
// exact by construction and cannot fall into TF32 or bf16 matmul. The taps
// and weights follow basi_tpu/ops/resize.py::_interp_matrix
// (align_corners=False) for any input/output size: the source coordinate is
// computed in double with the same two roundings numpy makes, then the
// weights round to f32 as the matrix entries do. Rows blend first, then
// columns, as in the matmul order.
//
// Bound: memory, by the f32 store of B*K*H*W*4 bytes (about 168 MB for the
// serving batch of 8 images x 20 slots at 512^2); the (B, K, h, w) logits are
// read once through L1/L2. One thread owns one output column of kRows rows,
// so neighbouring threads store neighbouring addresses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Taps {
  int lo, hi;
  float w_lo, w_hi;
};

__device__ __forceinline__ Taps taps(int o, int in, int out) {
  const double scale = (double)in / (double)out;
  // __dmul_rn/__dadd_rn: no FMA contraction, matching numpy's two roundings.
  double src = __dadd_rn(__dmul_rn((double)o + 0.5, scale), -0.5);
  src = fmin(fmax(src, 0.0), (double)(in - 1));
  const int lo = (int)src;  // src >= 0: truncation is floor
  const int hi = min(lo + 1, in - 1);
  const double fr = src - (double)lo;
  return {lo, hi, (float)(1.0 - fr), (float)fr};
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Output rows per thread: the loop amortises the block launch and the
// column taps. On the serving call (8 x 20 masks, 128^2 -> 512^2, H100 80GB
// HBM3 at 700 W) one row per thread (164K short blocks) measured 0.31 ms of
// device time, 8 rows per thread 0.15 ms (1.1 TB/s).
constexpr int kRows = 8;

template <typename T>
__global__ void upsample_sigmoid_kernel(const T *__restrict__ x,
                                        float *__restrict__ y, int h, int w,
                                        int oh, int ow) {
  // grid: (output columns, groups of kRows output rows, mask m) -- no
  // 64-bit division on the index path.
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  if (ox >= ow) return;
  const int m = blockIdx.z;
  const Taps tx = taps(ox, w, ow);
  const T *img = x + (long long)m * h * w;
  float *out = y + (long long)m * oh * ow + ox;
  const int oy_end = min(oh, (int)(blockIdx.y + 1) * kRows);
  for (int oy = blockIdx.y * kRows; oy < oy_end; ++oy) {
    const Taps ty = taps(oy, h, oh);
    const float a = to_f32(img[ty.lo * w + tx.lo]);
    const float bb = to_f32(img[ty.lo * w + tx.hi]);
    const float c = to_f32(img[ty.hi * w + tx.lo]);
    const float d = to_f32(img[ty.hi * w + tx.hi]);
    const float col_lo = ty.w_lo * a + ty.w_hi * c;
    const float col_hi = ty.w_lo * bb + ty.w_hi * d;
    const float v = tx.w_lo * col_lo + tx.w_hi * col_hi;
    out[(long long)oy * ow] = 1.0f / (1.0f + expf(-v));
  }
}

template <typename T>
int launch(const void *x, void *y, int b, int h, int w, int oh, int ow,
           void *stream) {
  const int threads = 256;
  const dim3 grid((ow + threads - 1) / threads, (oh + kRows - 1) / kRows, b);
  upsample_sigmoid_kernel<T><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const T *)x, (float *)y, h, w, oh, ow);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (b, h, w) contiguous logits; y: (b, oh, ow) f32 probabilities; b at
// most 65535 (grid z).
// Each returns cudaGetLastError() after the launch.
extern "C" int basi_upsample_sigmoid_f32(const void *x, void *y, int b, int h,
                                         int w, int oh, int ow, void *stream) {
  return launch<float>(x, y, b, h, w, oh, ow, stream);
}

extern "C" int basi_upsample_sigmoid_bf16(const void *x, void *y, int b, int h,
                                          int w, int oh, int ow,
                                          void *stream) {
  return launch<__nv_bfloat16>(x, y, b, h, w, oh, ow, stream);
}

extern "C" const char *basi_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
