// Fused per-image horizontal flip + normalize of a raw uint8 NHWC batch.
//
// Replaces basi_tpu/ops/pallas/normalize_aug.py::normalize_and_flip (raw
// C = 3 layout; the port has no s2d stem). Semantics are the Pallas body's:
// per element x = (float)u8 * (1/255), then x * inv_std[c] + neg_mean[c],
// each step rounded in f32 (__fmul_rn / __fadd_rn: no FMA contraction, so
// rows built on the host match the kernel bit for bit), then one rounding to
// the output type (bf16 round-to-nearest-even, or f32). Where an image's flag
// is set, pixel w reads its three bytes from column W - 1 - w: the flip that
// the JAX package does as an XLA where + reverse on the bytes before its
// kernel is folded into the load addresses here.
//
// Bound: memory. One pass reads N*H*W*3 bytes and writes 2x (bf16) or 4x
// (f32) that; there is no reuse to stage. One thread owns VEC consecutive
// output elements of an image (8 bf16 or 4 f32 = one 16-byte store); its
// byte loads stay inside a 24- or 12-byte window of one row (mirrored when
// flipped), served from L1. Neighbouring threads store neighbouring 16-byte
// vectors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Affine {
  float inv_std[3];
  float neg_mean[3];
};

__device__ __forceinline__ float norm_elem(const uint8_t *img, int e, int w,
                                           bool flip, const Affine &a) {
  // e: element index in the image (row-major H, W, 3)
  const int c = e % 3;
  const int pix = e / 3;
  const int row = pix / w;
  const int col = pix - row * w;
  const int src_col = flip ? (w - 1 - col) : col;
  const float x = (float)img[((long long)row * w + src_col) * 3 + c];
  return __fadd_rn(__fmul_rn(__fmul_rn(x, 1.0f / 255.0f), a.inv_std[c]),
                   a.neg_mean[c]);
}

template <typename Out>
__device__ __forceinline__ void store_vec(Out *dst, const float *v);

template <>
__device__ __forceinline__ void store_vec<__nv_bfloat16>(__nv_bfloat16 *dst,
                                                         const float *v) {
  uint4 out;
  __nv_bfloat162 *o2 = reinterpret_cast<__nv_bfloat162 *>(&out);
#pragma unroll
  for (int k = 0; k < 4; ++k) o2[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  *reinterpret_cast<uint4 *>(dst) = out;
}

template <>
__device__ __forceinline__ void store_vec<float>(float *dst, const float *v) {
  *reinterpret_cast<float4 *>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_one(__nv_bfloat16 *dst, float v) {
  *dst = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_one(float *dst, float v) { *dst = v; }

template <typename Out>
__global__ void normalize_flip_kernel(const uint8_t *__restrict__ x,
                                      const int32_t *__restrict__ flip,
                                      Out *__restrict__ y, int hw3, int w,
                                      Affine a) {
  // grid: (vectors of one image, image); hw3 = H * W * 3 elements per image.
  constexpr int VEC = 16 / sizeof(Out);
  const int b = blockIdx.y;
  const int e0 = (blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (e0 >= hw3) return;
  const bool f = flip[b] > 0;
  const uint8_t *img = x + (long long)b * hw3;
  Out *out = y + (long long)b * hw3;
  if (hw3 % VEC == 0) {  // every image starts 16-byte aligned: vector store
    float v[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = norm_elem(img, e0 + k, w, f, a);
    store_vec<Out>(out + e0, v);
  } else {
    for (int k = 0; k < VEC && e0 + k < hw3; ++k)
      store_one(out + e0 + k, norm_elem(img, e0 + k, w, f, a));
  }
}

template <typename Out>
int launch(const void *x, const void *flip, void *y, int n, int h, int w,
           const float *inv_std, const float *neg_mean, void *stream) {
  constexpr int VEC = 16 / sizeof(Out);
  const int hw3 = h * w * 3;
  const int threads = 256;
  const int vecs = (hw3 + VEC - 1) / VEC;
  const dim3 grid((vecs + threads - 1) / threads, n);
  Affine a;
  for (int c = 0; c < 3; ++c) {
    a.inv_std[c] = inv_std[c];
    a.neg_mean[c] = neg_mean[c];
  }
  normalize_flip_kernel<Out><<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t *)x, (const int32_t *)flip, (Out *)y, hw3, w, a);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n, h, w, 3) uint8 contiguous; flip: (n,) int32 on the device; y: (n, h,
// w, 3) bf16 or f32, 16-byte aligned; inv_std, neg_mean: 3 host floats each
// (1/std and -mean/std, computed in f32 by the caller); n at most 65535
// (grid y). Returns cudaGetLastError() after the launch.
extern "C" int basi_normalize_flip_bf16(const void *x, const void *flip,
                                        void *y, int n, int h, int w,
                                        const float *inv_std,
                                        const float *neg_mean, void *stream) {
  return launch<__nv_bfloat16>(x, flip, y, n, h, w, inv_std, neg_mean, stream);
}

extern "C" int basi_normalize_flip_f32(const void *x, const void *flip,
                                       void *y, int n, int h, int w,
                                       const float *inv_std,
                                       const float *neg_mean, void *stream) {
  return launch<float>(x, flip, y, n, h, w, inv_std, neg_mean, stream);
}
