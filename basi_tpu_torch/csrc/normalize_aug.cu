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
// (f32) that; there is no reuse to stage. Design:
// - Where W is a multiple of kRun (the path's 512), a thread owns a run of
//   kRun pixels of one row: 3*kRun bytes in 16-byte loads through the
//   read-only path. Each element's channel is fixed by its place in the run,
//   so the unrolled loop picks its (1/std, -mean/std) pair and its byte at
//   compile time.
// - The run's outputs go to the warp's slice of shared memory, and the warp
//   then writes its 32 runs out as one contiguous span, lane by lane in
//   16-byte streaming stores. Each thread storing its own run straight out
//   puts a warp's 32 stores 96 (bf16) or 192 (f32) bytes apart, on 32
//   cache lines an instruction, and ran at 1.3 and 0.5 TB/s (H100).
// - A flipped image reads the mirrored run of the same row (pixels
//   W - kRun - x0 ... W - 1 - x0, also 16-byte aligned) and reverses its
//   pixels in registers, with indices fixed at compile time.
// - The grid is flat, blocks_per_image blocks an image: the image comes from
//   the block, the run's column from one division a thread.
// - Other widths (or a misaligned view) take a scalar instance: a thread per
//   pixel, one division a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRun = 16;  // pixels a thread on the vector path
constexpr int kRunBytes = 3 * kRun;
static_assert(kRunBytes % 16 == 0, "a run is whole 16-byte vectors");

struct Affine {
  float inv_std[3];
  float neg_mean[3];
};

__device__ __forceinline__ float norm(uint32_t byte, int c, const Affine &a) {
  return __fadd_rn(__fmul_rn(__fmul_rn((float)byte, 1.0f / 255.0f),
                             a.inv_std[c]),
                   a.neg_mean[c]);
}

__device__ __forceinline__ void put(uint4 *p, uint4 v) { __stcs(p, v); }

// The run's 3*kRun outputs from its 3*kRun input bytes `in` (mirrored by
// pixel where kFlip), as 16-byte vectors at out.
template <typename Out, bool kFlip>
__device__ __forceinline__ void run(const uint4 *in, const Affine &a,
                                    uint4 *out) {
  constexpr int kPer = 16 / sizeof(Out);  // outputs a vector
  const uint32_t *words = reinterpret_cast<const uint32_t *>(in);
#pragma unroll
  for (int q = 0; q < kRunBytes / kPer; ++q) {
    float v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int e = kPer * q + k, i = e / 3, c = e % 3;
      const int se = kFlip ? 3 * (kRun - 1 - i) + c : e;
      v[k] = norm((words[se / 4] >> (8 * (se % 4))) & 0xffu, c, a);
    }
    uint32_t bits[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if constexpr (sizeof(Out) == 2) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
        bits[k] = *reinterpret_cast<const uint32_t *>(&p);
      } else {
        bits[k] = __float_as_uint(v[k]);
      }
    }
    out[q] = make_uint4(bits[0], bits[1], bits[2], bits[3]);
  }
}

template <typename Out>
__global__ void __launch_bounds__(kThreads)
    normalize_flip_runs(const uint8_t *__restrict__ x,
                        const int32_t *__restrict__ flip, Out *__restrict__ y,
                        unsigned runs_per_row, unsigned runs_per_image,
                        unsigned blocks_per_image, Affine a) {
  constexpr int kVecs = kRunBytes * sizeof(Out) / 16;  // 16-byte vectors a run
  __shared__ uint4 stage[kThreads * kVecs];
  const unsigned img = blockIdx.x / blocks_per_image;
  const unsigned r0 = (blockIdx.x - img * blocks_per_image) * kThreads;
  const unsigned r = r0 + threadIdx.x;
  const unsigned lane = threadIdx.x % 32, warp0 = r0 + threadIdx.x - lane;
  if (warp0 >= runs_per_image) return;  // the whole warp
  uint4 *mine = stage + threadIdx.x * kVecs;
  if (r < runs_per_image) {
    const long long run_idx = (long long)img * runs_per_image + r;
    const bool f = __ldg(flip + img) > 0;
    // the mirrored run of the same row: column run c -> runs_per_row - 1 - c
    const long long src_idx =
        f ? run_idx + runs_per_row - 1 - 2ll * (r % runs_per_row) : run_idx;
    const uint4 *src =
        reinterpret_cast<const uint4 *>(x + src_idx * kRunBytes);
    uint4 in[kRunBytes / 16];
#pragma unroll
    for (int q = 0; q < kRunBytes / 16; ++q) in[q] = __ldg(src + q);
    if (f)
      run<Out, true>(in, a, mine);
    else
      run<Out, false>(in, a, mine);
  }
  __syncwarp();
  // the warp's runs are contiguous in y: write them out lane by lane
  const uint4 *from = stage + (threadIdx.x - lane) * kVecs;
  uint4 *to = reinterpret_cast<uint4 *>(
      y + ((long long)img * runs_per_image + warp0) * kRunBytes);
  const unsigned vecs = min(32u, runs_per_image - warp0) * kVecs;
#pragma unroll
  for (int q = 0; q < kVecs; ++q) {
    const unsigned v = q * 32 + lane;
    if (v < vecs) put(to + v, from[v]);
  }
}

__device__ __forceinline__ void store_one(__nv_bfloat16 *dst, float v) {
  *dst = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_one(float *dst, float v) { *dst = v; }

template <typename Out>
__global__ void __launch_bounds__(kThreads)
    normalize_flip_pixels(const uint8_t *__restrict__ x,
                          const int32_t *__restrict__ flip,
                          Out *__restrict__ y, unsigned w,
                          unsigned pix_per_image, unsigned blocks_per_image,
                          Affine a) {
  const unsigned img = blockIdx.x / blocks_per_image;
  const unsigned p =
      (blockIdx.x - img * blocks_per_image) * kThreads + threadIdx.x;
  if (p >= pix_per_image) return;
  unsigned src = p;
  if (__ldg(flip + img) > 0) {
    const unsigned col = p % w;
    src = p - col + (w - 1 - col);
  }
  const long long base = (long long)img * pix_per_image;
  const uint8_t *in = x + (base + src) * 3;
  Out *out = y + (base + p) * 3;
#pragma unroll
  for (int c = 0; c < 3; ++c) store_one(out + c, norm(__ldg(in + c), c, a));
}

template <typename Out>
int launch(const void *x, const void *flip, void *y, int n, int h, int w,
           const float *inv_std, const float *neg_mean, void *stream) {
  Affine a;
  for (int c = 0; c < 3; ++c) {
    a.inv_std[c] = inv_std[c];
    a.neg_mean[c] = neg_mean[c];
  }
  const unsigned pixels = (unsigned)h * (unsigned)w;
  const bool runs = w % kRun == 0 && (uintptr_t)x % 16 == 0 &&
                    (uintptr_t)y % 16 == 0;
  const unsigned items = runs ? pixels / kRun : pixels;
  const unsigned per_image = (items + kThreads - 1) / kThreads;
  const long long blocks = (long long)n * per_image;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  if (runs) {
    normalize_flip_runs<Out><<<(int)blocks, kThreads, 0, st>>>(
        (const uint8_t *)x, (const int32_t *)flip, (Out *)y, w / kRun, items,
        per_image, a);
  } else {
    normalize_flip_pixels<Out><<<(int)blocks, kThreads, 0, st>>>(
        (const uint8_t *)x, (const int32_t *)flip, (Out *)y, w, items,
        per_image, a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: (n, h, w, 3) uint8 contiguous; flip: (n,) int32 on the device; y: (n, h,
// w, 3) bf16 or f32; inv_std, neg_mean: 3 host floats each (1/std and
// -mean/std, computed in f32 by the caller); h * w * 3 below 2^31 and at most
// 2^31 - 1 blocks. Returns cudaGetLastError() after the launch.
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
