// Fused bilinear upsample + sigmoid of low-resolution mask logits.
//
// Replaces basi_tpu/ops/pallas/upsample_sigmoid.py::upsample_sigmoid, which
// computes sigmoid(Wh @ x @ Ww) per mask as two f32 matmuls at HIGHEST
// precision (a reduced-precision pass cost 2.4e-3 against a 1e-3 budget).
// Each output pixel depends on 4 input pixels, so a direct gather in f32 is
// exact by construction and cannot fall into TF32 or bf16 matmul. The taps
// and weights follow basi_tpu/ops/resize.py::_interp_matrix
// (align_corners=False) for any input/output size: the source coordinate is
// computed in double with the same two roundings numpy makes (the scale
// in/out is divided on the host, correctly rounded as numpy's), then the
// weights round to f32 as the matrix entries do. Rows blend first, then
// columns, as in the matmul order.
//
// Bound: memory, by the f32 store of B*K*H*W*4 bytes (about 168 MB for the
// eval batch of 8 images x 20 slots at 512^2); the logits are a thirtieth of
// that. Design:
// - A block owns one mask, a band of kRows output rows and a tile of kTile
//   output columns; the grid is flat (mask, band, tile), so the mask count is
//   bounded by 2^31 blocks and not by a grid dimension.
// - The band's row taps are computed once per block into shared memory, and
//   the band's row blends (two input rows blended per output row, over the
//   input columns the tile touches) are staged in shared memory once, so the
//   column pass reads two shared floats per output pixel. A tile whose span
//   does not fit kStagedBytes takes the unstaged instance, which blends the rows
//   from global memory in the same arithmetic (bit-identical).
// - A thread owns kCols consecutive output columns: their taps are computed
//   once for the band, and each row leaves as 16-byte streaming stores
//   (__stcs: the output is over 3x the L2 and is not read back here).
// - The sigmoid is __frcp_rn(1 + __expf(-v)): exact 0 and 1 at large |v| and
//   no NaN (__fdividef would misbehave for huge denominators).
// Every blend is written with explicit __fmaf_rn/__fmul_rn, so no build's
// FMA contraction changes a bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 512;  // output columns a block covers
constexpr int kCols = 4;    // output columns a thread owns
constexpr int kRows = 32;   // output rows a band
// Blocks an SM must hold, which caps registers at 40: on an H100 six
// blocks with a few spills wrote faster than three or four without.
constexpr int kMinBlocks = 6;
constexpr int kColThreads = kTile / kCols;
constexpr int kRowGroups = kThreads / kColThreads;  // threads down a column
// staged row blends: dynamic shared memory up to the 48 KB a block gets
// without opting in, less the static tables
constexpr int kStagedBytes = 47 * 1024;
static_assert(kCols % 4 == 0 && kThreads % kColThreads == 0, "tiling");
static_assert(kRows < kThreads, "one thread per row tap, one for the span");

struct Taps {
  int lo, hi;
  float w_lo, w_hi;
};

__device__ __forceinline__ Taps taps(int o, double scale, int in) {
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

__device__ __forceinline__ float blend(float w_lo, float a, float w_hi,
                                       float b) {
  return __fmaf_rn(w_lo, a, __fmul_rn(w_hi, b));
}

__device__ __forceinline__ float sigmoid(float v) {
  return __frcp_rn(1.0f + __expf(-v));
}

struct Shape {
  int h, w, oh, ow;
  int bands, tiles;
  double sy, sx;  // h / oh and w / ow, rounded once (as numpy's in / out)
};

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    upsample_sigmoid_kernel(const T *__restrict__ x, float *__restrict__ y,
                            Shape s) {
  extern __shared__ float staged[];  // [rows][n] row blends (kStaged)
  __shared__ Taps row_taps[kRows];
  __shared__ int span[2];  // first input column of the tile, column count
  const int tile = blockIdx.x % s.tiles;
  const int rest = blockIdx.x / s.tiles;
  const int band = rest % s.bands;
  const long long m = rest / s.bands;
  const int oy0 = band * kRows;
  const int rows = min(kRows, s.oh - oy0);
  const int c0 = tile * kTile;
  const int c_last = min(c0 + kTile, s.ow) - 1;
  if (threadIdx.x < rows) {
    row_taps[threadIdx.x] = taps(oy0 + threadIdx.x, s.sy, s.h);
  } else if (threadIdx.x == kThreads - 1) {
    span[0] = taps(c0, s.sx, s.w).lo;
    span[1] = taps(c_last, s.sx, s.w).hi - span[0] + 1;
  }
  __syncthreads();
  const T *img = x + m * s.h * s.w;
  const int x0 = span[0], n = span[1];
  if (kStaged) {  // element (r, i) of the rows x n blends, r and i kept apart
    for (int r = 0, i = threadIdx.x;; i += kThreads) {
      for (; i >= n && r < rows; i -= n) ++r;
      if (r >= rows) break;
      const Taps t = row_taps[r];
      staged[r * n + i] = blend(t.w_lo, to_f32(img[t.lo * s.w + x0 + i]),
                                t.w_hi, to_f32(img[t.hi * s.w + x0 + i]));
    }
    __syncthreads();
  }
  const int ox = c0 + (threadIdx.x % kColThreads) * kCols;
  if (ox > c_last) return;
  int lo[kCols], hi[kCols];
  float wl[kCols], wh[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const Taps t = taps(min(ox + k, c_last), s.sx, s.w);
    lo[k] = t.lo - (kStaged ? x0 : 0);
    hi[k] = t.hi - (kStaged ? x0 : 0);
    wl[k] = t.w_lo;
    wh[k] = t.w_hi;
  }
  const bool vec = s.ow % 4 == 0;  // every row starts 16-byte aligned
  float *out = y + (m * s.oh + oy0) * s.ow + ox;
#pragma unroll 4
  for (int r = threadIdx.x / kColThreads; r < rows; r += kRowGroups) {
    float v[kCols];
    if (kStaged) {
      const float *row = staged + r * n;
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        v[k] = sigmoid(blend(wl[k], row[lo[k]], wh[k], row[hi[k]]));
    } else {
      const Taps t = row_taps[r];
      const T *a = img + t.lo * s.w, *b = img + t.hi * s.w;
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const float col_lo = blend(t.w_lo, to_f32(a[lo[k]]), t.w_hi,
                                   to_f32(b[lo[k]]));
        const float col_hi = blend(t.w_lo, to_f32(a[hi[k]]), t.w_hi,
                                   to_f32(b[hi[k]]));
        v[k] = sigmoid(blend(wl[k], col_lo, wh[k], col_hi));
      }
    }
    float *o = out + (long long)r * s.ow;
#pragma unroll
    for (int j = 0; j < kCols; j += 4) {
      if (vec) {  // ow % 4 == 0: a group of 4 lies inside the row or past it
        if (ox + j <= c_last)
          __stcs(reinterpret_cast<float4 *>(o + j),
                 make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]));
      } else {
#pragma unroll
        for (int k = j; k < j + 4; ++k)
          if (ox + k <= c_last) __stcs(o + k, v[k]);
      }
    }
  }
}

template <typename T>
int launch(const void *x, void *y, int b, int h, int w, int oh, int ow,
           void *stream) {
  Shape s{h, w, oh, ow, (oh + kRows - 1) / kRows, (ow + kTile - 1) / kTile,
          (double)h / (double)oh, (double)w / (double)ow};
  const long long blocks = (long long)b * s.bands * s.tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  // input columns a tile can touch: (kTile - 1) * w / ow + 4 at most
  const long long most = (long long)(kTile - 1) * w / ow + 4;
  const long long span = most < w ? most : w;
  const size_t smem = (size_t)kRows * span * sizeof(float);
  cudaStream_t st = (cudaStream_t)stream;
  if (smem <= kStagedBytes) {
    upsample_sigmoid_kernel<T, true><<<(int)blocks, kThreads, smem, st>>>(
        (const T *)x, (float *)y, s);
  } else {
    upsample_sigmoid_kernel<T, false><<<(int)blocks, kThreads, 0, st>>>(
        (const T *)x, (float *)y, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: (b, h, w) contiguous logits; y: (b, oh, ow) f32 probabilities, 16-byte
// aligned; b * ceil(oh / kRows) * ceil(ow / kTile) at most 2^31 - 1 blocks.
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
