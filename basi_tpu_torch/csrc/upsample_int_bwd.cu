// Backward of the integer-factor (2/4/8) bilinear upsample, NHWC bf16.
//
// Replaces the custom VJP of basi_tpu/ops/pallas/upsample_int.py (_bwd): the
// exact adjoint gx = Wh^T . g . Ww with the interpolation matrices of
// basi_tpu/ops/resize.py::_interp_matrix (align_corners=False). The JAX
// package runs it as two XLA einsums, rows first, then columns, f32 sums and
// one cast to bf16. This kernel keeps that order in two stages of one block:
//
// 1. Rows, in registers. A block owns one image, a band of kTY input rows, a
//    tile of input columns and a slab of kSlab 8-channel vectors. Each thread
//    owns one output column p (the tile's, plus a halo of f/2 columns on each
//    side) and one 16-byte vector, and walks the band's f * (kTY + 1) output
//    rows o in increasing order, loading g[n, o, p, vec] once. Output row o
//    feeds exactly two input rows, its forward taps: with k = o - (f*y0 - f/2)
//    = f*j + q, rows j - 1 and j of the band with weights 1 - (2q+1)/(2f) and
//    (2q+1)/(2f); at the image's first and last f/2 rows the clamp gives its
//    one row the weight 1, as _interp_matrix does. f is a template parameter,
//    so the loop unrolls, the weights and the accumulator each load feeds are
//    compile-time constants, and the loads issue together. Each row sum runs
//    over increasing o in f32 (kTY x 8 registers).
// 2. Columns, through shared memory. The row sums go to shared memory as f32
//    (two planes of float4, padded one slot in 8 so that neighbouring input
//    columns hit other banks); after __syncthreads() the threads re-map to
//    (input row, input column x, vector) and each sums its 2f output columns
//    p in [f*x - f/2, f*x + 3f/2 - 1], clipped, with Ww's weights (the same
//    tent, 1 where the clamp folds), over increasing p, rounds once to bf16
//    and stores 16 bytes.
//
// No atomics: the result is deterministic. Weights are multiples of 1/(2f),
// exact in f32. Bound: bytes. g is f^2 times the size of gx and is read from
// device memory once, plus the halo rows a band shares with its neighbours
// (1/kTY of a re-read, mostly from L2) and, where a row holds more than one
// column tile, the halo columns; gx is written once. The tap loops cost 2f
// multiply-adds per output element in each stage.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTY = 4;      // input rows per band
constexpr int kSlab = 4;    // 8-channel vectors per block
constexpr int kCols = 128;  // output columns of a tile, its halo not counted
constexpr int kMaxThreads = ((kCols + 8) * kSlab + 31) / 32 * 32;

// shared-memory slot of a tile's output column pc: one slot of padding in 8
__host__ __device__ constexpr int padded(int pc) { return pc + (pc >> 3); }

__device__ __forceinline__ void unpack8(const uint4 &v, float out[8]) {
  const __nv_bfloat162 *p = reinterpret_cast<const __nv_bfloat162 *>(&v);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float2 t = __bfloat1622float2(p[k]);
    out[2 * k] = t.x;
    out[2 * k + 1] = t.y;
  }
}

template <int F>
__global__ void __launch_bounds__(kMaxThreads, 2)
    upsample_int_bwd_kernel(const uint4 *__restrict__ g,
                            uint4 *__restrict__ gx, int h, int w, int groups,
                            int xw, int bands) {
  // grid: (slab, column tile * bands + band, image)
  extern __shared__ float4 rows[];  // [2][kTY][padded(pw - 1) + 1][kSlab]
  const int oh = F * h, ow = F * w;
  const int tile = blockIdx.y / bands;
  const int y0 = (blockIdx.y - tile * bands) * kTY;
  const int x0 = tile * xw;
  const int b = blockIdx.z;
  const int pw = F * (xw + 1);  // the tile's output columns with its halo
  const int stride = (padded(pw - 1) + 1) * kSlab;
  float4 *plane1 = rows + kTY * stride;

  // 1. rows: thread (pc, s) sums g over the band's output rows o
  const int s = threadIdx.x % kSlab;
  const int pc = threadIdx.x / kSlab;
  const int vec = blockIdx.x * kSlab + s;
  const int p = F * x0 - F / 2 + pc;
  float acc[kTY][8];
#pragma unroll
  for (int j = 0; j < kTY; ++j)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[j][c] = 0.0f;
  if (pc < pw && p >= 0 && p < ow && vec < groups) {
    const int o0 = F * y0 - F / 2;
    const uint4 *col =
        g + ((long long)b * oh * ow + p) * groups + vec;
#pragma unroll
    for (int k = 0; k < F * (kTY + 1); ++k) {
      const int j = k / F, q = k % F;
      const int o = o0 + k;
      if (o < 0 || o >= oh) continue;
      float v[8];
      unpack8(__ldg(col + (long long)o * ow * groups), v);
      const float w_hi = (2 * q + 1) / (2.0f * F);
      if (j >= 1) {  // input row y0 + j - 1, the lower tap
        const float wt = o >= oh - F / 2 ? 1.0f : 1.0f - w_hi;
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[j - 1][c] += wt * v[c];
      }
      if (j < kTY) {  // input row y0 + j, the upper tap
        const float wt = o < F / 2 ? 1.0f : w_hi;
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[j][c] += wt * v[c];
      }
    }
  }
  if (pc < pw) {
    const int slot = padded(pc) * kSlab + s;
#pragma unroll
    for (int j = 0; j < kTY; ++j) {
      rows[j * stride + slot] =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      plane1[j * stride + slot] =
          make_float4(acc[j][4], acc[j][5], acc[j][6], acc[j][7]);
    }
  }
  __syncthreads();

  // 2. columns: item (row jj, column xl, vector s2) sums its 2f columns
  const int items = kTY * xw * kSlab;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int s2 = i % kSlab;
    const int r = i / kSlab;
    const int jj = r / xw, xl = r - (r / xw) * xw;
    const int y = y0 + jj, x = x0 + xl, v2 = blockIdx.x * kSlab + s2;
    if (y >= h || x >= w || v2 >= groups) continue;
    float out[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) out[c] = 0.0f;
#pragma unroll
    for (int t = 0; t < 2 * F; ++t) {
      const int pp = F * x - F / 2 + t;
      if (pp < 0 || pp >= ow) continue;
      const float tent = t < F ? (2 * t + 1) / (2.0f * F)
                               : 1.0f - (2 * (t - F) + 1) / (2.0f * F);
      const float wt = pp < F / 2 || pp >= ow - F / 2 ? 1.0f : tent;
      const int slot = jj * stride + padded(F * xl + t) * kSlab + s2;
      const float4 a = rows[slot], c4 = plane1[slot];
      out[0] += wt * a.x;
      out[1] += wt * a.y;
      out[2] += wt * a.z;
      out[3] += wt * a.w;
      out[4] += wt * c4.x;
      out[5] += wt * c4.y;
      out[6] += wt * c4.z;
      out[7] += wt * c4.w;
    }
    uint4 res;
    __nv_bfloat162 *o2 = reinterpret_cast<__nv_bfloat162 *>(&res);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      o2[c] = __floats2bfloat162_rn(out[2 * c], out[2 * c + 1]);
    gx[(((long long)b * h + y) * w + x) * groups + v2] = res;
  }
}

template <int F>
int launch(const void *g, void *gx, int n, int h, int w, int c,
           cudaStream_t stream) {
  const int groups = c / 8;
  const int xw = w < kCols / F ? w : kCols / F;  // input columns of a tile
  const int tiles = (w + xw - 1) / xw;
  const int bands = (h + kTY - 1) / kTY;
  const int pw = F * (xw + 1);
  const int threads = (pw * kSlab + 31) / 32 * 32;
  const size_t smem =
      sizeof(float4) * 2 * kTY * (padded(pw - 1) + 1) * kSlab;
  static const cudaError_t attr = cudaFuncSetAttribute(
      upsample_int_bwd_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float4) * 2 * kTY * (padded(kCols + F - 1) + 1) * kSlab));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((groups + kSlab - 1) / kSlab, tiles * bands, n);
  upsample_int_bwd_kernel<F><<<grid, threads, smem, stream>>>(
      (const uint4 *)g, (uint4 *)gx, h, w, groups, xw, bands);
  return (int)cudaGetLastError();
}

}  // namespace

// g: (n, f*h, f*w, c) bf16 NHWC-contiguous, 16-byte aligned, c % 8 == 0;
// gx: (n, h, w, c) bf16; n at most 65535 and ceil(h / kTY) times the column
// tiles at most 65535 (grid z, y). Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a factor other than 2, 4, 8).
extern "C" int basi_upsample_int_bwd_bf16(const void *g, void *gx, int n,
                                          int h, int w, int c, int f,
                                          void *stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (f) {
    case 2: return launch<2>(g, gx, n, h, w, c, s);
    case 4: return launch<4>(g, gx, n, h, w, c, s);
    case 8: return launch<8>(g, gx, n, h, w, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
