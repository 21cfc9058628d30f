// Per-channel f32 sums of NHWC activations for the fused BatchNorm.
//
// Replaces basi_tpu/ops/pallas/bn_stats.py::channel_moments (sum x, sum x^2:
// the forward's batch statistics) and ::channel_dual_sums (sum g, sum g*x:
// the two reductions of the hand-written backward). The input is a
// channels_last activation seen as a row-major (rows = N*H*W, C) matrix, bf16
// or f32; the output is two f32 rows of C.
//
// Bound: memory. Each input element is read once and takes two flops; the
// outputs are 2*C floats. The TPU kernel carries its sums across sequential
// grid steps; Hopper's blocks run in parallel and in no order, so the sum
// is taken in two passes and no atomics, and a run repeats bit for bit:
//   1. bn_stats_partial_kernel: a block of 256 threads covers G channel
//      groups of 8 channels (G a power of two <= 32) and R = 256 / G row
//      lanes. Each thread owns 8 consecutive channels, reads them with one
//      16-byte load per row (bf16; two for f32), strides over rows (four
//      rows a trip, all loads issued before the adds) and keeps f32
//      partials in registers.
//      The block then sums its R row lanes in shared memory in a fixed order
//      and writes one (C,)-row of partials per quantity into the workspace
//      ws[2][parts][C] (grid: channel tiles x parts).
//   2. bn_stats_finalize_kernel: 32 channels x 8 lanes a block; each lane
//      sums every 8th partial, then lane 0 adds the 8 lane sums in order.
// Any shape: ragged rows end the row loop, a channel count that is not a
// multiple of the 16-byte vector takes scalar loads, masked at C.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;       // channels per thread
constexpr int kUnroll = 4;    // rows per trip of the row loop
constexpr int kLanes = 8;     // finalize: partial lanes per channel

__device__ __forceinline__ void load8(const __nv_bfloat16 *row, int c0, int c,
                                      bool vec, float v[kVec]) {
  if (vec) {
    const uint4 u = *reinterpret_cast<const uint4 *>(row + c0);
    const __nv_bfloat162 *h = reinterpret_cast<const __nv_bfloat162 *>(&u);
#pragma unroll
    for (int k = 0; k < kVec / 2; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      v[k] = c0 + k < c ? __bfloat162float(row[c0 + k]) : 0.0f;
  }
}

__device__ __forceinline__ void load8(const float *row, int c0, int c,
                                      bool vec, float v[kVec]) {
  if (vec) {
    const float4 a = *reinterpret_cast<const float4 *>(row + c0);
    const float4 b = *reinterpret_cast<const float4 *>(row + c0 + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) v[k] = c0 + k < c ? row[c0 + k] : 0.0f;
  }
}

// DUAL = false: (sum a, sum a*a); DUAL = true: (sum a, sum a*b).
template <typename T, bool DUAL>
__global__ void __launch_bounds__(kThreads)
bn_stats_partial_kernel(const T *__restrict__ a, const T *__restrict__ b,
                        float *__restrict__ ws, int rows, int c, int g,
                        int parts, bool vec_ok) {
  __shared__ float red[2 * kThreads * kVec];
  const int lanes = kThreads / g;  // row lanes R
  const int gl = threadIdx.x % g;
  const int rl = threadIdx.x / g;
  const int c0 = (blockIdx.x * g + gl) * kVec;
  const long long step = (long long)parts * lanes;
  float s1[kVec], s2[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) s1[k] = s2[k] = 0.0f;
  if (c0 < c) {
    const bool vec = vec_ok && c0 + kVec <= c;
    long long r = (long long)blockIdx.y * lanes + rl;
    for (; r + (kUnroll - 1) * step < rows; r += kUnroll * step) {
      float va[kUnroll][kVec], vb[kUnroll][kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        load8(a + (r + u * step) * c, c0, c, vec, va[u]);
        if (DUAL) load8(b + (r + u * step) * c, c0, c, vec, vb[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          s1[k] += va[u][k];
          s2[k] += va[u][k] * (DUAL ? vb[u][k] : va[u][k]);
        }
      }
    }
    for (; r < rows; r += step) {
      float va[kVec], vb[kVec];
      load8(a + r * c, c0, c, vec, va);
      if (DUAL) load8(b + r * c, c0, c, vec, vb);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        s1[k] += va[k];
        s2[k] += va[k] * (DUAL ? vb[k] : va[k]);
      }
    }
  }
  // red[q][rl][gl * 8 + k]: then each (q, channel) sums its R lanes in order
  const int width = g * kVec;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    red[rl * width + gl * kVec + k] = s1[k];
    red[(lanes + rl) * width + gl * kVec + k] = s2[k];
  }
  __syncthreads();
  for (int o = threadIdx.x; o < 2 * width; o += kThreads) {
    const int q = o / width;
    const int j = o - q * width;
    const int ch = blockIdx.x * width + j;
    float acc = 0.0f;
    for (int l = 0; l < lanes; ++l) acc += red[(q * lanes + l) * width + j];
    if (ch < c) ws[((long long)q * parts + blockIdx.y) * c + ch] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
bn_stats_finalize_kernel(const float *__restrict__ ws,
                         float *__restrict__ out, int c, int parts) {
  // grid: (channel tiles of 32, quantity); block: 32 channels x 8 lanes
  __shared__ float red[kLanes][32];
  const int q = blockIdx.y;
  const int cl = threadIdx.x % 32;
  const int lane = threadIdx.x / 32;
  const int ch = blockIdx.x * 32 + cl;
  float acc = 0.0f;
  if (ch < c) {
    const float *p = ws + (long long)q * parts * c + ch;
#pragma unroll 8
    for (int i = lane; i < parts; i += kLanes) acc += p[(long long)i * c];
  }
  red[lane][cl] = acc;
  __syncthreads();
  if (lane == 0 && ch < c) {
    float s = 0.0f;
#pragma unroll
    for (int l = 0; l < kLanes; ++l) s += red[l][cl];
    out[q * c + ch] = s;
  }
}

template <typename T, bool DUAL>
int launch(const void *a, const void *b, void *ws, void *out, int rows, int c,
           int g, int parts, void *stream) {
  // 16-byte loads need 16-byte aligned rows: C a multiple of 8 (bf16) or 4
  // (f32) and aligned base pointers.
  constexpr int per16 = 16 / sizeof(T);
  const bool vec_ok = c % per16 == 0 && (uintptr_t)a % 16 == 0 &&
                      (!DUAL || (uintptr_t)b % 16 == 0);
  const int groups = (c + kVec - 1) / kVec;
  const dim3 grid((groups + g - 1) / g, parts);
  cudaStream_t s = (cudaStream_t)stream;
  bn_stats_partial_kernel<T, DUAL><<<grid, kThreads, 0, s>>>(
      (const T *)a, (const T *)b, (float *)ws, rows, c, g, parts, vec_ok);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bn_stats_finalize_kernel<<<dim3((c + 31) / 32, 2), kThreads, 0, s>>>(
      (const float *)ws, (float *)out, c, parts);
  return (int)cudaGetLastError();
}

}  // namespace

// x (or g and x): (rows, c) row-major, bf16 or f32; ws: 2 * parts * c f32
// scratch; out: 2 * c f32 ((sum, sum of squares) or (sum g, sum g*x)).
// g: channel groups of 8 per block, a power of two <= 32; parts: row splits,
// 1..65535. rows >= 1, c >= 1. Returns cudaGetLastError() after the launches.
extern "C" int basi_channel_moments_bf16(const void *x, void *ws, void *out,
                                         int rows, int c, int g, int parts,
                                         void *stream) {
  return launch<__nv_bfloat16, false>(x, nullptr, ws, out, rows, c, g, parts,
                                      stream);
}

extern "C" int basi_channel_moments_f32(const void *x, void *ws, void *out,
                                        int rows, int c, int g, int parts,
                                        void *stream) {
  return launch<float, false>(x, nullptr, ws, out, rows, c, g, parts, stream);
}

extern "C" int basi_channel_dual_sums_bf16(const void *gy, const void *x,
                                           void *ws, void *out, int rows,
                                           int c, int g, int parts,
                                           void *stream) {
  return launch<__nv_bfloat16, true>(gy, x, ws, out, rows, c, g, parts,
                                     stream);
}

extern "C" int basi_channel_dual_sums_f32(const void *gy, const void *x,
                                          void *ws, void *out, int rows, int c,
                                          int g, int parts, void *stream) {
  return launch<float, true>(gy, x, ws, out, rows, c, g, parts, stream);
}
