// Per-channel f32 sums of NHWC activations for the fused BatchNorm, and the
// BatchNorm's per-channel terms computed from them, in one launch a call.
//
// Replaces basi_tpu/ops/pallas/bn_stats.py::channel_moments (sum x, sum x^2:
// the forward's batch statistics) and ::channel_dual_sums (sum g, sum g*x:
// the two reductions of the hand-written backward). The input is a
// channels_last activation seen as a row-major (rows = N*H*W, C) matrix, bf16
// or f32; the output is rows of C f32 values, chosen by the epilogue.
//
// Bound: memory. Each input element is read once and takes two flops (the
// card's ridge is ~295 flops a byte), so the design keeps bytes in flight:
//   1. The stream. A block of 256 threads covers a tile of G channel groups
//      (a group is one 16-byte vector: 8 bf16 or 4 f32 channels; G a power of
//      two <= 8, so a warp reads whole 128-byte lines) and R = 256 / G row
//      lanes, and reduces one contiguous slab of rows. The grid is (channel
//      tiles, slabs), sized by the wrapper so that every block is resident
//      at once. Each thread issues kDepth 16-byte loads per input before it
//      adds any, and keeps f32 sums in registers.
//   2. The block's partial. The row lanes of a warp are summed with
//      shuffles, the warps in shared memory, in a fixed order; the block
//      writes one row of 2W f32 partials (W channels per tile, two
//      quantities) to the workspace ws[slab][tile][2][W].
//   3. The last block. Every block fences its partial and takes a ticket
//      from its group's counter (a group: all slabs of one tile, up to
//      kOneLevel of them, else kGroup); the block that draws the group's
//      last ticket sums the group's partials in a fixed order (read with
//      __ldcg, past L1). With more than one group it writes that sum to a
//      row of its own, fences it and takes a ticket from the tile's counter,
//      and the last group's block sums those rows. That block applies the
//      epilogue and resets the counters to 0 for the next launch. A ticket
//      only elects a block, so two launches repeat bit for bit; the second
//      level keeps the serial tail short where a tile has hundreds of slabs
//      (one block reading 660 rows one after another cost more than the
//      stream at small layers).
//   4. The epilogue, per channel: the two sums; their means (mode "stats");
//      the BN forward's mean, var, inv, a, b (basi_tpu/models/norm.py
//      _bn_fwd_math); or the BN backward's dscale, dbias and the three dx
//      coefficients a, a*m_g, a*inv*m_gxn (_bn_bwd). Each step is rounded
//      as it is written there, with no contraction into a fused multiply-add
//      (__fmul_rn, __fsub_rn, __fadd_rn), as torch's separate kernels round;
//      a division by M is a product with 1/M, as torch's CUDA division by a
//      scalar (and XLA's by a constant) takes it. Every block reads its
//      tile's per-channel parameters before it streams, so the last block
//      does not wait on device memory for them.
// Any shape: ragged rows end a thread's row loop; a channel count that is not
// a multiple of the 16-byte vector takes scalar loads, masked at C.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kDepth = 8;      // 16-byte loads in flight per thread and input
constexpr int kMaxGroups = 8;  // channel groups in a tile: 128 bytes of a row
constexpr int kMaxWidth = kMaxGroups * 8;  // channels in a tile (bf16)
// Slabs whose partials one block sums: all of a tile's up to kOneLevel,
// else groups of kGroup, whose sums the last block adds.
constexpr int kOneLevel = 64;
constexpr int kGroup = 32;

// The epilogues; the wrapper (kernels/bn_stats.py) names them alike.
enum Epilogue { kSums = 0, kMeans = 1, kBnForward = 2, kBnBackward = 3 };

template <typename T> struct Pack;  // channels in a 16-byte vector
template <> struct Pack<__nv_bfloat16> { static constexpr int n = 8; };
template <> struct Pack<float> { static constexpr int n = 4; };

template <typename T>
struct Args {
  const T *a, *b;      // x (moments) or g and x (dual sums): (rows, c)
  float *ws;           // partials, slabs * tiles * 2W
  unsigned *counters;  // one per tile, 0 between launches
  float *out;          // the epilogue's rows of c
  const float *scale, *bias, *mean, *inv;  // (c,) each, where EPI reads them
  long long rows;
  int c, g, parts, slab;
  float eps;
  bool vec;            // 16-byte loads: c a multiple of the vector, aligned
};

__device__ __forceinline__ void unpack(const uint4 &u, float (&v)[8]) {
  const __nv_bfloat162 *h = reinterpret_cast<const __nv_bfloat162 *>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    v[2 * k] = f.x;
    v[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const uint4 &u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }

// DUAL = false: (sum a, sum a*a); DUAL = true: (sum a, sum a*b).
template <bool DUAL, int V>
__device__ __forceinline__ void add(const float (&va)[V], const float (&vb)[V],
                                    float (&s1)[V], float (&s2)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    s1[k] += va[k];
    s2[k] += va[k] * (DUAL ? vb[k] : va[k]);
  }
}

// Rows r, r + lanes, ... < end of one 16-byte vector; a and b point at the
// thread's channels of row 0. Every trip issues kDepth loads per input, the
// ones past the slab's end predicated off (zeros), so the last trip waits
// for the memory once, not once a row.
template <typename T, bool DUAL>
__device__ __forceinline__ void stream_vec(const T *a, const T *b, long long r,
                                           long long end, int lanes, int c,
                                           float (&s1)[Pack<T>::n],
                                           float (&s2)[Pack<T>::n]) {
  constexpr int V = Pack<T>::n;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  const long long step = (long long)lanes * c * sizeof(T) / 16;  // vectors
  const uint4 *pa = reinterpret_cast<const uint4 *>(a + r * c);
  const uint4 *pb = reinterpret_cast<const uint4 *>(DUAL ? b + r * c : a);
  for (; r < end; r += kDepth * lanes) {
    uint4 ua[kDepth], ub[kDepth];
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      const bool in = r + u * lanes < end;
      ua[u] = in ? __ldg(pa + u * step) : zero;
      if constexpr (DUAL) ub[u] = in ? __ldg(pb + u * step) : zero;
    }
    pa += kDepth * step;
    if constexpr (DUAL) pb += kDepth * step;
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      float va[V], vb[V];
      unpack(ua[u], va);
      if constexpr (DUAL) {
        unpack(ub[u], vb);
        add<true>(va, vb, s1, s2);
      } else {
        add<false>(va, va, s1, s2);
      }
    }
  }
}

// The same with scalar loads masked at c (c not a multiple of the vector).
template <typename T, bool DUAL>
__device__ void stream_scalar(const T *a, const T *b, long long r,
                              long long end, int lanes, int c, int c0,
                              float (&s1)[Pack<T>::n],
                              float (&s2)[Pack<T>::n]) {
  constexpr int V = Pack<T>::n;
  for (; r < end; r += lanes) {
    float va[V], vb[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const bool in = c0 + k < c;
      va[k] = in ? to_f32(a[r * c + c0 + k]) : 0.0f;
      vb[k] = DUAL && in ? to_f32(b[r * c + c0 + k]) : va[k];
    }
    add<DUAL>(va, vb, s1, s2);
  }
}

// Channel ch's per-channel parameters for the epilogue: (scale, bias) for
// the BN forward, (scale, mean, inv) for the backward.
template <int EPI, typename T>
__device__ __forceinline__ void load_params(const Args<T> &p, int ch,
                                            float (&prm)[3]) {
  if constexpr (EPI == kBnForward) {
    prm[0] = p.scale[ch];
    prm[1] = p.bias[ch];
  } else if constexpr (EPI == kBnBackward) {
    prm[0] = p.scale[ch];
    prm[1] = p.mean[ch];
    prm[2] = p.inv[ch];
  }
}

// Channel ch's outputs from its two sums and its parameters (load_params);
// out rows are c apart.
template <int EPI, typename T>
__device__ __forceinline__ void epilogue(const Args<T> &p, int ch, float s1,
                                         float s2, const float (&prm)[3]) {
  float *o = p.out + ch;
  const int c = p.c;
  const float inv_m = __fdiv_rn(1.0f, (float)p.rows);
  if constexpr (EPI == kSums) {
    o[0] = s1;
    o[c] = s2;
  } else if constexpr (EPI == kMeans) {
    o[0] = __fmul_rn(s1, inv_m);
    o[c] = __fmul_rn(s2, inv_m);
  } else if constexpr (EPI == kBnForward) {
    // mean, var = max(E[x^2] - mean^2, 0), inv = rsqrt(var + eps),
    // a = scale * inv, b = bias - mean * a
    const float mean = __fmul_rn(s1, inv_m);
    const float mean2 = __fmul_rn(s2, inv_m);
    const float d = __fsub_rn(mean2, __fmul_rn(mean, mean));
    const float var = d < 0.0f ? 0.0f : d;  // NaN stays NaN, as clamp_min
    const float inv = rsqrtf(__fadd_rn(var, p.eps));
    const float a = __fmul_rn(prm[0], inv);
    o[0] = mean;
    o[c] = var;
    o[2 * c] = inv;
    o[3 * c] = a;
    o[4 * c] = __fsub_rn(prm[1], __fmul_rn(mean, a));
  } else {  // kBnBackward: s1 = sum g, s2 = sum g*x
    // sgxn = (sgx - mean * sg) * inv, m_g = sg / M, m_gxn = sgxn / M,
    // a = scale * inv; dx = a*g - a*m_g - (a*inv*m_gxn) * (x - mean)
    const float inv = prm[2];
    const float sgxn = __fmul_rn(__fsub_rn(s2, __fmul_rn(prm[1], s1)), inv);
    const float a = __fmul_rn(prm[0], inv);
    o[0] = sgxn;  // dscale
    o[c] = s1;    // dbias
    o[2 * c] = a;
    o[3 * c] = __fmul_rn(a, __fmul_rn(s1, inv_m));
    o[4 * c] = __fmul_rn(__fmul_rn(a, inv), __fmul_rn(sgxn, inv_m));
  }
}

// The sum of n rows of 2W partials, ``stride`` floats apart, in a fixed
// order, into tot[2W]: 256 / (W / 2) lanes each take every so many rows as
// float4s, then the lanes are added in order. lanes: 256 float4s of shared
// memory.
__device__ __forceinline__ void sum_rows(const float *src, int n,
                                         long long stride, int width,
                                         float4 *lanes, float *tot) {
  const int quads = width / 2;  // float4s in a row of 2W
  const int nl = kThreads / quads;
  const int tid = threadIdx.x;
  const float4 *q = reinterpret_cast<const float4 *>(src) + tid % quads;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
  for (int s = tid / quads; s < n; s += nl) {
    const float4 v = __ldcg(q + s * (stride / 4));
    acc.x += v.x;
    acc.y += v.y;
    acc.z += v.z;
    acc.w += v.w;
  }
  lanes[tid] = acc;
  __syncthreads();
  if (tid < quads) {
    float4 t = lanes[tid];
    for (int l = 1; l < nl; ++l) {
      const float4 v = lanes[l * quads + tid];
      t.x += v.x;
      t.y += v.y;
      t.z += v.z;
      t.w += v.w;
    }
    reinterpret_cast<float4 *>(tot)[tid] = t;
  }
  __syncthreads();
}

template <typename T, bool DUAL, int EPI>
__global__ void __launch_bounds__(kThreads) bn_stats_kernel(const Args<T> p) {
  constexpr int V = Pack<T>::n;
  // the warps' sums ([warp][2][W]), later the finalize's lanes
  __shared__ __align__(16) float4 smem[kThreads];
  __shared__ __align__(16) float tot[2 * kMaxWidth];
  __shared__ bool last;
  float *red = reinterpret_cast<float *>(smem);
  const int g = p.g;
  const int lanes = kThreads / g;
  const int width = g * V;
  const int tid = threadIdx.x;
  const int gl = tid % g;
  const int tile = blockIdx.x;
  const int c0 = (tile * g + gl) * V;

  // 0. the epilogue's parameters of channel tid of the tile, read now so
  // that the last block does not wait for them
  float prm[3] = {0.0f, 0.0f, 0.0f};
  if (tid < width && tile * width + tid < p.c)
    load_params<EPI>(p, tile * width + tid, prm);

  // 1. the slab's rows, this thread's vector of channels
  float s1[V], s2[V];
#pragma unroll
  for (int k = 0; k < V; ++k) s1[k] = s2[k] = 0.0f;
  if (c0 < p.c) {
    const long long lo = (long long)blockIdx.y * p.slab;
    const long long hi = min(p.rows, lo + p.slab);
    const long long r = lo + tid / g;
    if (p.vec)
      stream_vec<T, DUAL>(p.a + c0, DUAL ? p.b + c0 : nullptr, r, hi, lanes,
                          p.c, s1, s2);
    else
      stream_scalar<T, DUAL>(p.a, p.b, r, hi, lanes, p.c, c0, s1, s2);
  }

  // 2. the block's partial: a warp's row lanes (lanes tid ^ g, tid ^ 2g, ...
  // hold the same channels) by shuffles, then the warps in order
  for (int off = g; off < 32; off <<= 1) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      s1[k] += __shfl_xor_sync(0xffffffffu, s1[k], off);
      s2[k] += __shfl_xor_sync(0xffffffffu, s2[k], off);
    }
  }
  const int warp = tid / 32;
  if (tid % 32 < g) {  // the warp's first row lane: gl == tid % 32
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[(warp * 2) * width + gl * V + k] = s1[k];
      red[(warp * 2 + 1) * width + gl * V + k] = s2[k];
    }
  }
  __syncthreads();
  const int tiles = gridDim.x;
  const long long row = 2LL * width;  // floats in a partial row
  float *mine = p.ws + ((long long)blockIdx.y * tiles + tile) * row;
  for (int o = tid; o < row; o += kThreads) {
    float acc = 0.0f;
    for (int w = 0; w < kWarps; ++w) acc += red[w * row + o];
    mine[o] = acc;
  }

  // 3. the last block of each group of slabs sums the group's partials;
  // with more than one group, into a row after the slabs'
  // (ws[parts + group]), and the last group to finish sums those
  const int per = p.parts <= kOneLevel ? p.parts : kGroup;
  const int group = blockIdx.y / per;
  const int groups = (p.parts + per - 1) / per;
  const int members = min(per, p.parts - group * per);
  unsigned *count = p.counters + (long long)tile * (groups + 1);
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last = atomicAdd(count + group, 1u) == (unsigned)(members - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  sum_rows(p.ws + ((long long)group * per * tiles + tile) * row, members,
           tiles * row, width, smem, tot);
  if (groups > 1) {
    float *up = p.ws + ((long long)(p.parts + group) * tiles + tile) * row;
    for (int o = tid; o < row; o += kThreads) up[o] = tot[o];
    __threadfence();
    __syncthreads();
    if (tid == 0)
      last = atomicAdd(count + groups, 1u) == (unsigned)(groups - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
    sum_rows(p.ws + ((long long)p.parts * tiles + tile) * row, groups,
             tiles * row, width, smem, tot);
  }

  // 4. the epilogue, one thread a channel; the counters back to 0 (every
  // block of the tile has taken its ticket)
  if (tid < width && tile * width + tid < p.c)
    epilogue<EPI>(p, tile * width + tid, tot[tid], tot[width + tid], prm);
  if (tid == 0) {
    for (int i = 0; i <= groups; ++i) count[i] = 0;
  }
}

template <typename T, bool DUAL>
const void *kernel_for(int epilogue) {
  if (epilogue == kSums) return (const void *)bn_stats_kernel<T, DUAL, kSums>;
  if constexpr (DUAL) {
    if (epilogue == kBnBackward)
      return (const void *)bn_stats_kernel<T, true, kBnBackward>;
  } else {
    if (epilogue == kMeans)
      return (const void *)bn_stats_kernel<T, false, kMeans>;
    if (epilogue == kBnForward)
      return (const void *)bn_stats_kernel<T, false, kBnForward>;
  }
  return nullptr;
}

template <typename T, bool DUAL>
int launch(const void *a, const void *b, void *ws, void *counters, void *out,
           const void *scale, const void *bias, const void *mean,
           const void *inv, int rows, int c, int g, int parts, int slab,
           int epilogue, float eps, void *stream) {
  const void *fn = kernel_for<T, DUAL>(epilogue);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  Args<T> p;
  p.a = (const T *)a;
  p.b = (const T *)b;
  p.ws = (float *)ws;
  p.counters = (unsigned *)counters;
  p.out = (float *)out;
  p.scale = (const float *)scale;
  p.bias = (const float *)bias;
  p.mean = (const float *)mean;
  p.inv = (const float *)inv;
  p.rows = rows;
  p.c = c;
  p.g = g;
  p.parts = parts;
  p.slab = slab;
  p.eps = eps;
  // 16-byte loads need 16-byte aligned rows: c a multiple of the vector and
  // aligned base pointers.
  p.vec = c % Pack<T>::n == 0 && (uintptr_t)a % 16 == 0 &&
          (!DUAL || (uintptr_t)b % 16 == 0);
  const int groups = (c + Pack<T>::n - 1) / Pack<T>::n;
  const dim3 grid((groups + g - 1) / g, parts);
  void *args[] = {&p};
  cudaLaunchKernel(fn, grid, dim3(kThreads), args, 0, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // namespace

// a (and b for the dual sums): (rows, c) row-major, bf16 or f32; ws: f32
// scratch of (parts + groups) * tiles * 2 * g * vector, groups = 1 for
// parts <= 64, else parts / 32 rounded up; counters: tiles * (groups + 1) u32, all 0 (the launch leaves
// them 0); out: f32, 2 rows of c (epilogue
// 0 sums, 1 means) or 5 (2 BN forward, 3 BN backward). scale, bias (BN
// forward) and scale, mean, inv (BN backward): f32 (c,); M = rows.
// g: channel groups of one vector per block, a power of two <= 8; parts:
// slabs of slab rows, parts * slab >= rows, 1..65535. rows >= 1, c >= 1.
// Returns cudaGetLastError() after the launch.
#define BASI_BN_STATS_ENTRY(NAME, T, DUAL)                                     \
  extern "C" int NAME(const void *a, const void *b, void *ws, void *counters, \
                      void *out, const void *scale, const void *bias,         \
                      const void *mean, const void *inv, int rows, int c,     \
                      int g, int parts, int slab, int epilogue, float eps,    \
                      void *stream) {                                         \
    return launch<T, DUAL>(a, b, ws, counters, out, scale, bias, mean, inv,   \
                           rows, c, g, parts, slab, epilogue, eps, stream);   \
  }
BASI_BN_STATS_ENTRY(basi_channel_moments_bf16, __nv_bfloat16, false)
BASI_BN_STATS_ENTRY(basi_channel_moments_f32, float, false)
BASI_BN_STATS_ENTRY(basi_channel_dual_sums_bf16, __nv_bfloat16, true)
BASI_BN_STATS_ENTRY(basi_channel_dual_sums_f32, float, true)

// Blocks that one SM holds at once of every epilogue of the kernel for
// (dual, f32): the least over them, so that one layout serves them all and
// every epilogue sums in the same order as the plain sums.
extern "C" int basi_bn_stats_blocks_per_sm(int dual, int f32, int *blocks) {
  *blocks = kThreads;  // above any count
  for (int e = kSums; e <= kBnBackward; ++e) {
    const void *fn = dual ? (f32 ? kernel_for<float, true>(e)
                                 : kernel_for<__nv_bfloat16, true>(e))
                          : (f32 ? kernel_for<float, false>(e)
                                 : kernel_for<__nv_bfloat16, false>(e));
    int n = 0;
    if (fn == nullptr) continue;
    const cudaError_t err =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    if (n < *blocks) *blocks = n;
  }
  return (int)cudaSuccess;
}
