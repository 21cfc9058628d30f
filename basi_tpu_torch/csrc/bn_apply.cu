// The fused BatchNorm's two elementwise passes over an activation, one launch
// each way: the forward's apply y = x*a + b and the backward's input gradient
// dx = a*g - a_mg - a_inv_mgxn*(x - mean), with the per-channel f32 terms
// that the bn_stats kernels' epilogues return (csrc/bn_stats.cu).
//
// They replace no Pallas kernel: on the TPU, XLA fuses the apply and the input
// gradient of basi_tpu/models/norm.py (_bn_fwd_math, _bn_bwd) into the
// neighbouring convolutions' epilogues. Without them the port ran them as
// three (forward) and six (backward) eager passes, most of them over f32
// temporaries: 20 and 46 bytes an element in bf16. These kernels move the
// compulsory bytes alone: the forward reads x and writes y, 4 bytes an element
// in bf16 (8 in f32); the backward reads g and x and writes dx, 6 (12).
//
// The input is a channels_last activation seen as a row-major (rows = N*H*W,
// C) matrix, bf16 or f32; the output has its dtype and layout. Design, for a
// pass with a handful of operations a byte (the card's ridge is ~295):
//   1. Each thread moves one 16-byte vector (8 bf16 or 4 f32 channels) a load
//      and a store; a block is tx threads along C (one row's vectors, at most
//      256) by ty row lanes, so neighbouring threads touch neighbouring
//      addresses and a block's loads cover ty whole rows.
//   2. The grid strides over rows by a multiple of the row, so a thread keeps
//      the same channels for the whole launch: its per-channel terms (2 or 4
//      floats a channel) are read once into registers. No shared memory, no
//      f32 intermediate in device memory.
//   3. The grid is as many blocks as the card holds at once (the wrapper's
//      launch plan); each thread issues kUnroll loads of each input before it
//      computes, so enough bytes are in flight to keep the memory busy.
//   4. Rounding is the eager passes' (basi_tpu_torch/kernels/bn_apply.py
//      bn_apply_reference, bn_input_gradient_reference): each product, sum and
//      difference rounded on its own in their order (__fmul_rn, __fadd_rn,
//      __fsub_rn: no contraction into a fused multiply-add), then one rounding
//      to the output dtype, so the output equals theirs bit for bit.
// Any shape: the row loop is predicated at the last row; a channel count that
// is not a multiple of the vector (or a misaligned pointer) takes scalar
// loads, one channel a thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 4;  // loads in flight per thread and input

// V channels of T moved as one unit: a 16-byte vector, or one scalar (V = 1).
template <typename T, int V> struct Unit;
template <typename T> struct Unit<T, 1> {
  using Raw = T;
};
template <> struct Unit<__nv_bfloat16, 8> {
  using Raw = uint4;
};
template <> struct Unit<float, 4> {
  using Raw = uint4;
};

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16 &out) {
  out = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void from_f32(float v, float &out) { out = v; }

template <typename T, int V>
__device__ __forceinline__ void unpack(const typename Unit<T, V>::Raw &u,
                                       float (&v)[V]) {
  const T *e = reinterpret_cast<const T *>(&u);
#pragma unroll
  for (int k = 0; k < V; ++k) v[k] = to_f32(e[k]);
}

template <typename T, int V>
__device__ __forceinline__ typename Unit<T, V>::Raw pack(const float (&v)[V]) {
  typename Unit<T, V>::Raw u;
  T *e = reinterpret_cast<T *>(&u);
#pragma unroll
  for (int k = 0; k < V; ++k) from_f32(v[k], e[k]);
  return u;
}

// V per-channel terms from channel c0 on.
template <int V>
__device__ __forceinline__ void load_terms(const float *t, int c0,
                                           float (&out)[V]) {
#pragma unroll
  for (int k = 0; k < V; ++k) out[k] = __ldg(t + c0 + k);
}

// y = x*a + b, rounded as (x*a) then (+ b), then to T.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
    basi_bn_apply_kernel(const T *__restrict__ x, const float *__restrict__ a,
                         const float *__restrict__ b, T *__restrict__ y,
                         long long rows, int c) {
  using Raw = typename Unit<T, V>::Raw;
  const int q = c / V;  // units in a row
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  if (v >= q) return;
  const int c0 = v * V;
  float av[V], bv[V];
  load_terms<V>(a, c0, av);
  load_terms<V>(b, c0, bv);
  const long long step = (long long)gridDim.x * blockDim.y;  // rows
  const Raw *px = reinterpret_cast<const Raw *>(x) + v;
  Raw *py = reinterpret_cast<Raw *>(y) + v;
  for (long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
       r < rows; r += kUnroll * step) {
    Raw u[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i)
      if (r + i * step < rows) u[i] = __ldg(px + (r + i * step) * q);
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (r + i * step >= rows) break;
      float f[V];
      unpack<T, V>(u[i], f);
#pragma unroll
      for (int k = 0; k < V; ++k)
        f[k] = __fadd_rn(__fmul_rn(f[k], av[k]), bv[k]);
      py[(r + i * step) * q] = pack<T, V>(f);
    }
  }
}

// dx = a*g - a_mg - a_inv_mgxn*(x - mean), rounded as ((g*a) - a_mg) -
// ((x - mean) * a_inv_mgxn), then to T. g is read only.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
    basi_bn_input_grad_kernel(const T *__restrict__ g, const T *__restrict__ x,
                              const float *__restrict__ mean,
                              const float *__restrict__ a,
                              const float *__restrict__ a_mg,
                              const float *__restrict__ a_inv_mgxn,
                              T *__restrict__ dx, long long rows, int c) {
  using Raw = typename Unit<T, V>::Raw;
  const int q = c / V;
  const int v = blockIdx.y * blockDim.x + threadIdx.x;
  if (v >= q) return;
  const int c0 = v * V;
  float mv[V], av[V], gv[V], kv[V];
  load_terms<V>(mean, c0, mv);
  load_terms<V>(a, c0, av);
  load_terms<V>(a_mg, c0, gv);
  load_terms<V>(a_inv_mgxn, c0, kv);
  const long long step = (long long)gridDim.x * blockDim.y;
  const Raw *pg = reinterpret_cast<const Raw *>(g) + v;
  const Raw *px = reinterpret_cast<const Raw *>(x) + v;
  Raw *pd = reinterpret_cast<Raw *>(dx) + v;
  for (long long r = (long long)blockIdx.x * blockDim.y + threadIdx.y;
       r < rows; r += kUnroll * step) {
    Raw ug[kUnroll], ux[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (r + i * step < rows) {
        ug[i] = __ldg(pg + (r + i * step) * q);
        ux[i] = __ldg(px + (r + i * step) * q);
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (r + i * step >= rows) break;
      float fg[V], fx[V];
      unpack<T, V>(ug[i], fg);
      unpack<T, V>(ux[i], fx);
#pragma unroll
      for (int k = 0; k < V; ++k)
        fg[k] = __fsub_rn(__fsub_rn(__fmul_rn(fg[k], av[k]), gv[k]),
                          __fmul_rn(__fsub_rn(fx[k], mv[k]), kv[k]));
      pd[(r + i * step) * q] = pack<T, V>(fg);
    }
  }
}

template <typename T>
const void *kernel_for(bool grad, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  if (grad)
    return vec ? (const void *)basi_bn_input_grad_kernel<T, kVec>
               : (const void *)basi_bn_input_grad_kernel<T, 1>;
  return vec ? (const void *)basi_bn_apply_kernel<T, kVec>
             : (const void *)basi_bn_apply_kernel<T, 1>;
}

// One launch on a grid of (blocks, units of a row / tx) blocks of (tx, ty)
// threads; ptrs: the kernel's pointer parameters in order, the activations'
// (read with 16-byte loads where vec) marked in ``rowwise``.
template <typename T>
int launch(bool grad, const void *const *ptrs, const bool *rowwise, int nptrs,
           long long rows, int c, int tx, int ty, int blocks, int vec,
           void *stream) {
  if (rows < 1 || c < 1 || tx < 1 || ty < 1 || tx * ty > kMaxThreads ||
      blocks < 1)
    return (int)cudaErrorInvalidValue;
  constexpr int kVec = 16 / sizeof(T);
  if (vec) {
    if (c % kVec != 0) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < nptrs; ++i)
      if (rowwise[i] && (uintptr_t)ptrs[i] % 16 != 0)
        return (int)cudaErrorMisalignedAddress;
  }
  const int q = vec ? c / kVec : c;
  const dim3 grid(blocks, (q + tx - 1) / tx);
  void *args[9];
  const void *p[7];
  for (int i = 0; i < nptrs; ++i) {
    p[i] = ptrs[i];
    args[i] = &p[i];
  }
  args[nptrs] = &rows;
  args[nptrs + 1] = &c;
  cudaLaunchKernel(kernel_for<T>(grad, vec), grid, dim3(tx, ty), args, 0,
                   (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (rows, c) row-major, bf16 or f32, y written; a, b: f32 (c,).
// tx: threads along a row's units (16-byte vectors if vec, else channels),
// ty: row lanes, tx * ty <= 256; blocks: the grid's blocks over rows (its
// second dimension covers the row's units, tx a block). vec: 16-byte units
// (c a multiple of the vector, every pointer 16-byte aligned). Returns
// cudaGetLastError() after the launch.
#define BASI_BN_APPLY_ENTRY(NAME, T)                                          \
  extern "C" int NAME(const void *x, const void *a, const void *b, void *y,  \
                      long long rows, int c, int tx, int ty, int blocks,     \
                      int vec, void *stream) {                               \
    const void *ptrs[] = {x, a, b, y};                                       \
    const bool rowwise[] = {true, false, false, true};                       \
    return launch<T>(false, ptrs, rowwise, 4, rows, c, tx, ty, blocks, vec,  \
                     stream);                                                \
  }
BASI_BN_APPLY_ENTRY(basi_bn_apply_bf16, __nv_bfloat16)
BASI_BN_APPLY_ENTRY(basi_bn_apply_f32, float)

// g, x, dx: (rows, c) row-major, one dtype, dx written; mean, a, a_mg,
// a_inv_mgxn: f32 (c,). The rest as for the apply.
#define BASI_BN_INPUT_GRAD_ENTRY(NAME, T)                                     \
  extern "C" int NAME(const void *g, const void *x, const void *mean,        \
                      const void *a, const void *a_mg,                       \
                      const void *a_inv_mgxn, void *dx, long long rows,      \
                      int c, int tx, int ty, int blocks, int vec,            \
                      void *stream) {                                        \
    const void *ptrs[] = {g, x, mean, a, a_mg, a_inv_mgxn, dx};              \
    const bool rowwise[] = {true, true, false, false, false, false, true};   \
    return launch<T>(true, ptrs, rowwise, 7, rows, c, tx, ty, blocks, vec,   \
                     stream);                                                \
  }
BASI_BN_INPUT_GRAD_ENTRY(basi_bn_input_grad_bf16, __nv_bfloat16)
BASI_BN_INPUT_GRAD_ENTRY(basi_bn_input_grad_f32, float)

// Blocks of ``threads`` threads that one SM holds at once of the kernel for
// (grad, f32, vec).
extern "C" int basi_bn_apply_blocks_per_sm(int grad, int f32, int vec,
                                           int threads, int *blocks) {
  const void *fn = f32 ? kernel_for<float>(grad, vec)
                       : kernel_for<__nv_bfloat16>(grad, vec);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn,
                                                            threads, 0);
}
