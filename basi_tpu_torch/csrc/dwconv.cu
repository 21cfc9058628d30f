// The ConvNeXt block's depthwise 7x7 convolution (stride 1, padding 3), one
// channel a filter, forward and both gradients:
//   forward         y[n,o,c]  = b[c] + sum_k w[c,k] * x[n,o+k-3,c]
//   input gradient  dx[n,i,c] = sum_k w[c,6-k] * g[n,i+k-3,c]   (the forward
//                   with the taps turned 180 degrees and no bias)
//   weight gradient dw[c,k]   = sum_{n,o} g[n,o,c] * x[n,o+k-3,c],
//                   db[c] = sum_{n,o} g[n,o,c]
// over 2-D positions o, i and taps k in [0, 7)^2, x zero outside the image.
//
// It replaces no Pallas kernel: the JAX package has no ConvNeXt. It takes the
// place of the library's depthwise kernels (cuDNN's) behind
// F.conv2d(groups=C) in models/convnext.py.
//
// x, g, y and dx are (N, H, W, C) row-major: the NHWC view of an NCHW tensor
// in channels_last memory, bf16 or f32, C a multiple of 8. w is (C, 49) and b
// (C,) in the same dtype. Every product and sum is f32 on the CUDA cores (no
// packed bf16 arithmetic, no tensor cores); the output is rounded once.
//
// What bounds it on the H100: 49 multiply-adds an output element against 4
// bytes of compulsory traffic in bf16, 24.5 operations a byte, just above
// the f32 ridge (67 TFLOP/s over 3.35 TB/s, 20 a byte): the f32 FMA pipe,
// with the memory close behind, so the two have to overlap, and the shared
// memory that feeds the FMAs must not become the third limit. The design:
//   1. A block owns CB channels (32, or 8 where C is no multiple of 32) and
//      walks a list of 16 x 16 output tiles (all images, all tiles of the
//      map) of those channels: the grid is what the card holds at once, and
//      its size a multiple of the channel groups, so a block keeps its
//      channels and its taps, and the blocks of one tile's channel groups
//      run side by side (a pixel's channels are read and written together).
//   2. The input window of a tile (22 x 22 pixels: the 3-pixel halo) is
//      copied into shared memory as it lies in memory, CB channels a pixel,
//      by cp.async, 16 bytes a thread, zero-filled outside the image (the
//      padding costs nothing). Two windows alternate: the next tile's copy
//      is started before the current tile's FMAs, so the memory works while
//      the FMA pipe does, behind one barrier a tile.
//   3. A thread owns one channel and 4 x 8 outputs of the tile; its
//      channel's 49 taps, widened to f32, stay in registers for the whole
//      list. It reads each of the 10 input rows it needs once (14 values,
//      each widened once) and feeds them to every tap row and output row
//      they meet: 1,568 FMAs for 140 loads. A warp's 32 lanes are 32
//      channels of one pixel, so each of its loads is 64 contiguous bytes
//      of one bank row (no conflict) and each output store 64 contiguous
//      bytes of the output.
//   4. The weight gradient walks the same lists with the roles turned: a
//      thread holds its 4 x 8 values of g and 49 + 1 f32 sums over every
//      tile of its block. The block sums its threads' partials in shared
//      memory in a fixed order and writes one set per channel into a
//      workspace; a second kernel sums the sets in a fixed order and rounds
//      once. No atomics: two runs agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTaps = 49;
constexpr int kParts = kTaps + 1;  // a channel's weight-gradient sums
constexpr int kRedPitch = 51;      // a thread's sums in shared memory (odd)
constexpr int kTileH = 16, kTileW = 16;  // an output tile
constexpr int kR = 4, kS = 8;      // a thread's output rows and columns
constexpr int kRows = kTileH + 6;  // the window: input rows y0-3 .. y0+18
constexpr int kCols = kTileW + 6;  // and columns x0-3 .. x0+18
constexpr int kRegs = 128;         // a thread's registers at most
static_assert(kTileH % kR == 0 && kTileW % kS == 0, "thread tiles");

// A block of CB channels of dtype T.
template <typename T, int CB> struct Geo {
  static constexpr int kThreads = CB * (kTileH / kR) * (kTileW / kS);
  static constexpr int kMinBlocks = 65536 / kRegs / kThreads;
  static constexpr int kChunks = CB * (int)sizeof(T) / 16;  // 16 B a pixel
  static constexpr int kWin = kRows * kCols * kChunks;  // chunks, a window
  static constexpr int kOut = kTileH * kTileW * kChunks;  // an output tile
  static constexpr int kFwdBytes = 2 * kWin * 16;
  static constexpr int kStageBytes = 2 * (kWin + kOut) * 16;
  static constexpr int kRedBytes = kThreads * kRedPitch * 4;
  static constexpr int kWgradBytes =
      kStageBytes > kRedBytes ? kStageBytes : kRedBytes;
};

__device__ __forceinline__ void cp_async16(void *dst, const void *src,
                                           bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Copies the ROWS x COLS pixel window of channels c0.. (CB of them) of
// image img, whose pixel (0, 0) is the input's (ya, xa), into raw as it lies
// in memory: channel k of window pixel p at ((T *)raw)[p * CB + k]; zeros
// outside the image. An image's h * w * c fits an int (plan_ok).
template <typename T, int CB, int ROWS, int COLS>
__device__ __forceinline__ void fetch(const T *__restrict__ src, uint4 *raw,
                                      int img, int h, int w, int c, int c0,
                                      int ya, int xa) {
  using G = Geo<T, CB>;
  constexpr int kItems = ROWS * COLS * G::kChunks;
  constexpr int kV = 16 / (int)sizeof(T);
  const T *base = src + (long long)img * h * w * c + c0;
  for (int t = threadIdx.x; t < kItems; t += G::kThreads) {
    const int p = t / G::kChunks, j = t - p * G::kChunks;
    const int row = p / COLS, col = p - row * COLS;
    const int yy = ya + row, xx = xa + col;
    const bool in = yy >= 0 && yy < h && xx >= 0 && xx < w;
    cp_async16(raw + t, in ? base + (yy * w + xx) * c + j * kV : src, in);
  }
}

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16 *p) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store(float v, float *p) { *p = v; }

// The item'th (channel group, tile, image) of a block's list; the group is
// the block's own (the grid is a multiple of the groups). The items fit an
// int (plan_ok).
struct Item {
  int c0, y0, x0, img;
};
__device__ __forceinline__ Item item_at(int item, int cb, int groups,
                                        int tiles_w, int tiles) {
  const int rest = item / groups;
  const int tile = rest % tiles;
  return {(item - rest * groups) * cb, tile / tiles_w * kTileH,
          tile % tiles_w * kTileW, rest / tiles};
}

// The forward (FLIP false: y = conv(x, w) + b) or the input gradient (FLIP
// true: dx = conv(g, w turned 180 degrees), no bias), over the block's list
// of tiles.
template <typename T, int CB, bool FLIP>
__global__ void __launch_bounds__(Geo<T, CB>::kThreads,
                                  Geo<T, CB>::kMinBlocks)
    basi_dwconv7x7_kernel(const T *__restrict__ x, const T *__restrict__ wt,
                          const T *__restrict__ bias, T *__restrict__ y, int n,
                          int h, int w, int c) {
  using G = Geo<T, CB>;
  extern __shared__ __align__(16) uint4 smem[];
  const int groups = c / CB;
  const int tiles_w = (w + kTileW - 1) / kTileW;
  const int tiles = ((h + kTileH - 1) / kTileH) * tiles_w;
  const int items = groups * tiles * n;
  int item = blockIdx.x;
  Item it = item_at(item, CB, groups, tiles_w, tiles);
  const int c0 = it.c0;
  fetch<T, CB, kRows, kCols>(x, smem, it.img, h, w, c, c0, it.y0 - 3,
                             it.x0 - 3);
  cp_async_commit();

  const int ch = threadIdx.x % CB;
  const int sp = threadIdx.x / CB;
  const int ty = sp / (kTileW / kS), tx = sp % (kTileW / kS);
  float wr[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t)
    wr[t] = to_f32(wt[(long long)(c0 + ch) * kTaps + (FLIP ? kTaps - 1 - t
                                                           : t)]);
  const float b0 = FLIP ? 0.f : to_f32(bias[c0 + ch]);
  // the thread's first output (ty*4, tx*8) reads window pixel (ty*4, tx*8)
  const int at = (ty * kR * kCols + tx * kS) * CB + ch;
  for (int k = 0; item < items; item += gridDim.x, ++k) {
    cp_async_wait_all();
    __syncthreads();  // this window is in; every thread is past the other
    const Item cur = it;
    if (item + gridDim.x < items) {
      it = item_at(item + gridDim.x, CB, groups, tiles_w, tiles);
      fetch<T, CB, kRows, kCols>(x, smem + ((k + 1) & 1) * G::kWin, it.img,
                                 h, w, c, c0, it.y0 - 3, it.x0 - 3);
      cp_async_commit();
    }
    const T *win = reinterpret_cast<const T *>(smem + (k & 1) * G::kWin) + at;
    float acc[kR][kS];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int j = 0; j < kS; ++j) acc[r][j] = b0;
#pragma unroll
    for (int i = 0; i < kR + 6; ++i) {
      float row[kS + 6];
#pragma unroll
      for (int m = 0; m < kS + 6; ++m)
        row[m] = to_f32(win[(i * kCols + m) * CB]);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int ky = i - r;
        if (ky < 0 || ky > 6) continue;
#pragma unroll
        for (int kx = 0; kx < 7; ++kx)
#pragma unroll
          for (int j = 0; j < kS; ++j)
            acc[r][j] = fmaf(wr[ky * 7 + kx], row[j + kx], acc[r][j]);
      }
    }
    const int oy = cur.y0 + ty * kR, ox = cur.x0 + tx * kS;
    T *out = y + ((long long)cur.img * h * w + oy * w + ox) * c + c0 + ch;
    if (oy + kR <= h && ox + kS <= w) {  // no edge: no test an output
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int j = 0; j < kS; ++j) store(acc[r][j], out + (r * w + j) * c);
    } else {
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int j = 0; j < kS; ++j)
          if (oy + r < h && ox + j < w)
            store(acc[r][j], out + (r * w + j) * c);
    }
  }
}

// The weight and bias gradients of the block's list of tiles: the 50 sums a
// channel go to part[(blockIdx.x / groups) * c * 50 + channel * 50 + tap],
// the bias's last.
template <typename T, int CB>
__global__ void __launch_bounds__(Geo<T, CB>::kThreads,
                                  Geo<T, CB>::kMinBlocks)
    basi_dwconv7x7_wgrad_kernel(const T *__restrict__ g,
                                const T *__restrict__ x,
                                float *__restrict__ part, int n, int h, int w,
                                int c) {
  using G = Geo<T, CB>;
  extern __shared__ __align__(16) uint4 smem[];
  uint4 *raw_g = smem + 2 * G::kWin;  // after the two x windows
  const int groups = c / CB;
  const int tiles_w = (w + kTileW - 1) / kTileW;
  const int tiles = ((h + kTileH - 1) / kTileH) * tiles_w;
  const int items = groups * tiles * n;
  int item = blockIdx.x;
  Item it = item_at(item, CB, groups, tiles_w, tiles);
  const int c0 = it.c0;
  fetch<T, CB, kRows, kCols>(x, smem, it.img, h, w, c, c0, it.y0 - 3,
                             it.x0 - 3);
  fetch<T, CB, kTileH, kTileW>(g, raw_g, it.img, h, w, c, c0, it.y0, it.x0);
  cp_async_commit();

  const int ch = threadIdx.x % CB;
  const int sp = threadIdx.x / CB;
  const int ty = sp / (kTileW / kS), tx = sp % (kTileW / kS);
  const int xat = (ty * kR * kCols + tx * kS) * CB + ch;
  const int gat = (ty * kR * kTileW + tx * kS) * CB + ch;
  float acc[kParts];
#pragma unroll
  for (int t = 0; t < kParts; ++t) acc[t] = 0.f;
  for (int k = 0; item < items; item += gridDim.x, ++k) {
    cp_async_wait_all();
    __syncthreads();
    if (item + gridDim.x < items) {
      it = item_at(item + gridDim.x, CB, groups, tiles_w, tiles);
      const int nb = (k + 1) & 1;
      fetch<T, CB, kRows, kCols>(x, smem + nb * G::kWin, it.img, h, w, c,
                                 c0, it.y0 - 3, it.x0 - 3);
      fetch<T, CB, kTileH, kTileW>(g, raw_g + nb * G::kOut, it.img, h, w, c,
                                   c0, it.y0, it.x0);
      cp_async_commit();
    }
    const T *xw =
        reinterpret_cast<const T *>(smem + (k & 1) * G::kWin) + xat;
    const T *gw =
        reinterpret_cast<const T *>(raw_g + (k & 1) * G::kOut) + gat;
    float gr[kR][kS];
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int j = 0; j < kS; ++j)
        gr[r][j] = to_f32(gw[(r * kTileW + j) * CB]);
#pragma unroll
    for (int i = 0; i < kR + 6; ++i) {
      float row[kS + 6];
#pragma unroll
      for (int m = 0; m < kS + 6; ++m)
        row[m] = to_f32(xw[(i * kCols + m) * CB]);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const int ky = i - r;
        if (ky < 0 || ky > 6) continue;
#pragma unroll
        for (int kx = 0; kx < 7; ++kx)
#pragma unroll
          for (int j = 0; j < kS; ++j)
            acc[ky * 7 + kx] = fmaf(gr[r][j], row[j + kx], acc[ky * 7 + kx]);
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r)
#pragma unroll
      for (int j = 0; j < kS; ++j) acc[kTaps] += gr[r][j];
  }
  // the block's threads of one channel, summed in a fixed order
  __syncthreads();  // every thread is past its last read of the windows
  float *red = reinterpret_cast<float *>(smem);  // [threads][kRedPitch]
#pragma unroll
  for (int t = 0; t < kParts; ++t) red[threadIdx.x * kRedPitch + t] = acc[t];
  __syncthreads();
  float *out = part + (long long)(blockIdx.x / groups) * c * kParts;
  for (int q = threadIdx.x; q < CB * kParts; q += G::kThreads) {
    const int k = q / kParts, t = q - k * kParts;
    float v = 0.f;
    for (int u = 0; u < G::kThreads / CB; ++u)
      v += red[(u * CB + k) * kRedPitch + t];
    out[(c0 + k) * kParts + t] = v;
  }
}

// dw[c, tap] and db[c]: the sets of partials summed in order, rounded once.
template <typename T>
__global__ void basi_dwconv7x7_wgrad_sum_kernel(const float *__restrict__ part,
                                                T *__restrict__ dw,
                                                T *__restrict__ db, int c,
                                                int sets) {
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= c * kParts) return;
  const long long stride = (long long)c * kParts;
  float v = 0.f;
#pragma unroll 8
  for (int b = 0; b < sets; ++b) v += __ldg(part + b * stride + q);
  const int k = q / kParts, t = q - k * kParts;
  store(v, t < kTaps ? dw + k * kTaps + t : db + k);
}

// The kernel of a launch, its shared memory granted (above 48 KB only on
// request; cheap, and set for the current device).
template <typename T, int CB>
cudaError_t conv_kernel(int flip, const void **fn, int *bytes) {
  *fn = flip ? (const void *)basi_dwconv7x7_kernel<T, CB, true>
             : (const void *)basi_dwconv7x7_kernel<T, CB, false>;
  *bytes = Geo<T, CB>::kFwdBytes;
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *bytes);
}
template <typename T, int CB>
cudaError_t wgrad_kernel(const void **fn, int *bytes) {
  *fn = (const void *)basi_dwconv7x7_wgrad_kernel<T, CB>;
  *bytes = Geo<T, CB>::kWgradBytes;
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              *bytes);
}

template <typename T, int CB>
int launch_conv(const void *x, const void *wt, const void *b, void *y, int n,
                int h, int w, int c, int blocks, int flip,
                cudaStream_t stream) {
  const void *fn;
  int bytes;
  cudaError_t e = conv_kernel<T, CB>(flip, &fn, &bytes);
  if (e != cudaSuccess) return (int)e;
  void *args[] = {&x, &wt, &b, &y, &n, &h, &w, &c};
  cudaLaunchKernel(fn, dim3(blocks), dim3(Geo<T, CB>::kThreads), args, bytes,
                   stream);
  return (int)cudaGetLastError();
}

template <typename T, int CB>
int launch_wgrad(const void *g, const void *x, void *part, void *dw, void *db,
                 int n, int h, int w, int c, int blocks,
                 cudaStream_t stream) {
  const void *fn;
  int bytes;
  cudaError_t e = wgrad_kernel<T, CB>(&fn, &bytes);
  if (e != cudaSuccess) return (int)e;
  void *args[] = {&g, &x, &part, &n, &h, &w, &c};
  cudaLaunchKernel(fn, dim3(blocks), dim3(Geo<T, CB>::kThreads), args, bytes,
                   stream);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int outs = c * kParts;
  basi_dwconv7x7_wgrad_sum_kernel<T><<<(outs + 255) / 256, 256, 0, stream>>>(
      static_cast<const float *>(part), static_cast<T *>(dw),
      static_cast<T *>(db), c, blocks / (c / CB));
  return (int)cudaGetLastError();
}

template <typename T, int CB>
int blocks_per_sm(int wgrad, int *blocks) {
  const void *fn;
  int bytes;
  cudaError_t e = wgrad ? wgrad_kernel<T, CB>(&fn, &bytes)
                        : conv_kernel<T, CB>(0, &fn, &bytes);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, Geo<T, CB>::kThreads, bytes);
}

// The launch's shape: CB 32 or 8 dividing C, a grid that is a positive
// multiple of the channel groups and no longer than the list of items.
// An image and the list of items fit an int.
bool plan_ok(int n, int h, int w, int c, int cb, int blocks) {
  if (n < 1 || h < 1 || w < 1 || (cb != 8 && cb != 32) || c < cb ||
      c % cb != 0 || blocks < 1 || (long long)h * w * c > INT32_MAX)
    return false;
  const long long items = (long long)(c / cb) *
                          ((h + kTileH - 1) / kTileH) *
                          ((w + kTileW - 1) / kTileW) * n;
  return items <= INT32_MAX && blocks % (c / cb) == 0 && blocks <= items;
}

bool aligned(const void *p) { return (uintptr_t)p % 16 == 0; }

}  // namespace

// The forward (flip 0: y = conv(x, w) + b) or the input gradient (flip 1: x
// is g, y is dx, the taps turned 180 degrees, b unused) of (n, h, w, c)
// row-major activations; w (c, 49), b (c,), all of one dtype. cb: channels a
// block (32 or 8); blocks: the grid (a multiple of c / cb). Returns
// cudaGetLastError() after the launch.
#define BASI_DWCONV_ENTRY(NAME, T)                                            \
  extern "C" int NAME(const void *x, const void *wt, const void *b, void *y, \
                      int n, int h, int w, int c, int cb, int blocks,        \
                      int flip, void *stream) {                              \
    if (!plan_ok(n, h, w, c, cb, blocks) || !aligned(x) || !aligned(y) ||    \
        (!flip && b == nullptr))                                             \
      return (int)cudaErrorInvalidValue;                                     \
    return cb == 32 ? launch_conv<T, 32>(x, wt, b, y, n, h, w, c, blocks,    \
                                         flip, (cudaStream_t)stream)         \
                    : launch_conv<T, 8>(x, wt, b, y, n, h, w, c, blocks,     \
                                        flip, (cudaStream_t)stream);         \
  }
BASI_DWCONV_ENTRY(basi_dwconv7x7_bf16, __nv_bfloat16)
BASI_DWCONV_ENTRY(basi_dwconv7x7_f32, float)

// The weight and bias gradients: g and x (n, h, w, c) row-major, dw (c, 49)
// and db (c,) written in their dtype; part: f32 workspace of blocks / (c /
// cb) * c * 50 values. Two launches; returns cudaGetLastError() after them.
#define BASI_DWCONV_WGRAD_ENTRY(NAME, T)                                      \
  extern "C" int NAME(const void *g, const void *x, void *part, void *dw,    \
                      void *db, int n, int h, int w, int c, int cb,          \
                      int blocks, void *stream) {                            \
    if (!plan_ok(n, h, w, c, cb, blocks) || !aligned(g) || !aligned(x))      \
      return (int)cudaErrorInvalidValue;                                     \
    return cb == 32 ? launch_wgrad<T, 32>(g, x, part, dw, db, n, h, w, c,    \
                                          blocks, (cudaStream_t)stream)      \
                    : launch_wgrad<T, 8>(g, x, part, dw, db, n, h, w, c,     \
                                         blocks, (cudaStream_t)stream);      \
  }
BASI_DWCONV_WGRAD_ENTRY(basi_dwconv7x7_wgrad_bf16, __nv_bfloat16)
BASI_DWCONV_WGRAD_ENTRY(basi_dwconv7x7_wgrad_f32, float)

// Blocks of cb channels (32 or 8) of the forward and input gradient's kernel
// (wgrad 0) or of the weight gradient's (wgrad 1) that an SM of the current
// device holds at once, in bf16 or f32, into *blocks.
extern "C" int basi_dwconv7x7_blocks_per_sm(int wgrad, int f32, int cb,
                                            int *blocks) {
  if (cb != 8 && cb != 32) return (int)cudaErrorInvalidValue;
  if (f32)
    return cb == 32 ? blocks_per_sm<float, 32>(wgrad, blocks)
                    : blocks_per_sm<float, 8>(wgrad, blocks);
  return cb == 32 ? blocks_per_sm<__nv_bfloat16, 32>(wgrad, blocks)
                  : blocks_per_sm<__nv_bfloat16, 8>(wgrad, blocks);
}
