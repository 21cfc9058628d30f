// PNG scanline filtering and unfiltering with the five filter types of the
// PNG specification (None, Sub, Up, Average, Paeth), for
// basi_tpu_torch/data/png.py, which does the zlib streams and the sample
// packing itself. Average and Paeth make each byte depend on the one
// before it, so they cannot be whole-array numpy operations; here each row
// costs one pass (five to filter).
//
// Exports (``bpp`` is the bytes per complete pixel, at least 1: the
// spec's rule for sub-byte depths):
//   basi_png_unfilter(raw, rows, stride, bpp, out): ``raw`` holds ``rows``
//     scanlines of 1 filter byte + ``stride`` bytes; ``out`` receives the
//     rows x stride unfiltered bytes. 0 on success; 1 + the row index where
//     a row names a filter type other than 0-4.
//   basi_png_filter(lines, rows, stride, bpp, out): the inverse, with the
//     filter type of each row chosen as libpng chooses it by default: of
//     None, Sub, Up, Average and Paeth, the first whose bytes, read as
//     signed, have the least sum of absolute values. ``out`` receives
//     rows x (1 + stride) bytes. Returns 0.

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

}  // namespace

extern "C" int basi_png_unfilter(const uint8_t* raw, int rows, size_t stride,
                                 int bpp, uint8_t* out) {
  const size_t b = static_cast<size_t>(bpp);
  const uint8_t* prior = nullptr;  // the first row's prior row is zeros
  for (int y = 0; y < rows; ++y) {
    const uint8_t* line = raw + static_cast<size_t>(y) * (stride + 1);
    const uint8_t type = *line++;
    uint8_t* cur = out + static_cast<size_t>(y) * stride;
    switch (type) {
      case 0:
        std::memcpy(cur, line, stride);
        break;
      case 1:
        for (size_t x = 0; x < stride; ++x)
          cur[x] = static_cast<uint8_t>(line[x] + (x >= b ? cur[x - b] : 0));
        break;
      case 2:
        for (size_t x = 0; x < stride; ++x)
          cur[x] = static_cast<uint8_t>(line[x] + (prior ? prior[x] : 0));
        break;
      case 3:
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= b ? cur[x - b] : 0;
          int up = prior ? prior[x] : 0;
          cur[x] = static_cast<uint8_t>(line[x] + ((a + up) >> 1));
        }
        break;
      case 4:
        for (size_t x = 0; x < stride; ++x) {
          int a = x >= b ? cur[x - b] : 0;
          int up = prior ? prior[x] : 0;
          int c = prior && x >= b ? prior[x - b] : 0;
          cur[x] = static_cast<uint8_t>(line[x] + paeth(a, up, c));
        }
        break;
      default:
        return y + 1;
    }
    prior = cur;
  }
  return 0;
}

extern "C" int basi_png_filter(const uint8_t* lines, int rows, size_t stride,
                               int bpp, uint8_t* out) {
  const size_t b = static_cast<size_t>(bpp);
  uint8_t* cand = static_cast<uint8_t*>(std::malloc(5 * stride + 1));
  if (!cand) return -1;
  const uint8_t* prior = nullptr;
  for (int y = 0; y < rows; ++y) {
    const uint8_t* cur = lines + static_cast<size_t>(y) * stride;
    long best_sum = -1;
    int best = 0;
    for (int type = 0; type < 5; ++type) {
      uint8_t* f = cand + type * stride;
      long sum = 0;
      for (size_t x = 0; x < stride; ++x) {
        int a = x >= b ? cur[x - b] : 0;
        int up = prior ? prior[x] : 0;
        int c = prior && x >= b ? prior[x - b] : 0;
        int pred = type == 0   ? 0
                   : type == 1 ? a
                   : type == 2 ? up
                   : type == 3 ? (a + up) >> 1
                               : paeth(a, up, c);
        uint8_t v = static_cast<uint8_t>(cur[x] - pred);
        f[x] = v;
        sum += v < 128 ? v : 256 - v;
      }
      if (best_sum < 0 || sum < best_sum) {
        best_sum = sum;
        best = type;
      }
    }
    uint8_t* row = out + static_cast<size_t>(y) * (stride + 1);
    row[0] = static_cast<uint8_t>(best);
    std::memcpy(row + 1, cand + best * stride, stride);
    prior = cur;
  }
  std::free(cand);
  return 0;
}
