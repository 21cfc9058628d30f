// JPEG decode through nvJPEG (the CUDA toolkit's decoder): the decoded
// components, before upsampling and colour conversion, into a caller-owned
// buffer in device memory.
//
// The route for a machine without the libjpeg headers (the H100's). nvJPEG
// decodes the entropy-coded data and runs the IDCT; its planar output
// (NVJPEG_OUTPUT_Y for one component, NVJPEG_OUTPUT_YUV for three, each
// component at its own sampled size) is what libjpeg's IDCT gives up to
// nvJPEG's own IDCT rounding. The caller copies it to the host and does
// libjpeg's chroma upsampling and YCbCr -> RGB conversion there
// (basi_tpu_torch/data/native.py): nvJPEG's own RGB output upsamples
// chroma by repetition, not by libjpeg's triangle filter, so its colours
// differ from libjpeg's at the colour edges of subsampled images. One
// library handle per process, one decoder state per calling thread (nvJPEG
// states are not shared between threads).
//
// Exports (0 on success, else an nvjpegStatus_t; -1 when the handle could
// not be made; -2 for more than three components):
//   basi_nvjpeg_dims(data, len, &comps, dims[8]): (height, width) of each
//     component, then the chroma's horizontal and vertical upsampling
//     factors (from nvJPEG's chroma subsampling; 0 where it names none)
//   basi_nvjpeg_decode(data, len, dev_out, comps, dims, stream): the
//     planes one after the other, each height x width bytes

#include <cstddef>
#include <cstdint>
#include <mutex>

#include <nvjpeg.h>

namespace {

nvjpegHandle_t g_handle = nullptr;
nvjpegStatus_t g_status = NVJPEG_STATUS_SUCCESS;
std::once_flag g_once;
// never destroyed: a state outlives its thread until the process ends
thread_local nvjpegJpegState_t t_state = nullptr;

nvjpegHandle_t handle() {
  std::call_once(g_once, [] { g_status = nvjpegCreateSimple(&g_handle); });
  return g_status == NVJPEG_STATUS_SUCCESS ? g_handle : nullptr;
}

}  // namespace

extern "C" {

int basi_nvjpeg_dims(const uint8_t* data, size_t len, int* comps,
                     int* dims) {
  nvjpegHandle_t hd = handle();
  if (!hd) return -1;
  nvjpegChromaSubsampling_t sub;
  int ws[NVJPEG_MAX_COMPONENT] = {0}, hs[NVJPEG_MAX_COMPONENT] = {0};
  nvjpegStatus_t st = nvjpegGetImageInfo(hd, data, len, comps, &sub, ws, hs);
  if (st != NVJPEG_STATUS_SUCCESS) return static_cast<int>(st);
  if (*comps > 3) return -2;
  for (int c = 0; c < *comps; ++c) {
    dims[2 * c] = hs[c];
    dims[2 * c + 1] = ws[c];
  }
  int hf = 0, vf = 0;
  switch (sub) {
    case NVJPEG_CSS_444: hf = 1; vf = 1; break;
    case NVJPEG_CSS_422: hf = 2; vf = 1; break;
    case NVJPEG_CSS_420: hf = 2; vf = 2; break;
    case NVJPEG_CSS_440: hf = 1; vf = 2; break;
    case NVJPEG_CSS_411: hf = 4; vf = 1; break;
    case NVJPEG_CSS_410: hf = 4; vf = 2; break;
    case NVJPEG_CSS_GRAY: hf = 1; vf = 1; break;
    default: break;
  }
  dims[6] = hf;
  dims[7] = vf;
  return 0;
}

int basi_nvjpeg_decode(const uint8_t* data, size_t len, uint8_t* dev_out,
                       int comps, const int* dims, void* stream) {
  nvjpegHandle_t hd = handle();
  if (!hd) return -1;
  if (comps > 3) return -2;
  if (!t_state) {
    nvjpegStatus_t st = nvjpegJpegStateCreate(hd, &t_state);
    if (st != NVJPEG_STATUS_SUCCESS) {
      t_state = nullptr;
      return static_cast<int>(st);
    }
  }
  nvjpegImage_t img = {};
  uint8_t* plane = dev_out;
  for (int c = 0; c < comps; ++c) {
    img.channel[c] = plane;
    img.pitch[c] = static_cast<size_t>(dims[2 * c + 1]);
    plane += static_cast<size_t>(dims[2 * c]) * dims[2 * c + 1];
  }
  nvjpegOutputFormat_t fmt = comps == 1 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_YUV;
  return static_cast<int>(nvjpegDecode(hd, t_state, data, len, fmt, &img,
                                       static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
