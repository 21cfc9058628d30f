// JPEG decode through libjpeg, into a caller-owned RGB buffer.
//
// The JPEG half of the JAX package's native decoder
// (basi_tpu/data/_native/decode.cc): the same libjpeg calls (default
// decompression parameters, JCS_RGB out), so the pixels are the same; the
// source is a memory buffer instead of a FILE*. The letterbox is
// basi_tpu_torch/data/native.py's. Built with g++ and -ljpeg where the
// libjpeg headers exist (basi_tpu_torch/data/native.py).
//
// Exports (0 on success, 1 on a libjpeg error):
//   basi_libjpeg_dims(data, len, &h, &w)
//   basi_libjpeg_decode(data, len, out[h*w*3], h, w)
//   basi_libjpeg_planes(data, len, out, cap, comps[1], dims[8]): the
//     decoded components before upsampling and colour conversion (raw
//     data out), each plane (height x width) one after the other, their
//     sizes in dims[0..5] and the chroma's horizontal and vertical
//     upsampling factors in dims[6], dims[7]: what the nvJPEG route gets
//     from nvJPEG, so that its upsampling and colour conversion can be
//     held against libjpeg's.

#include <csetjmp>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#include <jpeglib.h>

namespace {

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  longjmp(reinterpret_cast<JpegErr*>(cinfo->err)->jb, 1);
}

}  // namespace

extern "C" {

int basi_libjpeg_dims(const uint8_t* data, size_t len, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_calc_output_dimensions(&cinfo);
  *h = static_cast<int>(cinfo.output_height);
  *w = static_cast<int>(cinfo.output_width);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int basi_libjpeg_decode(const uint8_t* data, size_t len, uint8_t* out, int h,
                     int w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != h ||
      static_cast<int>(cinfo.output_width) != w ||
      cinfo.output_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + size_t(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int basi_libjpeg_planes(const uint8_t* data, size_t len, uint8_t* out,
                        size_t cap, int* comps, int* dims) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jb)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  jpeg_read_header(&cinfo, TRUE);
  if (cinfo.num_components > 3) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  cinfo.raw_data_out = TRUE;
  jpeg_start_decompress(&cinfo);
  const int n = cinfo.num_components;
  const int group = cinfo.max_v_samp_factor * DCTSIZE;
  std::vector<std::vector<uint8_t>> planes(n);
  std::vector<std::vector<JSAMPROW>> rows(n);
  std::vector<JSAMPARRAY> image(n);
  size_t total = 0;
  for (int c = 0; c < n; ++c) {
    jpeg_component_info* ci = &cinfo.comp_info[c];
    int pw = ci->width_in_blocks * DCTSIZE;
    int ph = (cinfo.total_iMCU_rows) * ci->v_samp_factor * DCTSIZE;
    planes[c].assign(size_t(pw) * ph, 0);
    rows[c].resize(ci->v_samp_factor * DCTSIZE);
    dims[2 * c] = static_cast<int>(ci->downsampled_height);
    dims[2 * c + 1] = static_cast<int>(ci->downsampled_width);
    total += size_t(ci->downsampled_height) * ci->downsampled_width;
  }
  if (total > cap) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  for (JDIMENSION mcu = 0; mcu < cinfo.total_iMCU_rows; ++mcu) {
    for (int c = 0; c < n; ++c) {
      jpeg_component_info* ci = &cinfo.comp_info[c];
      int pw = ci->width_in_blocks * DCTSIZE;
      int rows_here = ci->v_samp_factor * DCTSIZE;
      for (int r = 0; r < rows_here; ++r)
        rows[c][r] = planes[c].data() + (size_t(mcu) * rows_here + r) * pw;
      image[c] = rows[c].data();
    }
    jpeg_read_raw_data(&cinfo, image.data(), group);
  }
  uint8_t* dst = out;
  for (int c = 0; c < n; ++c) {
    int pw = cinfo.comp_info[c].width_in_blocks * DCTSIZE;
    for (int r = 0; r < dims[2 * c]; ++r) {
      std::memcpy(dst, planes[c].data() + size_t(r) * pw, dims[2 * c + 1]);
      dst += dims[2 * c + 1];
    }
  }
  *comps = n;
  dims[6] = n > 1 ? cinfo.max_h_samp_factor / cinfo.comp_info[1].h_samp_factor
                  : 1;
  dims[7] = n > 1 ? cinfo.max_v_samp_factor / cinfo.comp_info[1].v_samp_factor
                  : 1;
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
