// JPEG decode and encode through libjpeg: route (a) of the port's image I/O
// (utils/native.py), the counterpart of cv2.imread / cv2.imdecode and
// cv2.imwrite / cv2.imencode for JPEG files.
//
// The decoder is the port's own copy of the full-resolution decode in the
// JAX package's native/fdrt_native.cpp (JDCT_ISLOW, libjpeg's default
// upsampling, as OpenCV decodes), with a grayscale file returned as three
// equal channels, as cv2.imread returns it; the encoder is libjpeg's
// baseline compressor at a given quality with 4:2:0 chroma, OpenCV's
// default. Plain C interface, bound with ctypes; built by the host compiler
// with -ljpeg on first use.

#include <cstddef>
#include <cstdio>
#include <cstdlib>

#include <jpeglib.h>

#include <csetjmp>
#include <cstdint>
#include <vector>

namespace {

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrMgr* err = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// warnings are not printed; a decode that raised one (a truncated or
// corrupt file) fails instead, as cv2.imdecode returns None for it
void quiet(j_common_ptr) {}

}  // namespace

extern "C" {

const char* fdr_jpeg_route() { return "libjpeg"; }

// Header-only pass: image width and height.
// Returns 0 ok, -1 not a readable JPEG header.
int fdr_jpeg_info(const uint8_t* data, size_t len, int* w, int* h) {
  if (len == 0) return -1;
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = quiet;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  jpeg_read_header(&cinfo, TRUE);
  *w = cinfo.image_width;
  *h = cinfo.image_height;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Decode at full resolution into a caller-allocated BGR u8 HWC buffer of
// w*h*3 bytes (w, h from fdr_jpeg_info). A grayscale file comes back as
// three equal channels. Returns 0 ok, -1 decode error, corrupt or
// truncated data, or size mismatch, -2 a color space other than grayscale
// and YCbCr/RGB (CMYK, YCCK).
int fdr_jpeg_decode_bgr(const uint8_t* data, size_t len, uint8_t* out, int w,
                        int h) {
  if (len == 0) return -1;
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = quiet;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<uint8_t*>(data), len);
  jpeg_read_header(&cinfo, TRUE);
  const bool gray = cinfo.jpeg_color_space == JCS_GRAYSCALE;
  if (!gray && cinfo.num_components != 3) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  cinfo.out_color_space = gray ? JCS_GRAYSCALE : JCS_RGB;
  cinfo.dct_method = JDCT_ISLOW;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_width) != w ||
      static_cast<int>(cinfo.output_height) != h) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  const int ch = cinfo.output_components;  // 1 (gray) or 3 (RGB)
  std::vector<uint8_t> row(static_cast<size_t>(w) * ch);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* dst = out + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    uint8_t* src = row.data();
    jpeg_read_scanlines(&cinfo, &src, 1);
    for (int x = 0; x < w; ++x) {
      if (ch == 1) {
        dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = src[x];
      } else {  // RGB -> BGR
        dst[3 * x] = src[3 * x + 2];
        dst[3 * x + 1] = src[3 * x + 1];
        dst[3 * x + 2] = src[3 * x];
      }
    }
  }
  jpeg_finish_decompress(&cinfo);
  const long warnings = jerr.pub.num_warnings;  // NOLINT(runtime/int)
  jpeg_destroy_decompress(&cinfo);
  return warnings == 0 ? 0 : -1;
}

// Encode a BGR u8 HWC image of w*h*3 bytes as a baseline JPEG at
// `quality` (1-100), 4:2:0 chroma. On success *out points to len bytes
// that the caller releases with fdr_jpeg_free. Returns 0 ok, -1 error.
int fdr_jpeg_encode_bgr(const uint8_t* img, int w, int h, int quality,
                        uint8_t** out, size_t* out_len) {
  *out = nullptr;
  *out_len = 0;
  jpeg_compress_struct cinfo;
  ErrMgr jerr;
  unsigned char* buf = nullptr;
  unsigned long buf_len = 0;  // NOLINT(runtime/int): libjpeg's type
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = quiet;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_compress(&cinfo);
    free(buf);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &buf, &buf_len);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);  // YCbCr, 4:2:0, JDCT_ISLOW, baseline
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  std::vector<uint8_t> row(static_cast<size_t>(w) * 3);
  while (cinfo.next_scanline < cinfo.image_height) {
    const uint8_t* src = img + static_cast<size_t>(cinfo.next_scanline) * w * 3;
    for (int x = 0; x < w; ++x) {  // BGR -> RGB
      row[3 * x] = src[3 * x + 2];
      row[3 * x + 1] = src[3 * x + 1];
      row[3 * x + 2] = src[3 * x];
    }
    uint8_t* r = row.data();
    jpeg_write_scanlines(&cinfo, &r, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  *out = buf;
  *out_len = buf_len;
  return 0;
}

void fdr_jpeg_free(uint8_t* p) { free(p); }

}  // extern "C"
