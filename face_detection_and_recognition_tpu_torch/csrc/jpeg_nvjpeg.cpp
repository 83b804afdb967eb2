// JPEG decode and encode through nvJPEG (CUDA toolkit): route (b) of the
// port's image I/O (utils/native.py), for machines with the CUDA toolkit and
// no libjpeg. The same C interface as jpeg_libjpeg.cpp, on host buffers:
// the bitstream goes to the card, nvJPEG decodes (or encodes) there on a
// stream of its own, and the pixels (or the bitstream) come back.
//
// nvJPEG decodes to its YUV planes at the file's own chroma subsampling;
// the chroma is then upsampled and converted to BGR on the host exactly as
// libjpeg does it (its "fancy" triangle-filter upsampling and its
// fixed-point YCbCr -> RGB tables), so the pixels are libjpeg's (and
// cv2's) up to nvJPEG's IDCT, which differs from libjpeg's JDCT_ISLOW by a
// level here and there. (With nvJPEG's own interleaved BGR output, its
// own chroma upsampling and colour conversion, the mean error of a quality
// 95 round trip of chip_smoke.py's frame on an H100 was 1.655 levels; with
// this conversion it is 1.341, the rest being nvJPEG's encoder.)
//
// A grayscale file comes back as three equal channels, as cv2.imread
// returns it; the encoder writes baseline JPEG at a given quality with
// 4:2:0 chroma, OpenCV's default.
//
// One nvJPEG handle, decoder state, encoder state and device buffer serve
// the process, behind one mutex: request threads call in concurrently.
// Plain C interface, bound with ctypes; built by the host compiler against
// the toolkit's headers with -lnvjpeg on first use.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <vector>

#include "jpeg_ycc.h"

namespace {

std::mutex g_mu;
nvjpegHandle_t g_handle = nullptr;
nvjpegJpegState_t g_dec = nullptr;
nvjpegEncoderState_t g_enc = nullptr;
nvjpegEncoderParams_t g_params = nullptr;
cudaStream_t g_stream = nullptr;
uint8_t* g_buf = nullptr;
size_t g_cap = 0;

constexpr int kBadData = -1;      // not a JPEG nvJPEG can read
constexpr int kColorSpace = -2;   // not gray or 3 components, or a chroma
                                  // layout of no integer subsampling
constexpr int kDevice = -3;       // CUDA or nvJPEG failed to set up or run
constexpr int kNoMemory = -4;     // the device buffer could not grow

int g_init = 1;  // 1: not tried yet; 0: ready; kDevice: the set-up failed

// The handle, states and stream, made once: a failed set-up is not
// retried, and every later call returns its error.
int init() {
  if (g_init != 1) return g_init;
  g_init = kDevice;
  if (cudaStreamCreateWithFlags(&g_stream, cudaStreamNonBlocking) !=
          cudaSuccess ||
      nvjpegCreateSimple(&g_handle) != NVJPEG_STATUS_SUCCESS ||
      nvjpegJpegStateCreate(g_handle, &g_dec) != NVJPEG_STATUS_SUCCESS ||
      nvjpegEncoderStateCreate(g_handle, &g_enc, g_stream) !=
          NVJPEG_STATUS_SUCCESS ||
      nvjpegEncoderParamsCreate(g_handle, &g_params, g_stream) !=
          NVJPEG_STATUS_SUCCESS ||
      nvjpegEncoderParamsSetSamplingFactors(g_params, NVJPEG_CSS_420,
                                            g_stream) !=
          NVJPEG_STATUS_SUCCESS ||
      nvjpegEncoderParamsSetOptimizedHuffman(g_params, 0, g_stream) !=
          NVJPEG_STATUS_SUCCESS)
    return g_init;
  g_init = 0;
  return 0;
}

// The device buffer, grown to at least n bytes; nullptr if it cannot be.
uint8_t* device_buffer(size_t n) {
  if (n > g_cap) {
    cudaFree(g_buf);
    g_buf = nullptr;
    g_cap = 0;
    if (cudaMalloc(reinterpret_cast<void**>(&g_buf), n) != cudaSuccess) {
      g_buf = nullptr;
      return nullptr;
    }
    g_cap = n;
  }
  return g_buf;
}

// The chroma planes' horizontal and vertical subsampling factors; false
// for a layout libjpeg would not upsample by an integer factor.
bool chroma_factors(nvjpegChromaSubsampling_t ss, int* hf, int* vf) {
  switch (ss) {
    case NVJPEG_CSS_444: *hf = 1; *vf = 1; return true;
    case NVJPEG_CSS_422: *hf = 2; *vf = 1; return true;
    case NVJPEG_CSS_420: *hf = 2; *vf = 2; return true;
    case NVJPEG_CSS_440: *hf = 1; *vf = 2; return true;
    case NVJPEG_CSS_411: *hf = 4; *vf = 1; return true;
    case NVJPEG_CSS_410: *hf = 4; *vf = 2; return true;
    default: return false;
  }
}

}  // namespace

extern "C" {

const char* fdr_jpeg_route() { return "nvjpeg"; }

// Header-only pass: image width and height.
// Returns 0 ok, -1 not a readable JPEG header, -3 device set-up failed.
int fdr_jpeg_info(const uint8_t* data, size_t len, int* w, int* h) {
  if (len == 0) return kBadData;
  std::lock_guard<std::mutex> lock(g_mu);
  int err = init();
  if (err != 0) return err;
  int widths[NVJPEG_MAX_COMPONENT];
  int heights[NVJPEG_MAX_COMPONENT];
  int comps = 0;
  nvjpegChromaSubsampling_t ss;
  if (nvjpegGetImageInfo(g_handle, data, len, &comps, &ss, widths,
                         heights) != NVJPEG_STATUS_SUCCESS)
    return kBadData;
  *w = widths[0];
  *h = heights[0];
  return 0;
}

// Decode at full resolution into a caller-allocated BGR u8 HWC buffer of
// w*h*3 host bytes (w, h from fdr_jpeg_info). Returns 0 ok, -1 decode
// error or size mismatch, -2 unsupported color space or subsampling,
// -3 / -4 device failure.
int fdr_jpeg_decode_bgr(const uint8_t* data, size_t len, uint8_t* out, int w,
                        int h) {
  if (len == 0) return kBadData;
  std::lock_guard<std::mutex> lock(g_mu);
  int err = init();
  if (err != 0) return err;
  int widths[NVJPEG_MAX_COMPONENT];
  int heights[NVJPEG_MAX_COMPONENT];
  int comps = 0;
  nvjpegChromaSubsampling_t ss;
  if (nvjpegGetImageInfo(g_handle, data, len, &comps, &ss, widths,
                         heights) != NVJPEG_STATUS_SUCCESS)
    return kBadData;
  if (widths[0] != w || heights[0] != h) return kBadData;
  int hf = 1, vf = 1;
  if (comps == 3 && !chroma_factors(ss, &hf, &vf)) return kColorSpace;
  if (comps != 1 && comps != 3) return kColorSpace;
  const size_t ny = static_cast<size_t>(w) * h;
  const int cw = comps == 3 ? widths[1] : 0;
  const int ch = comps == 3 ? heights[1] : 0;
  if (comps == 3 && (widths[2] != cw || heights[2] != ch ||
                     cw * hf < w || ch * vf < h))
    return kColorSpace;
  const size_t nc = static_cast<size_t>(cw) * ch;
  uint8_t* buf = device_buffer(ny + 2 * nc);
  if (buf == nullptr) return kNoMemory;
  nvjpegImage_t img;
  std::memset(&img, 0, sizeof(img));
  img.channel[0] = buf;
  img.pitch[0] = w;
  if (comps == 3) {
    img.channel[1] = buf + ny;
    img.channel[2] = buf + ny + nc;
    img.pitch[1] = img.pitch[2] = cw;
  }
  const nvjpegOutputFormat_t fmt =
      comps == 1 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_YUV;
  if (nvjpegDecode(g_handle, g_dec, data, len, fmt, &img, g_stream) !=
      NVJPEG_STATUS_SUCCESS) {
    cudaStreamSynchronize(g_stream);
    return kBadData;
  }
  std::vector<uint8_t> planes(ny + 2 * nc);
  if (cudaMemcpyAsync(planes.data(), buf, planes.size(),
                      cudaMemcpyDeviceToHost, g_stream) != cudaSuccess ||
      cudaStreamSynchronize(g_stream) != cudaSuccess)
    return kDevice;
  if (comps == 1) {  // Y -> three equal channels
    for (size_t i = 0; i < ny; ++i)
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = planes[i];
    return 0;
  }
  fdr_ycc::ycc_to_bgr(planes.data(), planes.data() + ny,
                      planes.data() + ny + nc, w, h, cw, ch, hf, vf, out);
  return 0;
}

// Encode a BGR u8 HWC host image of w*h*3 bytes as a baseline JPEG at
// `quality` (1-100), 4:2:0 chroma. On success *out points to len bytes
// that the caller releases with fdr_jpeg_free. Returns 0 ok, -1 encode
// error, -3 / -4 device failure.
int fdr_jpeg_encode_bgr(const uint8_t* img, int w, int h, int quality,
                        uint8_t** out, size_t* out_len) {
  *out = nullptr;
  *out_len = 0;
  std::lock_guard<std::mutex> lock(g_mu);
  int err = init();
  if (err != 0) return err;
  const size_t n = static_cast<size_t>(w) * h * 3;
  uint8_t* buf = device_buffer(n);
  if (buf == nullptr) return kNoMemory;
  if (cudaMemcpyAsync(buf, img, n, cudaMemcpyHostToDevice, g_stream) !=
      cudaSuccess)
    return kDevice;
  nvjpegImage_t src;
  std::memset(&src, 0, sizeof(src));
  src.channel[0] = buf;
  src.pitch[0] = static_cast<size_t>(w) * 3;
  size_t len = 0;
  if (nvjpegEncoderParamsSetQuality(g_params, quality, g_stream) !=
          NVJPEG_STATUS_SUCCESS ||
      nvjpegEncodeImage(g_handle, g_enc, g_params, &src, NVJPEG_INPUT_BGRI,
                        w, h, g_stream) != NVJPEG_STATUS_SUCCESS ||
      nvjpegEncodeRetrieveBitstream(g_handle, g_enc, nullptr, &len,
                                    g_stream) != NVJPEG_STATUS_SUCCESS) {
    cudaStreamSynchronize(g_stream);
    return kBadData;
  }
  if (cudaStreamSynchronize(g_stream) != cudaSuccess) return kDevice;
  uint8_t* bytes = static_cast<uint8_t*>(malloc(len));
  if (bytes == nullptr) return kNoMemory;
  if (nvjpegEncodeRetrieveBitstream(g_handle, g_enc, bytes, &len,
                                    g_stream) != NVJPEG_STATUS_SUCCESS ||
      cudaStreamSynchronize(g_stream) != cudaSuccess) {
    free(bytes);
    return kDevice;
  }
  *out = bytes;
  *out_len = len;
  return 0;
}

void fdr_jpeg_free(uint8_t* p) { free(p); }

}  // extern "C"
