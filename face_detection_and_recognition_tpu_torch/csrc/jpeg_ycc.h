// libjpeg's chroma upsampling and YCbCr -> BGR conversion, on the host.
//
// jpeg_codec.cpp's decoder finishes here: its IDCT writes each component's
// samples at the file's own subsampling, and these functions upsample and
// convert them as libjpeg-turbo does, so that the pixels are cv2's. The
// arithmetic is libjpeg-turbo's: the "fancy" triangle-filter upsampling of
// jdsample.c (do_fancy_upsampling, the library's default) and the 16-bit
// fixed-point tables of jdcolor.c. Header-only, so a host test can hold it
// to libjpeg's own raw planes.

#ifndef FDR_JPEG_YCC_H_
#define FDR_JPEG_YCC_H_

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <vector>

namespace fdr_ycc {

// One output row of a component plane (cw x ch samples at row stride
// `stride`, subsampled by hf, vf) upsampled as libjpeg-turbo's jdsample.c
// does with do_fancy_upsampling: the triangle filters h2v1, h2v2 (when the
// plane is wider than 2) and h1v2, and plain replication otherwise. Rows
// above the first and below the last repeat them, as libjpeg's context rows
// do. `out` holds cw * hf samples; `sums` is scratch of cw ints.
inline void upsample_row(const uint8_t* plane, size_t stride, int cw, int ch,
                         int hf, int vf, int row, int* sums, int* out) {
  const int sr = row / vf;
  const uint8_t* in0 = plane + static_cast<size_t>(sr) * stride;
  const bool fancy_h = hf == 2 && cw > 2;
  if (vf == 2 && (hf == 1 || fancy_h)) {
    const bool upper = row % 2 == 0;  // the nearer other row is above
    const int nr = upper ? std::max(sr - 1, 0) : std::min(sr + 1, ch - 1);
    const uint8_t* in1 = plane + static_cast<size_t>(nr) * stride;
    if (hf == 1) {  // h1v2
      const int bias = upper ? 1 : 2;
      for (int c = 0; c < cw; ++c) out[c] = (in0[c] * 3 + in1[c] + bias) >> 2;
      return;
    }
    // h2v2: 9/16, 3/16, 3/16, 1/16 of the four nearest samples
    for (int c = 0; c < cw; ++c) sums[c] = in0[c] * 3 + in1[c];
    out[0] = (sums[0] * 4 + 8) >> 4;
    out[1] = (sums[0] * 3 + sums[1] + 7) >> 4;
    for (int c = 1; c + 1 < cw; ++c) {
      out[2 * c] = (sums[c] * 3 + sums[c - 1] + 8) >> 4;
      out[2 * c + 1] = (sums[c] * 3 + sums[c + 1] + 7) >> 4;
    }
    out[2 * cw - 2] = (sums[cw - 1] * 3 + sums[cw - 2] + 8) >> 4;
    out[2 * cw - 1] = (sums[cw - 1] * 4 + 7) >> 4;
    return;
  }
  if (vf == 1 && fancy_h) {  // h2v1: 3/4 nearer + 1/4 further sample
    out[0] = in0[0];
    out[1] = (in0[0] * 3 + in0[1] + 2) >> 2;
    for (int c = 1; c + 1 < cw; ++c) {
      out[2 * c] = (in0[c] * 3 + in0[c - 1] + 1) >> 2;
      out[2 * c + 1] = (in0[c] * 3 + in0[c + 1] + 2) >> 2;
    }
    out[2 * cw - 2] = (in0[cw - 1] * 3 + in0[cw - 2] + 1) >> 2;
    out[2 * cw - 1] = in0[cw - 1];
    return;
  }
  for (int c = 0; c < cw * hf; ++c) out[c] = in0[c / hf];  // replication
}

// jdcolor.c's YCbCr -> RGB: 16-bit fixed point, FIX(x) = x * 2^16 rounded,
// the tables' arithmetic written out so that the loop vectorizes.
constexpr int kCrR = 91881;    // FIX(1.40200)
constexpr int kCbB = 116130;   // FIX(1.77200)
constexpr int kCrG = 46802;    // FIX(0.71414)
constexpr int kCbG = 22554;    // FIX(0.34414)

inline uint8_t clamp255(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// One component of a decoded image: `w` x `h` samples at row stride
// `stride`, each covering hf x vf output pixels.
struct Plane {
  const uint8_t* data;
  size_t stride;
  int w, h, hf, vf;
};

// Three planes -> BGR u8 HWC [h, w, 3]: YCbCr converted by jdcolor.c's
// arithmetic, or (rgb) R, G, B taken as they are.
inline void planes_to_bgr(const Plane p[3], int w, int h, bool rgb,
                          uint8_t* out) {
  std::vector<int> rows[3];
  int maxw = 0;
  for (int k = 0; k < 3; ++k) {
    rows[k].resize(static_cast<size_t>(p[k].w) * p[k].hf);
    maxw = std::max(maxw, p[k].w);
  }
  std::vector<int> sums(maxw);
  for (int r = 0; r < h; ++r) {
    for (int k = 0; k < 3; ++k)
      upsample_row(p[k].data, p[k].stride, p[k].w, p[k].h, p[k].hf, p[k].vf,
                   r, sums.data(), rows[k].data());
    const int* a = rows[0].data();
    const int* b = rows[1].data();
    const int* c2 = rows[2].data();
    uint8_t* o = out + static_cast<size_t>(r) * w * 3;
    if (rgb) {
      for (int c = 0; c < w; ++c) {
        o[3 * c] = static_cast<uint8_t>(c2[c]);
        o[3 * c + 1] = static_cast<uint8_t>(b[c]);
        o[3 * c + 2] = static_cast<uint8_t>(a[c]);
      }
      continue;
    }
    for (int c = 0; c < w; ++c) {
      const int yy = a[c], u = b[c] - 128, v = c2[c] - 128;
      o[3 * c] = clamp255(yy + ((kCbB * u + 32768) >> 16));
      o[3 * c + 1] = clamp255(yy + ((-kCbG * u - kCrG * v + 32768) >> 16));
      o[3 * c + 2] = clamp255(yy + ((kCrR * v + 32768) >> 16));
    }
  }
}

}  // namespace fdr_ycc

#endif  // FDR_JPEG_YCC_H_
