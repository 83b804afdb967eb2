// libjpeg's chroma upsampling and YCbCr -> BGR conversion, on the host.
//
// jpeg_nvjpeg.cpp decodes with nvJPEG to YUV planes at the file's own
// chroma subsampling and finishes here, so that its pixels are libjpeg's
// (and cv2's) up to the IDCT. The arithmetic is libjpeg-turbo's: the
// "fancy" triangle-filter upsampling of jdsample.c (do_fancy_upsampling,
// the library's default) and the 16-bit fixed-point tables of jdcolor.c.
// Header-only and free of CUDA, so a host test can hold it to libjpeg.

#ifndef FDR_JPEG_YCC_H_
#define FDR_JPEG_YCC_H_

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <vector>

namespace fdr_ycc {

// One output row of a chroma plane (cw x ch samples, subsampled by hf, vf)
// upsampled as libjpeg-turbo's jdsample.c does with do_fancy_upsampling:
// the triangle filters h2v1, h2v2 (when the plane is wider than 2) and
// h1v2, and plain replication otherwise. Rows above the first and below
// the last repeat them, as libjpeg's context rows do. `out` holds
// cw * hf samples; `sums` is scratch of cw ints.
inline void upsample_row(const uint8_t* plane, int cw, int ch, int hf,
                         int vf, int row, int* sums, int* out) {
  const int sr = row / vf;
  const uint8_t* in0 = plane + static_cast<size_t>(sr) * cw;
  const bool fancy_h = hf == 2 && cw > 2;
  if (vf == 2 && (hf == 1 || fancy_h)) {
    const bool upper = row % 2 == 0;  // the nearer other row is above
    const int nr = upper ? std::max(sr - 1, 0) : std::min(sr + 1, ch - 1);
    const uint8_t* in1 = plane + static_cast<size_t>(nr) * cw;
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

// Planes -> BGR u8 HWC [h, w, 3]: Y at w x h, Cb and Cr at cw x ch,
// subsampled by (hf, vf).
inline void ycc_to_bgr(const uint8_t* y, const uint8_t* cb,
                       const uint8_t* cr, int w, int h, int cw, int ch,
                       int hf, int vf, uint8_t* out) {
  std::vector<int> ub(static_cast<size_t>(cw) * hf);
  std::vector<int> vr(static_cast<size_t>(cw) * hf);
  std::vector<int> sums(cw);
  for (int r = 0; r < h; ++r) {
    upsample_row(cb, cw, ch, hf, vf, r, sums.data(), ub.data());
    upsample_row(cr, cw, ch, hf, vf, r, sums.data(), vr.data());
    const uint8_t* yr = y + static_cast<size_t>(r) * w;
    uint8_t* o = out + static_cast<size_t>(r) * w * 3;
    for (int c = 0; c < w; ++c) {
      const int yy = yr[c], u = ub[c] - 128, v = vr[c] - 128;
      o[3 * c] = clamp255(yy + ((kCbB * u + 32768) >> 16));
      o[3 * c + 1] = clamp255(yy + ((-kCbG * u - kCrG * v + 32768) >> 16));
      o[3 * c + 2] = clamp255(yy + ((kCrR * v + 32768) >> 16));
    }
  }
}

}  // namespace fdr_ycc

#endif  // FDR_JPEG_YCC_H_
