// PNG scanline unfiltering (the PNG specification's filter types 0-4: None,
// Sub, Up, Average, Paeth) for the port's PNG reader, utils/native.py. The
// Average and Paeth filters depend on the byte one pixel to the left, so a
// row is a serial chain; this loop runs it in C++ where a numpy loop over
// the pixels of a 576x1024 frame takes about a second. The numpy twin in
// utils/native.py (png_unfilter_plain) is its plain version for the tests.
//
// Plain C interface, bound with ctypes; built by the host compiler on first
// use, as the JPEG library is.

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  if (pb <= pc) return static_cast<uint8_t>(b);
  return static_cast<uint8_t>(c);
}

}  // namespace

extern "C" {

// in: `height` filtered rows of 1 + rowbytes bytes (the filter type first);
// out: `height` x rowbytes unfiltered bytes; bpp: bytes a pixel (at least
// 1). Returns 0, or -1 on a filter type outside 0-4 (a corrupt file).
int fdr_png_unfilter(const uint8_t* in, uint8_t* out, int height,
                     long rowbytes, int bpp) {
  const uint8_t* prev = nullptr;  // the row above, unfiltered; none above row 0
  for (int y = 0; y < height; ++y) {
    const uint8_t* src = in + static_cast<size_t>(y) * (rowbytes + 1);
    uint8_t* dst = out + static_cast<size_t>(y) * rowbytes;
    const uint8_t type = *src++;
    switch (type) {
      case 0:
        std::memcpy(dst, src, rowbytes);
        break;
      case 1:
        for (long i = 0; i < rowbytes; ++i)
          dst[i] = static_cast<uint8_t>(src[i] + (i >= bpp ? dst[i - bpp] : 0));
        break;
      case 2:
        for (long i = 0; i < rowbytes; ++i)
          dst[i] = static_cast<uint8_t>(src[i] + (prev ? prev[i] : 0));
        break;
      case 3:
        for (long i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (long i = 0; i < rowbytes; ++i) {
          const int a = i >= bpp ? dst[i - bpp] : 0;
          const int b = prev ? prev[i] : 0;
          const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
          dst[i] = static_cast<uint8_t>(src[i] + paeth(a, b, c));
        }
        break;
      default:
        return -1;
    }
    prev = dst;
  }
  return 0;
}

}  // extern "C"
