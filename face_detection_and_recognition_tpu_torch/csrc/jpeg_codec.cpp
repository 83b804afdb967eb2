// The port's own JPEG codec: the counterpart of cv2.imread / cv2.imdecode
// and cv2.imwrite / cv2.imencode for JPEG files, computed as libjpeg-turbo
// computes them with cv2's settings, so that pixels and bytes are cv2's.
// The same host code runs on every machine (utils/native.py builds it with
// the host compiler on first use); it needs no libjpeg.
//
// Decode: baseline and extended-sequential 8-bit Huffman (SOF0, SOF1) and
// progressive (SOF2) files, with restart intervals, in gray and in three
// components at any integral sampling (4:4:4, 4:2:2, 4:4:0, 4:2:0, 4:1:1).
// A sequential file that leaves out its Huffman tables, as Motion-JPEG
// frames do, decodes with the standard ones, as libjpeg-turbo's does.
// Dequantisation and jidctint.c's JDCT_ISLOW integer IDCT with its range
// limit, then jdsample.c's fancy upsampling and jdcolor.c's tables
// (jpeg_ycc.h). A progressive file is buffered whole before output, as
// libjpeg does outside buffered-image mode; when its scans leave the low
// coefficients unrefined libjpeg would smooth the blocks (jdcoefct.c), and
// such a file is refused as a variant, as are arithmetic-coded, lossless,
// hierarchical and 12-bit files. Any fault libjpeg reports, a warning
// included (a truncated or corrupt file), makes the decode fail: the
// caller returns None, as the libjpeg decode it replaces did.
//
// Encode: what jpeg_set_defaults + jpeg_set_quality(q, TRUE) write, as
// cv2.imencode(".jpg", img) does: jccolor.c's RGB -> YCbCr tables, 4:2:0
// with jcsample.c's h2v2_downsample (alternating 1/2 bias, right and bottom
// edges replicated), jfdctint.c's islow FDCT and jcdctmgr.c's reciprocal
// quantiser, the standard Huffman tables without optimisation, the JFIF
// APP0, DQT, SOF0, DHT and SOS markers in jcmarker.c's order, dummy blocks
// at the right and bottom of the last MCUs as jccoefct.c makes them, and
// the last byte padded with 1-bits. Gray input writes one component.

#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "jpeg_ycc.h"

namespace {

// Return codes shared with utils/native.py.
constexpr int kOk = 0;
constexpr int kUnreadable = -1;    // not a whole JPEG: cv2 gives None
constexpr int kColorSpace = -2;    // 2 or 4 components (CMYK, YCCK)
constexpr int kArithmetic = -11;   // SOF9-11, SOF13-15
constexpr int kLossless = -12;     // SOF3
constexpr int kHierarchical = -13; // SOF5-7
constexpr int kPrecision = -14;    // 12-bit samples
constexpr int kSmoothing = -15;    // progressive, low coefficients unrefined

// zigzag -> natural order, with libjpeg's 16 guard entries for a run past
// the end of a corrupt block
constexpr int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// jstdhuff.c's standard tables (T.81 Annex K.3): bits[1..16], then the
// values. The encoder writes them; the decoder takes them for a sequential
// scan whose tables no DHT defined (a Motion-JPEG frame).
constexpr uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1,
                                    1, 0, 0, 0, 0, 0, 0, 0};
constexpr uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1,
                                      1, 1, 1, 0, 0, 0, 0, 0};
constexpr uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3,
                                    5, 5, 4, 4, 0, 0, 1, 0x7d};
constexpr uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
constexpr uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4,
                                      7, 5, 4, 4, 0, 1, 2, 0x77};
constexpr uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// ---------------------------------------------------------------- decode

struct HuffTable {  // jdhuff.c's d_derived_tbl
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint8_t look_nbits[256];  // 0: the code is longer than 8 bits
  uint8_t look_sym[256];
};

bool build_huff(HuffTable* t, const uint8_t bits[17], const uint8_t* vals,
                int count, bool dc) {
  int huffcode[257];
  int p = 0, code = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l]; ++i) huffcode[p++] = code++;
    if (code > (1 << l)) return false;  // JERR_BAD_HUFF_TABLE
    code <<= 1;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l]) {
      t->valoffset[l] = p - huffcode[p];
      p += bits[l];
      t->maxcode[l] = huffcode[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0xFFFFF;
  std::memset(t->look_nbits, 0, sizeof(t->look_nbits));
  p = 0;
  for (int l = 1; l <= 8; ++l) {
    for (int i = 0; i < bits[l]; ++i, ++p) {
      int look = huffcode[p] << (8 - l);
      for (int c = 0; c < (1 << (8 - l)); ++c, ++look) {
        t->look_nbits[look] = static_cast<uint8_t>(l);
        t->look_sym[look] = vals[p];
      }
    }
  }
  for (int i = 0; i < count; ++i) {
    if (dc && vals[i] > 15) return false;
    t->vals[i] = vals[i];
  }
  t->defined = true;
  return true;
}

// Entropy-coded data: bytes with 0xFF 0x00 stuffing, up to the next marker.
// Bits wanted past the marker read as zeros and mark the data corrupt, as
// libjpeg's fill_bit_buffer warns (JWRN_HIT_MARKER).
struct BitReader {
  const uint8_t* d;
  size_t n;
  size_t pos;
  uint64_t buf = 0;
  int bits = 0;
  int marker = 0;  // the marker that ended the data, 0 while none, -1 EOF
  bool corrupt = false;

  void fill() {
    while (bits <= 56 && marker == 0) {
      if (pos >= n) {
        marker = -1;
        break;
      }
      int c = d[pos++];
      if (c == 0xFF) {
        while (pos < n && d[pos] == 0xFF) ++pos;
        if (pos >= n) {
          marker = -1;
          break;
        }
        const int m = d[pos++];
        if (m != 0) {
          marker = m;
          break;
        }
      }
      buf = (buf << 8) | static_cast<uint64_t>(c);
      bits += 8;
    }
  }
  int get(int k) {  // k in 1..16
    if (bits < k) {
      fill();
      if (bits < k) {
        corrupt = true;
        buf <<= (k - bits);
        bits = k;
      }
    }
    bits -= k;
    return static_cast<int>((buf >> bits) & ((1u << k) - 1));
  }
  // One Huffman symbol: the 8-bit lookahead table, else the code's length
  // found from 16 bits peeked at once (zeros past the data's end, which
  // mark it corrupt only when a code takes them)
  int decode(const HuffTable& t) {
    if (bits < 16) fill();
    const int avail = bits;
    const uint32_t peek = avail >= 16
        ? static_cast<uint32_t>(buf >> (avail - 16)) & 0xFFFF
        : static_cast<uint32_t>(buf << (16 - avail)) & 0xFFFF;
    const int look = static_cast<int>(peek >> 8);
    int nb = t.look_nbits[look];
    int sym = t.look_sym[look];
    if (!nb) {
      for (nb = 9; nb <= 16; ++nb) {
        const int code = static_cast<int>(peek >> (16 - nb));
        if (code <= t.maxcode[nb]) {
          sym = t.vals[(code + t.valoffset[nb]) & 0xFF];
          break;
        }
      }
      if (nb > 16) {  // JWRN_HUFF_BAD_CODE
        corrupt = true;
        bits = 0;
        return 0;
      }
    }
    if (nb > avail) {
      corrupt = true;
      bits = 0;
    } else {
      bits -= nb;
    }
    return sym;
  }
  // The restart marker RST(n & 7) next, after at most the padding bits of
  // the last byte; false where libjpeg would warn and resynchronise.
  bool restart(int n_rst) {
    const bool whole_bytes = bits >= 8 && marker == 0 ? true : false;
    buf = 0;
    bits = 0;
    if (whole_bytes) return false;
    if (marker == 0) {
      if (pos + 1 >= this->n || d[pos] != 0xFF) return false;
      while (pos < this->n && d[pos] == 0xFF) ++pos;
      if (pos >= this->n) return false;
      marker = d[pos++];
    }
    if (marker != 0xD0 + (n_rst & 7)) return false;
    marker = 0;
    return true;
  }
};

inline int extend(int v, int s) {  // HUFF_EXTEND
  return v < (1 << (s - 1)) ? v + static_cast<int>((-1u) << s) + 1 : v;
}

struct Component {
  int id, h, v, tq;
  int td = 0, ta = 0;
  int bw, bh;    // blocks holding image samples
  int bwp, bhp;  // blocks of whole MCUs
  int cw, ch;    // samples
  bool latched = false;
  int16_t quant[64];
  int coef_bits[64];
  std::vector<int16_t> coef;  // bwp * bhp blocks of 64, natural order
  int16_t* block(int bx, int by) {
    return coef.data() + (static_cast<size_t>(by) * bwp + bx) * 64;
  }
};

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0;
  bool progressive = false, frame = false, saw_jfif = false,
       saw_adobe = false;
  int adobe_transform = -1;
  int maxh = 1, maxv = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  int scans = 0;
  bool eoi = false;
  Component comp[4];
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];

  int u16(size_t at) const { return (d[at] << 8) | d[at + 1]; }

  // The next marker code at pos, after fill bytes; -1 when the bytes there
  // are not a marker (libjpeg would skip them with a warning) or run out.
  int next_marker() {
    if (pos + 1 >= n || d[pos] != 0xFF) return -1;
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos >= n) return -1;
    return d[pos++];
  }

  int parse_sof(int m, size_t at, int len) {
    if (m == 0xC3) return kLossless;
    if (m == 0xC5 || m == 0xC6 || m == 0xC7) return kHierarchical;
    if ((m >= 0xC9 && m <= 0xCB) || (m >= 0xCD && m <= 0xCF))
      return kArithmetic;
    if (frame || len < 8) return kUnreadable;
    if (d[at] != 8) return d[at] == 12 ? kPrecision : kUnreadable;
    height = u16(at + 1);
    width = u16(at + 3);
    ncomp = d[at + 5];
    if (len != 6 + 3 * ncomp || width == 0 || height == 0) return kUnreadable;
    if (ncomp == 2 || ncomp == 4) return kColorSpace;
    if (ncomp != 1 && ncomp != 3) return kUnreadable;
    progressive = m == 0xC2;
    maxh = maxv = 1;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = d[at + 6 + 3 * i];
      c.h = d[at + 7 + 3 * i] >> 4;
      c.v = d[at + 7 + 3 * i] & 15;
      c.tq = d[at + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        return kUnreadable;
      maxh = c.h > maxh ? c.h : maxh;
      maxv = c.v > maxv ? c.v : maxv;
    }
    if (ncomp == 1) {  // a lone component is its own MCU at full size
      comp[0].h = comp[0].v = maxh = maxv = 1;
    }
    mcux = (width + 8 * maxh - 1) / (8 * maxh);
    mcuy = (height + 8 * maxv - 1) / (8 * maxv);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      if (maxh % c.h || maxv % c.v) return kUnreadable;  // fractional
      c.cw = static_cast<int>((static_cast<long>(width) * c.h + maxh - 1) /
                              maxh);
      c.ch = static_cast<int>((static_cast<long>(height) * c.v + maxv - 1) /
                              maxv);
      c.bw = (c.cw + 7) / 8;
      c.bh = (c.ch + 7) / 8;
      c.bwp = mcux * c.h;
      c.bhp = mcuy * c.v;
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
    }
    frame = true;
    return kOk;
  }

  int parse_dqt(size_t at, int len) {
    size_t end = at + len;
    while (at < end) {
      const int pq = d[at] >> 4, tq = d[at] & 15;
      if (tq > 3 || pq > 1 || at + 1 + 64 * (pq + 1) > end) return kUnreadable;
      ++at;
      for (int k = 0; k < 64; ++k) {
        qt[tq][kNatural[k]] = pq ? static_cast<uint16_t>(u16(at)) : d[at];
        at += pq + 1;
      }
      qt_defined[tq] = true;
    }
    return kOk;
  }

  int parse_dht(size_t at, int len) {
    size_t end = at + len;
    while (at < end) {
      if (at + 17 > end) return kUnreadable;
      const int tc = d[at] >> 4, th = d[at] & 15;
      uint8_t bits[17] = {0};
      int count = 0;
      for (int l = 1; l <= 16; ++l) count += bits[l] = d[at + l];
      if (tc > 1 || th > 3 || count > 256 || at + 17 + count > end)
        return kUnreadable;
      if (!build_huff(tc ? &ac[th] : &dc[th], bits, d + at + 17, count,
                      tc == 0))
        return kUnreadable;
      at += 17 + count;
    }
    return kOk;
  }

  // jdhuff.c's jinit_huff_decoder, at the first scan of a sequential file:
  // tables 0 and 1 that no DHT has defined yet get the standard ones
  // (std_huff_tables leaves a defined table as it is). Motion-JPEG frames
  // leave them out. A later DHT still replaces them.
  void std_tables() {
    if (!dc[0].defined) build_huff(&dc[0], kDcLumBits, kDcVals, 12, true);
    if (!ac[0].defined) build_huff(&ac[0], kAcLumBits, kAcLumVals, 162, false);
    if (!dc[1].defined) build_huff(&dc[1], kDcChromBits, kDcVals, 12, true);
    if (!ac[1].defined)
      build_huff(&ac[1], kAcChromBits, kAcChromVals, 162, false);
  }

  // One scan: the header at `at`, the entropy-coded data after it.
  int scan(size_t at, int len) {
    if (!frame) return kUnreadable;
    const int ns = d[at];
    if (ns < 1 || ns > 4 || len != 4 + 2 * ns) return kUnreadable;
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      const int id = d[at + 1 + 2 * i];
      sc[i] = nullptr;
      for (int k = 0; k < ncomp; ++k)
        if (comp[k].id == id) sc[i] = &comp[k];
      if (!sc[i]) return kUnreadable;
      sc[i]->td = d[at + 2 + 2 * i] >> 4;
      sc[i]->ta = d[at + 2 + 2 * i] & 15;
      if (sc[i]->td > 3 || sc[i]->ta > 3) return kUnreadable;
    }
    const size_t p = at + 1 + 2 * ns;
    const int ss = d[p], se = d[p + 1], ah = d[p + 2] >> 4, al = d[p + 2] & 15;
    bool warn = false;
    if (progressive) {
      bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
      if (ah != 0 && al != ah - 1) bad = true;
      if (al > 13) bad = true;
      if (bad) return kUnreadable;  // JERR_BAD_PROGRESSION
      for (int i = 0; i < ns; ++i) {
        int* cb = sc[i]->coef_bits;
        if (ss != 0 && cb[0] < 0) warn = true;
        for (int k = ss; k <= se; ++k) {
          if (ah != (cb[k] < 0 ? 0 : cb[k])) warn = true;  // bogus progression
          cb[k] = al;
        }
      }
    } else {
      if (ss != 0 || se != 63 || ah != 0 || al != 0)
        warn = true;  // JWRN_NOT_SEQUENTIAL
      if (scans == 0) std_tables();
    }
    for (int i = 0; i < ns; ++i) {
      Component& c = *sc[i];
      const bool need_dc = ss == 0 && ah == 0;
      const bool need_ac = progressive ? ss != 0 : true;
      if ((need_dc && !dc[c.td].defined) || (need_ac && !ac[c.ta].defined))
        return kUnreadable;  // JERR_NO_HUFF_TABLE
      if (!c.latched) {  // latch_quant_tables: the table as it is now
        if (!qt_defined[c.tq]) return kUnreadable;
        for (int k = 0; k < 64; ++k)
          c.quant[k] = static_cast<int16_t>(qt[c.tq][k]);
        c.latched = true;
      }
      if (c.coef.empty())
        c.coef.assign(static_cast<size_t>(c.bwp) * c.bhp * 64, 0);
    }
    BitReader br{d, n, pos};
    int pred[4] = {0, 0, 0, 0};
    int eobrun = 0, n_rst = 0;
    const int units = ns == 1 ? sc[0]->bw * sc[0]->bh : mcux * mcuy;
    for (int u = 0; u < units; ++u) {
      if (restart_interval && u && u % restart_interval == 0) {
        if (!br.restart(n_rst++)) return kUnreadable;
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
        eobrun = 0;
      }
      for (int i = 0; i < ns; ++i) {
        Component& c = *sc[i];
        const int nh = ns == 1 ? 1 : c.h, nv = ns == 1 ? 1 : c.v;
        const int bx0 = ns == 1 ? u % c.bw : (u % mcux) * c.h;
        const int by0 = ns == 1 ? u / c.bw : (u / mcux) * c.v;
        for (int yy = 0; yy < nv; ++yy) {
          for (int xx = 0; xx < nh; ++xx) {
            int16_t* blk = c.block(bx0 + xx, by0 + yy);
            if (!progressive) {
              decode_sequential(&br, c, blk, &pred[i]);
            } else if (ss == 0) {
              if (ah == 0) {
                const int s = br.decode(dc[c.td]);
                const int diff = s ? extend(br.get(s), s) : 0;
                pred[i] += diff;
                blk[0] = static_cast<int16_t>(pred[i] * (1 << al));
              } else if (br.get(1)) {
                blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
              }
            } else if (ah == 0) {
              ac_first(&br, ac[c.ta], blk, ss, se, al, &eobrun);
            } else {
              if (!ac_refine(&br, ac[c.ta], blk, ss, se, al, &eobrun))
                warn = true;
            }
          }
        }
      }
      if (br.corrupt) return kUnreadable;
    }
    if (br.corrupt || warn || br.marker < 0) return kUnreadable;
    // on to the marker after the data (the caller reads it): a byte left
    // before it is one libjpeg would skip with a warning
    pos = br.marker == 0 ? br.pos : br.pos - 2;
    ++scans;
    return kOk;
  }

  void decode_sequential(BitReader* br, Component& c, int16_t* blk,
                         int* pred) {
    const int s = br->decode(dc[c.td]);
    const int diff = s ? extend(br->get(s), s) : 0;
    *pred += diff;
    blk[0] = static_cast<int16_t>(*pred);
    const HuffTable& t = ac[c.ta];
    for (int k = 1; k < 64; ++k) {
      int rs = br->decode(t);
      const int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        blk[kNatural[k]] = static_cast<int16_t>(extend(br->get(sz), sz));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  static void ac_first(BitReader* br, const HuffTable& t, int16_t* blk,
                       int ss, int se, int al, int* eobrun) {
    if (*eobrun > 0) {
      --*eobrun;
      return;
    }
    for (int k = ss; k <= se; ++k) {
      const int rs = br->decode(t);
      int r = rs >> 4;
      const int s = rs & 15;
      if (s) {
        k += r;
        blk[kNatural[k]] =
            static_cast<int16_t>(extend(br->get(s), s) * (1 << al));
      } else if (r == 15) {
        k += 15;
      } else {
        *eobrun = 1 << r;
        if (r) *eobrun += br->get(r);
        --*eobrun;
        break;
      }
    }
  }

  // jdphuff.c's decode_mcu_AC_refine; false where it warns (a new
  // coefficient's size other than 1)
  static bool ac_refine(BitReader* br, const HuffTable& t, int16_t* blk,
                        int ss, int se, int al, int* eobrun) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    bool ok = true;
    int k = ss;
    auto correct = [&](int16_t* coef) {
      if (br->get(1) && (*coef & p1) == 0)
        *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
    };
    if (*eobrun == 0) {
      for (; k <= se; ++k) {
        const int rs = br->decode(t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) ok = false;
          s = br->get(1) ? p1 : m1;
        } else if (r != 15) {
          *eobrun = 1 << r;
          if (r) *eobrun += br->get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural[k]] = static_cast<int16_t>(s);
      }
    }
    if (*eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) correct(coef);
      }
      --*eobrun;
    }
    return ok;
  }

  int run() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return kUnreadable;
    pos = 2;
    while (!eoi) {
      const int m = next_marker();
      if (m < 0) return kUnreadable;
      if (m == 0xD9) {
        eoi = true;
        break;
      }
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;  // no parameters
      if (m == 0xD8 || pos + 2 > n) return kUnreadable;
      const int len = u16(pos);
      if (len < 2 || pos + len > n) return kUnreadable;
      const size_t at = pos + 2;
      pos += len;
      int rc = kOk;
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        rc = parse_sof(m, at, len - 2);
      } else if (m == 0xC4) {
        rc = parse_dht(at, len - 2);
      } else if (m == 0xDB) {
        rc = parse_dqt(at, len - 2);
      } else if (m == 0xDD) {
        if (len != 4) return kUnreadable;
        restart_interval = u16(at);
      } else if (m == 0xDA) {
        rc = scan(at, len - 2);
      } else if (m == 0xE0) {
        if (len >= 16 && std::memcmp(d + at, "JFIF\0", 5) == 0)
          saw_jfif = true;
      } else if (m == 0xEE) {
        if (len >= 14 && std::memcmp(d + at, "Adobe", 5) == 0) {
          saw_adobe = true;
          adobe_transform = d[at + 11];
        }
      } else if (m == 0xDC || m == 0xC8 || m == 0xCC) {
        return m == 0xCC ? kArithmetic : kUnreadable;  // DNL, JPG, DAC
      }
      if (rc != kOk) return rc;
    }
    return frame && scans ? kOk : kUnreadable;
  }

  // The header up to the frame: the size, or why the file is not read.
  int info() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) return kUnreadable;
    pos = 2;
    for (;;) {
      const int m = next_marker();
      if (m < 0 || m == 0xD9 || m == 0xDA || m == 0xD8) return kUnreadable;
      if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (pos + 2 > n) return kUnreadable;
      const int len = u16(pos);
      if (len < 2 || pos + len > n) return kUnreadable;
      const size_t at = pos + 2;
      pos += len;
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC)
        return parse_sof(m, at, len - 2);
      if (m == 0xCC) return kArithmetic;
    }
  }

  bool rgb() const {
    if (saw_jfif) return false;
    if (saw_adobe) return adobe_transform == 0;
    return comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
  }

  // libjpeg smooths the blocks of a progressive file whose scans left any
  // of the first nine AC coefficients short of their last bit (smoothing_ok
  // in jdcoefct.c)
  bool needs_smoothing() const {
    if (!progressive) return false;
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (int i = 0; i < ncomp; ++i) {
      const Component& c = comp[i];
      if (!c.latched) return false;
      for (int k = 0; k < 10; ++k)
        if (c.quant[kPos[k]] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (c.coef_bits[k] != 0) useful = true;
    }
    return useful;
  }
};

// jidctint.c's jpeg_idct_islow, with the range limit of its
// sample_range_limit table (a 10-bit wrap, then a clamp to 0..255).
constexpr int kConstBits = 13, kPass1Bits = 2;
constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                  F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                  F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

inline uint8_t range_limit(int64_t x) {
  int v = static_cast<int>(x) & 1023;
  if (v >= 512) v -= 1024;
  v += 128;
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// The 8-point inverse butterfly of both passes: in[0..7] -> out[0..7]
// before the descale, with in[0] and in[4] pre-shifted by the caller.
inline void idct_1d(int64_t i0, int64_t i1, int64_t i2, int64_t i3,
                    int64_t i4, int64_t i5, int64_t i6, int64_t i7,
                    int64_t out[8]) {
  int64_t z1 = (i2 + i6) * F0541;
  const int64_t tmp2 = z1 + i6 * -F1847;
  const int64_t tmp3 = z1 + i2 * F0765;
  const int64_t tmp0 = (i0 + i4) * (int64_t(1) << kConstBits);
  const int64_t tmp1 = (i0 - i4) * (int64_t(1) << kConstBits);
  const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
  const int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
  int64_t o0 = i7, o1 = i5, o2 = i3, o3 = i1;
  z1 = o0 + o3;
  int64_t z2 = o1 + o2, z3 = o0 + o2, z4 = o1 + o3;
  const int64_t z5 = (z3 + z4) * F1175;
  o0 *= F0298;
  o1 *= F2053;
  o2 *= F3072;
  o3 *= F1501;
  z1 *= -F0899;
  z2 *= -F2562;
  z3 *= -F1961;
  z4 *= -F0390;
  z3 += z5;
  z4 += z5;
  o0 += z1 + z3;
  o1 += z2 + z4;
  o2 += z2 + z3;
  o3 += z1 + z4;
  out[0] = t10 + o3;
  out[7] = t10 - o3;
  out[1] = t11 + o2;
  out[6] = t11 - o2;
  out[2] = t12 + o1;
  out[5] = t12 - o1;
  out[3] = t13 + o0;
  out[4] = t13 - o0;
}

void idct_islow(const int16_t* coef, const int16_t* q, uint8_t* out,
                size_t stride) {
  int ws[64];
  int64_t o[8];
  for (int c = 0; c < 8; ++c) {  // pass 1: columns
    int64_t in[8];
    for (int r = 0; r < 8; ++r)
      in[r] = static_cast<int64_t>(coef[8 * r + c]) * q[8 * r + c];
    idct_1d(in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7], o);
    for (int r = 0; r < 8; ++r)
      ws[8 * r + c] = static_cast<int>(descale(o[r], kConstBits - kPass1Bits));
  }
  for (int r = 0; r < 8; ++r) {  // pass 2: rows
    const int* w = ws + 8 * r;
    idct_1d(w[0], w[1], w[2], w[3], w[4], w[5], w[6], w[7], o);
    uint8_t* dst = out + r * stride;
    for (int c = 0; c < 8; ++c)
      dst[c] = range_limit(descale(o[c], kConstBits + kPass1Bits + 3));
  }
}

// ---------------------------------------------------------------- encode

constexpr uint8_t kStdLumQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
constexpr uint8_t kStdChromQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

struct EncHuff {  // jchuff.c's c_derived_tbl
  uint32_t code[256];
  uint8_t size[256];
};

EncHuff make_enc(const uint8_t bits[17], const uint8_t* vals) {
  EncHuff t;
  std::memset(t.size, 0, sizeof(t.size));
  int p = 0, code = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < bits[l]; ++i, ++p) {
      t.code[vals[p]] = code++;
      t.size[vals[p]] = static_cast<uint8_t>(l);
    }
    code <<= 1;
  }
  return t;
}

// jcdctmgr.c's compute_reciprocal for a divisor (quantval << 3): the
// reciprocal, the correction and the shift of its quantiser
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {
  int b = 0;
  while ((divisor >> (b + 1)) != 0) ++b;  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = static_cast<uint32_t>((uint64_t(1) << r) / divisor);
  const uint32_t fr = static_cast<uint32_t>((uint64_t(1) << r) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2U) {
    ++c;
  } else {
    ++fq;
  }
  return {fq, c, r - 16};
}

// jfdctint.c's jpeg_fdct_islow in place over 64 samples (centred)
void fdct_islow(int32_t* data) {
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8;  // along a row, then a column
    for (int i = 0; i < 8; ++i) {
      int32_t* p = data + (pass == 0 ? 8 * i : i);
      const int64_t t0 = p[0] + p[7 * step], t7 = p[0] - p[7 * step];
      const int64_t t1 = p[step] + p[6 * step], t6 = p[step] - p[6 * step];
      const int64_t t2 = p[2 * step] + p[5 * step],
                    t5 = p[2 * step] - p[5 * step];
      const int64_t t3 = p[3 * step] + p[4 * step],
                    t4 = p[3 * step] - p[4 * step];
      const int64_t t10 = t0 + t3, t13 = t0 - t3;
      const int64_t t11 = t1 + t2, t12 = t1 - t2;
      const int odd = pass == 0 ? kConstBits - kPass1Bits
                                : kConstBits + kPass1Bits;
      if (pass == 0) {
        p[0] = static_cast<int32_t>((t10 + t11) * (1 << kPass1Bits));
        p[4 * step] = static_cast<int32_t>((t10 - t11) * (1 << kPass1Bits));
      } else {
        p[0] = static_cast<int32_t>(descale(t10 + t11, kPass1Bits));
        p[4 * step] = static_cast<int32_t>(descale(t10 - t11, kPass1Bits));
      }
      const int64_t z1e = (t12 + t13) * F0541;
      p[2 * step] = static_cast<int32_t>(descale(z1e + t13 * F0765, odd));
      p[6 * step] = static_cast<int32_t>(descale(z1e + t12 * -F1847, odd));
      int64_t z1 = t4 + t7, z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
      const int64_t z5 = (z3 + z4) * F1175;
      const int64_t a4 = t4 * F0298, a5 = t5 * F2053, a6 = t6 * F3072,
                    a7 = t7 * F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      p[7 * step] = static_cast<int32_t>(descale(a4 + z1 + z3, odd));
      p[5 * step] = static_cast<int32_t>(descale(a5 + z2 + z4, odd));
      p[3 * step] = static_cast<int32_t>(descale(a6 + z2 + z3, odd));
      p[step] = static_cast<int32_t>(descale(a7 + z1 + z4, odd));
    }
  }
}

struct BitWriter {  // big-endian bits with 0xFF 0x00 stuffing
  std::vector<uint8_t>* out;
  uint64_t acc = 0;
  int n = 0;  // bits in acc not yet written, < 32 between calls
  // size <= 32; the caller's bits above `size` are zero
  void put(uint32_t bits, int size) {
    acc = (acc << size) | bits;
    n += size;
    if (n >= 32) {
      n -= 32;
      const uint32_t word = static_cast<uint32_t>(acc >> n);
      const uint32_t inv = ~word;  // a 0xFF byte is a zero byte of inv
      if (((inv - 0x01010101u) & ~inv & 0x80808080u) == 0) {
        const uint8_t b[4] = {static_cast<uint8_t>(word >> 24),
                              static_cast<uint8_t>(word >> 16),
                              static_cast<uint8_t>(word >> 8),
                              static_cast<uint8_t>(word)};
        out->insert(out->end(), b, b + 4);
      } else {
        for (int i = 24; i >= 0; i -= 8) emit(static_cast<uint8_t>(word >> i));
      }
    }
  }
  void flush() {  // the whole bytes left, then the last padded with 1-bits
    while (n >= 8) {
      n -= 8;
      emit(static_cast<uint8_t>(acc >> n));
    }
    if (n) {
      const int pad = 8 - n;
      acc = (acc << pad) | ((1u << pad) - 1);
      n = 0;
      emit(static_cast<uint8_t>(acc));
    }
  }
  void emit(uint8_t b) {
    out->push_back(b);
    if (b == 0xFF) out->push_back(0);
  }
};

struct Encoder {
  int w, h, quality;
  bool gray;
  uint8_t qtab[2][64];
  Divisor div[2][64];
  EncHuff dc[2], ac[2];
  std::vector<uint8_t> out;

  void setup() {
    const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    for (int t = 0; t < 2; ++t) {
      const uint8_t* base = t ? kStdChromQ : kStdLumQ;
      for (int k = 0; k < 64; ++k) {
        long v = (static_cast<long>(base[k]) * scale + 50L) / 100L;
        v = v <= 0 ? 1 : (v > 255 ? 255 : v);
        qtab[t][k] = static_cast<uint8_t>(v);
        div[t][k] = reciprocal(static_cast<uint32_t>(v) << 3);
      }
    }
    dc[0] = make_enc(kDcLumBits, kDcVals);
    ac[0] = make_enc(kAcLumBits, kAcLumVals);
    dc[1] = make_enc(kDcChromBits, kDcVals);
    ac[1] = make_enc(kAcChromBits, kAcChromVals);
  }

  void marker(int m) {
    out.push_back(0xFF);
    out.push_back(static_cast<uint8_t>(m));
  }
  void u16(int v) {
    out.push_back(static_cast<uint8_t>(v >> 8));
    out.push_back(static_cast<uint8_t>(v & 0xFF));
  }
  void dht(int index, const uint8_t bits[17], const uint8_t* vals) {
    int count = 0;
    for (int l = 1; l <= 16; ++l) count += bits[l];
    marker(0xC4);
    u16(2 + 1 + 16 + count);
    out.push_back(static_cast<uint8_t>(index));
    for (int l = 1; l <= 16; ++l) out.push_back(bits[l]);
    out.insert(out.end(), vals, vals + count);
  }

  void headers() {
    const int nc = gray ? 1 : 3;
    marker(0xD8);
    marker(0xE0);  // JFIF 1.01, no density unit, 1:1, no thumbnail
    u16(16);
    const uint8_t jfif[14] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
    out.insert(out.end(), jfif, jfif + 14);
    for (int t = 0; t < (gray ? 1 : 2); ++t) {
      marker(0xDB);
      u16(67);
      out.push_back(static_cast<uint8_t>(t));
      for (int k = 0; k < 64; ++k) out.push_back(qtab[t][kNatural[k]]);
    }
    marker(0xC0);
    u16(8 + 3 * nc);
    out.push_back(8);
    u16(h);
    u16(w);
    out.push_back(static_cast<uint8_t>(nc));
    for (int c = 0; c < nc; ++c) {
      out.push_back(static_cast<uint8_t>(c + 1));
      out.push_back(c == 0 && !gray ? 0x22 : 0x11);
      out.push_back(c == 0 ? 0 : 1);
    }
    dht(0x00, kDcLumBits, kDcVals);
    dht(0x10, kAcLumBits, kAcLumVals);
    if (!gray) {
      dht(0x01, kDcChromBits, kDcVals);
      dht(0x11, kAcChromBits, kAcChromVals);
    }
    marker(0xDA);
    u16(6 + 2 * nc);
    out.push_back(static_cast<uint8_t>(nc));
    for (int c = 0; c < nc; ++c) {
      out.push_back(static_cast<uint8_t>(c + 1));
      out.push_back(c == 0 ? 0x00 : 0x11);
    }
    out.push_back(0);
    out.push_back(63);
    out.push_back(0);
  }

  // FDCT and quantise the 8x8 block at (bx, by) of a plane.
  void block(const std::vector<uint8_t>& plane, int stride, int bx, int by,
             int t, int16_t* q) {
    int32_t data[64];
    for (int r = 0; r < 8; ++r) {
      const uint8_t* src = plane.data() + static_cast<size_t>(by * 8 + r) *
                                              stride + bx * 8;
      for (int c = 0; c < 8; ++c) data[8 * r + c] = src[c] - 128;
    }
    fdct_islow(data);
    for (int k = 0; k < 64; ++k) {  // jcdctmgr.c's quantize
      const Divisor& dv = div[t][k];
      int32_t v = data[k];
      const bool neg = v < 0;
      if (neg) v = -v;
      const uint32_t prod = (static_cast<uint32_t>(v) + dv.corr) * dv.recip;
      int32_t qv = static_cast<int32_t>(prod >> (dv.shift + 16));
      q[k] = static_cast<int16_t>(neg ? -qv : qv);
    }
  }

  static void encode_block(BitWriter* bw, const int16_t* q, int* last_dc,
                           const EncHuff& dct, const EncHuff& act) {
    int temp = q[0] - *last_dc, temp2 = temp;
    *last_dc = q[0];
    if (temp < 0) {
      temp = -temp;
      --temp2;
    }
    int nbits = temp ? 32 - __builtin_clz(static_cast<unsigned>(temp)) : 0;
    // the code and its appended bits in one put (at most 16 + 11 bits)
    bw->put((dct.code[nbits] << nbits) |
                (static_cast<uint32_t>(temp2) & ((1u << nbits) - 1)),
            dct.size[nbits] + nbits);
    int r = 0;
    for (int k = 1; k < 64; ++k) {
      temp = q[kNatural[k]];
      if (temp == 0) {
        ++r;
        continue;
      }
      while (r > 15) {
        bw->put(act.code[0xF0], act.size[0xF0]);
        r -= 16;
      }
      temp2 = temp;
      if (temp < 0) {
        temp = -temp;
        --temp2;
      }
      nbits = 32 - __builtin_clz(static_cast<unsigned>(temp));
      const int i = (r << 4) + nbits;
      bw->put((act.code[i] << nbits) |
                  (static_cast<uint32_t>(temp2) & ((1u << nbits) - 1)),
              act.size[i] + nbits);
      r = 0;
    }
    if (r > 0) bw->put(act.code[0], act.size[0]);
  }

  void run(const uint8_t* img) {
    setup();
    headers();
    const int wb = (w + 7) / 8, hb = (h + 7) / 8;
    // Y at full size, the right and bottom edges replicated to whole blocks
    std::vector<uint8_t> yp(static_cast<size_t>(wb) * 8 * hb * 8);
    const int ys = wb * 8;
    const int cwb = (w + 15) / 16, chb = (h + 15) / 16, cs = cwb * 8;
    std::vector<uint8_t> cbp, crp;
    std::vector<uint8_t> cbf, crf;  // full-size chroma of the image
    if (!gray) {
      cbf.resize(static_cast<size_t>(w) * h);
      crf.resize(static_cast<size_t>(w) * h);
    }
    std::vector<uint8_t> yf(static_cast<size_t>(w) * h);
    for (int r = 0; r < h; ++r) {
      for (int c = 0; c < w; ++c) {
        const size_t i = static_cast<size_t>(r) * w + c;
        if (gray) {
          yf[i] = img[i];
          continue;
        }
        const int b = img[3 * i], g = img[3 * i + 1], rr = img[3 * i + 2];
        yf[i] = static_cast<uint8_t>((19595 * rr + 38470 * g + 7471 * b +
                                      32768) >> 16);
        cbf[i] = static_cast<uint8_t>((-11059 * rr - 21709 * g + 32768 * b +
                                       (128 << 16) + 32767) >> 16);
        crf[i] = static_cast<uint8_t>((32768 * rr - 27439 * g - 5329 * b +
                                       (128 << 16) + 32767) >> 16);
      }
    }
    for (int r = 0; r < hb * 8; ++r) {
      const int sr = r < h ? r : h - 1;
      for (int c = 0; c < ys; ++c)
        yp[static_cast<size_t>(r) * ys + c] =
            yf[static_cast<size_t>(sr) * w + (c < w ? c : w - 1)];
    }
    if (!gray) {  // h2v2_downsample over edge-replicated rows and columns
      const int rows = (h + 1) / 2;
      cbp.resize(static_cast<size_t>(cs) * chb * 8);
      crp.resize(cbp.size());
      for (int r = 0; r < chb * 8; ++r) {
        const int orow = r < rows ? r : rows - 1;
        const int r0 = 2 * orow, r1 = 2 * orow + 1 < h ? 2 * orow + 1 : h - 1;
        int bias = 1;
        for (int c = 0; c < cs; ++c) {
          const int c0 = 2 * c < w ? 2 * c : w - 1;
          const int c1 = 2 * c + 1 < w ? 2 * c + 1 : w - 1;
          const size_t a = static_cast<size_t>(r0) * w, b = static_cast<size_t>(r1) * w;
          cbp[static_cast<size_t>(r) * cs + c] = static_cast<uint8_t>(
              (cbf[a + c0] + cbf[a + c1] + cbf[b + c0] + cbf[b + c1] + bias) >>
              2);
          crp[static_cast<size_t>(r) * cs + c] = static_cast<uint8_t>(
              (crf[a + c0] + crf[a + c1] + crf[b + c0] + crf[b + c1] + bias) >>
              2);
          bias ^= 3;
        }
      }
    }
    BitWriter bw{&out};
    int last[3] = {0, 0, 0};
    int16_t q[4][64];
    if (gray) {
      for (int by = 0; by < hb; ++by)
        for (int bx = 0; bx < wb; ++bx) {
          block(yp, ys, bx, by, 0, q[0]);
          encode_block(&bw, q[0], &last[0], dc[0], ac[0]);
        }
    } else {
      for (int my = 0; my < chb; ++my) {
        for (int mx = 0; mx < cwb; ++mx) {
          // the four Y blocks; those past the image are jccoefct.c's dummy
          // blocks: no AC, the DC of the block before them
          for (int yy = 0; yy < 2; ++yy) {
            for (int xx = 0; xx < 2; ++xx) {
              const int bx = 2 * mx + xx, by = 2 * my + yy;
              int16_t* b = q[2 * yy + xx];
              if (by >= hb) {  // a bottom row: the DC of the row above's last
                std::memset(b, 0, 64 * sizeof(int16_t));
                b[0] = q[1][0];
              } else if (bx >= wb) {
                std::memset(b, 0, 64 * sizeof(int16_t));
                b[0] = q[2 * yy][0];
              } else {
                block(yp, ys, bx, by, 0, b);
              }
            }
          }
          for (int k = 0; k < 4; ++k)
            encode_block(&bw, q[k], &last[0], dc[0], ac[0]);
          block(cbp, cs, mx, my, 1, q[0]);
          encode_block(&bw, q[0], &last[1], dc[1], ac[1]);
          block(crp, cs, mx, my, 1, q[0]);
          encode_block(&bw, q[0], &last[2], dc[1], ac[1]);
        }
      }
    }
    bw.flush();
    marker(0xD9);
  }
};

}  // namespace

extern "C" {

// The header up to the frame: 0 and the size, or a return code above.
int fdr_jpeg_info(const uint8_t* data, size_t len, int* w, int* h) {
  Decoder dec;
  dec.d = data;
  dec.n = len;
  const int rc = dec.info();
  *w = dec.width;
  *h = dec.height;
  return rc;
}

// Decode into a caller-allocated BGR u8 HWC buffer of w*h*3 bytes (w, h
// from fdr_jpeg_info). A grayscale file comes back as three equal
// channels. Returns 0 or a return code above.
int fdr_jpeg_decode_bgr(const uint8_t* data, size_t len, uint8_t* out, int w,
                        int h) {
  Decoder dec;
  dec.d = data;
  dec.n = len;
  int rc = dec.run();
  if (rc != kOk) return rc;
  if (dec.width != w || dec.height != h) return kUnreadable;
  if (dec.needs_smoothing()) return kSmoothing;
  std::vector<uint8_t> planes[3];
  fdr_ycc::Plane p[3];
  for (int i = 0; i < dec.ncomp; ++i) {
    Component& c = dec.comp[i];
    const size_t stride = static_cast<size_t>(c.bw) * 8;
    planes[i].assign(stride * c.bh * 8, 0);
    if (!c.coef.empty()) {
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          idct_islow(c.block(bx, by), c.quant,
                     planes[i].data() + by * 8 * stride + bx * 8, stride);
    } else {
      std::memset(planes[i].data(), 128, planes[i].size());
    }
    p[i] = {planes[i].data(), stride, c.cw, c.ch, dec.maxh / c.h,
            dec.maxv / c.v};
  }
  if (dec.ncomp == 1) {
    for (int r = 0; r < h; ++r) {
      const uint8_t* src = planes[0].data() + r * p[0].stride;
      uint8_t* dst = out + static_cast<size_t>(r) * w * 3;
      for (int x = 0; x < w; ++x) dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = src[x];
    }
    return kOk;
  }
  fdr_ycc::planes_to_bgr(p, w, h, dec.rgb(), out);
  return kOk;
}

// Encode a u8 HWC image of w*h*channels bytes (channels 3: BGR, 1: gray)
// at `quality` (1-100) as cv2.imencode(".jpg") writes it. On success *out
// points to *out_len bytes that the caller releases with fdr_jpeg_free.
// Returns 0, or -1 for arguments out of range.
int fdr_jpeg_encode(const uint8_t* img, int w, int h, int channels,
                    int quality, uint8_t** out, size_t* out_len) {
  *out = nullptr;
  *out_len = 0;
  if (w < 1 || h < 1 || w > 65535 || h > 65535 || quality < 1 ||
      quality > 100 || (channels != 1 && channels != 3))
    return -1;
  Encoder enc;
  enc.w = w;
  enc.h = h;
  enc.quality = quality;
  enc.gray = channels == 1;
  enc.run(img);
  *out = static_cast<uint8_t*>(std::malloc(enc.out.size()));
  if (!*out) return -1;
  std::memcpy(*out, enc.out.data(), enc.out.size());
  *out_len = enc.out.size();
  return 0;
}

void fdr_jpeg_free(uint8_t* p) { std::free(p); }

}  // extern "C"
