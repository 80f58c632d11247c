// A self-contained baseline JPEG decoder for the host data pipeline.
//
// It reads baseline Huffman JPEGs (SOF0, and SOF1 at 8 bits) with one or
// three components, any integer chroma sampling (4:4:4, 4:2:2, 4:2:0,
// 4:4:0, ...), interleaved or per-component scans and restart markers, and
// writes 8-bit RGB. The arithmetic is libjpeg-turbo's with its default
// decompression settings, so the output is that library's byte for byte:
//   * the integer inverse DCT of jidctint.c (JDCT_ISLOW: CONST_BITS 13,
//     PASS1_BITS 2, the post-IDCT range-limit table of jdmaster.c);
//   * "fancy" triangular upsampling (jdsample.c: h2v1, h1v2, h2v2 with
//     their rounding biases; plain replication when the downsampled width
//     is 2 or less, or for other integer ratios);
//   * the fixed-point YCbCr -> RGB tables of jdcolor.c (SCALEBITS 16).
// Progressive, lossless, hierarchical and arithmetic-coded files, 12-bit
// samples and four-component (CMYK / YCCK) files are refused with
// kUnsupported and a message naming the frame type.
//
// C ABI for ctypes (every call returns 0 or a negative error code, with a
// message in `err` when one is given):
//   yt_jpeg_info(path, &h, &w, &components, &orientation, err, n)
//   yt_jpeg_decode(path, out_u8, h, w, err, n)          out is h*w*3 bytes
//   yt_jpeg_decode_batch(paths, n, out_f32, h, w, n_threads, status, err, n)
//       decodes n same-sized files on std::threads into one (n, h, w, 3)
//       float32 buffer, each sample as u8 / 255.0f.
// `orientation` is the EXIF orientation tag (1-8; 1 when absent).
//
// Build: g++ -O3 -shared -fPIC -std=c++17 jpeg.cpp -lpthread (no libjpeg).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kOk = 0;
constexpr int kErrOpen = -1;
constexpr int kErrFormat = -2;
constexpr int kErrDecode = -3;
constexpr int kErrDims = -4;
constexpr int kUnsupported = -5;

struct JpegError {
  int code;
  std::string msg;
};

[[noreturn]] void fail(int code, const std::string& msg) { throw JpegError{code, msg}; }

// Zigzag position -> natural (row-major) position, padded like
// jpeg_natural_order so that a corrupt run length cannot index past 63.
const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ------------------------------------------------------------- Huffman ----

struct HuffTable {
  bool defined = false;
  // A table that libjpeg-turbo's jpeg_make_d_derived_tbl refuses: code
  // lengths that over-subscribe the code space (an all-ones code included)
  // or a DC symbol above 15. Like libjpeg, a scan that uses it fails; a
  // table no scan uses is never looked at.
  bool bad = false;
  // F.2.2.3: per code length l, the largest code (-1: none) and the offset
  // of its values; a 9-bit lookup answers the short codes at once.
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint8_t look_len[1 << 9];  // 0: longer than 9 bits
  uint8_t look_val[1 << 9];

  void build(const uint8_t* counts, const uint8_t* values, int nvals, bool dc) {
    defined = true;
    bad = false;
    memcpy(vals, values, nvals);
    memset(look_len, 0, sizeof(look_len));
    if (dc)
      for (int i = 0; i < nvals; ++i)
        if (vals[i] > 15) bad = true;
    int code = 0, p = 0;
    for (int l = 1; l <= 16 && !bad; ++l) {
      int n = counts[l - 1];
      if (n) {
        valoffset[l] = p - code;
        for (int i = 0; i < n; ++i, ++p, ++code) {
          // Checked before the code enters the lookup, so that a bad
          // table never writes past it.
          if (code >= (1 << l) - 1) {
            bad = true;
            break;
          }
          if (l <= 9) {
            int shift = 9 - l;
            for (int j = 0; j < (1 << shift); ++j) {
              look_len[(code << shift) | j] = static_cast<uint8_t>(l);
              look_val[(code << shift) | j] = vals[p];
            }
          }
        }
        maxcode[l] = code - 1;
      } else {
        maxcode[l] = -1;
      }
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;  // sentinel: a 17-bit "code" ends the search
    valoffset[17] = 0;
  }
};

// The entropy-coded segment's bit reader. Like libjpeg it stops at a
// marker and then feeds zero bits; 0xFF00 is a stuffed 0xFF.
struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t pos;
  uint64_t acc = 0;
  int nbits = 0;
  bool at_marker = false;

  void fill() {
    while (nbits <= 56) {
      uint8_t byte = 0;
      if (!at_marker && pos < size) {
        byte = data[pos];
        if (byte == 0xFF) {
          size_t q = pos + 1;
          while (q < size && data[q] == 0xFF) ++q;  // fill bytes
          if (q < size && data[q] == 0x00) {
            pos = q + 1;
          } else {
            at_marker = true;  // leave pos on the marker's first 0xFF
            byte = 0;
          }
        } else {
          ++pos;
        }
      }
      acc |= static_cast<uint64_t>(byte) << (56 - nbits);
      nbits += 8;
    }
  }
  inline int peek(int n) {
    if (nbits < n) fill();
    return static_cast<int>(acc >> (64 - n));
  }
  inline void skip(int n) {
    acc <<= n;
    nbits -= n;
  }
  inline int get(int n) {
    if (n == 0) return 0;
    int v = peek(n);
    skip(n);
    return v;
  }
  int decode(const HuffTable& t) {
    int look = peek(9);
    int l = t.look_len[look];
    if (l) {
      skip(l);
      return t.look_val[look];
    }
    if (nbits < 16) fill();
    l = 10;
    int code = static_cast<int>(acc >> (64 - l));
    while (code > t.maxcode[l]) {
      ++l;
      code = static_cast<int>(acc >> (64 - l));
    }
    skip(l);
    if (l > 16) return 0;  // corrupt data: libjpeg warns and takes 0
    return t.vals[(t.valoffset[l] + code) & 0xFF];
  }
  // Byte-align at a restart interval's end and consume its RSTn marker.
  void restart() {
    acc = 0;
    nbits = 0;
    at_marker = false;
    while (pos + 1 < size && !(data[pos] == 0xFF && data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7)) {
      if (data[pos] == 0xFF && data[pos + 1] != 0x00 && data[pos + 1] != 0xFF) break;  // another marker
      ++pos;
    }
    if (pos + 1 < size && data[pos] == 0xFF && data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7) pos += 2;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// ------------------------------------------------------ inverse DCT -------

// jdmaster.c prepare_range_limit_table, seen from IDCT_range_limit: index
// (x & 1023) of a descaled output x, which is centred on 0.
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i) {
      if (i < 128) t[i] = static_cast<uint8_t>(128 + i);
      else if (i < 512) t[i] = 255;
      else if (i < 896) t[i] = 0;
      else t[i] = static_cast<uint8_t>(i - 896);
    }
  }
};
const RangeLimit kRange;

constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// jidctint.c jpeg_idct_islow: coef in natural order, quant the table in
// natural order; writes 8 rows of 8 samples at out (row pitch `stride`).
void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out, size_t stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* q = quant + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      int dc = (int(in[0]) * int(q[0])) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(in[16]) * q[16], z3 = int64_t(in[48]) * q[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(in[0]) * q[0];
    z3 = int64_t(in[32]) * q[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = int64_t(in[56]) * q[56];
    tmp1 = int64_t(in[40]) * q[40];
    tmp2 = int64_t(in[24]) * q[24];
    tmp3 = int64_t(in[8]) * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int n = CONST_BITS - PASS1_BITS;
    w[0] = int(descale(tmp10 + tmp3, n));
    w[56] = int(descale(tmp10 - tmp3, n));
    w[8] = int(descale(tmp11 + tmp2, n));
    w[48] = int(descale(tmp11 - tmp2, n));
    w[16] = int(descale(tmp12 + tmp1, n));
    w[40] = int(descale(tmp12 - tmp1, n));
    w[24] = int(descale(tmp13 + tmp0, n));
    w[32] = int(descale(tmp13 - tmp0, n));
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = kRange.t[int(descale(w[0], PASS1_BITS + 3)) & 1023];
      for (int i = 0; i < 8; ++i) o[i] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << CONST_BITS);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    constexpr int n = CONST_BITS + PASS1_BITS + 3;
    o[0] = kRange.t[int(descale(tmp10 + tmp3, n)) & 1023];
    o[7] = kRange.t[int(descale(tmp10 - tmp3, n)) & 1023];
    o[1] = kRange.t[int(descale(tmp11 + tmp2, n)) & 1023];
    o[6] = kRange.t[int(descale(tmp11 - tmp2, n)) & 1023];
    o[2] = kRange.t[int(descale(tmp12 + tmp1, n)) & 1023];
    o[5] = kRange.t[int(descale(tmp12 - tmp1, n)) & 1023];
    o[3] = kRange.t[int(descale(tmp13 + tmp0, n)) & 1023];
    o[4] = kRange.t[int(descale(tmp13 - tmp0, n)) & 1023];
  }
}

// ------------------------------------------------------ colour tables -----

// jdcolor.c build_ycc_rgb_table (SCALEBITS 16).
struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    constexpr int SCALEBITS = 16;
    constexpr int32_t ONE_HALF = int32_t(1) << (SCALEBITS - 1);
    auto fix = [](double x) { return int32_t(x * (1 << SCALEBITS) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int32_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = int((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }

// --------------------------------------------------------------- frame ----

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;         // blocks per line / column, padded to whole MCUs
  int dw = 0, dh = 0;         // downsampled width / height (jdinput.c)
  std::vector<uint8_t> plane; // bw*8 x bh*8 samples
  int dc_pred = 0;
};

struct Frame {
  int sof = -1, precision = 8, width = 0, height = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  uint16_t quant[4][64];
  bool quant_defined[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int orientation = 1;
};

const char* sof_name(int m) {
  switch (m) {
    case 0xC0: return "SOF0 (baseline)";
    case 0xC1: return "SOF1 (extended sequential)";
    case 0xC2: return "SOF2 (progressive)";
    case 0xC3: return "SOF3 (lossless)";
    case 0xC5: return "SOF5 (differential sequential)";
    case 0xC6: return "SOF6 (differential progressive)";
    case 0xC7: return "SOF7 (differential lossless)";
    case 0xC9: return "SOF9 (arithmetic sequential)";
    case 0xCA: return "SOF10 (arithmetic progressive)";
    case 0xCB: return "SOF11 (arithmetic lossless)";
    case 0xCD: return "SOF13 (arithmetic differential sequential)";
    case 0xCE: return "SOF14 (arithmetic differential progressive)";
    case 0xCF: return "SOF15 (arithmetic differential lossless)";
  }
  return "unknown SOF";
}

inline int be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// EXIF orientation (tag 0x0112 of IFD0) from an APP1 body.
int exif_orientation(const uint8_t* p, size_t n) {
  if (n < 14 || memcmp(p, "Exif\0\0", 6) != 0) return 1;
  const uint8_t* t = p + 6;
  size_t tn = n - 6;
  bool le;
  if (t[0] == 'I' && t[1] == 'I') le = true;
  else if (t[0] == 'M' && t[1] == 'M') le = false;
  else return 1;
  auto u16 = [&](size_t o) -> uint32_t { return le ? (t[o] | (t[o + 1] << 8)) : ((t[o] << 8) | t[o + 1]); };
  auto u32 = [&](size_t o) -> uint32_t {
    return le ? (t[o] | (t[o + 1] << 8) | (t[o + 2] << 16) | (uint32_t(t[o + 3]) << 24))
              : ((uint32_t(t[o]) << 24) | (t[o + 1] << 16) | (t[o + 2] << 8) | t[o + 3]);
  };
  uint32_t ifd = u32(4);
  if (ifd + 2 > tn) return 1;
  uint32_t count = u16(ifd);
  for (uint32_t i = 0; i < count; ++i) {
    size_t e = ifd + 2 + 12 * size_t(i);
    if (e + 12 > tn) break;
    if (u16(e) == 0x0112) {
      uint32_t v = u16(e + 8);
      return (v >= 1 && v <= 8) ? int(v) : 1;
    }
  }
  return 1;
}

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) : data_(data), size_(size) {}

  // Reads the markers up to the first SOS (header_only) or the whole file.
  void run(bool header_only) {
    if (size_ < 4 || data_[0] != 0xFF || data_[1] != 0xD8) fail(kErrFormat, "not a JPEG file (no SOI)");
    pos_ = 2;
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;  // EOI
      if (m < 0) {
        if (scanned_) break;
        fail(kErrDecode, "unexpected end of file before a scan");
      }
      if (m >= 0xD0 && m <= 0xD7) continue;  // stray RSTn
      if (m == 0x01) continue;              // TEM
      if (pos_ + 2 > size_) fail(kErrDecode, "truncated marker segment");
      int len = be16(data_ + pos_);
      if (len < 2 || pos_ + len > size_) fail(kErrDecode, "truncated marker segment");
      const uint8_t* body = data_ + pos_ + 2;
      size_t blen = size_t(len) - 2;
      size_t next = pos_ + len;
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
        read_sof(m, body, blen);
      } else if (m == 0xC4) {
        read_dht(body, blen);
      } else if (m == 0xCC) {
        fail(kUnsupported, "arithmetic coding (DAC)");
      } else if (m == 0xDB) {
        read_dqt(body, blen);
      } else if (m == 0xDD) {
        if (blen < 2) fail(kErrDecode, "bad DRI");
        f_.restart_interval = be16(body);
      } else if (m == 0xE0) {
        if (blen >= 5 && memcmp(body, "JFIF\0", 5) == 0) f_.jfif = true;
      } else if (m == 0xE1) {
        if (f_.orientation == 1) f_.orientation = exif_orientation(body, blen);
      } else if (m == 0xEE) {
        if (blen >= 12 && memcmp(body, "Adobe", 5) == 0) {
          f_.adobe = true;
          f_.adobe_transform = body[11];
        }
      } else if (m == 0xDA) {
        if (f_.sof < 0) fail(kErrDecode, "SOS before SOF");
        if (header_only) return;
        pos_ = next;
        read_sos(body, blen);
        scanned_ = true;
        continue;
      }
      pos_ = next;
    }
    if (f_.sof < 0) fail(kErrDecode, "no frame header (SOF)");
    if (!header_only && !scanned_) fail(kErrDecode, "no scan (SOS)");
  }

  const Frame& frame() const { return f_; }

  // Upsample and convert to RGB, libjpeg-turbo's way, into out (h*w*3).
  void to_rgb(uint8_t* out) {
    const int W = f_.width, H = f_.height;
    const int nc = int(f_.comps.size());
    std::vector<std::vector<uint8_t>> full(nc);
    for (int c = 0; c < nc; ++c) full[c] = upsample(f_.comps[c]);
    const size_t n = size_t(W) * H;
    if (nc == 1) {
      const uint8_t* y = full[0].data();
      for (size_t i = 0; i < n; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
      return;
    }
    const uint8_t *y = full[0].data(), *cb = full[1].data(), *cr = full[2].data();
    if (rgb_colorspace()) {
      for (size_t i = 0; i < n; ++i) {
        out[3 * i] = y[i];
        out[3 * i + 1] = cb[i];
        out[3 * i + 2] = cr[i];
      }
      return;
    }
    for (size_t i = 0; i < n; ++i) {
      int Y = y[i], b = cb[i], r = cr[i];
      out[3 * i] = clamp255(Y + kYcc.cr_r[r]);
      out[3 * i + 1] = clamp255(Y + int((kYcc.cb_g[b] + kYcc.cr_g[r]) >> 16));
      out[3 * i + 2] = clamp255(Y + kYcc.cb_b[b]);
    }
  }

 private:
  const uint8_t* data_;
  size_t size_;
  size_t pos_ = 0;
  bool scanned_ = false;
  Frame f_;

  // jdapimin.c default_decompress_parms for three components.
  bool rgb_colorspace() const {
    if (f_.jfif) return false;
    if (f_.adobe) return f_.adobe_transform == 0;
    return f_.comps[0].id == 82 && f_.comps[1].id == 71 && f_.comps[2].id == 66;
  }

  int next_marker() {
    while (pos_ < size_ && data_[pos_] != 0xFF) ++pos_;  // skip garbage
    while (pos_ < size_ && data_[pos_] == 0xFF) ++pos_;  // fill bytes
    if (pos_ >= size_) return -1;
    return data_[pos_++];
  }

  void read_sof(int m, const uint8_t* p, size_t n) {
    if (m != 0xC0 && m != 0xC1) fail(kUnsupported, sof_name(m));
    if (f_.sof >= 0) fail(kErrDecode, "two frame headers");
    if (n < 6) fail(kErrDecode, "bad SOF");
    f_.precision = p[0];
    if (f_.precision != 8) fail(kUnsupported, std::string(sof_name(m)) + " with " + std::to_string(f_.precision) + "-bit samples");
    f_.height = be16(p + 1);
    f_.width = be16(p + 3);
    int nc = p[5];
    if (f_.height <= 0 || f_.width <= 0) fail(kErrDecode, "zero image size (DNL is not supported)");
    if (nc == 4) fail(kUnsupported, std::string(sof_name(m)) + " with 4 components (CMYK / YCCK)");
    if (nc != 1 && nc != 3) fail(kUnsupported, std::string(sof_name(m)) + " with " + std::to_string(nc) + " components");
    if (n < 6 + 3 * size_t(nc)) fail(kErrDecode, "bad SOF");
    f_.sof = m;
    f_.comps.resize(nc);
    for (int c = 0; c < nc; ++c) {
      Component& cp = f_.comps[c];
      cp.id = p[6 + 3 * c];
      cp.h = p[7 + 3 * c] >> 4;
      cp.v = p[7 + 3 * c] & 15;
      cp.tq = p[8 + 3 * c];
      if (cp.h < 1 || cp.h > 4 || cp.v < 1 || cp.v > 4 || cp.tq > 3) fail(kErrDecode, "bad component");
      f_.hmax = std::max(f_.hmax, cp.h);
      f_.vmax = std::max(f_.vmax, cp.v);
    }
    f_.mcux = (f_.width + 8 * f_.hmax - 1) / (8 * f_.hmax);
    f_.mcuy = (f_.height + 8 * f_.vmax - 1) / (8 * f_.vmax);
    for (Component& cp : f_.comps) {
      if (f_.hmax % cp.h || f_.vmax % cp.v) fail(kUnsupported, "fractional sampling ratios");
      cp.dw = int((int64_t(f_.width) * cp.h + f_.hmax - 1) / f_.hmax);
      cp.dh = int((int64_t(f_.height) * cp.v + f_.vmax - 1) / f_.vmax);
      cp.bw = f_.mcux * cp.h;
      cp.bh = f_.mcuy * cp.v;
    }
  }

  void read_dht(const uint8_t* p, size_t n) {
    size_t i = 0;
    while (i < n) {
      if (i + 17 > n) fail(kErrDecode, "bad DHT");
      int tc = p[i] >> 4, th = p[i] & 15;
      if (tc > 1 || th > 3) fail(kErrDecode, "bad DHT");
      int total = 0;
      for (int l = 0; l < 16; ++l) total += p[i + 1 + l];
      if (total > 256 || i + 17 + total > n) fail(kErrDecode, "bad DHT");
      (tc ? f_.ac[th] : f_.dc[th]).build(p + i + 1, p + i + 17, total, tc == 0);
      i += 17 + total;
    }
  }

  void read_dqt(const uint8_t* p, size_t n) {
    size_t i = 0;
    while (i < n) {
      int pq = p[i] >> 4, tq = p[i] & 15;
      if (pq > 1 || tq > 3) fail(kErrDecode, "bad DQT");
      size_t need = 1 + 64 * (pq + 1);
      if (i + need > n) fail(kErrDecode, "bad DQT");
      for (int k = 0; k < 64; ++k) {
        int v = pq ? be16(p + i + 1 + 2 * k) : p[i + 1 + k];
        f_.quant[tq][kNaturalOrder[k]] = static_cast<uint16_t>(v);
      }
      f_.quant_defined[tq] = true;
      i += need;
    }
  }

  void read_sos(const uint8_t* p, size_t n) {
    if (n < 1) fail(kErrDecode, "bad SOS");
    int ns = p[0];
    if (ns < 1 || ns > 4 || n < 4 + 2 * size_t(ns)) fail(kErrDecode, "bad SOS");
    std::vector<Component*> sc;
    for (int s = 0; s < ns; ++s) {
      int id = p[1 + 2 * s];
      Component* cp = nullptr;
      for (Component& c : f_.comps)
        if (c.id == id) cp = &c;
      if (!cp) fail(kErrDecode, "SOS names an unknown component");
      cp->td = p[2 + 2 * s] >> 4;
      cp->ta = p[2 + 2 * s] & 15;
      if (cp->td > 3 || cp->ta > 3) fail(kErrDecode, "bad SOS table");
      if (!f_.dc[cp->td].defined || !f_.ac[cp->ta].defined) fail(kErrDecode, "scan uses an undefined Huffman table");
      if (f_.dc[cp->td].bad || f_.ac[cp->ta].bad) fail(kErrDecode, "bad Huffman table");
      if (!f_.quant_defined[cp->tq]) fail(kErrDecode, "component uses an undefined quantization table");
      if (cp->plane.empty()) cp->plane.assign(size_t(cp->bw) * 8 * cp->bh * 8, 0);
      cp->dc_pred = 0;
      sc.push_back(cp);
    }
    int ss = p[1 + 2 * ns], se = p[2 + 2 * ns], ahal = p[3 + 2 * ns];
    if (ss != 0 || se != 63 || ahal != 0) fail(kUnsupported, "a non-sequential scan (Ss/Se/Ah/Al)");

    BitReader br{data_, size_, pos_};
    int16_t block[64];
    const int ri = f_.restart_interval;
    auto decode_block = [&](Component& c, int bx, int by) {
      memset(block, 0, sizeof(block));
      const HuffTable& dct = f_.dc[c.td];
      const HuffTable& act = f_.ac[c.ta];
      int s = br.decode(dct);
      int diff = s ? extend(br.get(s), s) : 0;
      c.dc_pred += diff;
      block[0] = static_cast<int16_t>(c.dc_pred);
      for (int k = 1; k < 64; ++k) {
        int rs = br.decode(act);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          block[kNaturalOrder[k]] = static_cast<int16_t>(extend(br.get(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      size_t stride = size_t(c.bw) * 8;
      idct_islow(block, f_.quant[c.tq], c.plane.data() + size_t(by) * 8 * stride + size_t(bx) * 8, stride);
    };
    int todo = ri;
    auto maybe_restart = [&](bool last) {
      if (!ri) return;
      if (--todo == 0 && !last) {
        br.restart();
        for (Component* c : sc) c->dc_pred = 0;
        todo = ri;
      }
    };
    if (ns == 1) {
      // Non-interleaved: one block per MCU over the component's own blocks.
      Component& c = *sc[0];
      int cbw = (c.dw + 7) / 8, cbh = (c.dh + 7) / 8;
      for (int by = 0; by < cbh; ++by)
        for (int bx = 0; bx < cbw; ++bx) {
          decode_block(c, bx, by);
          maybe_restart(by == cbh - 1 && bx == cbw - 1);
        }
    } else {
      for (int my = 0; my < f_.mcuy; ++my)
        for (int mx = 0; mx < f_.mcux; ++mx) {
          for (Component* c : sc)
            for (int v = 0; v < c->v; ++v)
              for (int h = 0; h < c->h; ++h) decode_block(*c, mx * c->h + h, my * c->v + v);
          maybe_restart(my == f_.mcuy - 1 && mx == f_.mcux - 1);
        }
    }
    // Continue the marker scan after the entropy-coded data.
    pos_ = br.pos;
    while (pos_ + 1 < size_ && !(data_[pos_] == 0xFF && data_[pos_ + 1] != 0x00 &&
                                 !(data_[pos_ + 1] >= 0xD0 && data_[pos_ + 1] <= 0xD7))) {
      ++pos_;
    }
  }

  // jdsample.c: one component to full size (W x H).
  std::vector<uint8_t> upsample(const Component& c) const {
    const int W = f_.width, H = f_.height;
    const size_t pitch = size_t(c.bw) * 8;
    const uint8_t* in = c.plane.data();
    std::vector<uint8_t> out(size_t(W) * H);
    const int hr = f_.hmax / c.h, vr = f_.vmax / c.v;
    const int dw = c.dw, dh = c.dh;
    auto row = [&](int r) { return in + size_t(std::min(std::max(r, 0), dh - 1)) * pitch; };
    if (hr == 1 && vr == 1) {
      for (int y = 0; y < H; ++y) memcpy(out.data() + size_t(y) * W, row(y), W);
      return out;
    }
    std::vector<uint8_t> line(size_t(dw) * hr + 8);
    std::vector<int> colsum(dw);
    const bool fancy_h = dw > 2;
    for (int y = 0; y < H; ++y) {
      uint8_t* o = out.data() + size_t(y) * W;
      if (hr == 2 && vr == 1 && fancy_h) {  // h2v1_fancy_upsample
        const uint8_t* r0 = row(y);
        for (int x = 0; x < dw; ++x) {
          int v = r0[x] * 3, l = r0[std::max(x - 1, 0)], rt = r0[std::min(x + 1, dw - 1)];
          line[2 * x] = static_cast<uint8_t>((v + l + 1) >> 2);
          line[2 * x + 1] = static_cast<uint8_t>((v + rt + 2) >> 2);
        }
      } else if (hr == 1 && vr == 2) {  // h1v2_fancy_upsample
        int r = y >> 1, v = y & 1;
        const uint8_t *r0 = row(r), *r1 = row(v ? r + 1 : r - 1);
        int bias = v ? 2 : 1;
        for (int x = 0; x < dw; ++x) line[x] = static_cast<uint8_t>((r0[x] * 3 + r1[x] + bias) >> 2);
      } else if (hr == 2 && vr == 2 && fancy_h) {  // h2v2_fancy_upsample
        int r = y >> 1, v = y & 1;
        const uint8_t *r0 = row(r), *r1 = row(v ? r + 1 : r - 1);
        for (int x = 0; x < dw; ++x) colsum[x] = r0[x] * 3 + r1[x];
        for (int x = 0; x < dw; ++x) {
          int t = colsum[x] * 3, l = colsum[std::max(x - 1, 0)], rt = colsum[std::min(x + 1, dw - 1)];
          line[2 * x] = static_cast<uint8_t>((t + l + 8) >> 4);
          line[2 * x + 1] = static_cast<uint8_t>((t + rt + 7) >> 4);
        }
      } else {  // h2v1_upsample / h2v2_upsample / int_upsample: replication
        const uint8_t* r0 = row(y / vr);
        for (int x = 0; x < dw; ++x)
          for (int k = 0; k < hr; ++k) line[size_t(x) * hr + k] = r0[x];
      }
      memcpy(o, line.data(), W);
    }
    return out;
  }
};

bool read_file(const char* path, std::vector<uint8_t>* buf) {
  FILE* fp = fopen(path, "rb");
  if (!fp) return false;
  fseek(fp, 0, SEEK_END);
  long n = ftell(fp);
  fseek(fp, 0, SEEK_SET);
  buf->resize(n > 0 ? size_t(n) : 0);
  size_t got = n > 0 ? fread(buf->data(), 1, size_t(n), fp) : 0;
  fclose(fp);
  return got == buf->size();
}

void put_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) {
    size_t k = std::min(msg.size(), size_t(errlen - 1));
    memcpy(err, msg.data(), k);
    err[k] = 0;
  }
}

int decode_file(const char* path, uint8_t* out_u8, float* out_f32, int h, int w, std::string* msg) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) {
    *msg = "cannot read the file";
    return kErrOpen;
  }
  try {
    Decoder d(buf.data(), buf.size());
    d.run(false);
    if (d.frame().height != h || d.frame().width != w) {
      *msg = "size " + std::to_string(d.frame().width) + "x" + std::to_string(d.frame().height) +
             ", expected " + std::to_string(w) + "x" + std::to_string(h);
      return kErrDims;
    }
    if (out_u8) {
      d.to_rgb(out_u8);
    } else {
      std::vector<uint8_t> rgb(size_t(h) * w * 3);
      d.to_rgb(rgb.data());
      for (size_t i = 0; i < rgb.size(); ++i) out_f32[i] = rgb[i] / 255.0f;
    }
  } catch (const JpegError& e) {
    *msg = e.msg;
    return e.code;
  } catch (const std::bad_alloc&) {
    *msg = "out of memory";
    return kErrDecode;
  }
  return kOk;
}

}  // namespace

extern "C" {

int yt_jpeg_info(const char* path, int* h, int* w, int* components, int* orientation, char* err, int errlen) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) {
    put_err(err, errlen, "cannot read the file");
    return kErrOpen;
  }
  try {
    Decoder d(buf.data(), buf.size());
    d.run(true);
    *h = d.frame().height;
    *w = d.frame().width;
    *components = int(d.frame().comps.size());
    *orientation = d.frame().orientation;
  } catch (const JpegError& e) {
    put_err(err, errlen, e.msg);
    return e.code;
  }
  return kOk;
}

int yt_jpeg_decode(const char* path, uint8_t* out, int h, int w, char* err, int errlen) {
  std::string msg;
  int rc = decode_file(path, out, nullptr, h, w, &msg);
  if (rc != kOk) put_err(err, errlen, msg);
  return rc;
}

// Decode n same-sized files in parallel into one (n, h, w, 3) float32
// buffer. status[i] is each file's code; the first failure's message goes
// to err and its code is returned.
int yt_jpeg_decode_batch(const char** paths, int n, float* outs, int h, int w, int n_threads, int* status, char* err,
                         int errlen) {
  if (n_threads <= 0) n_threads = static_cast<int>(std::thread::hardware_concurrency());
  if (n_threads <= 0) n_threads = 1;
  if (n_threads > n) n_threads = n;
  std::vector<std::string> msgs(n);
  std::vector<std::thread> workers;
  const size_t stride = size_t(h) * w * 3;
  for (int t = 0; t < n_threads; ++t) {
    workers.emplace_back([&, t]() {
      for (int i = t; i < n; i += n_threads) status[i] = decode_file(paths[i], nullptr, outs + stride * i, h, w, &msgs[i]);
    });
  }
  for (auto& th : workers) th.join();
  for (int i = 0; i < n; ++i) {
    if (status[i] != kOk) {
      put_err(err, errlen, msgs[i]);
      return status[i];
    }
  }
  return kOk;
}

}  // extern "C"
