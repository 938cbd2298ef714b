// The serial parts of the port's WebP decoder (utils/image.py), built with
// g++ into a shared library with a plain C interface and loaded with ctypes:
//
// * vp8_decode: a VP8 key frame (RFC 6386): the frame header, the boolean
//   decoder, segmentation, the quantisers, the token partitions, intra
//   prediction and the inverse transforms (vp8.h), then the simple or the
//   normal loop filter over the whole frame in macroblock order. It writes
//   the filtered Y, U and V planes; utils/image.py crops them and applies
//   libwebp's fancy upsampler and its fixed-point YUV -> RGB.
// * vp8l_decode: a lossless stream (RFC 9649): the transforms, the colour
//   cache, the meta prefix codes, canonical prefix codes and LZ77, to ARGB.
//   With has_header 0 it reads the headerless stream of an ALPH chunk.
// * alpha_unfilter: the ALPH chunk's horizontal, vertical and gradient
//   filters undone row by row.
//
// Every function follows libwebp 1.6's decoder where the standards leave a
// choice (the order of the loop filter's edges, the DC predictors at the
// frame's edges, the colour cache's hash), so the planes equal libwebp's bit
// for bit. Each returns 0, or a negative code that utils/image.py turns into
// an exception; none allocates what the caller must free.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "vp8.h"

namespace {

using namespace vp8;

// --- the boolean decoder (RFC 6386 section 7) --------------------------------

struct BoolDecoder {
  const uint8_t* p;
  const uint8_t* end;
  uint32_t value;
  uint32_t range;
  int bit_count;

  void init(const uint8_t* data, size_t size) {
    p = data;
    end = data + size;
    value = (next() << 8);
    value |= next();
    range = 255;
    bit_count = 0;
  }
  uint32_t next() { return p < end ? *p++ : 0; }  // zeros past the end
  int get(int prob) {
    const uint32_t split = 1 + (((range - 1) * static_cast<uint32_t>(prob)) >> 8);
    const uint32_t big = split << 8;
    int bit;
    if (value >= big) {
      bit = 1;
      range -= split;
      value -= big;
    } else {
      bit = 0;
      range = split;
    }
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      if (++bit_count == 8) {
        bit_count = 0;
        value |= next();
      }
    }
    return bit;
  }
  int literal(int bits) {
    int v = 0;
    while (bits-- > 0) v = (v << 1) | get(128);
    return v;
  }
  int signed_literal(int bits) {
    const int v = literal(bits);
    return get(128) ? -v : v;
  }
};

struct QuantMatrix {
  int y1[2], y2[2], uv[2];
};

struct FilterInfo {
  int limit;   // 0: no filtering
  int ilevel;  // the interior limit
  int inner;   // filter the inner edges
  int hev_thresh;
};

struct MBData {
  int16_t coeffs[384];  // 16 Y, 4 U, 4 V subblocks of 16, dequantised, raster order
  uint8_t imodes[16];   // the 16 x 16 mode in imodes[0], or the 16 subblock modes
  uint8_t uvmode;
  uint8_t is_i4x4;
  uint8_t segment;
  uint8_t skip;
  uint32_t non_zero_y;   // 2 bits per subblock, as libwebp's NzCodeBits
  uint32_t non_zero_uv;
};

int clip(int v, int hi) { return v < 0 ? 0 : v > hi ? hi : v; }

// the tokens of one subblock (libwebp's GetCoeffs): returns the position
// after the last token read (16 when no end of block was coded)
int get_coeffs(BoolDecoder& br, const uint8_t (*probs)[3][11], int ctx, const int* dq, int n,
               int16_t* out) {
  const uint8_t* p = probs[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.get(p[0])) return n;
    while (!br.get(p[1])) {
      p = probs[kBands[++n]][0];
      if (n == 16) return 16;
    }
    int v;
    const uint8_t (*next)[11] = probs[kBands[n + 1]];
    if (!br.get(p[2])) {
      v = 1;
      p = next[1];
    } else {
      if (!br.get(p[3])) {
        if (!br.get(p[4])) {
          v = 2;
        } else {
          v = 3 + br.get(p[5]);
        }
      } else if (!br.get(p[6])) {
        if (!br.get(p[7])) {
          v = 5 + br.get(159);
        } else {
          v = 7 + 2 * br.get(165);
          v += br.get(145);
        }
      } else {
        const int bit1 = br.get(p[8]);
        const int bit0 = br.get(p[9 + bit1]);
        const int cat = 2 * bit1 + bit0;
        v = 0;
        for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br.get(*tab);
        v += 3 + (8 << cat);
      }
      p = next[2];
    }
    const int s = br.get(128) ? -v : v;
    out[kZigzag[n]] = static_cast<int16_t>(s * dq[n > 0]);
  }
  return 16;
}

uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
  nz_coeffs <<= 2;
  nz_coeffs |= (nz > 3) ? 3 : (nz > 1) ? 2 : dc_nz;
  return nz_coeffs;
}

// --- the loop filter (RFC 6386 section 15, libwebp's dsp/dec.c) --------------

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020, 1020]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }     // [-112, 112]

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

inline int hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (abs(p1 - p0) > thresh) || (abs(q1 - q0) > thresh);
}

inline int needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return (4 * abs(p0 - q0) + abs(p1 - q1)) <= t;
}

inline int needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if ((4 * abs(p0 - q0) + abs(p1 - q1)) > t) return 0;
  return abs(p3 - p2) <= it && abs(p2 - p1) <= it && abs(p1 - p0) <= it &&
         abs(q3 - q2) <= it && abs(q2 - q1) <= it && abs(q1 - q0) <= it;
}

// the simple filter across one edge of 16 pixels: hstride steps across the
// edge, vstride along it
void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, thresh2)) do_filter2(p, hstride);
}

// the normal filter across one edge of size pixels: the macroblock edge's
// six-tap variant (mb_edge) or the inner edges' four-tap one
void normal_edge(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_thresh, bool mb_edge) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, thresh2, ithresh)) continue;
    if (hev(p, hstride, hev_thresh)) {
      do_filter2(p, hstride);
    } else if (mb_edge) {
      do_filter6(p, hstride);
    } else {
      do_filter4(p, hstride);
    }
  }
}

// libwebp's DoFilter for macroblock (mb_x, mb_y): its left edge, its inner
// vertical edges, its top edge, its inner horizontal edges
void filter_mb(int type, const FilterInfo& f, int mb_x, int mb_y, uint8_t* y, int ys, uint8_t* u,
               uint8_t* v, int uvs) {
  const int limit = f.limit;
  if (limit == 0) return;
  uint8_t* yd = y + mb_y * 16 * ys + mb_x * 16;
  if (type == 1) {
    if (mb_x > 0) simple_edge(yd, 1, ys, limit + 4);
    if (f.inner)
      for (int k = 1; k < 4; ++k) simple_edge(yd + 4 * k, 1, ys, limit);
    if (mb_y > 0) simple_edge(yd, ys, 1, limit + 4);
    if (f.inner)
      for (int k = 1; k < 4; ++k) simple_edge(yd + 4 * k * ys, ys, 1, limit);
    return;
  }
  uint8_t* ud = u + mb_y * 8 * uvs + mb_x * 8;
  uint8_t* vd = v + mb_y * 8 * uvs + mb_x * 8;
  const int il = f.ilevel, ht = f.hev_thresh;
  if (mb_x > 0) {
    normal_edge(yd, 1, ys, 16, limit + 4, il, ht, true);
    normal_edge(ud, 1, uvs, 8, limit + 4, il, ht, true);
    normal_edge(vd, 1, uvs, 8, limit + 4, il, ht, true);
  }
  if (f.inner) {
    for (int k = 1; k < 4; ++k) normal_edge(yd + 4 * k, 1, ys, 16, limit, il, ht, false);
    normal_edge(ud + 4, 1, uvs, 8, limit, il, ht, false);
    normal_edge(vd + 4, 1, uvs, 8, limit, il, ht, false);
  }
  if (mb_y > 0) {
    normal_edge(yd, ys, 1, 16, limit + 4, il, ht, true);
    normal_edge(ud, uvs, 1, 8, limit + 4, il, ht, true);
    normal_edge(vd, uvs, 1, 8, limit + 4, il, ht, true);
  }
  if (f.inner) {
    for (int k = 1; k < 4; ++k) normal_edge(yd + 4 * k * ys, ys, 1, 16, limit, il, ht, false);
    normal_edge(ud + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
    normal_edge(vd + 4 * uvs, uvs, 1, 8, limit, il, ht, false);
  }
}

// --- VP8L (RFC 9649) -----------------------------------------------------------

struct LBitReader {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;  // next byte to load
  uint64_t buf = 0;
  int nbits = 0;
  bool eos = false;

  void fill() {
    while (nbits <= 56) {
      uint64_t b = 0;
      if (pos < size) {
        b = data[pos];
      } else if (pos >= size + 8) {
        eos = true;
      }
      ++pos;
      buf |= b << nbits;
      nbits += 8;
    }
  }
  uint32_t peek(int n) {
    if (nbits < n) fill();
    return static_cast<uint32_t>(buf & ((uint64_t(1) << n) - 1));
  }
  void skip(int n) {
    buf >>= n;
    nbits -= n;
  }
  uint32_t read(int n) {
    if (n == 0) return 0;
    const uint32_t v = peek(n);
    skip(n);
    return v;
  }
};

constexpr int kFastBits = 10;

// a canonical prefix code: a table over the next kFastBits bits for codes
// that short, the canonical walk for longer ones, and no bits at all for a
// code of a single symbol
struct PrefixCode {
  int single = -1;
  std::vector<int32_t> fast;  // (symbol << 8) | length, or -1
  int count[16] = {0};
  std::vector<int> sorted;

  bool build(const int* lengths, int n) {
    int nonzero = 0, last = 0;
    for (int i = 0; i < n; ++i)
      if (lengths[i]) {
        ++nonzero;
        last = i;
        if (lengths[i] > 15) return false;
      }
    if (nonzero == 0) return false;
    if (nonzero == 1) {
      single = last;
      return true;
    }
    for (int i = 0; i < n; ++i) ++count[lengths[i]];
    count[0] = 0;
    // the code must be complete (libwebp refuses any other)
    int left = 1;
    for (int len = 1; len < 16; ++len) {
      left = 2 * left - count[len];
      if (left < 0) return false;
    }
    if (left != 0) return false;
    int offs[16];
    offs[1] = 0;
    for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + count[len];
    sorted.assign(nonzero, 0);
    for (int i = 0; i < n; ++i)
      if (lengths[i]) sorted[offs[lengths[i]]++] = i;
    fast.assign(1 << kFastBits, -1);
    int code = 0, k = 0;
    for (int len = 1; len <= 15; ++len) {
      for (int c = 0; c < count[len]; ++c, ++k, ++code) {
        if (len > kFastBits) continue;
        int rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
        for (int j = rev; j < (1 << kFastBits); j += 1 << len) fast[j] = (sorted[k] << 8) | len;
      }
      code <<= 1;
    }
    return true;
  }

  int decode(LBitReader& br) const {
    if (single >= 0) return single;
    const int32_t e = fast[br.peek(kFastBits)];
    if (e >= 0) {
      br.skip(e & 0xff);
      return e >> 8;
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= 15; ++len) {
      code |= static_cast<int>(br.read(1));
      const int c = count[len];
      if (code - c < first) return sorted[index + (code - first)];
      index += c;
      first += c;
      first <<= 1;
      code <<= 1;
    }
    return -1;
  }
};

constexpr int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                      7, 8, 9, 10, 11, 12, 13, 14, 15};

bool read_prefix_code(LBitReader& br, int alphabet, PrefixCode& code) {
  std::vector<int> lengths(alphabet, 0);
  if (br.read(1)) {  // simple code
    const int num = br.read(1) + 1;
    const int first_bits = br.read(1) ? 8 : 1;
    const int s0 = br.read(first_bits);
    if (s0 >= alphabet) return false;
    lengths[s0] = 1;
    if (num == 2) {
      const int s1 = br.read(8);
      if (s1 >= alphabet) return false;
      lengths[s1] = 1;
    }
    return code.build(lengths.data(), alphabet);
  }
  int cl_lengths[19] = {0};
  const int num_codes = br.read(4) + 4;
  for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthOrder[i]] = br.read(3);
  PrefixCode cl;
  if (!cl.build(cl_lengths, 19)) return false;
  int max_symbol = alphabet;
  if (br.read(1)) {
    const int nbits = 2 + 2 * br.read(3);
    max_symbol = 2 + br.read(nbits);
    if (max_symbol > alphabet) return false;
  }
  int symbol = 0, prev = 8;
  while (symbol < alphabet) {
    if (max_symbol-- == 0) break;
    const int len = cl.decode(br);
    if (len < 0) return false;
    if (len < 16) {
      lengths[symbol++] = len;
      if (len) prev = len;
    } else {
      const int slot = len - 16;
      static const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
      const int repeat = br.read(extra[slot]) + offset[slot];
      if (symbol + repeat > alphabet) return false;
      const int v = len == 16 ? prev : 0;
      for (int i = 0; i < repeat; ++i) lengths[symbol++] = v;
    }
  }
  return code.build(lengths.data(), alphabet);
}

inline int sub_sample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

// RFC 9649 section 4.2.2's distance map: (yoffset << 4) | (8 - xoffset)
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37,
    0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56,
    0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77,
    0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e,
    0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

inline int copy_value(LBitReader& br, int prefix) {
  if (prefix < 4) return prefix + 1;
  const int extra = (prefix - 2) >> 1;
  const int offset = (2 + (prefix & 1)) << extra;
  return offset + static_cast<int>(br.read(extra)) + 1;
}

inline int plane_to_distance(int xsize, int code) {
  if (code > 120) return code - 120;
  const int dist_code = kCodeToPlane[code - 1];
  const int yoffset = dist_code >> 4;
  const int xoffset = 8 - (dist_code & 0xf);
  const int dist = yoffset * xsize + xoffset;
  return dist >= 1 ? dist : 1;
}

struct Group {
  PrefixCode codes[5];  // green + lengths + cache, red, blue, alpha, distance
};

int decode_image_stream(LBitReader& br, int xsize, int ysize, bool level0,
                        std::vector<uint32_t>& out);

enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };

struct Transform {
  int type, bits, xsize;
  std::vector<uint32_t> data;
};

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
}
inline int sub3(int a, int b, int c) { return abs(b - c) - abs(a - c); }
inline uint32_t select(uint32_t a, uint32_t b, uint32_t c) {
  const int pa_minus_pb = sub3(a >> 24, b >> 24, c >> 24) +
                          sub3((a >> 16) & 0xff, (b >> 16) & 0xff, (c >> 16) & 0xff) +
                          sub3((a >> 8) & 0xff, (b >> 8) & 0xff, (c >> 8) & 0xff) +
                          sub3(a & 0xff, b & 0xff, c & 0xff);
  return pa_minus_pb <= 0 ? a : b;
}
inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
inline uint32_t add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int v = static_cast<int>((c0 >> s) & 0xff) + static_cast<int>((c1 >> s) & 0xff) -
                  static_cast<int>((c2 >> s) & 0xff);
    out |= clip255(static_cast<uint32_t>(v)) << s;
  }
  return out;
}
inline uint32_t add_subtract_half(uint32_t c0, uint32_t c2) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int a = (c0 >> s) & 0xff, b = (c2 >> s) & 0xff;
    out |= clip255(static_cast<uint32_t>(a + (a - b) / 2)) << s;
  }
  return out;
}

uint32_t predict(int mode, const uint32_t* cur, const uint32_t* up) {
  const uint32_t L = cur[-1], T = up[0], TR = up[1], TL = up[-1];
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: return select(T, L, TL);
    case 12: return add_subtract_full(L, T, TL);
    case 13: return add_subtract_half(average2(L, T), TL);
    default: return 0xff000000u;  // 0, and libwebp's 14 and 15
  }
}

inline int color_delta(int8_t pred, int8_t color) { return (static_cast<int>(pred) * color) >> 5; }

void inverse_transform(const Transform& t, int ysize, std::vector<uint32_t>& px) {
  const int w = t.xsize;
  if (t.type == SUBTRACT_GREEN) {
    for (uint32_t& a : px) {
      const uint32_t g = (a >> 8) & 0xff;
      const uint32_t rb = ((a & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
      a = (a & 0xff00ff00u) | rb;
    }
  } else if (t.type == PREDICTOR) {
    const int tiles = sub_sample(w, t.bits);
    for (int y = 0; y < ysize; ++y) {
      uint32_t* row = px.data() + static_cast<size_t>(y) * w;
      if (y == 0) {
        row[0] = add_pixels(row[0], 0xff000000u);
        for (int x = 1; x < w; ++x) row[x] = add_pixels(row[x], row[x - 1]);
        continue;
      }
      const uint32_t* up = row - w;
      row[0] = add_pixels(row[0], up[0]);
      const uint32_t* modes = t.data.data() + static_cast<size_t>(y >> t.bits) * tiles;
      for (int x = 1; x < w; ++x) {
        const int mode = (modes[x >> t.bits] >> 8) & 0xf;
        row[x] = add_pixels(row[x], predict(mode, row + x, up + x));
      }
    }
  } else if (t.type == CROSS_COLOR) {
    const int tiles = sub_sample(w, t.bits);
    for (int y = 0; y < ysize; ++y) {
      uint32_t* row = px.data() + static_cast<size_t>(y) * w;
      const uint32_t* codes = t.data.data() + static_cast<size_t>(y >> t.bits) * tiles;
      for (int x = 0; x < w; ++x) {
        const uint32_t code = codes[x >> t.bits];
        const int8_t g2r = static_cast<int8_t>(code & 0xff);
        const int8_t g2b = static_cast<int8_t>((code >> 8) & 0xff);
        const int8_t r2b = static_cast<int8_t>((code >> 16) & 0xff);
        const uint32_t argb = row[x];
        const int8_t green = static_cast<int8_t>(argb >> 8);
        int new_red = (argb >> 16) & 0xff;
        int new_blue = argb & 0xff;
        new_red += color_delta(g2r, green);
        new_red &= 0xff;
        new_blue += color_delta(g2b, green);
        new_blue += color_delta(r2b, static_cast<int8_t>(new_red));
        new_blue &= 0xff;
        row[x] = (argb & 0xff00ff00u) | (static_cast<uint32_t>(new_red) << 16) |
                 static_cast<uint32_t>(new_blue);
      }
    }
  } else {  // COLOR_INDEXING: px holds the packed image, t.xsize pixels wide
    const int packed_w = sub_sample(w, t.bits);
    std::vector<uint32_t> out(static_cast<size_t>(w) * ysize);
    const int per = 1 << t.bits, bpp = 8 >> t.bits, mask = (1 << bpp) - 1;
    for (int y = 0; y < ysize; ++y) {
      const uint32_t* src = px.data() + static_cast<size_t>(y) * packed_w;
      uint32_t* dst = out.data() + static_cast<size_t>(y) * w;
      for (int x = 0; x < w; ++x) {
        const uint32_t g = (src[x >> t.bits] >> 8) & 0xff;
        const int index = (g >> ((x & (per - 1)) * bpp)) & mask;
        dst[x] = t.data[index];
      }
    }
    px.swap(out);
  }
}

// the entropy-coded image of xsize x ysize pixels: its colour cache, its
// prefix codes (with the meta codes' entropy image at level 0) and its
// pixels (libwebp's DecodeImageData)
int decode_entropy_image(LBitReader& br, int xsize, int ysize, bool level0,
                         std::vector<uint32_t>& out) {
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = br.read(4);
    if (cache_bits < 1 || cache_bits > 11) return -20;
  }
  int meta_bits = 0, meta_w = 0;
  std::vector<uint32_t> meta;
  int num_groups = 1;
  if (level0 && br.read(1)) {
    meta_bits = br.read(3) + 2;
    meta_w = sub_sample(xsize, meta_bits);
    if (int err = decode_image_stream(br, meta_w, sub_sample(ysize, meta_bits), false, meta))
      return err;
    for (uint32_t& m : meta) {
      m = (m >> 8) & 0xffff;
      if (static_cast<int>(m) + 1 > num_groups) num_groups = m + 1;
    }
  }
  if (br.eos) return -21;
  const int cache_size = cache_bits ? 1 << cache_bits : 0;
  const int alphabets[5] = {256 + 24 + cache_size, 256, 256, 256, 40};
  std::vector<Group> groups(num_groups);
  for (Group& g : groups)
    for (int i = 0; i < 5; ++i)
      if (!read_prefix_code(br, alphabets[i], g.codes[i])) return -22;
  std::vector<uint32_t> cache(cache_size ? cache_size : 1, 0);
  const size_t total = static_cast<size_t>(xsize) * ysize;
  out.assign(total, 0);
  size_t pos = 0, cached = 0;
  const int shift = 32 - cache_bits;
  while (pos < total) {
    if (br.eos) return -23;
    const int x = static_cast<int>(pos % xsize), y = static_cast<int>(pos / xsize);
    const Group& g = meta.empty()
                         ? groups[0]
                         : groups[meta[static_cast<size_t>(y >> meta_bits) * meta_w +
                                       (x >> meta_bits)]];
    const int s = g.codes[0].decode(br);
    if (s < 0) return -24;
    if (s < 256) {
      const int r = g.codes[1].decode(br);
      const int b = g.codes[2].decode(br);
      const int a = g.codes[3].decode(br);
      if (r < 0 || b < 0 || a < 0) return -24;
      out[pos++] = (static_cast<uint32_t>(a) << 24) | (static_cast<uint32_t>(r) << 16) |
                   (static_cast<uint32_t>(s) << 8) | static_cast<uint32_t>(b);
    } else if (s < 256 + 24) {
      const int length = copy_value(br, s - 256);
      const int dsym = g.codes[4].decode(br);
      if (dsym < 0) return -24;
      const size_t dist = plane_to_distance(xsize, copy_value(br, dsym));
      if (dist > pos || total - pos < static_cast<size_t>(length)) return -25;
      for (int i = 0; i < length; ++i, ++pos) out[pos] = out[pos - dist];
    } else {
      // every pixel before this one is in the cache first
      while (cached < pos) {
        const uint32_t c = out[cached++];
        cache[(0x1e35a7bdu * c) >> shift] = c;
      }
      out[pos++] = cache[s - 280];
    }
    if (cache_bits)
      while (cached < pos) {
        const uint32_t c = out[cached++];
        cache[(0x1e35a7bdu * c) >> shift] = c;
      }
  }
  return 0;
}

int decode_image_stream(LBitReader& br, int xsize, int ysize, bool level0,
                        std::vector<uint32_t>& out) {
  std::vector<Transform> transforms;
  int w = xsize;
  if (level0) {
    unsigned seen = 0;
    while (br.read(1)) {
      Transform t;
      t.type = br.read(2);
      if (seen & (1u << t.type)) return -10;
      seen |= 1u << t.type;
      t.xsize = w;
      t.bits = 0;
      if (t.type == PREDICTOR || t.type == CROSS_COLOR) {
        t.bits = br.read(3) + 2;
        if (int err = decode_image_stream(br, sub_sample(w, t.bits), sub_sample(ysize, t.bits),
                                          false, t.data))
          return err;
      } else if (t.type == COLOR_INDEXING) {
        const int num_colors = br.read(8) + 1;
        t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
        std::vector<uint32_t> palette;
        if (int err = decode_image_stream(br, num_colors, 1, false, palette)) return err;
        // the palette is delta coded; past its end, transparent black
        t.data.assign(static_cast<size_t>(1) << (8 >> t.bits), 0);
        t.data[0] = palette[0];
        for (int i = 1; i < num_colors; ++i) t.data[i] = add_pixels(palette[i], t.data[i - 1]);
        w = sub_sample(w, t.bits);
      }
      transforms.push_back(std::move(t));
    }
  }
  if (int err = decode_entropy_image(br, w, ysize, level0, out)) return err;
  for (size_t i = transforms.size(); i-- > 0;) inverse_transform(transforms[i], ysize, out);
  return 0;
}

}  // namespace

extern "C" {

// A VP8 key frame (data: the frame tag onwards, size bytes) into the
// filtered planes y (stride 16 mb_w, 16 mb_h rows), u and v (stride 8 mb_w,
// 8 mb_h rows), mb_w and mb_h the frame's macroblocks across and down.
int vp8_decode(const uint8_t* data, int64_t size, uint8_t* yplane, uint8_t* uplane,
               uint8_t* vplane) {
  if (size < 10) return -1;
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  if (bits & 1) return -2;  // not a key frame
  if (((bits >> 1) & 7) > 3) return -3;
  if (!((bits >> 4) & 1)) return -4;  // not displayable
  const uint32_t part0 = bits >> 5;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return -5;
  const int width = (data[6] | (data[7] << 8)) & 0x3fff;
  const int height = (data[8] | (data[9] << 8)) & 0x3fff;
  const int mb_w = (width + 15) >> 4, mb_h = (height + 15) >> 4;
  const uint8_t* buf = data + 10;
  int64_t left = size - 10;
  if (static_cast<int64_t>(part0) > left) return -6;
  BoolDecoder br;
  br.init(buf, part0);
  buf += part0;
  left -= part0;
  br.get(128);  // colour space
  br.get(128);  // clamping type
  // segmentation
  int use_segment = br.get(128), update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0}, filter_strength[4] = {0};
  uint8_t segment_probs[3] = {255, 255, 255};
  if (use_segment) {
    update_map = br.get(128);
    if (br.get(128)) {  // update the segment data
      absolute_delta = br.get(128);
      for (int s = 0; s < 4; ++s) quantizer[s] = br.get(128) ? br.signed_literal(7) : 0;
      for (int s = 0; s < 4; ++s) filter_strength[s] = br.get(128) ? br.signed_literal(6) : 0;
    }
    if (update_map)
      for (int s = 0; s < 3; ++s) segment_probs[s] = br.get(128) ? br.literal(8) : 255;
  }
  // the loop filter
  const int simple = br.get(128);
  const int level = br.literal(6);
  const int sharpness = br.literal(3);
  const int use_lf_delta = br.get(128);
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  if (use_lf_delta && br.get(128)) {
    for (int i = 0; i < 4; ++i)
      if (br.get(128)) ref_lf_delta[i] = br.signed_literal(6);
    for (int i = 0; i < 4; ++i)
      if (br.get(128)) mode_lf_delta[i] = br.signed_literal(6);
  }
  const int filter_type = level == 0 ? 0 : simple ? 1 : 2;
  // the token partitions
  const int num_parts = 1 << br.literal(2);
  if (left < 3 * (num_parts - 1)) return -7;
  const uint8_t* sizes = buf;
  const uint8_t* part_start = buf + 3 * (num_parts - 1);
  int64_t part_left = left - 3 * (num_parts - 1);
  std::vector<BoolDecoder> parts(num_parts);
  for (int p = 0; p < num_parts; ++p) {
    int64_t psize = part_left;
    if (p < num_parts - 1) {
      psize = sizes[3 * p] | (sizes[3 * p + 1] << 8) | (sizes[3 * p + 2] << 16);
      if (psize > part_left) psize = part_left;
    }
    parts[p].init(part_start, psize);
    part_start += psize;
    part_left -= psize;
  }
  // the quantisers
  const int base_q0 = br.literal(7);
  const int dqy1_dc = br.get(128) ? br.signed_literal(4) : 0;
  const int dqy2_dc = br.get(128) ? br.signed_literal(4) : 0;
  const int dqy2_ac = br.get(128) ? br.signed_literal(4) : 0;
  const int dquv_dc = br.get(128) ? br.signed_literal(4) : 0;
  const int dquv_ac = br.get(128) ? br.signed_literal(4) : 0;
  QuantMatrix dqm[4];
  for (int s = 0; s < 4; ++s) {
    int q = base_q0;
    if (use_segment) {
      q = quantizer[s];
      if (!absolute_delta) q += base_q0;
    }
    QuantMatrix& m = dqm[s];
    m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
    m.y1[1] = kAcTable[clip(q, 127)];
    m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
    m.y2[1] = (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
    m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
  }
  br.get(128);  // refresh the entropy probabilities: a key frame ignores it
  uint8_t probs[4][8][3][11];
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          probs[t][b][c][p] =
              br.get(kCoeffsUpdateProba[t][b][c][p]) ? br.literal(8) : kCoeffsProba0[t][b][c][p];
  const int use_skip_proba = br.get(128);
  const int skip_p = use_skip_proba ? br.literal(8) : 0;

  // the filter strengths per segment and per (not B_PRED, B_PRED)
  FilterInfo fstrengths[4][2];
  for (int s = 0; s < 4; ++s) {
    int base_level = level;
    if (use_segment) {
      base_level = filter_strength[s];
      if (!absolute_delta) base_level += level;
    }
    for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
      FilterInfo& info = fstrengths[s][i4x4];
      int lv = base_level;
      if (use_lf_delta) {
        lv += ref_lf_delta[0];
        if (i4x4) lv += mode_lf_delta[0];
      }
      lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
      info.limit = 0;
      info.ilevel = 0;
      info.hev_thresh = 0;
      if (lv > 0) {
        int ilevel = lv;
        if (sharpness > 0) {
          ilevel >>= sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = ilevel;
        info.limit = 2 * lv + ilevel;
        info.hev_thresh = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
      }
      info.inner = i4x4;
    }
  }

  const int ys = 16 * mb_w, uvs = 8 * mb_w;
  std::vector<uint8_t> top_y(16 * mb_w), top_u(8 * mb_w), top_v(8 * mb_w);
  std::vector<uint8_t> intra_t(4 * mb_w, B_DC_PRED);
  std::vector<uint8_t> top_nz(9 * mb_w, 0);  // 4 Y, 2 U, 2 V, Y2 per macroblock
  std::vector<FilterInfo> finfo(static_cast<size_t>(mb_w) * mb_h);
  uint8_t work[kWorkSize];
  memset(work, 0, sizeof(work));
  const uint8_t (*bands[4])[3][11] = {probs[0], probs[1], probs[2], probs[3]};
  MBData block;
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    BoolDecoder& tok = parts[mb_y & (num_parts - 1)];
    uint8_t intra_l[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
    uint8_t left_nz[9] = {0};
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      // the modes (first partition)
      uint8_t* top = intra_t.data() + 4 * mb_x;
      block.segment = 0;
      if (update_map)
        block.segment = !br.get(segment_probs[0]) ? br.get(segment_probs[1])
                                                  : br.get(segment_probs[2]) + 2;
      block.skip = use_skip_proba ? br.get(skip_p) : 0;
      block.is_i4x4 = !br.get(145);
      if (!block.is_i4x4) {
        const int ymode = br.get(156) ? (br.get(128) ? TM_PRED : H_PRED)
                                      : (br.get(163) ? V_PRED : DC_PRED);
        block.imodes[0] = static_cast<uint8_t>(ymode);
        memset(top, ymode, 4);
        memset(intra_l, ymode, 4);
      } else {
        uint8_t* modes = block.imodes;
        for (int y = 0; y < 4; ++y) {
          int ymode = intra_l[y];
          for (int x = 0; x < 4; ++x) {
            const uint8_t* prob = kBModesProba[top[x]][ymode];
            int i = kYModesIntra4[br.get(prob[0])];
            while (i > 0) i = kYModesIntra4[2 * i + br.get(prob[i])];
            ymode = -i;
            top[x] = static_cast<uint8_t>(ymode);
          }
          memcpy(modes, top, 4);
          modes += 4;
          intra_l[y] = static_cast<uint8_t>(ymode);
        }
      }
      block.uvmode = !br.get(142) ? DC_PRED : !br.get(114) ? V_PRED : br.get(183) ? TM_PRED
                                                                                  : H_PRED;
      // the residuals (the row's token partition)
      uint8_t* tnz = top_nz.data() + 9 * mb_x;
      int skip = block.skip;
      if (!skip) {
        const QuantMatrix& q = dqm[block.segment];
        int16_t* dst = block.coeffs;
        memset(dst, 0, sizeof(block.coeffs));
        int first;
        const uint8_t (*ac)[3][11];
        if (!block.is_i4x4) {
          int16_t dc[16] = {0};
          const int ctx = tnz[8] + left_nz[8];
          const int nz = get_coeffs(tok, bands[1], ctx, q.y2, 0, dc);
          tnz[8] = left_nz[8] = nz > 0;
          if (nz > 1) {
            transform_wht(dc, dst);
          } else {
            const int dc0 = (dc[0] + 3) >> 3;
            for (int i = 0; i < 16 * 16; i += 16) dst[i] = static_cast<int16_t>(dc0);
          }
          first = 1;
          ac = bands[0];
        } else {
          first = 0;
          ac = bands[3];
        }
        uint32_t non_zero_y = 0, non_zero_uv = 0;
        for (int y = 0; y < 4; ++y) {
          uint32_t nz_coeffs = 0;
          for (int x = 0; x < 4; ++x) {
            const int ctx = tnz[x] + left_nz[y];
            const int nz = get_coeffs(tok, ac, ctx, q.y1, first, dst);
            tnz[x] = left_nz[y] = nz > first;
            nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
            dst += 16;
          }
          non_zero_y = (non_zero_y << 8) | nz_coeffs;
        }
        for (int ch = 0; ch < 4; ch += 2) {
          uint32_t nz_coeffs = 0;
          for (int y = 0; y < 2; ++y) {
            for (int x = 0; x < 2; ++x) {
              const int ctx = tnz[4 + ch + x] + left_nz[4 + ch + y];
              const int nz = get_coeffs(tok, bands[2], ctx, q.uv, 0, dst);
              tnz[4 + ch + x] = left_nz[4 + ch + y] = nz > 0;
              nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
              dst += 16;
            }
          }
          non_zero_uv |= nz_coeffs << (4 * ch);
        }
        block.non_zero_y = non_zero_y;
        block.non_zero_uv = non_zero_uv;
        skip = !(non_zero_y | non_zero_uv);
      } else {
        memset(tnz, 0, 8);
        memset(left_nz, 0, 8);
        if (!block.is_i4x4) tnz[8] = left_nz[8] = 0;
        block.non_zero_y = block.non_zero_uv = 0;
      }
      if (filter_type > 0) {
        FilterInfo f = fstrengths[block.segment][block.is_i4x4];
        f.inner |= !skip;
        finfo[static_cast<size_t>(mb_y) * mb_w + mb_x] = f;
      }
      // reconstruction (libwebp's ReconstructRow), before the loop filter
      set_borders(work, mb_x, mb_y, mb_w, top_y.data(), top_u.data(), top_v.data());
      uint8_t* yd = work + kYOff;
      uint8_t* ud = work + kUOff;
      uint8_t* vd = work + kVOff;
      const int16_t* coeffs = block.coeffs;
      if (block.is_i4x4) {
        for (int n = 0; n < 16; ++n) {
          uint8_t* d = yd + kScan[n];
          predict4(d, block.imodes[n]);
          if (block.non_zero_y) transform_add(coeffs + n * 16, d);
        }
      } else {
        predict_block(yd, check_mode(mb_x, mb_y, block.imodes[0]), 16);
        if (block.non_zero_y)
          for (int n = 0; n < 16; ++n) transform_add(coeffs + n * 16, yd + kScan[n]);
      }
      const int uvmode = check_mode(mb_x, mb_y, block.uvmode);
      predict_block(ud, uvmode, 8);
      predict_block(vd, uvmode, 8);
      if (block.non_zero_uv & 0xff)
        for (int n = 0; n < 4; ++n)
          transform_add(coeffs + 256 + n * 16, ud + (n & 1) * 4 + (n >> 1) * 4 * kBps);
      if (block.non_zero_uv & 0xff00)
        for (int n = 0; n < 4; ++n)
          transform_add(coeffs + 320 + n * 16, vd + (n & 1) * 4 + (n >> 1) * 4 * kBps);
      if (mb_y < mb_h - 1) {
        memcpy(top_y.data() + 16 * mb_x, yd + 15 * kBps, 16);
        memcpy(top_u.data() + 8 * mb_x, ud + 7 * kBps, 8);
        memcpy(top_v.data() + 8 * mb_x, vd + 7 * kBps, 8);
      }
      for (int j = 0; j < 16; ++j)
        memcpy(yplane + static_cast<size_t>(mb_y * 16 + j) * ys + mb_x * 16, yd + j * kBps, 16);
      for (int j = 0; j < 8; ++j) {
        memcpy(uplane + static_cast<size_t>(mb_y * 8 + j) * uvs + mb_x * 8, ud + j * kBps, 8);
        memcpy(vplane + static_cast<size_t>(mb_y * 8 + j) * uvs + mb_x * 8, vd + j * kBps, 8);
      }
    }
  }
  if (filter_type > 0)
    for (int mb_y = 0; mb_y < mb_h; ++mb_y)
      for (int mb_x = 0; mb_x < mb_w; ++mb_x)
        filter_mb(filter_type, finfo[static_cast<size_t>(mb_y) * mb_w + mb_x], mb_x, mb_y,
                  yplane, ys, uplane, vplane, uvs);
  return 0;
}

// A VP8L stream (data, size bytes) of width x height pixels into argb
// (0xAARRGGBB, row-major). has_header: the stream starts with the 0x2f
// signature and the 5-byte header (a VP8L chunk); else it is an ALPH
// chunk's headerless stream.
int vp8l_decode(const uint8_t* data, int64_t size, int width, int height, int has_header,
                uint32_t* argb) {
  LBitReader br{data, static_cast<size_t>(size)};
  if (has_header) {
    if (size < 5 || br.read(8) != 0x2f) return -1;
    const int w = br.read(14) + 1, h = br.read(14) + 1;
    br.read(1);  // alpha is used
    if (br.read(3) != 0) return -2;
    if (w != width || h != height) return -3;
  }
  std::vector<uint32_t> out;
  if (int err = decode_image_stream(br, width, height, true, out)) return err;
  memcpy(argb, out.data(), out.size() * sizeof(uint32_t));
  return 0;
}

// Undo an ALPH chunk's filter (1 horizontal, 2 vertical, 3 gradient) on
// the h x w alpha plane in place (libwebp's dsp/filters.c unfilters): each
// row predicted from the row above as already unfiltered; the first row
// from the left, its first pixel from 0.
int alpha_unfilter(uint8_t* alpha, int64_t w, int64_t h, int method) {
  for (int64_t y = 0; y < h; ++y) {
    uint8_t* row = alpha + y * w;
    const uint8_t* prev = y > 0 ? row - w : nullptr;
    if (method == 1 || prev == nullptr) {
      uint8_t pred = prev ? prev[0] : 0;
      for (int64_t x = 0; x < w; ++x) pred = row[x] = static_cast<uint8_t>(pred + row[x]);
    } else if (method == 2) {
      for (int64_t x = 0; x < w; ++x) row[x] = static_cast<uint8_t>(prev[x] + row[x]);
    } else {
      int top_left = prev[0], left = prev[0];
      for (int64_t x = 0; x < w; ++x) {
        const int top = prev[x];
        const int g = left + top - top_left;
        left = static_cast<uint8_t>(row[x] + (g < 0 ? 0 : g > 255 ? 255 : g));
        top_left = top;
        row[x] = static_cast<uint8_t>(left);
      }
    }
  }
  return 0;
}

}  // extern "C"
