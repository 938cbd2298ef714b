// The serial parts of the port's image decoders (utils/image.py), built with
// g++ into a shared library with a plain C interface and loaded with ctypes:
// PNG's row filters, whose Average and Paeth predictors depend on the byte
// just decoded; the Huffman and arithmetic entropy decoding of a sequential
// (baseline) or progressive JPEG scan, a lossless JPEG scan's differences and
// their prediction, and libjpeg's block smoothing of a progressive image;
// TIFF's LZW and PackBits; BMP's RLE4 and RLE8 as Pillow reads them.
// Everything else (chunk, marker and tag parsing, the IDCT, chroma
// upsampling, colour conversion, resizing) is vectorised numpy in
// utils/image.py.
//
// Neither function allocates; the caller passes every buffer. Each returns
// 0, or a negative code that utils/image.py turns into an exception.

#include <cstdint>
#include <cstdlib>

extern "C" {

// Reverse the PNG row filters (PNG spec, section 9). raw holds h rows of
// 1 + stride bytes (filter type, then the filtered row); out receives h rows
// of stride bytes. bpp is the filter's byte step: bytes per complete pixel,
// at least 1. Returns -1 on an unknown filter type.
int png_unfilter(const uint8_t* raw, int64_t h, int64_t stride, int64_t bpp,
                 uint8_t* out) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* src = raw + y * (stride + 1);
    const uint8_t type = src[0];
    ++src;
    uint8_t* row = out + y * stride;
    const uint8_t* up = y > 0 ? out + (y - 1) * stride : nullptr;
    for (int64_t x = 0; x < stride; ++x) {
      const int a = x >= bpp ? row[x - bpp] : 0;
      const int b = up ? up[x] : 0;
      const int c = (up && x >= bpp) ? up[x - bpp] : 0;
      int pred;
      switch (type) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: {
          const int p = a + b - c;
          const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          break;
        }
        default: return -1;
      }
      row[x] = static_cast<uint8_t>(src[x] + pred);
    }
  }
  return 0;
}

namespace {

// Zig-zag position -> natural (row-major) position in the 8x8 block.
const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// A canonical Huffman table in the form of the JPEG spec's F.2.2.3 decoder.
struct Huff {
  int32_t maxcode[18];  // largest code of each length, -1 where none
  int32_t valptr[17];   // index into vals of each length's first code
  int32_t mincode[17];
  const uint8_t* vals;
};

// bits: the 16 code counts of a DHT table; vals: its symbols.
bool build_huff(const uint8_t* bits, const uint8_t* vals, Huff* t) {
  int32_t code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    const int n = bits[l - 1];
    t->valptr[l] = k;
    t->mincode[l] = code;
    code += n;
    k += n;
    t->maxcode[l] = n ? code - 1 : -1;
    if (code > (1 << l) || k > 256) return false;
    code <<= 1;
  }
  t->maxcode[17] = 0x7fffffff;
  t->vals = vals;
  return true;
}

// MSB-first bit reader over entropy-coded bytes: unstuffs 0xFF00 and stops
// at a marker, after which it supplies zero bits (as libjpeg does).
struct Bits {
  const uint8_t* data;
  int64_t len, pos;
  uint64_t buf = 0;
  int nbits = 0;
  bool at_marker = false;

  void fill() {
    while (nbits <= 56) {
      uint8_t byte = 0;
      if (!at_marker && pos < len) {
        byte = data[pos];
        if (byte == 0xFF) {
          const uint8_t next = pos + 1 < len ? data[pos + 1] : 0xD9;
          if (next == 0x00) {
            pos += 2;
          } else {
            at_marker = true;
            byte = 0;
          }
        } else {
          ++pos;
        }
      }
      buf |= static_cast<uint64_t>(byte) << (56 - nbits);
      nbits += 8;
    }
  }
  int bits(int n) {  // n in 1..16
    if (nbits < n) fill();
    const int v = static_cast<int>(buf >> (64 - n));
    buf <<= n;
    nbits -= n;
    return v;
  }
  int decode(const Huff& t) {
    if (nbits < 16) fill();
    int32_t code = 0;
    for (int l = 1; l <= 16; ++l) {
      code = (code << 1) | static_cast<int32_t>(buf >> 63);
      buf <<= 1;
      --nbits;
      if (code <= t.maxcode[l]) return t.vals[t.valptr[l] + code - t.mincode[l]];
    }
    return -1;  // no code of 16 bits or fewer matches
  }
  // Drop the bits left in the byte and skip an RSTn marker.
  bool restart() {
    buf = 0;
    nbits = 0;
    at_marker = false;
    while (pos + 1 < len && !(data[pos] == 0xFF && data[pos + 1] != 0x00 &&
                              data[pos + 1] != 0xFF))
      ++pos;
    if (pos + 1 >= len || data[pos + 1] < 0xD0 || data[pos + 1] > 0xD7) return false;
    pos += 2;
    return true;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

}  // namespace

// Huffman-decode one sequential (baseline) scan into quantised coefficient
// blocks in natural order.
//   data, len: the entropy-coded bytes after the SOS header;
//   tables: 8 tables (DC 0-3, then AC 0-3) of 16 code counts + 256 symbols;
//   comp: per scan component 5 ints: h and v blocks per MCU, DC and AC table
//     ids, and the width in blocks of its coefficient array;
//   coefs: per scan component a pointer to its int16 [rows, width, 64] array;
//   mcus_x, mcus_y: MCUs of the scan (a one-component scan has one block per
//     MCU); restart_interval: MCUs between RSTn markers, 0 for none.
// consumed receives the offset of the first byte after the scan's data.
// Returns 0, -1 for a bad table, -2 for a code that matches no symbol, -3
// for a missing restart marker.
int jpeg_decode_scan(const uint8_t* data, int64_t len, const uint8_t* tables,
                     int ncomp, const int32_t* comp, int16_t** coefs,
                     int64_t mcus_x, int64_t mcus_y, int64_t restart_interval,
                     int64_t* consumed) {
  Huff huff[8];
  for (int i = 0; i < 8; ++i)
    if (!build_huff(tables + i * 272, tables + i * 272 + 16, &huff[i])) return -1;
  Bits br{data, len, 0};
  int pred[4] = {0, 0, 0, 0};
  int64_t mcus_left = restart_interval;
  for (int64_t my = 0; my < mcus_y; ++my) {
    for (int64_t mx = 0; mx < mcus_x; ++mx) {
      if (restart_interval > 0) {
        if (mcus_left == 0) {
          if (!br.restart()) return -3;
          pred[0] = pred[1] = pred[2] = pred[3] = 0;
          mcus_left = restart_interval;
        }
        --mcus_left;
      }
      for (int c = 0; c < ncomp; ++c) {
        const int32_t* p = comp + 5 * c;
        const int h = p[0], v = p[1];
        const Huff& dc = huff[p[2]];
        const Huff& ac = huff[4 + p[3]];
        for (int by = 0; by < v; ++by) {
          for (int bx = 0; bx < h; ++bx) {
            int16_t* blk = coefs[c] + ((my * v + by) * p[4] + mx * h + bx) * 64;
            const int s = br.decode(dc);
            if (s < 0) return -2;
            if (s) pred[c] += extend(br.bits(s), s);
            blk[0] = static_cast<int16_t>(pred[c]);
            for (int k = 1; k < 64; ++k) {
              const int rs = br.decode(ac);
              if (rs < 0) return -2;
              const int r = rs >> 4, sz = rs & 15;
              if (sz) {
                k += r;
                const int val = extend(br.bits(sz), sz);
                if (k < 64) blk[kNatural[k]] = static_cast<int16_t>(val);
              } else if (r == 15) {
                k += 15;
              } else {
                break;
              }
            }
          }
        }
      }
    }
  }
  // the scan ends at the next marker: skip to it
  int64_t pos = br.pos;
  while (pos + 1 < len && !(data[pos] == 0xFF && data[pos + 1] != 0x00 &&
                            data[pos + 1] != 0xFF))
    ++pos;
  *consumed = pos;
  return 0;
}

// Huffman-decode one scan of a progressive JPEG (ITU T.81 G.1.2, as
// libjpeg's jdphuff.c does it) into the coefficient blocks, which persist
// across the scans: a DC first scan (ss = 0, ah = 0) or DC refinement
// (ss = 0, ah > 0), interleaved or not, or an AC first scan or AC
// refinement over the band ss..se of one component, with end-of-band runs.
// al is the scan's point transform. The other arguments, the return codes
// and the restart handling are jpeg_decode_scan's; -4 for a scan header
// that breaks the spec's rules.
int jpeg_decode_progressive_scan(const uint8_t* data, int64_t len, const uint8_t* tables,
                                 int ncomp, const int32_t* comp, int16_t** coefs,
                                 int64_t mcus_x, int64_t mcus_y, int64_t restart_interval,
                                 int ss, int se, int ah, int al, int64_t* consumed) {
  if (ss > se || se > 63 || (ss == 0 && se != 0) || (ss > 0 && ncomp != 1) || al > 13)
    return -4;
  Huff huff[8];
  for (int i = 0; i < 8; ++i)
    if (!build_huff(tables + i * 272, tables + i * 272 + 16, &huff[i])) return -1;
  Bits br{data, len, 0};
  int pred[4] = {0, 0, 0, 0};
  int64_t eobrun = 0;
  int64_t mcus_left = restart_interval;
  const int p1 = 1 << al;      // a refined bit at this scan's position
  const int m1 = -(1 << al);   // the same for a negative coefficient
  for (int64_t my = 0; my < mcus_y; ++my) {
    for (int64_t mx = 0; mx < mcus_x; ++mx) {
      if (restart_interval > 0) {
        if (mcus_left == 0) {
          if (!br.restart()) return -3;
          pred[0] = pred[1] = pred[2] = pred[3] = 0;
          eobrun = 0;
          mcus_left = restart_interval;
        }
        --mcus_left;
      }
      for (int c = 0; c < ncomp; ++c) {
        const int32_t* p = comp + 5 * c;
        const int h = p[0], v = p[1];
        const Huff& dc = huff[p[2]];
        const Huff& ac = huff[4 + p[3]];
        for (int by = 0; by < v; ++by) {
          for (int bx = 0; bx < h; ++bx) {
            int16_t* blk = coefs[c] + ((my * v + by) * p[4] + mx * h + bx) * 64;
            if (ss == 0) {
              if (ah == 0) {  // DC first: the difference, shifted by al
                const int s = br.decode(dc);
                if (s < 0) return -2;
                if (s) pred[c] += extend(br.bits(s), s);
                blk[0] = static_cast<int16_t>(static_cast<unsigned>(pred[c]) << al);
              } else if (br.bits(1)) {  // DC refinement: one bit
                blk[0] = static_cast<int16_t>(blk[0] | p1);
              }
              continue;
            }
            if (ah == 0) {  // AC first
              if (eobrun > 0) {
                --eobrun;
                continue;
              }
              for (int k = ss; k <= se; ++k) {
                const int rs = br.decode(ac);
                if (rs < 0) return -2;
                const int r = rs >> 4, sz = rs & 15;
                if (sz) {
                  k += r;
                  const int val = extend(br.bits(sz), sz);
                  if (k < 64)
                    blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(val) << al);
                } else if (r == 15) {
                  k += 15;
                } else {
                  eobrun = (int64_t{1} << r) - 1;
                  if (r) eobrun += br.bits(r);
                  break;
                }
              }
              continue;
            }
            // AC refinement: correction bits for the coefficients already
            // nonzero, new coefficients of magnitude 1 << al
            int k = ss;
            if (eobrun == 0) {
              for (; k <= se; ++k) {
                const int rs = br.decode(ac);
                if (rs < 0) return -2;
                int r = rs >> 4, s = rs & 15;
                if (s) {
                  s = br.bits(1) ? p1 : m1;
                } else if (r != 15) {
                  eobrun = int64_t{1} << r;
                  if (r) eobrun += br.bits(r);
                  break;  // the rest of the band is the end-of-band's
                }
                // past the nonzero coefficients (each taking a correction
                // bit) and r zero ones, to the one that becomes s
                while (k <= se) {
                  int16_t* coef = blk + kNatural[k];
                  if (*coef != 0) {
                    if (br.bits(1) && (*coef & p1) == 0)
                      *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
                  } else if (--r < 0) {
                    break;
                  }
                  ++k;
                }
                if (s && k < 64) blk[kNatural[k]] = static_cast<int16_t>(s);
              }
            }
            if (eobrun > 0) {
              for (; k <= se; ++k) {
                int16_t* coef = blk + kNatural[k];
                if (*coef != 0 && br.bits(1) && (*coef & p1) == 0)
                  *coef = static_cast<int16_t>(*coef + (*coef >= 0 ? p1 : m1));
              }
              --eobrun;
            }
          }
        }
      }
    }
  }
  int64_t pos = br.pos;
  while (pos + 1 < len && !(data[pos] == 0xFF && data[pos + 1] != 0x00 &&
                            data[pos + 1] != 0xFF))
    ++pos;
  *consumed = pos;
  return 0;
}


// ---------------------------------------------------------------------------
// Arithmetic-coded JPEG (ITU T.81 Annex D and F.1.4 / G.1.3, as libjpeg's
// jdarith.c decodes them).

namespace {

// T.81 Table D.2, packed as libjpeg's jaricom.c packs it:
// Qe << 16 | Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS.
// Entry 113 is the fixed 0.5 estimate of the sign and refinement bits.
#define ARI(qe, nmps, nlps, sw) ((int32_t{qe} << 16) | ((nmps) << 8) | ((sw) << 7) | (nlps))
const int32_t kAriTab[114] = {
    ARI(0x5a1d, 1, 1, 1),     ARI(0x2586, 2, 14, 0),    ARI(0x1114, 3, 16, 0),
    ARI(0x080b, 4, 18, 0),    ARI(0x03d8, 5, 20, 0),    ARI(0x01da, 6, 23, 0),
    ARI(0x00e5, 7, 25, 0),    ARI(0x006f, 8, 28, 0),    ARI(0x0036, 9, 30, 0),
    ARI(0x001a, 10, 33, 0),   ARI(0x000d, 11, 35, 0),   ARI(0x0006, 12, 9, 0),
    ARI(0x0003, 13, 10, 0),   ARI(0x0001, 13, 12, 0),   ARI(0x5a7f, 15, 15, 1),
    ARI(0x3f25, 16, 36, 0),   ARI(0x2cf2, 17, 38, 0),   ARI(0x207c, 18, 39, 0),
    ARI(0x17b9, 19, 40, 0),   ARI(0x1182, 20, 42, 0),   ARI(0x0cef, 21, 43, 0),
    ARI(0x09a1, 22, 45, 0),   ARI(0x072f, 23, 46, 0),   ARI(0x055c, 24, 48, 0),
    ARI(0x0406, 25, 49, 0),   ARI(0x0303, 26, 51, 0),   ARI(0x0240, 27, 52, 0),
    ARI(0x01b1, 28, 54, 0),   ARI(0x0144, 29, 56, 0),   ARI(0x00f5, 30, 57, 0),
    ARI(0x00b7, 31, 59, 0),   ARI(0x008a, 32, 60, 0),   ARI(0x0068, 33, 62, 0),
    ARI(0x004e, 34, 63, 0),   ARI(0x003b, 35, 32, 0),   ARI(0x002c, 9, 33, 0),
    ARI(0x5ae1, 37, 37, 1),   ARI(0x484c, 38, 64, 0),   ARI(0x3a0d, 39, 65, 0),
    ARI(0x2ef1, 40, 67, 0),   ARI(0x261f, 41, 68, 0),   ARI(0x1f33, 42, 69, 0),
    ARI(0x19a8, 43, 70, 0),   ARI(0x1518, 44, 72, 0),   ARI(0x1177, 45, 73, 0),
    ARI(0x0e74, 46, 74, 0),   ARI(0x0bfb, 47, 75, 0),   ARI(0x09f8, 48, 77, 0),
    ARI(0x0861, 49, 78, 0),   ARI(0x0706, 50, 79, 0),   ARI(0x05cd, 51, 48, 0),
    ARI(0x04de, 52, 50, 0),   ARI(0x040f, 53, 50, 0),   ARI(0x0363, 54, 51, 0),
    ARI(0x02d4, 55, 52, 0),   ARI(0x025c, 56, 53, 0),   ARI(0x01f8, 57, 54, 0),
    ARI(0x01a4, 58, 55, 0),   ARI(0x0160, 59, 56, 0),   ARI(0x0125, 60, 57, 0),
    ARI(0x00f6, 61, 58, 0),   ARI(0x00cb, 62, 59, 0),   ARI(0x00ab, 63, 61, 0),
    ARI(0x008f, 32, 61, 0),   ARI(0x5b12, 65, 65, 1),   ARI(0x4d04, 66, 80, 0),
    ARI(0x412c, 67, 81, 0),   ARI(0x37d8, 68, 82, 0),   ARI(0x2fe8, 69, 83, 0),
    ARI(0x293c, 70, 84, 0),   ARI(0x2379, 71, 86, 0),   ARI(0x1edf, 72, 87, 0),
    ARI(0x1aa9, 73, 87, 0),   ARI(0x174e, 74, 72, 0),   ARI(0x1424, 75, 72, 0),
    ARI(0x119c, 76, 74, 0),   ARI(0x0f6b, 77, 74, 0),   ARI(0x0d51, 78, 75, 0),
    ARI(0x0bb6, 79, 77, 0),   ARI(0x0a40, 48, 77, 0),   ARI(0x5832, 81, 80, 1),
    ARI(0x4d1c, 82, 88, 0),   ARI(0x438e, 83, 89, 0),   ARI(0x3bdd, 84, 90, 0),
    ARI(0x34ee, 85, 91, 0),   ARI(0x2eae, 86, 92, 0),   ARI(0x299a, 87, 93, 0),
    ARI(0x2516, 71, 86, 0),   ARI(0x5570, 89, 88, 1),   ARI(0x4ca9, 90, 95, 0),
    ARI(0x44d9, 91, 96, 0),   ARI(0x3e22, 92, 97, 0),   ARI(0x3824, 93, 99, 0),
    ARI(0x32b4, 94, 99, 0),   ARI(0x2e17, 86, 93, 0),   ARI(0x56a8, 96, 95, 1),
    ARI(0x4f46, 97, 101, 0),  ARI(0x47e5, 98, 102, 0),  ARI(0x41cf, 99, 103, 0),
    ARI(0x3c3d, 100, 104, 0), ARI(0x375e, 93, 99, 0),   ARI(0x5231, 102, 105, 0),
    ARI(0x4c0f, 103, 106, 0), ARI(0x4639, 104, 107, 0), ARI(0x415e, 99, 103, 0),
    ARI(0x5627, 106, 105, 1), ARI(0x50e7, 107, 108, 0), ARI(0x4b85, 103, 109, 0),
    ARI(0x5597, 109, 110, 0), ARI(0x504f, 107, 111, 0), ARI(0x5a10, 111, 110, 1),
    ARI(0x5522, 109, 112, 0), ARI(0x59eb, 111, 112, 1), ARI(0x5a1d, 113, 113, 0)};
#undef ARI

// The decoder's registers (jdarith.c arith_decode): C holds the code base
// and the bits read ahead, CT the shift between them; past a marker the
// data are zeros, as T.81 prescribes.
struct ArithDecoder {
  const uint8_t* data;
  int64_t len, pos;
  int64_t c = 0, a = 0;
  int ct = -16;
  bool at_marker = false;
  int marker = 0;

  int next_byte() { return pos < len ? data[pos++] : -1; }
  void reset() {
    c = 0;
    a = 0;
    ct = -16;  // read two bytes before the first decision
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int d = 0;
        if (!at_marker) {
          d = next_byte();
          if (d < 0) {  // the data end: libjpeg's source inserts an EOI
            at_marker = true;
            marker = 0xD9;
            d = 0;
          } else if (d == 0xFF) {
            do d = next_byte();
            while (d == 0xFF);
            if (d == 0) {
              d = 0xFF;  // a stuffed zero
            } else {
              at_marker = true;
              marker = d < 0 ? 0xD9 : d;
              d = 0;
            }
          }
        }
        c = (c << 8) | d;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;  // two bytes in: A becomes 0x10000
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAriTab[sv & 0x7F];
    const int nl = qe & 0xFF;
    qe >>= 8;
    const int nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  // Read the RSTn marker that ends a restart interval (jdmarker.c
  // read_restart_marker: bytes before the marker are skipped).
  bool restart() {
    if (!at_marker) {
      while (pos + 1 < len && !(data[pos] == 0xFF && data[pos + 1] != 0x00 &&
                                data[pos + 1] != 0xFF))
        ++pos;
      if (pos + 1 >= len) return false;
      marker = data[pos + 1];
      pos += 2;
    }
    at_marker = false;
    return marker >= 0xD0 && marker <= 0xD7;
  }
  // The offset of the marker that ends the scan.
  int64_t end() const {
    int64_t p = at_marker ? pos - 2 : pos;
    if (at_marker && p >= 0 && p + 1 < len && data[p] == 0xFF) return p;
    while (p + 1 < len && !(data[p] == 0xFF && data[p + 1] != 0x00 && data[p + 1] != 0xFF))
      ++p;
    return p < 0 ? 0 : p;
  }
};

struct ArithStats {
  uint8_t dc[4][64];
  uint8_t ac[4][256];
  uint8_t fixed = 113;
};

// Figures F.23-F.24 (the magnitude category and bits after the sign): the
// DIFF or AC value's magnitude, st at its first category bin.
inline int arith_magnitude(ArithDecoder& d, uint8_t* st, uint8_t* bins_x, int* ok) {
  int m = d.decode(st);
  if (m) {
    st = bins_x;
    while (d.decode(st)) {
      if ((m <<= 1) == 0x8000) {
        *ok = 0;
        return 0;
      }
      ++st;
    }
  }
  int v = m;
  st += 14;
  while (m >>= 1)
    if (d.decode(st)) v |= m;
  return v + 1;
}

}  // namespace

// Decode one arithmetic-coded scan, sequential (SOF9) or of a progressive
// frame (SOF10), into the coefficient blocks (natural order), as
// jdarith.c does: the statistics bins zeroed at the scan's start and at
// every restart, the DC differences conditioned on the previous one (DAC's
// L and U), the AC bins split at K. cond holds L[4], U[4] and K[4] of the
// four conditioning tables. progressive = 0 for a sequential scan (ss, se,
// ah, al ignored). The other arguments and the return codes are
// jpeg_decode_progressive_scan's; -2 for a magnitude or a position past the
// band (libjpeg's JWRN_ARITH_BAD_CODE).
int jpeg_decode_arith_scan(const uint8_t* data, int64_t len, const uint8_t* cond, int ncomp,
                           const int32_t* comp, int16_t** coefs, int64_t mcus_x,
                           int64_t mcus_y, int64_t restart_interval, int progressive, int ss,
                           int se, int ah, int al, int64_t* consumed) {
  if (!progressive) {
    ss = 0;
    se = 63;
    ah = al = 0;
  }
  if (ss > se || se > 63 || (progressive && ((ss == 0 && se != 0) || (ss > 0 && ncomp != 1))))
    return -4;
  static thread_local ArithStats stats;
  ArithDecoder d{data, len, 0};
  int last_dc[4] = {0, 0, 0, 0};
  int dc_context[4] = {0, 0, 0, 0};
  const bool dc_scan = !progressive || (ss == 0 && ah == 0);
  const bool ac_scan = !progressive || ss > 0;
  auto reset = [&]() {
    for (int c = 0; c < ncomp; ++c) {
      const int32_t* p = comp + 5 * c;
      if (dc_scan) {
        for (int i = 0; i < 64; ++i) stats.dc[p[2]][i] = 0;
        last_dc[c] = 0;
        dc_context[c] = 0;
      }
      if (ac_scan)
        for (int i = 0; i < 256; ++i) stats.ac[p[3]][i] = 0;
    }
    d.reset();
  };
  reset();
  stats.fixed = 113;
  const int p1 = 1 << al;
  const int m1 = -(1 << al);
  int ok = 1;
  int64_t mcus_left = restart_interval;
  for (int64_t my = 0; my < mcus_y; ++my) {
    for (int64_t mx = 0; mx < mcus_x; ++mx) {
      if (restart_interval > 0) {
        if (mcus_left == 0) {
          if (!d.restart()) return -3;
          reset();
          mcus_left = restart_interval;
        }
        --mcus_left;
      }
      for (int c = 0; c < ncomp; ++c) {
        const int32_t* p = comp + 5 * c;
        const int h = p[0], v = p[1];
        uint8_t* dcs = stats.dc[p[2]];
        uint8_t* acs = stats.ac[p[3]];
        const int L = cond[p[2]], U = cond[4 + p[2]], K = cond[8 + p[3]];
        for (int by = 0; by < v; ++by) {
          for (int bx = 0; bx < h; ++bx) {
            int16_t* blk = coefs[c] + ((my * v + by) * p[4] + mx * h + bx) * 64;
            if (ss == 0) {
              if (ah == 0) {  // Figure F.19 (Decode_DC_DIFF) and F.1.4.4.1.2
                uint8_t* st = dcs + dc_context[c];
                if (d.decode(st) == 0) {
                  dc_context[c] = 0;
                } else {
                  const int sign = d.decode(st + 1);
                  st += 2 + sign;
                  const int m0 = d.decode(st);
                  int m = m0;
                  uint8_t* s2 = st;
                  if (m) {
                    s2 = dcs + 20;
                    while (d.decode(s2)) {
                      if ((m <<= 1) == 0x8000) return -2;
                      ++s2;
                    }
                  }
                  if (m < ((1 << L) >> 1))
                    dc_context[c] = 0;
                  else if (m > ((1 << U) >> 1))
                    dc_context[c] = 12 + sign * 4;
                  else
                    dc_context[c] = 4 + sign * 4;
                  int val = m;
                  s2 += 14;
                  while (m >>= 1)
                    if (d.decode(s2)) val |= m;
                  val += 1;
                  if (sign) val = -val;
                  last_dc[c] += val;
                }
                blk[0] = static_cast<int16_t>(static_cast<unsigned>(last_dc[c]) << al);
              } else if (d.decode(&stats.fixed)) {  // DC refinement
                blk[0] = static_cast<int16_t>(blk[0] | p1);
              }
              if (progressive) continue;
            }
            if (progressive && ss > 0 && ah > 0) {  // AC refinement (G.1.3.3)
              int kex = se;
              for (; kex > 0; --kex)
                if (blk[kNatural[kex]]) break;
              for (int k = ss; k <= se; ++k) {
                uint8_t* st = acs + 3 * (k - 1);
                if (k > kex && d.decode(st)) break;  // end of band
                for (;;) {
                  int16_t* coef = blk + kNatural[k];
                  if (*coef) {
                    if (d.decode(st + 2))
                      *coef = static_cast<int16_t>(*coef + (*coef < 0 ? m1 : p1));
                    break;
                  }
                  if (d.decode(st + 1)) {
                    *coef = static_cast<int16_t>(d.decode(&stats.fixed) ? m1 : p1);
                    break;
                  }
                  st += 3;
                  if (++k > se) return -2;
                }
              }
              continue;
            }
            // AC coefficients: sequential, or a progressive first scan
            const int k0 = progressive ? ss : 1;
            for (int k = k0; k <= se; ++k) {
              uint8_t* st = acs + 3 * (k - 1);
              if (d.decode(st)) break;  // end of block
              while (d.decode(st + 1) == 0) {
                st += 3;
                if (++k > se) return -2;
              }
              const int sign = d.decode(&stats.fixed);
              st += 2;
              int m = d.decode(st);
              if (m) {
                if (d.decode(st)) {
                  m <<= 1;
                  st = acs + (k <= K ? 189 : 217);
                  while (d.decode(st)) {
                    if ((m <<= 1) == 0x8000) return -2;
                    ++st;
                  }
                }
              }
              int val = m;
              st += 14;
              while (m >>= 1)
                if (d.decode(st)) val |= m;
              val += 1;
              if (sign) val = -val;
              blk[kNatural[k]] = static_cast<int16_t>(static_cast<unsigned>(val) << al);
            }
          }
        }
      }
    }
  }
  (void)ok;
  *consumed = d.end();
  return 0;
}

// ---------------------------------------------------------------------------
// Lossless JPEG (SOF3; jdlhuff.c, jdpred.c).

// Huffman-decode a lossless scan's differences into int32 planes, one
// sample per "block": comp holds per scan component h, v, its DC table id,
// an unused int and the plane's width in samples. A category of 16 is the
// difference 32768, with no extra bits. The return codes are
// jpeg_decode_scan's.
int jpeg_decode_lossless_scan(const uint8_t* data, int64_t len, const uint8_t* tables,
                              int ncomp, const int32_t* comp, int32_t** diffs,
                              int64_t mcus_x, int64_t mcus_y, int64_t restart_interval,
                              int64_t* consumed) {
  Huff huff[4];
  for (int i = 0; i < 4; ++i)
    if (!build_huff(tables + i * 272, tables + i * 272 + 16, &huff[i])) return -1;
  Bits br{data, len, 0};
  int64_t mcus_left = restart_interval;
  for (int64_t my = 0; my < mcus_y; ++my) {
    for (int64_t mx = 0; mx < mcus_x; ++mx) {
      if (restart_interval > 0) {
        if (mcus_left == 0) {
          if (!br.restart()) return -3;
          mcus_left = restart_interval;
        }
        --mcus_left;
      }
      for (int c = 0; c < ncomp; ++c) {
        const int32_t* p = comp + 5 * c;
        const int h = p[0], v = p[1];
        for (int by = 0; by < v; ++by) {
          for (int bx = 0; bx < h; ++bx) {
            const int s = br.decode(huff[p[2]]);
            if (s < 0) return -2;
            int diff = 0;
            if (s == 16)
              diff = 32768;
            else if (s)
              diff = extend(br.bits(s), s);
            diffs[c][(my * v + by) * p[4] + mx * h + bx] = diff;
          }
        }
      }
    }
  }
  int64_t pos = br.pos;
  while (pos + 1 < len && !(data[pos] == 0xFF && data[pos + 1] != 0x00 &&
                            data[pos + 1] != 0xFF))
    ++pos;
  *consumed = pos;
  return 0;
}

// Undo the prediction of one component's [rows, cols] differences in
// place (jdpred.c): a row flagged in first_row (the scan's first and the
// first after each restart) predicts its first sample by
// 1 << (precision - al - 1) and the rest by the left neighbour Ra; every
// other row predicts its first sample by the one above (Rb) and the rest
// by selection value psv (1 Ra, 2 Rb, 3 Rc, 4 Ra + Rb - Rc,
// 5 Ra + ((Rb - Rc) >> 1), 6 Rb + ((Ra - Rc) >> 1), 7 (Ra + Rb) >> 1),
// every sum modulo 2^16.
int jpeg_lossless_undifference(int32_t* samples, int64_t rows, int64_t cols, int psv,
                               int precision, int al, const uint8_t* first_row) {
  if (psv < 1 || psv > 7) return -4;
  for (int64_t y = 0; y < rows; ++y) {
    int32_t* row = samples + y * cols;
    const int32_t* up = y > 0 ? row - cols : nullptr;
    if (first_row[y] || !up) {
      row[0] = (row[0] + (1 << (precision - al - 1))) & 0xFFFF;
      for (int64_t x = 1; x < cols; ++x) row[x] = (row[x] + row[x - 1]) & 0xFFFF;
      continue;
    }
    row[0] = (row[0] + up[0]) & 0xFFFF;
    for (int64_t x = 1; x < cols; ++x) {
      const int ra = row[x - 1], rb = up[x], rc = up[x - 1];
      int pred;
      switch (psv) {
        case 1: pred = ra; break;
        case 2: pred = rb; break;
        case 3: pred = rc; break;
        case 4: pred = ra + rb - rc; break;
        case 5: pred = ra + ((rb - rc) >> 1); break;
        case 6: pred = rb + ((ra - rc) >> 1); break;
        default: pred = (ra + rb) >> 1; break;
      }
      row[x] = (row[x] + pred) & 0xFFFF;
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Block smoothing of a progressive image (libjpeg-turbo's jdcoefct.c
// decompress_smooth_data): a coefficient among the first nine AC ones that
// is still zero and not known to its last bit is estimated from the DC
// values of the 5 x 5 blocks around; where no AC coefficient is known at
// all, the DC value too.
//   coefs: one component's [rows, cols, 64] blocks (natural order, the
//     allocation rounded up to whole iMCU rows), out: the smoothed copy;
//   height, width: its real blocks; v_samp: its vertical sampling factor;
//   imcu_rows: the image's iMCU rows; q: its quantisation table (natural
//   order); coef_bits: the point transform each of coefficients 0-9 (zig-zag)
//   is known to, -1 for none.
// The row arithmetic is libjpeg's, quirks included: image_block_row counts
// the last iMCU row's short rows as if every iMCU row had them.
int jpeg_smooth_blocks(const int16_t* coefs, int64_t rows, int64_t cols, int64_t height,
                       int64_t width, int v_samp, int64_t imcu_rows, const int32_t* q,
                       const int32_t* coef_bits, int16_t* out) {
  for (int64_t i = 0; i < rows * cols * 64; ++i) out[i] = coefs[i];
  for (int i = 0; i < 10; ++i)
    if (q[i == 0 ? 0 : kNatural[i]] == 0) return -4;
  const bool change_dc = coef_bits[1] == -1 && coef_bits[2] == -1 && coef_bits[3] == -1 &&
                         coef_bits[4] == -1 && coef_bits[5] == -1 && coef_bits[6] == -1 &&
                         coef_bits[7] == -1 && coef_bits[8] == -1 && coef_bits[9] == -1;
  const int64_t Q00 = q[0], Q01 = q[1], Q10 = q[8], Q20 = q[16], Q11 = q[9], Q02 = q[2];
  const int64_t Q03 = q[3], Q12 = q[10], Q21 = q[17], Q30 = q[24];
  const int64_t last_imcu = imcu_rows - 1;
  auto dc = [&](int64_t r, int64_t c) -> int { return coefs[(r * cols + c) * 64]; };
  auto estimate = [](int64_t qk, int64_t num, int al) -> int {
    int pred;
    if (num >= 0) {
      pred = static_cast<int>(((qk << 7) + num) / (qk << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    } else {
      pred = static_cast<int>(((qk << 7) - num) / (qk << 8));
      if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      pred = -pred;
    }
    return pred;
  };
  for (int64_t imcu = 0; imcu < imcu_rows; ++imcu) {
    int64_t block_rows;
    if (imcu < last_imcu) {
      block_rows = v_samp;
    } else {
      block_rows = height % v_samp;
      if (block_rows == 0) block_rows = v_samp;
    }
    const int64_t image_block_rows = block_rows * imcu_rows;
    for (int64_t br = 0; br < block_rows; ++br) {
      const int64_t row = imcu * v_samp + br;  // the virtual array's row
      const int64_t ibr = imcu * block_rows + br;
      const int64_t cur = row;
      const int64_t prev = ibr > 0 ? row - 1 : cur;
      const int64_t prev2 = ibr > 1 ? row - 2 : prev;
      const int64_t next = ibr < image_block_rows - 1 ? row + 1 : cur;
      const int64_t next2 = ibr < image_block_rows - 2 ? row + 2 : next;
      const int64_t rr[5] = {prev2, prev, cur, next, next2};
      int D[5][5];  // D[row][col], DC01..DC25 row by row
      for (int i = 0; i < 5; ++i)
        for (int j = 0; j < 5; ++j) D[i][j] = dc(rr[i], 0);
      const int64_t last_col = width - 1;
      for (int64_t b = 0; b < width; ++b) {
        int16_t* ws = out + (row * cols + b) * 64;
        if (b == 0 && b < last_col)
          for (int i = 0; i < 5; ++i) D[i][3] = D[i][4] = dc(rr[i], 1);
        if (b + 1 < last_col)
          for (int i = 0; i < 5; ++i) D[i][4] = dc(rr[i], b + 2);
        const int DC01 = D[0][0], DC02 = D[0][1], DC03 = D[0][2], DC04 = D[0][3],
                  DC05 = D[0][4];
        const int DC06 = D[1][0], DC07 = D[1][1], DC08 = D[1][2], DC09 = D[1][3],
                  DC10 = D[1][4];
        const int DC11 = D[2][0], DC12 = D[2][1], DC13 = D[2][2], DC14 = D[2][3],
                  DC15 = D[2][4];
        const int DC16 = D[3][0], DC17 = D[3][1], DC18 = D[3][2], DC19 = D[3][3],
                  DC20 = D[3][4];
        const int DC21 = D[4][0], DC22 = D[4][1], DC23 = D[4][2], DC24 = D[4][3],
                  DC25 = D[4][4];
        int al;
        int64_t num;
        if ((al = coef_bits[1]) != 0 && ws[1] == 0) {  // AC01
          num = Q00 * (change_dc ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 -
                                    13 * DC09 + 3 * DC10 - 3 * DC11 + 38 * DC12 -
                                    38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
                                    13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25)
                                 : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
          ws[1] = static_cast<int16_t>(estimate(Q01, num, al));
        }
        if ((al = coef_bits[2]) != 0 && ws[8] == 0) {  // AC10
          num = Q00 * (change_dc ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 +
                                    13 * DC07 + 38 * DC08 + 13 * DC09 - DC10 + DC16 -
                                    13 * DC17 - 38 * DC18 - 13 * DC19 + DC20 + DC21 +
                                    3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                                 : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
          ws[8] = static_cast<int16_t>(estimate(Q10, num, al));
        }
        if ((al = coef_bits[3]) != 0 && ws[16] == 0) {  // AC20
          num = Q00 * (change_dc ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 -
                                    14 * DC13 - 5 * DC14 + 2 * DC17 + 7 * DC18 +
                                    2 * DC19 + DC23)
                                 : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23));
          ws[16] = static_cast<int16_t>(estimate(Q20, num, al));
        }
        if ((al = coef_bits[4]) != 0 && ws[9] == 0) {  // AC11
          num = Q00 * (change_dc ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
                                    9 * DC19 + DC21 - DC25)
                                 : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 +
                                    DC22 - DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09));
          ws[9] = static_cast<int16_t>(estimate(Q11, num, al));
        }
        if ((al = coef_bits[5]) != 0 && ws[2] == 0) {  // AC02
          num = Q00 * (change_dc ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 -
                                    14 * DC13 + 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 +
                                    2 * DC19)
                                 : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15));
          ws[2] = static_cast<int16_t>(estimate(Q02, num, al));
        }
        if (change_dc) {
          if ((al = coef_bits[6]) != 0 && ws[3] == 0) {  // AC03
            num = Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19);
            ws[3] = static_cast<int16_t>(estimate(Q03, num, al));
          }
          if ((al = coef_bits[7]) != 0 && ws[10] == 0) {  // AC12
            num = Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19);
            ws[10] = static_cast<int16_t>(estimate(Q12, num, al));
          }
          if ((al = coef_bits[8]) != 0 && ws[17] == 0) {  // AC21
            num = Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19);
            ws[17] = static_cast<int16_t>(estimate(Q21, num, al));
          }
          if ((al = coef_bits[9]) != 0 && ws[24] == 0) {  // AC30
            num = Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19);
            ws[24] = static_cast<int16_t>(estimate(Q30, num, al));
          }
          num = Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 +
                       6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 +
                       152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 +
                       6 * DC19 - 6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 -
                       2 * DC25);
          ws[0] = static_cast<int16_t>(estimate(Q00, num, 0));
        }
        for (int i = 0; i < 5; ++i)
          for (int j = 0; j < 4; ++j) D[i][j] = D[i][j + 1];
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// TIFF and BMP.

// TIFF LZW (TIFF 6.0 section 13, as libtiff's LZWDecode reads it: codes
// MSB first from 9 to 12 bits, the width growing one code early). Writes
// at most cap bytes; n_out receives the count. Returns 0, -1 for a code
// that is not yet in the table.
int tiff_lzw_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap, int64_t* n_out) {
  static thread_local uint16_t prefix[4096];
  static thread_local uint8_t suffix[4096], first[4096];
  static thread_local uint16_t length[4096];
  static thread_local uint8_t stack[4096];
  for (int i = 0; i < 256; ++i) {
    prefix[i] = 0;
    suffix[i] = first[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  int64_t out = 0, bitpos = 0;
  const int64_t nbits_total = n * 8;
  int width = 9, next = 258, old = -1;
  while (bitpos + width <= nbits_total) {
    int code = 0;
    for (int i = 0; i < width; ++i, ++bitpos)
      code = (code << 1) | ((src[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    if (code == 257) break;  // EOI
    if (code == 256) {       // Clear
      width = 9;
      next = 258;
      old = -1;
      continue;
    }
    int entry;
    uint8_t head;
    if (old < 0) {
      if (code > 255) return -1;
      entry = code;
      head = static_cast<uint8_t>(code);
    } else if (code < next) {
      entry = code;
      head = first[code];
    } else if (code == next) {
      entry = -1;  // KwKwK: the previous string and its own first byte
      head = first[old];
    } else {
      return -1;
    }
    // the string of entry (or old + head), written back to front
    int len = 0;
    if (entry >= 0) {
      for (int e = entry;; e = prefix[e]) {
        stack[len++] = suffix[e];
        if (length[e] == 1) break;
      }
    } else {
      stack[len++] = head;
      for (int e = old;; e = prefix[e]) {
        stack[len++] = suffix[e];
        if (length[e] == 1) break;
      }
    }
    for (int i = len - 1; i >= 0; --i)
      if (out < cap) dst[out++] = stack[i];
    if (old >= 0 && next < 4096) {
      prefix[next] = static_cast<uint16_t>(old);
      suffix[next] = head;
      first[next] = first[old];
      length[next] = static_cast<uint16_t>(length[old] + 1);
      ++next;
      if (next >= (1 << width) - 1 && width < 12) ++width;
    }
    old = code;
  }
  *n_out = out;
  return 0;
}

// PackBits (TIFF 6.0 section 9): at most cap bytes; n_out receives the
// count.
int tiff_packbits_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap,
                         int64_t* n_out) {
  int64_t i = 0, out = 0;
  while (i < n && out < cap) {
    const int c = static_cast<int8_t>(src[i++]);
    if (c >= 0) {
      for (int k = 0; k <= c && i < n; ++k, ++i)
        if (out < cap) dst[out++] = src[i];
    } else if (c != -128) {
      if (i >= n) break;
      const uint8_t b = src[i++];
      for (int k = 0; k < 1 - c; ++k)
        if (out < cap) dst[out++] = b;
    }
  }
  *n_out = out;
  return 0;
}

// BMP RLE8 / RLE4 as Pillow 12.1's BmpRleDecoder reads it, quirks
// included: a delta skips two bytes more than it reads; RLE4's absolute
// run of n pixels reads n / 2 bytes (an odd last pixel is lost) but
// advances the column by n; the word alignment after an absolute run
// follows the position in the file. data: the whole file, start: the
// offset of the pixel data; out receives up to width * height index bytes
// in file row order (bottom-up for a positive height). n_out receives the
// count; fewer than width * height means the data ran out.
int bmp_rle_decode(const uint8_t* data, int64_t len, int64_t start, int rle4, int64_t width,
                   int64_t height, uint8_t* out, int64_t* n_out) {
  const int64_t dest = width * height;
  int64_t pos = start, n = 0, x = 0;
  auto put = [&](uint8_t v) {
    if (n < dest) out[n] = v;
    ++n;
  };
  while (n < dest) {
    if (pos + 2 > len) break;
    int64_t num = data[pos];
    const uint8_t byte = data[pos + 1];
    pos += 2;
    if (num) {
      if (x + num > width) num = width - x > 0 ? width - x : 0;
      for (int64_t i = 0; i < num; ++i)
        put(rle4 ? static_cast<uint8_t>(i % 2 == 0 ? byte >> 4 : byte & 0x0F) : byte);
      x += num;
    } else if (byte == 0) {  // end of line
      while (n % width != 0) put(0);
      x = 0;
    } else if (byte == 1) {  // end of bitmap
      break;
    } else if (byte == 2) {  // delta: Pillow reads two bytes, then two more
      if (pos + 2 > len) break;
      pos += 2;
      if (pos + 2 > len) break;
      const int64_t right = data[pos], up = data[pos + 1];
      pos += 2;
      for (int64_t i = 0; i < right + up * width; ++i) put(0);
      x = n % width;
    } else {  // absolute run
      const int64_t count = rle4 ? byte / 2 : byte;
      const int64_t avail = len - pos < count ? len - pos : count;
      for (int64_t i = 0; i < avail; ++i) {
        const uint8_t b = data[pos + i];
        if (rle4) {
          put(static_cast<uint8_t>(b >> 4));
          put(static_cast<uint8_t>(b & 0x0F));
        } else {
          put(b);
        }
      }
      pos += avail;
      if (avail < count) break;
      x += byte;
      if (pos % 2 != 0) ++pos;
    }
  }
  *n_out = n < dest ? n : dest;
  return 0;
}

}  // extern "C"
