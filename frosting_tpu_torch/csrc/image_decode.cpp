// The serial parts of the port's image decoders (utils/image.py), built with
// g++ into a shared library with a plain C interface and loaded with ctypes:
// PNG's row filters, whose Average and Paeth predictors depend on the byte
// just decoded, and the Huffman entropy decoding of a sequential (baseline)
// or progressive JPEG scan.
// Everything else (chunk and marker parsing, the IDCT, chroma upsampling,
// colour conversion, resizing) is vectorised numpy in utils/image.py.
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

}  // extern "C"
