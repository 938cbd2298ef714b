// The serial parts of utils/image_encode.py, the small writers with which
// the tests and chip_smoke.py make TIFF, BMP, JPEG, WebP and GIF variants
// without PIL: the arithmetic coding of a JPEG scan (ITU T.81 Annex D and
// F.1.4 / G.1.3, as libjpeg's jcarith.c codes it), TIFF's and GIF's LZW,
// VP8L's LSB-first bit packing, and a small VP8 key-frame writer (mode
// choice, forward transforms, quantisation, the boolean encoder) that
// reconstructs with vp8.h as the decoder does. Built with g++ into a
// shared library with a plain C interface by _build.py at first use, like
// image_decode.cpp.
//
// None allocates what the caller must free; the caller passes every
// buffer. Each returns the number of bytes written, or -1 when the output
// buffer is too small.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "vp8.h"

extern "C" {

namespace {

const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// T.81 Table D.2 (Qe, Next_Index_MPS, Next_Index_LPS, Switch_MPS), packed
// as in image_decode.cpp; entry 113 is the fixed 0.5 estimate.
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

// The encoder's registers (jcarith.c): C, A, the byte counter CT, the
// pending output byte and the stacked 0xFF (sc) and 0x00 (zc) bytes.
struct ArithEncoder {
  uint8_t* out;
  int64_t cap, n = 0;
  bool full = false;
  int64_t c = 0, a = 0x10000;
  int ct = 11;
  int64_t sc = 0, zc = 0;
  int buffer = -1;

  void emit(int b) {
    if (n < cap)
      out[n++] = static_cast<uint8_t>(b);
    else
      full = true;
  }
  void init() {
    c = 0;
    a = 0x10000;
    ct = 11;
    sc = zc = 0;
    buffer = -1;
  }
  void flush_zeros() {
    while (zc) {
      emit(0x00);
      --zc;
    }
  }
  void encode(uint8_t* st, int val) {
    int sv = *st;
    int64_t qe = kAriTab[sv & 0x7F];
    const int nl = qe & 0xFF;
    qe >>= 8;
    const int nm = qe & 0xFF;
    qe >>= 8;
    a -= qe;
    if (val != (sv >> 7)) {  // the less probable symbol
      if (a >= qe) {
        c += a;
        a = qe;
      }
      *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
    } else {  // the more probable symbol
      if (a >= 0x8000) return;
      if (a < qe) {
        c += a;
        a = qe;
      }
      *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
    }
    do {  // renormalisation and output (D.1.6)
      a <<= 1;
      c <<= 1;
      if (--ct == 0) {
        const int64_t temp = c >> 19;
        if (temp > 0xFF) {  // a carry into the stacked bytes
          if (buffer >= 0) {
            flush_zeros();
            emit(buffer + 1);
            if (buffer + 1 == 0xFF) emit(0x00);
          }
          zc += sc;
          sc = 0;
          buffer = static_cast<int>(temp & 0xFF);
        } else if (temp == 0xFF) {
          ++sc;
        } else {
          if (buffer == 0) {
            ++zc;
          } else if (buffer >= 0) {
            flush_zeros();
            emit(buffer);
          }
          if (sc) {
            flush_zeros();
            do {
              emit(0xFF);
              emit(0x00);
            } while (--sc);
          }
          buffer = static_cast<int>(temp & 0xFF);
        }
        c &= 0x7FFFF;
        ct += 8;
      }
    } while (a < 0x8000);
  }
  void finish() {  // D.1.8
    int64_t temp = (a - 1 + c) & 0xFFFF0000LL;
    c = temp < c ? temp + 0x8000 : temp;
    c <<= ct;
    if (c & 0xF8000000LL) {
      if (buffer >= 0) {
        flush_zeros();
        emit(buffer + 1);
        if (buffer + 1 == 0xFF) emit(0x00);
      }
      zc += sc;
      sc = 0;
    } else {
      if (buffer == 0) {
        ++zc;
      } else if (buffer >= 0) {
        flush_zeros();
        emit(buffer);
      }
      if (sc) {
        flush_zeros();
        do {
          emit(0xFF);
          emit(0x00);
        } while (--sc);
      }
    }
    if (c & 0x7FFF800LL) {
      flush_zeros();
      emit(static_cast<int>((c >> 19) & 0xFF));
      if (((c >> 19) & 0xFF) == 0xFF) emit(0x00);
      if (c & 0x7F800LL) {
        emit(static_cast<int>((c >> 11) & 0xFF));
        if (((c >> 11) & 0xFF) == 0xFF) emit(0x00);
      }
    }
  }
};

// Figures F.8-F.9 for an AC coefficient: the category of v - 1, its
// first two decisions at st and the later ones at x, then its bits.
void encode_ac_magnitude(ArithEncoder& e, uint8_t* st, uint8_t* x, int v) {
  int m = 0;
  if (v -= 1) {
    e.encode(st, 1);
    m = 1;
    int v2 = v;
    if (v2 >>= 1) {
      e.encode(st, 1);
      m <<= 1;
      st = x;
      while (v2 >>= 1) {
        e.encode(st, 1);
        m <<= 1;
        ++st;
      }
    }
  }
  e.encode(st, 0);
  st += 14;
  while (m >>= 1) e.encode(st, (m & v) ? 1 : 0);
}

}  // namespace

// Arithmetic-code one scan of coefficient blocks (natural order), the
// inverse of image_decode.cpp's jpeg_decode_arith_scan, with its
// arguments: cond holds the conditioning tables' L[4], U[4] and K[4];
// progressive = 0 for a sequential scan. A restart interval ends with an
// RSTn marker, which this function writes. Returns the bytes written.
int64_t jpeg_encode_arith_scan(const int16_t* const* coefs, const uint8_t* cond, int ncomp,
                               const int32_t* comp, int64_t mcus_x, int64_t mcus_y,
                               int64_t restart_interval, int progressive, int ss, int se,
                               int ah, int al, uint8_t* out, int64_t cap) {
  if (!progressive) {
    ss = 0;
    se = 63;
    ah = al = 0;
  }
  uint8_t dc_stats[4][64], ac_stats[4][256];
  uint8_t fixed = 113;
  int last_dc[4] = {0, 0, 0, 0};
  int dc_context[4] = {0, 0, 0, 0};
  ArithEncoder e{out, cap};
  const bool dc_scan = !progressive || (ss == 0 && ah == 0);
  const bool ac_scan = !progressive || ss > 0;
  auto reset = [&]() {
    for (int c = 0; c < ncomp; ++c) {
      const int32_t* p = comp + 5 * c;
      if (dc_scan) {
        for (int i = 0; i < 64; ++i) dc_stats[p[2]][i] = 0;
        last_dc[c] = 0;
        dc_context[c] = 0;
      }
      if (ac_scan)
        for (int i = 0; i < 256; ++i) ac_stats[p[3]][i] = 0;
    }
    e.init();
  };
  reset();
  int64_t mcus_left = restart_interval, next_rst = 0;
  for (int64_t my = 0; my < mcus_y; ++my) {
    for (int64_t mx = 0; mx < mcus_x; ++mx) {
      if (restart_interval > 0) {
        if (mcus_left == 0) {
          e.finish();
          e.emit(0xFF);
          e.emit(static_cast<int>(0xD0 + next_rst));
          next_rst = (next_rst + 1) & 7;
          reset();
          mcus_left = restart_interval;
        }
        --mcus_left;
      }
      for (int c = 0; c < ncomp; ++c) {
        const int32_t* p = comp + 5 * c;
        const int h = p[0], v = p[1];
        uint8_t* dcs = dc_stats[p[2]];
        uint8_t* acs = ac_stats[p[3]];
        const int L = cond[p[2]], U = cond[4 + p[2]], K = cond[8 + p[3]];
        for (int by = 0; by < v; ++by) {
          for (int bx = 0; bx < h; ++bx) {
            const int16_t* blk = coefs[c] + ((my * v + by) * p[4] + mx * h + bx) * 64;
            if (ss == 0) {
              if (ah == 0) {  // F.1.4.1: the DC difference
                const int m0 = progressive ? (blk[0] >> al) : blk[0];
                uint8_t* st = dcs + dc_context[c];
                int v0 = m0 - last_dc[c];
                if (v0 == 0) {
                  e.encode(st, 0);
                  dc_context[c] = 0;
                } else {
                  last_dc[c] = m0;
                  e.encode(st, 1);
                  if (v0 > 0) {
                    e.encode(st + 1, 0);
                    st += 2;
                    dc_context[c] = 4;
                  } else {
                    v0 = -v0;
                    e.encode(st + 1, 1);
                    st += 3;
                    dc_context[c] = 8;
                  }
                  // the magnitude (F.8-F.9), its context set before its bits
                  int m = 0;
                  int vv = v0 - 1;
                  if (vv) {
                    e.encode(st, 1);
                    m = 1;
                    int v2 = vv;
                    st = dcs + 20;
                    while (v2 >>= 1) {
                      e.encode(st, 1);
                      m <<= 1;
                      ++st;
                    }
                  }
                  e.encode(st, 0);
                  if (m < ((1 << L) >> 1))
                    dc_context[c] = 0;
                  else if (m > ((1 << U) >> 1))
                    dc_context[c] += 8;
                  st += 14;
                  while (m >>= 1) e.encode(st, (m & vv) ? 1 : 0);
                }
              } else {  // DC refinement: bit al
                e.encode(&fixed, (blk[0] >> al) & 1);
              }
              if (progressive) continue;
            }
            const int k0 = progressive ? ss : 1;
            auto mag = [&](int k) {  // |coef| >> al at zig-zag position k
              const int t = blk[kNatural[k]];
              return (t >= 0 ? t : -t) >> al;
            };
            int ke = se;
            for (; ke > 0; --ke)
              if (mag(ke)) break;
            if (progressive && ss > 0 && ah > 0) {  // AC refinement (G.1.3.3)
              int kex = ke;
              for (; kex > 0; --kex) {
                const int t = blk[kNatural[kex]];
                if (((t >= 0 ? t : -t) >> ah) != 0) break;
              }
              int k = ss;
              for (; k <= ke; ++k) {
                uint8_t* st = acs + 3 * (k - 1);
                if (k > kex) e.encode(st, 0);
                for (;;) {
                  const int t = blk[kNatural[k]];
                  const int m = (t >= 0 ? t : -t) >> al;
                  if (m) {
                    if (m >> 1) {
                      e.encode(st + 2, m & 1);
                    } else {
                      e.encode(st + 1, 1);
                      e.encode(&fixed, t < 0 ? 1 : 0);
                    }
                    break;
                  }
                  e.encode(st + 1, 0);
                  st += 3;
                  ++k;
                }
              }
              if (k <= se) e.encode(acs + 3 * (k - 1), 1);
              continue;
            }
            int k = k0;
            for (; k <= ke; ++k) {  // F.1.4.2 / G.1.3.2: first AC coding
              uint8_t* st = acs + 3 * (k - 1);
              e.encode(st, 0);
              int vk;
              for (;;) {
                vk = mag(k);
                if (vk) {
                  e.encode(st + 1, 1);
                  e.encode(&fixed, blk[kNatural[k]] < 0 ? 1 : 0);
                  break;
                }
                e.encode(st + 1, 0);
                st += 3;
                ++k;
              }
              encode_ac_magnitude(e, st + 2, acs + (k <= K ? 189 : 217), vk);
            }
            if (k <= se) e.encode(acs + 3 * (k - 1), 1);
          }
        }
      }
    }
  }
  e.finish();
  return e.full ? -1 : e.n;
}

// TIFF LZW (TIFF 6.0 section 13, as libtiff's LZWEncode writes it): a
// Clear code first, the width growing when the next entry would not fit
// (the reader, one entry behind, grows it one code early), a Clear when
// the table fills, EOI last. Returns the bytes written.
int64_t tiff_lzw_encode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap) {
  const int kHash = 1 << 16;
  static thread_local int32_t hkey[1 << 16];
  static thread_local int16_t hval[1 << 16];
  int64_t out = 0;
  uint64_t acc = 0;
  int nacc = 0;
  bool full = false;
  int width = 9, next = 258;
  auto put = [&](int code) {
    acc = (acc << width) | static_cast<uint64_t>(code);
    nacc += width;
    while (nacc >= 8) {
      nacc -= 8;
      if (out < cap)
        dst[out++] = static_cast<uint8_t>(acc >> nacc);
      else
        full = true;
    }
  };
  auto clear_table = [&]() {
    for (int i = 0; i < kHash; ++i) hkey[i] = -1;
    width = 9;
    next = 258;
  };
  clear_table();
  put(256);
  if (n == 0) {
    put(257);
  } else {
    int w = src[0];
    for (int64_t i = 1; i < n; ++i) {
      const int k = src[i];
      const int32_t key = (w << 8) | k;
      uint32_t h = (static_cast<uint32_t>(key) * 2654435761u) >> 16;
      int found = -1;
      while (hkey[h] != -1) {
        if (hkey[h] == key) {
          found = hval[h];
          break;
        }
        h = (h + 1) & (kHash - 1);
      }
      if (found >= 0) {
        w = found;
        continue;
      }
      put(w);
      hkey[h] = key;
      hval[h] = static_cast<int16_t>(next);
      if (++next == 4094) {  // the table is full: start again
        put(256);
        clear_table();
      } else if (next > (1 << width) - 1) {
        ++width;
      }
      w = k;
    }
    put(w);
    if (++next == 4094) {  // the reader adds an entry after this code too
      put(256);
      width = 9;
    } else if (next > (1 << width) - 1) {
      ++width;
    }
    put(257);
  }
  if (nacc > 0) {
    if (out < cap)
      dst[out++] = static_cast<uint8_t>(acc << (8 - nacc));
    else
      full = true;
  }
  return full ? -1 : out;
}

// Pack n codes LSB first, code i being the low nbits[i] bits of values[i]
// (a VP8L stream's bit order). Returns the bytes written, or -1 when cap is
// too small.
int64_t lsb_pack(const uint32_t* values, const uint8_t* nbits, int64_t n, uint8_t* dst,
                 int64_t cap) {
  uint64_t acc = 0;
  int nacc = 0;
  int64_t out = 0;
  for (int64_t i = 0; i < n; ++i) {
    acc |= static_cast<uint64_t>(values[i]) << nacc;
    nacc += nbits[i];
    while (nacc >= 8) {
      if (out >= cap) return -1;
      dst[out++] = static_cast<uint8_t>(acc);
      acc >>= 8;
      nacc -= 8;
    }
  }
  if (nacc > 0) {
    if (out >= cap) return -1;
    dst[out++] = static_cast<uint8_t>(acc);
  }
  return out;
}

// GIF's LZW (GIF89a, appendix F): a clear code first, codes LSB first as
// wide as the reader will read them (its table one entry behind the
// writer's), the end code last. When the table holds 4096 entries the
// writer either sends a clear code (clear_when_full) or goes on with
// 12-bit codes and a full table, the case a reader must not grow past.
// Returns the bytes written, or -1 when cap is too small.
int64_t gif_lzw_encode(const uint8_t* src, int64_t n, int min_size, int clear_when_full,
                       uint8_t* dst, int64_t cap) {
  const int kHash = 1 << 16;
  static thread_local int32_t hkey[1 << 16];
  static thread_local int16_t hval[1 << 16];
  const int clear = 1 << min_size, end = clear + 1;
  int64_t out = 0;
  uint64_t acc = 0;
  int nacc = 0;
  bool full = false;
  int width = 0, next = 0, reader_next = 0;
  bool first = true;
  auto put = [&](int code) {
    acc |= static_cast<uint64_t>(code) << nacc;
    nacc += width;
    while (nacc >= 8) {
      if (out < cap)
        dst[out++] = static_cast<uint8_t>(acc);
      else
        full = true;
      acc >>= 8;
      nacc -= 8;
    }
  };
  // a data code, and the entry the reader adds on reading it
  auto emit = [&](int code) {
    put(code);
    if (first) {
      first = false;
    } else if (reader_next < 4096) {
      if (reader_next == (1 << width) - 1 && width < 12) ++width;
      ++reader_next;
    }
  };
  auto reset = [&]() {
    for (int i = 0; i < kHash; ++i) hkey[i] = -1;
    width = min_size + 1;
    next = reader_next = clear + 2;
    first = true;
  };
  reset();
  put(clear);
  if (n > 0) {
    int w = src[0];
    for (int64_t i = 1; i < n; ++i) {
      const int k = src[i];
      const int32_t key = (w << 8) | k;
      uint32_t h = (static_cast<uint32_t>(key) * 2654435761u) >> 16;
      int found = -1;
      while (hkey[h] != -1) {
        if (hkey[h] == key) {
          found = hval[h];
          break;
        }
        h = (h + 1) & (kHash - 1);
      }
      if (found >= 0) {
        w = found;
        continue;
      }
      emit(w);
      if (next < 4096) {
        hkey[h] = key;
        hval[h] = static_cast<int16_t>(next++);
      } else if (clear_when_full) {
        put(clear);
        reset();
      }
      w = k;
    }
    emit(w);
  }
  put(end);
  if (nacc > 0) {
    if (out < cap)
      dst[out++] = static_cast<uint8_t>(acc);
    else
      full = true;
  }
  return full ? -1 : out;
}

namespace {

// --- a small VP8 key-frame writer ---------------------------------------------

using namespace vp8;

// RFC 6386 section 7.3's boolean encoder
struct BoolEncoder {
  std::vector<uint8_t> out;
  uint32_t range = 255, bottom = 0;
  int bit_count = 24;

  void add_one() {
    size_t i = out.size();
    while (i > 0 && out[i - 1] == 255) out[--i] = 0;
    if (i > 0) ++out[i - 1];
  }
  void put(int prob, int bit) {
    const uint32_t split = 1 + (((range - 1) * static_cast<uint32_t>(prob)) >> 8);
    if (bit) {
      bottom += split;
      range -= split;
    } else {
      range = split;
    }
    while (range < 128) {
      range <<= 1;
      if (bottom & (1u << 31)) add_one();
      bottom <<= 1;
      if (!--bit_count) {
        out.push_back(static_cast<uint8_t>(bottom >> 24));
        bottom &= (1 << 24) - 1;
        bit_count = 8;
      }
    }
  }
  void literal(int v, int bits) {
    while (bits-- > 0) put(128, (v >> bits) & 1);
  }
  void flush() {
    int c = bit_count;
    uint32_t v = bottom;
    if (v & (1u << (32 - c))) add_one();
    v <<= c & 7;
    c >>= 3;
    while (--c >= 0) v <<= 8;
    for (c = 0; c < 4; ++c) {
      out.push_back(static_cast<uint8_t>(v >> 24));
      v <<= 8;
    }
  }
};

// libwebp's forward transforms (enc/dsp): the 4 x 4 DCT of src - ref (both
// kBps a row) and the Walsh-Hadamard transform of the 16 luma DCs
void forward_dct(const uint8_t* src, const uint8_t* ref, int* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i, src += kBps, ref += kBps) {
    const int d0 = src[0] - ref[0], d1 = src[1] - ref[1];
    const int d2 = src[2] - ref[2], d3 = src[3] - ref[3];
    const int a0 = d0 + d3, a1 = d1 + d2, a2 = d1 - d2, a3 = d0 - d3;
    tmp[0 + i * 4] = (a0 + a1) * 8;
    tmp[1 + i * 4] = (a2 * 2217 + a3 * 5352 + 1812) >> 9;
    tmp[2 + i * 4] = (a0 - a1) * 8;
    tmp[3 + i * 4] = (a3 * 2217 - a2 * 5352 + 937) >> 9;
  }
  for (int i = 0; i < 4; ++i) {
    const int a0 = tmp[0 + i] + tmp[12 + i], a1 = tmp[4 + i] + tmp[8 + i];
    const int a2 = tmp[4 + i] - tmp[8 + i], a3 = tmp[0 + i] - tmp[12 + i];
    out[0 + i] = (a0 + a1 + 7) >> 4;
    out[4 + i] = ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0);
    out[8 + i] = (a0 - a1 + 7) >> 4;
    out[12 + i] = (a3 * 2217 - a2 * 5352 + 51000) >> 16;
  }
}

void forward_wht(const int* dc, int* out) {  // dc[16]: the blocks' DCs, raster order
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int* in = dc + 4 * i;
    const int a0 = in[0] + in[2], a1 = in[1] + in[3];
    const int a2 = in[1] - in[3], a3 = in[0] - in[2];
    tmp[0 + i * 4] = a0 + a1;
    tmp[1 + i * 4] = a3 + a2;
    tmp[2 + i * 4] = a3 - a2;
    tmp[3 + i * 4] = a0 - a1;
  }
  for (int i = 0; i < 4; ++i) {
    const int a0 = tmp[0 + i] + tmp[8 + i], a1 = tmp[4 + i] + tmp[12 + i];
    const int a2 = tmp[4 + i] - tmp[12 + i], a3 = tmp[0 + i] - tmp[8 + i];
    out[0 + i] = (a0 + a1) >> 1;
    out[4 + i] = (a3 + a2) >> 1;
    out[8 + i] = (a3 - a2) >> 1;
    out[12 + i] = (a0 - a1) >> 1;
  }
}

int quantize(int c, int q) {
  const int level = (abs(c) + (q >> 1)) / q;
  const int capped = level > 2048 ? 2048 : level;
  return c < 0 ? -capped : capped;
}

struct Quant {
  int y1[2], y2[2], uv[2];
};

struct MBCode {
  int is_i4x4, ymode, uvmode, skip;
  uint8_t imodes[16];
  int16_t levels[25][16];  // 16 Y, 4 U, 4 V, Y2; raster order
};

// quantise the residual of the 4 x 4 block at src against the prediction
// at rec, then add its reconstruction to rec; levels receive the quantised
// values (raster order)
void code_block(const uint8_t* src, uint8_t* rec, const int* dq, int16_t* levels) {
  int c[16];
  forward_dct(src, rec, c);
  int16_t deq[16];
  for (int i = 0; i < 16; ++i) {
    levels[i] = static_cast<int16_t>(quantize(c[i], dq[i > 0]));
    deq[i] = static_cast<int16_t>(levels[i] * dq[i > 0]);
  }
  transform_add(deq, rec);
}

int64_t sse(const uint8_t* a, const uint8_t* b, int w, int h) {
  int64_t s = 0;
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      const int d = a[x + y * kBps] - b[x + y * kBps];
      s += d * d;
    }
  return s;
}

// a 16 x 16 luma mode: predict, code (Y2 for the DCs), reconstruct into
// work; returns the SSE against src
int64_t code_i16(const uint8_t* src, uint8_t* work, int mode, int mb_x, int mb_y, const Quant& q,
                 MBCode& mb) {
  uint8_t* y = work + kYOff;
  predict_block(y, check_mode(mb_x, mb_y, mode), 16);
  int dcs[16];
  int16_t deq[16][16];
  for (int n = 0; n < 16; ++n) {
    int c[16];
    forward_dct(src + kYOff + kScan[n], y + kScan[n], c);
    dcs[n] = c[0];
    mb.levels[n][0] = 0;
    deq[n][0] = 0;
    for (int i = 1; i < 16; ++i) {
      mb.levels[n][i] = static_cast<int16_t>(quantize(c[i], q.y1[1]));
      deq[n][i] = static_cast<int16_t>(mb.levels[n][i] * q.y1[1]);
    }
  }
  int wht[16];
  forward_wht(dcs, wht);
  int16_t y2deq[16];
  for (int i = 0; i < 16; ++i) {
    mb.levels[24][i] = static_cast<int16_t>(quantize(wht[i], q.y2[i > 0]));
    y2deq[i] = static_cast<int16_t>(mb.levels[24][i] * q.y2[i > 0]);
  }
  int16_t dc_out[256];
  transform_wht(y2deq, dc_out);
  for (int n = 0; n < 16; ++n) {
    deq[n][0] = dc_out[16 * n];
    transform_add(deq[n], y + kScan[n]);
  }
  mb.is_i4x4 = 0;
  mb.ymode = mode;
  return sse(src + kYOff, y, 16, 16);
}

// B_PRED: each subblock in turn, its mode the one (of those allowed) with
// the least SSE after reconstruction
int64_t code_i4(const uint8_t* src, uint8_t* work, const Quant& q, MBCode& mb) {
  uint8_t* y = work + kYOff;
  int64_t total = 0;
  uint8_t trial[kWorkSize];
  for (int n = 0; n < 16; ++n) {
    int64_t best = -1;
    int best_mode = 0;
    for (int mode = 0; mode < NUM_BMODES; ++mode) {
      memcpy(trial, work, kWorkSize);
      uint8_t* d = trial + kYOff + kScan[n];
      predict4(d, mode);
      int16_t lv[16];
      code_block(src + kYOff + kScan[n], d, q.y1, lv);
      const int64_t e = sse(src + kYOff + kScan[n], d, 4, 4);
      if (best < 0 || e < best) {
        best = e;
        best_mode = mode;
      }
    }
    uint8_t* d = y + kScan[n];
    predict4(d, best_mode);
    code_block(src + kYOff + kScan[n], d, q.y1, mb.levels[n]);
    mb.imodes[n] = static_cast<uint8_t>(best_mode);
    total += best;
  }
  memset(mb.levels[24], 0, sizeof(mb.levels[24]));
  mb.is_i4x4 = 1;
  return total;
}

int64_t code_uv(const uint8_t* src, uint8_t* work, int mode, int mb_x, int mb_y, const Quant& q,
                MBCode& mb) {
  int64_t e = 0;
  for (int ch = 0; ch < 2; ++ch) {
    const int off = ch ? kVOff : kUOff;
    uint8_t* d = work + off;
    predict_block(d, check_mode(mb_x, mb_y, mode), 8);
    for (int n = 0; n < 4; ++n) {
      const int o = (n & 1) * 4 + (n >> 1) * 4 * kBps;
      code_block(src + off + o, d + o, q.uv, mb.levels[16 + 4 * ch + n]);
    }
    e += sse(src + off, d, 8, 8);
  }
  mb.uvmode = mode;
  return e;
}

void write_value(BoolEncoder& e, const uint8_t* p, int v) {
  if (v == 1) {
    e.put(p[2], 0);
    return;
  }
  e.put(p[2], 1);
  if (v <= 4) {
    e.put(p[3], 0);
    if (v == 2) {
      e.put(p[4], 0);
    } else {
      e.put(p[4], 1);
      e.put(p[5], v == 4);
    }
  } else if (v <= 10) {
    e.put(p[3], 1);
    e.put(p[6], 0);
    if (v <= 6) {
      e.put(p[7], 0);
      e.put(159, v == 6);
    } else {
      e.put(p[7], 1);
      e.put(165, (v - 7) >> 1);
      e.put(145, (v - 7) & 1);
    }
  } else {
    e.put(p[3], 1);
    e.put(p[6], 1);
    const int cat = v < 19 ? 0 : v < 35 ? 1 : v < 67 ? 2 : 3;
    e.put(p[8], cat >> 1);
    e.put(p[9 + (cat >> 1)], cat & 1);
    const uint8_t* tab = kCat3456[cat];
    int nb = 0;
    while (tab[nb]) ++nb;
    const int extra = v - (3 + (8 << cat));
    for (int i = 0; i < nb; ++i) e.put(tab[i], (extra >> (nb - 1 - i)) & 1);
  }
}

// one subblock's tokens with the default probabilities; returns what the
// decoder's GetCoeffs returns (the position after the last token)
int write_coeffs(BoolEncoder& e, const uint8_t (*probs)[3][11], int ctx, const int16_t* lv,
                 int first) {
  int last = -1;
  for (int n = first; n < 16; ++n)
    if (lv[kZigzag[n]]) last = n;
  const uint8_t* p = probs[kBands[first]][ctx];
  if (last < 0) {
    e.put(p[0], 0);
    return first;
  }
  for (int n = first; n <= last;) {
    e.put(p[0], 1);
    while (lv[kZigzag[n]] == 0) {
      e.put(p[1], 0);
      p = probs[kBands[++n]][0];
    }
    e.put(p[1], 1);
    const int v = abs(lv[kZigzag[n]]);
    write_value(e, p, v);
    e.put(128, lv[kZigzag[n]] < 0);
    ++n;
    p = probs[kBands[n]][v == 1 ? 1 : 2];
    if (n > last && n < 16) e.put(p[0], 0);
  }
  return last + 1;
}

void write_bmode(BoolEncoder& e, const uint8_t* prob, int mode) {
  // the path from the root of kYModesIntra4 to the leaf -mode
  int path[10][2], len = 0;
  struct Walk {
    static bool find(int node, int mode, int (*path)[2], int& len) {
      for (int b = 0; b < 2; ++b) {
        const int next = kYModesIntra4[2 * node + b];
        path[len][0] = node;
        path[len][1] = b;
        ++len;
        if (next <= 0 ? -next == mode : find(next, mode, path, len)) return true;
        --len;
      }
      return false;
    }
  };
  Walk::find(0, mode, path, len);
  for (int i = 0; i < len; ++i) e.put(prob[path[i][0]], path[i][1]);
}

}  // namespace

// A VP8 key frame of width x height from the planes y (stride 16 mb_w,
// 16 mb_h rows, the image's edges replicated), u and v (stride 8 mb_w):
// quantiser index q for every coefficient, no segments, the loop filter
// (filter_type 0 none, 1 simple, 2 normal) at level and sharpness,
// 1 << log2_parts token partitions, default token probabilities, and per
// macroblock the least-error mode of DC / V / H / TM and B_PRED with all
// ten subblock modes. Writes the frame (tag onwards) to dst;
// returns its size, or -1 when cap is too small.
int64_t vp8_encode(const uint8_t* yp, const uint8_t* up, const uint8_t* vp, int width, int height,
                   int q, int filter_type, int level, int sharpness, int log2_parts,
                   uint8_t* dst, int64_t cap) {
  const int mb_w = (width + 15) >> 4, mb_h = (height + 15) >> 4;
  const int ys = 16 * mb_w, uvs = 8 * mb_w;
  Quant quant;
  quant.y1[0] = kDcTable[q];
  quant.y1[1] = kAcTable[q];
  quant.y2[0] = kDcTable[q] * 2;
  quant.y2[1] = (kAcTable[q] * 101581) >> 16;
  if (quant.y2[1] < 8) quant.y2[1] = 8;
  quant.uv[0] = kDcTable[q < 117 ? q : 117];
  quant.uv[1] = kAcTable[q];
  std::vector<MBCode> mbs(static_cast<size_t>(mb_w) * mb_h);
  std::vector<uint8_t> top_y(16 * mb_w), top_u(8 * mb_w), top_v(8 * mb_w);
  uint8_t work[kWorkSize], src[kWorkSize], trial[kWorkSize], best_work[kWorkSize];
  memset(work, 0, sizeof(work));
  memset(src, 0, sizeof(src));
  int skipped = 0;
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      MBCode& mb = mbs[static_cast<size_t>(mb_y) * mb_w + mb_x];
      memset(&mb, 0, sizeof(mb));
      for (int j = 0; j < 16; ++j)
        memcpy(src + kYOff + j * kBps, yp + static_cast<size_t>(mb_y * 16 + j) * ys + mb_x * 16, 16);
      for (int j = 0; j < 8; ++j) {
        memcpy(src + kUOff + j * kBps, up + static_cast<size_t>(mb_y * 8 + j) * uvs + mb_x * 8, 8);
        memcpy(src + kVOff + j * kBps, vp + static_cast<size_t>(mb_y * 8 + j) * uvs + mb_x * 8, 8);
      }
      set_borders(work, mb_x, mb_y, mb_w, top_y.data(), top_u.data(), top_v.data());
      int64_t best = -1;
      MBCode trial_mb;
      for (int mode : {DC_PRED, V_PRED, H_PRED, TM_PRED}) {
        memcpy(trial, work, kWorkSize);
        trial_mb = mb;
        const int64_t e = code_i16(src, trial, mode, mb_x, mb_y, quant, trial_mb);
        if (best < 0 || e < best) {
          best = e;
          memcpy(best_work, trial, kWorkSize);
          mb = trial_mb;
        }
      }
      memcpy(trial, work, kWorkSize);
      trial_mb = mb;
      if (code_i4(src, trial, quant, trial_mb) < best) {
        memcpy(best_work, trial, kWorkSize);
        mb = trial_mb;
      }
      memcpy(work, best_work, kWorkSize);
      best = -1;
      for (int mode : {DC_PRED, V_PRED, H_PRED, TM_PRED}) {
        memcpy(trial, work, kWorkSize);
        trial_mb = mb;
        const int64_t e = code_uv(src, trial, mode, mb_x, mb_y, quant, trial_mb);
        if (best < 0 || e < best) {
          best = e;
          memcpy(best_work, trial, kWorkSize);
          mb = trial_mb;
        }
      }
      memcpy(work, best_work, kWorkSize);
      bool any = false;
      for (int b = 0; b < 25 && !any; ++b)
        for (int i = 0; i < 16; ++i)
          if (mb.levels[b][i]) {
            any = true;
            break;
          }
      mb.skip = !any;
      skipped += mb.skip;
      if (mb_y < mb_h - 1) {
        memcpy(top_y.data() + 16 * mb_x, work + kYOff + 15 * kBps, 16);
        memcpy(top_u.data() + 8 * mb_x, work + kUOff + 7 * kBps, 8);
        memcpy(top_v.data() + 8 * mb_x, work + kVOff + 7 * kBps, 8);
      }
    }
  }
  // the first partition: the header, then every macroblock's modes
  const int n_mb = mb_w * mb_h;
  int skip_p = 255 - (255 * skipped) / n_mb;  // P(not skipped)
  skip_p = skip_p < 1 ? 1 : skip_p > 255 ? 255 : skip_p;
  BoolEncoder hdr;
  hdr.put(128, 0);  // colour space
  hdr.put(128, 0);  // clamping type
  hdr.put(128, 0);  // no segmentation
  hdr.put(128, filter_type == 1);
  hdr.literal(filter_type ? level : 0, 6);
  hdr.literal(sharpness, 3);
  hdr.put(128, 0);  // no loop-filter deltas
  hdr.literal(log2_parts, 2);
  hdr.literal(q, 7);
  for (int i = 0; i < 5; ++i) hdr.put(128, 0);  // no quantiser deltas
  hdr.put(128, 0);  // refresh entropy probabilities
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) hdr.put(kCoeffsUpdateProba[t][b][c][p], 0);
  hdr.put(128, 1);
  hdr.literal(skip_p, 8);
  const int num_parts = 1 << log2_parts;
  std::vector<BoolEncoder> parts(num_parts);
  std::vector<uint8_t> intra_t(4 * mb_w, B_DC_PRED), top_nz(9 * mb_w, 0);
  const uint8_t (*bands[4])[3][11] = {kCoeffsProba0[0], kCoeffsProba0[1], kCoeffsProba0[2],
                                      kCoeffsProba0[3]};
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    uint8_t intra_l[4] = {B_DC_PRED, B_DC_PRED, B_DC_PRED, B_DC_PRED};
    uint8_t left_nz[9] = {0};
    BoolEncoder& tok = parts[mb_y & (num_parts - 1)];
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      const MBCode& mb = mbs[static_cast<size_t>(mb_y) * mb_w + mb_x];
      uint8_t* top = intra_t.data() + 4 * mb_x;
      hdr.put(skip_p, mb.skip);
      hdr.put(145, !mb.is_i4x4);
      if (!mb.is_i4x4) {
        const int m = mb.ymode;
        if (m == DC_PRED || m == V_PRED) {
          hdr.put(156, 0);
          hdr.put(163, m == V_PRED);
        } else {
          hdr.put(156, 1);
          hdr.put(128, m == TM_PRED);
        }
        memset(top, m, 4);
        memset(intra_l, m, 4);
      } else {
        for (int y = 0; y < 4; ++y) {
          for (int x = 0; x < 4; ++x) {
            const int m = mb.imodes[4 * y + x];
            write_bmode(hdr, kBModesProba[top[x]][intra_l[y]], m);
            top[x] = intra_l[y] = static_cast<uint8_t>(m);
          }
        }
      }
      const int uvm = mb.uvmode;
      hdr.put(142, uvm != DC_PRED);
      if (uvm != DC_PRED) {
        hdr.put(114, uvm != V_PRED);
        if (uvm != V_PRED) hdr.put(183, uvm == TM_PRED);
      }
      uint8_t* tnz = top_nz.data() + 9 * mb_x;
      if (mb.skip) {
        memset(tnz, 0, 8);
        memset(left_nz, 0, 8);
        if (!mb.is_i4x4) tnz[8] = left_nz[8] = 0;
        continue;
      }
      int first = 0;
      const uint8_t (*ac)[3][11] = bands[3];
      if (!mb.is_i4x4) {
        const int nz = write_coeffs(tok, bands[1], tnz[8] + left_nz[8], mb.levels[24], 0);
        tnz[8] = left_nz[8] = nz > 0;
        first = 1;
        ac = bands[0];
      }
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) {
          const int nz = write_coeffs(tok, ac, tnz[x] + left_nz[y], mb.levels[4 * y + x], first);
          tnz[x] = left_nz[y] = nz > first;
        }
      for (int ch = 0; ch < 4; ch += 2)
        for (int y = 0; y < 2; ++y)
          for (int x = 0; x < 2; ++x) {
            const int nz = write_coeffs(tok, bands[2], tnz[4 + ch + x] + left_nz[4 + ch + y],
                                        mb.levels[16 + 2 * ch + 2 * y + x], 0);
            tnz[4 + ch + x] = left_nz[4 + ch + y] = nz > 0;
          }
    }
  }
  hdr.flush();
  for (BoolEncoder& p : parts) p.flush();
  const size_t part0 = hdr.out.size();
  size_t total = 10 + part0 + 3 * (num_parts - 1);
  for (const BoolEncoder& p : parts) total += p.out.size();
  if (static_cast<int64_t>(total) > cap || part0 >= (1u << 19)) return -1;
  const uint32_t tag = (1u << 4) | (static_cast<uint32_t>(part0) << 5);  // key frame, shown
  uint8_t* o = dst;
  *o++ = tag & 0xff;
  *o++ = (tag >> 8) & 0xff;
  *o++ = (tag >> 16) & 0xff;
  *o++ = 0x9d;
  *o++ = 0x01;
  *o++ = 0x2a;
  *o++ = width & 0xff;
  *o++ = (width >> 8) & 0x3f;
  *o++ = height & 0xff;
  *o++ = (height >> 8) & 0x3f;
  memcpy(o, hdr.out.data(), part0);
  o += part0;
  for (int p = 0; p + 1 < num_parts; ++p) {
    const size_t n = parts[p].out.size();
    *o++ = n & 0xff;
    *o++ = (n >> 8) & 0xff;
    *o++ = (n >> 16) & 0xff;
  }
  for (const BoolEncoder& p : parts) {
    memcpy(o, p.out.data(), p.out.size());
    o += p.out.size();
  }
  return static_cast<int64_t>(total);
}

}  // extern "C"
