// The serial parts of utils/image_encode.py, the small writers with which
// the tests and chip_smoke.py make TIFF, BMP and JPEG variants without PIL:
// the arithmetic coding of a JPEG scan (ITU T.81 Annex D and F.1.4 / G.1.3,
// as libjpeg's jcarith.c codes it) and TIFF's LZW. Built with g++ into a
// shared library with a plain C interface by _build.py at first use, like
// image_decode.cpp.
//
// Neither function allocates; the caller passes every buffer. Each returns
// the number of bytes written, or -1 when the output buffer is too small.

#include <cstdint>

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

}  // extern "C"
