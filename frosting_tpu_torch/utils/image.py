"""PNG, JPEG, TIFF and BMP decoding, and PIL's default resize, without PIL.

The JAX package reads ground-truth images as ``np.asarray(Image.open(p))``
and resizes them with ``im.resize((w, h))`` (``frosting_tpu/scene/
dataset.py``). The port must run where PIL is not installed, so it decodes
the files itself and aims at the same arrays, bit for bit (against Pillow
12.1.0 with libjpeg-turbo 3.1 and libtiff 4.7; ``tests/test_torch_image.py``
and ``tests/test_torch_image_formats.py``). The container is told by its
magic bytes. Each image comes back in PIL's mode, quirks included:

* PNG: colour types 0, 2, 3 and 6 at 8 bit, 16-bit grey and RGB(A), grey
  and palette images at 1, 2 and 4 bits, interlaced (Adam7) or not. A
  palette image comes back as its indices ("P"), 16-bit grey as uint16
  ("I;16"), 16-bit RGB(A) as the high byte of each sample, 1-bit grey as
  bool ("1"), 2- and 4-bit grey scaled to 8 bits ("L"). Grey + alpha
  ("LA"), which no trainer can use, raises ValueError.
* JPEG (libjpeg-turbo's default decoding, specified in integers: the
  ``JDCT_ISLOW`` IDCT of ``jidctint.c``, ``jdsample.c``'s upsamplers,
  ``jdcolor.c``'s fixed-point tables): Huffman- or arithmetic-coded
  (``jdarith.c``: the Q-coder, DAC conditioning, restarts), sequential or
  progressive (spectral selection, successive approximation, end-of-band
  runs), with ``jdcoefct.c``'s block smoothing where a progressive file
  leaves its first AC coefficients unrefined; lossless (SOF3, predictors
  1-7, point transform; 1 x 1 sampling); 8-bit; grey, YCbCr or RGB (as
  libjpeg decides), CMYK and YCCK (Adobe transforms 0 and 2, returned as
  Pillow returns them, "CMYK" with every byte inverted); every integral
  sampling up to 4 x 4 (fancy h2v1 / h1v2 / h2v2, box replication for the
  rest); restart markers. EXIF orientation is not applied, as
  ``np.asarray(Image.open(p))`` does not apply it. 12-bit, hierarchical and
  arithmetic-coded lossless files raise NotImplementedError, as do MCUs of
  more than 10 blocks (ValueError); Pillow refuses all but the last.
* TIFF (the first image): uncompressed, LZW, Deflate and PackBits, the
  horizontal predictor at 8 and 16 bits, strips and tiles, chunky and
  planar, either byte order; bilevel ("1"), grey ("L", min-is-white
  inverted), 16-bit grey ("I;16", or "I;16B" for an uncompressed
  big-endian file), palette ("P", indices), RGB, RGBA (associated alpha
  divided out as Pillow divides it), 16-bit RGB(A) as the high bytes, CMYK.
  JPEG-in-TIFF, other compressions, BigTIFF, fill order 2 and the layouts
  Pillow refuses or misreads raise NotImplementedError.
* BMP: 1-, 4- and 8-bit palettes (indices, or "L" / "1" for a grey ramp or
  black and white, as Pillow decides), RLE8 and RLE4 (Pillow's reading,
  quirks included), 16-bit 5-5-5 and 5-6-5, 24- and 32-bit, the
  BI_BITFIELDS layouts Pillow knows, OS/2 and V2-V5 headers, bottom-up and
  top-down rows.
* Other containers (GIF, WebP, JPEG 2000, ...) raise ValueError.
* resize: Pillow's BICUBIC (its default filter), horizontal pass then
  vertical: in fixed point with 22 precision bits for 8-bit modes ("L",
  "RGB", "CMYK"; "RGBA" premultiplied), each pass clipped to uint8; in
  float64 for "I;16" / "I;16B" with Pillow's byte clipping; palette and
  1-bit images by NEAREST, as PIL does.

The serial parts (PNG's row filters, JPEG's entropy decoding, lossless
prediction and block smoothing, TIFF's LZW and PackBits, BMP's RLE) are
C++ (``csrc/image_decode.cpp``, built with g++ at first use by
``_build.py``).
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Tuple

import numpy as np

from frosting_tpu_torch import _build

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PTR = ctypes.c_void_p
_I64 = ctypes.c_int64

# (colour type, bit depth) -> (channels, PIL mode)
_PNG_MODES = {
    (0, 1): (1, "1"),
    (0, 2): (1, "L"),
    (0, 4): (1, "L"),
    (0, 8): (1, "L"),
    (0, 16): (1, "I;16"),
    (2, 8): (3, "RGB"),
    (2, 16): (3, "RGB"),
    (3, 1): (1, "P"),
    (3, 2): (1, "P"),
    (3, 4): (1, "P"),
    (3, 8): (1, "P"),
    (4, 8): (2, "LA"),
    (4, 16): (2, "LA"),
    (6, 8): (4, "RGBA"),
    (6, 16): (4, "RGBA"),
}


def _lib() -> ctypes.CDLL:
    lib = _build.load("image_decode")
    lib.png_unfilter.argtypes = [_PTR, _I64, _I64, _I64, _PTR]
    lib.png_unfilter.restype = ctypes.c_int
    lib.jpeg_decode_scan.argtypes = [
        _PTR, _I64, _PTR, ctypes.c_int, _PTR, _PTR, _I64, _I64, _I64,
        ctypes.POINTER(_I64),
    ]
    lib.jpeg_decode_scan.restype = ctypes.c_int
    lib.jpeg_decode_progressive_scan.argtypes = lib.jpeg_decode_scan.argtypes[:-1] + [
        ctypes.c_int] * 4 + [ctypes.POINTER(_I64)]
    lib.jpeg_decode_progressive_scan.restype = ctypes.c_int
    _INT = ctypes.c_int
    signatures = {
        "jpeg_decode_arith_scan": [_PTR, _I64, _PTR, _INT, _PTR, _PTR, _I64, _I64, _I64, _INT,
                                   _INT, _INT, _INT, _INT, ctypes.POINTER(_I64)],
        "jpeg_decode_lossless_scan": [_PTR, _I64, _PTR, _INT, _PTR, _PTR, _I64, _I64, _I64,
                                      ctypes.POINTER(_I64)],
        "jpeg_lossless_undifference": [_PTR, _I64, _I64, _INT, _INT, _INT, _PTR],
        "jpeg_smooth_blocks": [_PTR, _I64, _I64, _I64, _I64, _INT, _I64, _PTR, _PTR, _PTR],
        "tiff_lzw_decode": [_PTR, _I64, _PTR, _I64, ctypes.POINTER(_I64)],
        "tiff_packbits_decode": [_PTR, _I64, _PTR, _I64, ctypes.POINTER(_I64)],
        "bmp_rle_decode": [_PTR, _I64, _I64, _INT, _I64, _I64, _PTR, ctypes.POINTER(_I64)],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _png_chunks(data: bytes):
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + n]
        if kind == b"IEND":
            return
        pos += 12 + n


# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _png_samples(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """Unfiltered rows [h, stride] -> samples [h, width, channels]: uint8
    for depths up to 8 (unscaled), big-endian pairs as uint16 for 16."""
    h = rows.shape[0]
    if depth == 16:
        return rows[:, :2 * width * channels].view(">u2").reshape(h, width, channels)
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    bits = np.unpackbits(rows, axis=1)[:, :width * channels * depth]
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits.reshape(h, width * channels, depth) * weights).sum(
        axis=2, dtype=np.uint8).reshape(h, width, channels)


def decode_png(data: bytes) -> Tuple[np.ndarray, str]:
    """PNG bytes -> (array, mode) as ``np.asarray(Image.open(...))`` and
    ``Image.mode`` give them."""
    ihdr, idat = None, []
    for kind, body in _png_chunks(data):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _comp, _filter, interlace = ihdr
    if (ctype, depth) not in _PNG_MODES:
        raise NotImplementedError(f"PNG colour type {ctype} at {depth} bits")
    channels, mode = _PNG_MODES[ctype, depth]
    if mode == "LA":
        raise ValueError("grey + alpha (LA) PNG: no trainer takes two channels")
    if interlace > 1:
        raise ValueError(f"unknown PNG interlace method {interlace}")
    bpp = max(1, channels * depth // 8)  # the filters' byte step
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    lib = _lib()
    # an interlaced image gathers its passes; a plain one is its only pass
    px = np.empty((h, w, channels), np.uint16 if depth == 16 else np.uint8) if interlace else None
    pos = 0
    for x0, y0, dx, dy in _ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:  # an empty pass has no bytes
            continue
        stride = -(-pw * channels * depth // 8)
        if raw.size < pos + ph * (stride + 1):
            raise ValueError("truncated PNG image data")
        rows = np.empty((ph, stride), np.uint8)
        if lib.png_unfilter(raw.ctypes.data + pos, ph, stride, bpp, rows.ctypes.data):
            raise ValueError("PNG row with an unknown filter type")
        pos += ph * (stride + 1)
        samples = _png_samples(rows, pw, channels, depth)
        if interlace:
            px[y0::dy, x0::dx] = samples
        else:
            px = samples
    if mode == "I;16":
        return px[..., 0].astype(np.uint16), mode
    if depth == 16:
        px = (px >> 8).astype(np.uint8)  # PIL keeps the high byte
    elif mode == "1":
        px = px != 0
    elif mode == "L" and depth < 8:
        px = px * np.uint8(255 // ((1 << depth) - 1))  # PIL's L;2 and L;4
    return (px[..., 0] if channels == 1 else px), mode


# --- JPEG -----------------------------------------------------------------

# zig-zag position -> natural position in the 8x8 block
_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])
# SOF markers: (entropy coding, progressive); the hierarchical ones
# libjpeg refuses (JERR_SOF_UNSUPPORTED), and so does Pillow
_SOF = {
    0xC0: ("huffman", False), 0xC1: ("huffman", False), 0xC2: ("huffman", True),
    0xC9: ("arithmetic", False), 0xCA: ("arithmetic", True), 0xC3: ("lossless", False),
}
_SOF_UNSUPPORTED = {
    0xC5: "hierarchical", 0xC6: "hierarchical progressive", 0xC7: "hierarchical lossless",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
    0xCE: "arithmetic-coded hierarchical", 0xCF: "arithmetic-coded hierarchical",
}

# jidctint.c: CONST_BITS 13, PASS1_BITS 2 and its FIX_* constants
_CB, _P1 = 13, 2
_F0298, _F0390, _F0541, _F0765 = 2446, 3196, 4433, 6270
_F0899, _F1175, _F1501, _F1847 = 7373, 9633, 12299, 15137
_F1961, _F2053, _F2562, _F3072 = 16069, 16819, 20995, 25172


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(c):
    """The linear part of one 8-point pass of jpeg_idct_islow: the butterfly
    over c[0..7] (arrays or ints) before its final descale. Returns the 8
    outputs, each an integer combination of the inputs."""
    z1 = (c[2] + c[6]) * _F0541
    tmp2 = z1 + c[6] * -_F1847
    tmp3 = z1 + c[2] * _F0765
    tmp0 = (c[0] + c[4]) * (1 << _CB)
    tmp1 = (c[0] - c[4]) * (1 << _CB)
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = c[7], c[5], c[3], c[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * _F1175
    o0, o1, o2, o3 = o0 * _F0298, o1 * _F2053, o2 * _F3072, o3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
    return [t10 + o3, t11 + o2, t12 + o1, t13 + o0, t13 - o0, t12 - o1, t11 - o2, t10 - o3]


# The butterfly as an integer matrix: output j = sum_k _IDCT[j, k] c[k].
# Products and sums of the passes stay below 2^53, so float64 matrix
# products compute them exactly.
_IDCT = np.array(_idct_1d(list(np.eye(8, dtype=np.int64))), np.float64)


# the post-IDCT range limit (jdmaster.c prepare_range_limit_table), indexed
# by the descaled output & 1023
_IDCT_LIMIT = np.concatenate([
    np.arange(128, 256), np.full(384, 255), np.zeros(384), np.arange(0, 128),
]).astype(np.uint8)


def _idct_islow(coefs: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """[..., 64] quantised coefficients (natural order) -> [..., 8, 8] uint8
    samples, jpeg_idct_islow exactly (its zero-AC shortcuts give the same
    values as the full computation): pass 1 over the columns, descaled by
    CONST_BITS - PASS1_BITS and kept as C ints, pass 2 over the rows,
    descaled by CONST_BITS + PASS1_BITS + 3."""
    deq = (coefs.astype(np.int64) * qtable.astype(np.int64)).reshape(
        coefs.shape[:-1] + (8, 8)).astype(np.float64)
    ws = _descale((_IDCT @ deq).astype(np.int64), _CB - _P1)
    ws = ws.astype(np.int32).astype(np.float64)
    out = _descale((ws @ _IDCT.T).astype(np.int64), _CB + _P1 + 3)
    return _IDCT_LIMIT[out & 1023]


def _fancy_h2(s: np.ndarray) -> np.ndarray:
    """Triangular 2x horizontal upsampling of int32 column sums, as
    jdsample.c's fancy upsamplers do it; s holds rows of one component
    (already vertically combined for h2v2: 3 x nearer row + further row).
    Returns the int32 numerators: even outputs 3 s[j] + s[j - 1], odd
    3 s[j] + s[j + 1], the first and last columns replicating the edge."""
    prev = np.concatenate([s[:, :1], s[:, :-1]], axis=1)
    nxt = np.concatenate([s[:, 1:], s[:, -1:]], axis=1)
    out = np.empty((s.shape[0], 2 * s.shape[1]), np.int32)
    out[:, 0::2] = 3 * s + prev
    out[:, 1::2] = 3 * s + nxt
    return out


def _upsample(plane: np.ndarray, h_ratio: int, v_ratio: int) -> np.ndarray:
    """One component (its real samples, uint8) upsampled by integral
    ratios (h, v) as libjpeg-turbo's jdsample.c picks the method with fancy
    upsampling on: h2v1 and h2v2 triangular where the component is more
    than 2 samples wide (else replicated), h1v2 triangular, and any other
    ratio by replication (int_upsample)."""
    if (h_ratio, v_ratio) == (1, 1):
        return plane
    s = plane.astype(np.int32)
    if (h_ratio, v_ratio) == (1, 2):
        above = np.concatenate([s[:1], s[:-1]], axis=0)
        below = np.concatenate([s[1:], s[-1:]], axis=0)
        rows = np.empty((2 * s.shape[0], s.shape[1]), np.int32)
        rows[0::2] = (3 * s + above + 1) >> 2
        rows[1::2] = (3 * s + below + 2) >> 2
        return rows.astype(np.uint8)
    if (h_ratio, v_ratio) not in ((2, 1), (2, 2)) or s.shape[1] <= 2:
        return np.repeat(np.repeat(plane, v_ratio, axis=0), h_ratio, axis=1)
    if v_ratio == 1:
        num = _fancy_h2(s)
        num[:, 0::2] += 1
        num[:, 1::2] += 2
        return (num >> 2).astype(np.uint8)
    above = np.concatenate([s[:1], s[:-1]], axis=0)
    below = np.concatenate([s[1:], s[-1:]], axis=0)
    rows = np.empty((2 * s.shape[0], s.shape[1]), np.int32)
    rows[0::2] = 3 * s + above
    rows[1::2] = 3 * s + below
    num = _fancy_h2(rows)
    num[:, 0::2] += 8
    num[:, 1::2] += 7
    return (num >> 4).astype(np.uint8)


def _ycc_tables():
    """jdcolor.c build_ycc_rgb_table (SCALEBITS 16)."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    cr_r = (fix(1.40200) * x + one_half) >> 16
    cb_b = (fix(1.77200) * x + one_half) >> 16
    cr_g = -fix(0.71414) * x
    cb_g = -fix(0.34414) * x + one_half
    # every entry and every sum below fits in 32 bits
    return tuple(t.astype(np.int32) for t in (cr_r, cb_b, cr_g, cb_g))


_YCC = _ycc_tables()


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    cr_r, cb_b, cr_g, cb_g = _YCC
    y = y.astype(np.int32)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _sof(seg: bytes):
    precision, height, width, n = struct.unpack(">BHHB", seg[:6])
    comps = [
        (seg[6 + 3 * i], seg[7 + 3 * i] >> 4, seg[7 + 3 * i] & 15, seg[8 + 3 * i])
        for i in range(n)
    ]  # (id, h, v, quant table)
    return precision, height, width, comps


def _scan_layout(seg, frame, arrays, block=8):
    """The scan whose SOS header is seg, over the frame's per-component
    arrays (coefficient blocks, or a lossless scan's samples with
    block = 1): (components in the scan, their frame indices, the C
    decoders' per-component ints, pointers to the arrays, MCUs across and
    down)."""
    _p, height, width, comps = frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    ns = seg[0]
    index = {c[0]: i for i, c in enumerate(comps)}
    params, ptrs, cis = [], [], []
    for j in range(ns):
        if seg[1 + 2 * j] not in index:
            raise ValueError("JPEG scan of a component the frame does not have")
        ci = index[seg[1 + 2 * j]]
        td, ta = seg[2 + 2 * j] >> 4, seg[2 + 2 * j] & 15
        _id, h, v, _q = comps[ci]
        arr = arrays[ci]
        # a non-interleaved scan has one block per MCU
        params.append((1, 1, td, ta, arr.shape[1]) if ns == 1 else (h, v, td, ta, arr.shape[1]))
        ptrs.append(arr.ctypes.data)
        cis.append(ci)
    if ns > 1 and sum(comps[ci][1] * comps[ci][2] for ci in cis) > 10:
        raise ValueError("JPEG MCU of more than 10 blocks (libjpeg's JERR_BAD_MCU_SIZE)")
    if ns == 1:
        _id, h, v, _q = comps[cis[0]]
        mcus_x = -(-(-(-width * h // hmax)) // block)
        mcus_y = -(-(-(-height * v // vmax)) // block)
    else:
        mcus_x = -(-width // (block * hmax))
        mcus_y = -(-height // (block * vmax))
    return (ns, cis, np.array(params, np.int32), (ctypes.c_void_p * ns)(*ptrs), mcus_x,
            mcus_y)


def _decode_scan(lib, data, pos, seg, frame, coefs, tables, restart, kind, progressive,
                 coef_bits, cond):
    """Decode the DCT scan whose SOS header is seg and whose data start at
    pos into coefs: Huffman (tables: the DHT tables) or arithmetic (cond:
    DAC's L, U and K per table) coding, sequential or progressive (a
    progressive frame's scans update the blocks in place, and coef_bits
    records per component the point transform each coefficient is known
    to, -1 before its first scan). Returns the offset where the scan's data
    end."""
    ns, cis, comp, ptrs, mcus_x, mcus_y = _scan_layout(seg, frame, coefs)
    ss, se = seg[1 + 2 * ns], seg[2 + 2 * ns]
    ah, al = seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
    buf = np.frombuffer(data, np.uint8)[pos:]
    consumed = _I64(0)
    args = (buf.ctypes.data, buf.size)
    tail = (ns, comp.ctypes.data, ptrs, mcus_x, mcus_y, restart)
    if kind == "arithmetic":
        err = lib.jpeg_decode_arith_scan(*args, cond.ctypes.data, *tail, int(progressive), ss,
                                         se, ah, al, ctypes.byref(consumed))
    elif progressive:
        err = lib.jpeg_decode_progressive_scan(*args, tables.ctypes.data, *tail, ss, se, ah, al,
                                               ctypes.byref(consumed))
    else:
        err = lib.jpeg_decode_scan(*args, tables.ctypes.data, *tail, ctypes.byref(consumed))
    if err:
        raise ValueError(f"corrupt JPEG scan (decoder error {err})")
    if progressive:
        for ci in cis:
            coef_bits[ci][ss:se + 1] = al
    return pos + consumed.value


def _decode_lossless_scan(lib, data, pos, seg, frame, diffs, tables, restart, samples):
    """Decode a lossless scan (SOF3) and undo its prediction: samples[ci]
    receives each scanned component's values, shifted back by the point
    transform and cut to 8 bits as libjpeg's 8-bit output does."""
    precision, _h, _w, _c = frame
    ns, cis, comp, ptrs, mcus_x, mcus_y = _scan_layout(seg, frame, diffs, block=1)
    psv, al = seg[1 + 2 * ns], seg[3 + 2 * ns] & 15
    if restart and restart % mcus_x:
        raise NotImplementedError("lossless JPEG whose restarts do not fall on row starts")
    buf = np.frombuffer(data, np.uint8)[pos:]
    consumed = _I64(0)
    err = lib.jpeg_decode_lossless_scan(buf.ctypes.data, buf.size, tables.ctypes.data, ns,
                                        comp.ctypes.data, ptrs, mcus_x, mcus_y, restart,
                                        ctypes.byref(consumed))
    if err:
        raise ValueError(f"corrupt lossless JPEG scan (decoder error {err})")
    for ci in cis:
        rows, cols = diffs[ci].shape
        first = np.zeros(rows, np.uint8)
        first[::max(1, restart // mcus_x) if restart else rows] = 1
        if lib.jpeg_lossless_undifference(diffs[ci].ctypes.data, rows, cols, psv, precision, al,
                                          first.ctypes.data):
            raise ValueError(f"lossless JPEG predictor {psv}")
        samples[ci] = ((diffs[ci] << al) & 0xFF).astype(np.uint8)
    return pos + consumed.value


def _smoothing_ok(coef_bits, qtables, comps) -> bool:
    """jdcoefct.c smoothing_ok: a progressive image is smoothed when every
    component's DC is known, its quantisers of the DC and the first nine
    AC coefficients are nonzero, and some of those nine is not known to
    its last bit."""
    zz = _NATURAL[:10]
    if any((qtables[tq][zz] == 0).any() for _i, _h, _v, tq in comps):
        return False
    return bool((coef_bits[:, 0] >= 0).all() and (coef_bits[:, 1:10] != 0).any())


def _smooth(lib, arr, comp, frame, qtable, coef_bits):
    """One component's blocks after libjpeg's block smoothing."""
    _p, height, width, comps = frame
    _id, h, v, _q = comp
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    rows_real = -(-(-(-height * v // vmax)) // 8)
    cols_real = -(-(-(-width * h // hmax)) // 8)
    imcu_rows = -(-height // (8 * vmax))
    out = np.empty_like(arr)
    q = np.ascontiguousarray(qtable, np.int32)
    bits = np.ascontiguousarray(coef_bits[:10], np.int32)
    lib.jpeg_smooth_blocks(arr.ctypes.data, arr.shape[0], arr.shape[1], rows_real, cols_real,
                           v, imcu_rows, q.ctypes.data,
                           bits.ctypes.data, out.ctypes.data)
    return out


def _jpeg_read(data: bytes):
    """Parse a JPEG and entropy-decode every scan: a dict with the frame
    (precision, height, width, [(id, h, v, quant table)]), its coding
    ("huffman", "arithmetic" or "lossless") and progressiveness, the
    quantisation tables, the coefficient blocks (DCT) or samples
    (lossless), coef_bits, and the JFIF and Adobe markers."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    lib = _lib()
    st = {"qtables": {}, "frame": None, "jfif": False, "adobe": None, "restart": 0,
          "coef_bits": None, "kind": None, "progressive": False}
    tables = np.zeros((8, 272), np.uint8)
    cond = np.array([0] * 4 + [1] * 4 + [5] * 4, np.uint8)  # DAC defaults: L 0, U 1, K 5
    coefs = diffs = None
    pos = 2
    while True:
        while pos < len(data) and data[pos] != 0xFF:
            pos += 1
        while pos + 1 < len(data) and data[pos + 1] == 0xFF:
            pos += 1
        if pos + 1 >= len(data):
            raise ValueError("JPEG ends before EOI")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        (n,) = struct.unpack(">H", data[pos:pos + 2])
        seg = data[pos + 2:pos + n]
        pos += n
        if marker in _SOF_UNSUPPORTED:
            raise NotImplementedError(f"{_SOF_UNSUPPORTED[marker]} JPEG")
        if marker == 0xDB:
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                size = 128 if pq else 64
                raw = np.frombuffer(seg[i + 1:i + 1 + size], ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[_NATURAL] = raw
                st["qtables"][tq] = table
                i += 1 + size
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                bits = np.frombuffer(seg[i + 1:i + 17], np.uint8)
                n_vals = int(bits.sum())
                tables[4 * tc + th] = 0
                tables[4 * tc + th, :16] = bits
                tables[4 * tc + th, 16:16 + n_vals] = np.frombuffer(
                    seg[i + 17:i + 17 + n_vals], np.uint8)
                i += 17 + n_vals
        elif marker == 0xCC:
            for i in range(0, len(seg) - 1, 2):
                tc, tb = seg[i] >> 4, seg[i] & 15
                if tc == 0:
                    cond[tb], cond[4 + tb] = seg[i + 1] & 15, seg[i + 1] >> 4
                else:
                    cond[8 + tb] = seg[i + 1]
        elif marker == 0xDD:
            (st["restart"],) = struct.unpack(">H", seg[:2])
        elif marker in _SOF:
            st["kind"], st["progressive"] = _SOF[marker]
            st["frame"] = frame = _sof(seg)
            precision, height, width, comps = frame
            if precision != 8:  # Pillow opens 8-bit JPEGs only
                raise NotImplementedError(f"{precision}-bit JPEG")
            if len(comps) not in (1, 3, 4):
                raise NotImplementedError(f"JPEG with {len(comps)} components")
            if any(not (1 <= c[1] <= 4 and 1 <= c[2] <= 4) for c in comps):
                raise ValueError("JPEG sampling factor outside 1-4")
            hmax = max(c[1] for c in comps)
            vmax = max(c[2] for c in comps)
            if st["kind"] == "lossless":
                if hmax != 1 or vmax != 1:
                    raise NotImplementedError("lossless JPEG with subsampled components")
                diffs = [np.zeros((height, width), np.int32) for _ in comps]
                st["samples"] = [None] * len(comps)
            else:
                mx, my = -(-width // (8 * hmax)), -(-height // (8 * vmax))
                coefs = [np.zeros((my * c[2], mx * c[1], 64), np.int16) for c in comps]
                if st["progressive"]:
                    st["coef_bits"] = np.full((len(comps), 64), -1)
        elif marker == 0xDA:
            if st["frame"] is None:
                raise ValueError("JPEG scan before its frame header")
            if st["kind"] == "lossless":
                pos = _decode_lossless_scan(lib, data, pos, seg, st["frame"], diffs, tables,
                                            st["restart"], st["samples"])
            else:
                pos = _decode_scan(lib, data, pos, seg, st["frame"], coefs, tables,
                                   st["restart"], st["kind"], st["progressive"],
                                   st["coef_bits"], cond)
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            st["jfif"] = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            st["adobe"] = seg[11]
    if st["frame"] is None:
        raise ValueError("JPEG without a frame header")
    st["coefs"] = coefs
    return st


def _jpeg_colour(planes, comps, jfif, adobe):
    """jdapimin.c default_decompress_parms and jdcolor.c, then Pillow's
    rawmode: (array, mode)."""
    if len(planes) == 1:
        return planes[0], "L"
    if len(planes) == 4:
        # CMYK (Adobe transform 0, or no Adobe marker) or YCCK; libjpeg
        # outputs CMYK, which Pillow reads as "CMYK;I", inverting every
        # byte: YCCK's three colour bytes come out as its RGB
        if adobe is not None and adobe != 0:
            rgb = _ycc_to_rgb(*planes[:3])
            return np.concatenate([rgb, (255 - planes[3])[..., None]], axis=-1), "CMYK"
        return 255 - np.stack(planes, axis=-1), "CMYK"
    ids = tuple(c[0] for c in comps)
    # RGB only when the file says so
    if jfif:
        rgb = False
    elif adobe is not None:
        rgb = adobe == 0
    else:
        rgb = ids == (82, 71, 66)
    if rgb:
        return np.stack(planes, axis=-1), "RGB"
    return _ycc_to_rgb(*planes), "RGB"


def decode_jpeg(data: bytes) -> Tuple[np.ndarray, str]:
    """JPEG bytes -> (array, mode) as ``np.asarray(Image.open(...))`` and
    ``Image.mode`` give them with libjpeg-turbo's default decoding."""
    st = _jpeg_read(data)
    _p, height, width, comps = frame = st["frame"]
    if st["kind"] == "lossless":
        if any(s is None for s in st["samples"]):
            raise ValueError("lossless JPEG with a component no scan codes")
        return _jpeg_colour(st["samples"], comps, st["jfif"], st["adobe"])
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    coef_bits = st["coef_bits"]
    smooth = coef_bits is not None and _smoothing_ok(coef_bits, st["qtables"], comps)
    lib = _lib()
    planes = []
    for ci, ((_id, h, v, tq), arr) in enumerate(zip(comps, st["coefs"])):
        if hmax % h or vmax % v:  # jdsample.c JERR_FRACT_SAMPLE_NOTIMPL
            raise NotImplementedError("JPEG sampling factors that do not divide")
        if smooth:
            arr = _smooth(lib, arr, comps[ci], frame, st["qtables"][tq], coef_bits[ci])
        blocks = _idct_islow(arr, st["qtables"][tq])
        bh, bw = arr.shape[:2]
        plane = blocks.transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        # the component's real samples (jdmaster.c downsampled_width/height)
        plane = plane[:-(-height * v // vmax), :-(-width * h // hmax)]
        planes.append(_upsample(plane, hmax // h, vmax // v)[:height, :width])
    return _jpeg_colour(planes, comps, st["jfif"], st["adobe"])


# --- TIFF -----------------------------------------------------------------

_TIFF_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "I", 6: "b", 7: "B", 8: "h", 9: "i", 10: "i",
               11: "f", 12: "d", 16: "Q", 17: "q"}
_TIFF_COMPRESSION = {1: "none", 5: "lzw", 8: "deflate", 32946: "deflate", 32773: "packbits"}


def _tiff_tags(data: bytes):
    """(byte order, {tag: tuple of values}) of the first IFD."""
    order = "<" if data[:2] == b"II" else ">"
    (magic,) = struct.unpack(order + "H", data[2:4])
    if magic == 43:
        raise NotImplementedError("BigTIFF")
    if magic != 42:
        raise ValueError("not a TIFF file")
    (off,) = struct.unpack(order + "I", data[4:8])
    (n,) = struct.unpack(order + "H", data[off:off + 2])
    tags = {}
    for i in range(n):
        at = off + 2 + 12 * i
        tag, typ, count = struct.unpack(order + "HHI", data[at:at + 8])
        if typ not in _TIFF_TYPES:
            continue
        code = _TIFF_TYPES[typ]
        count *= 2 if typ in (5, 10) else 1  # rationals: numerator, denominator
        size = struct.calcsize(code) * count
        if size <= 4:
            raw = data[at + 8:at + 8 + size]
        else:
            (voff,) = struct.unpack(order + "I", data[at + 8:at + 12])
            raw = data[voff:voff + size]
        if len(raw) == size:
            tags[tag] = struct.unpack(order + code * count, raw)
    return order, tags


def _tiff_mode(order, photo, fmt, bps, extra):
    """Pillow's OPEN_INFO, the part the port reads: (mode, rawmode)."""
    key = (photo, fmt, bps, extra)
    if fmt == (1,) or (fmt == (2,) and bps == (8,) and photo == 1):
        table = {
            (0, (1,)): ("1", "1;I"), (1, (1,)): ("1", "1"),
            (0, (8,)): ("L", "L;I"), (1, (8,)): ("L", "L"),
            (0, (16,)): ("I;16", "I;16") if order == "<" else None,
            (1, (16,)): ("I;16", "I;16") if order == "<" else ("I;16B", "I;16B"),
            (3, (1,)): ("P", "P;1"), (3, (2,)): ("P", "P;2"), (3, (4,)): ("P", "P;4"),
            (3, (8,)): ("P", "P"),
        }
        if extra == () and (photo, bps) in table and table[photo, bps] is not None:
            return table[photo, bps]
        if fmt == (1,) and photo == 2:
            rgb = {
                ((8,) * 3, ()): ("RGB", "RGB"), ((8,) * 4, ()): ("RGBA", "RGBA"),
                ((8,) * 4, (0,)): ("RGB", "RGBX"), ((8,) * 4, (1,)): ("RGBA", "RGBa"),
                ((8,) * 4, (2,)): ("RGBA", "RGBA"), ((8,) * 4, (999,)): ("RGBA", "RGBA"),
                ((16,) * 3, ()): ("RGB", "RGB;16"), ((16,) * 4, ()): ("RGBA", "RGBA;16"),
                ((16,) * 4, (0,)): ("RGB", "RGBX;16"), ((16,) * 4, (2,)): ("RGBA", "RGBA;16"),
            }
            if (bps, extra) in rgb:
                return rgb[bps, extra]
        if fmt == (1,) and photo == 5 and bps == (8,) * 4 and extra == ():
            return "CMYK", "CMYK"
    if key[:3] == (1, (1,), (8, 8)) and extra == (2,):
        raise ValueError("grey + alpha (LA) TIFF: no trainer takes two channels")
    raise NotImplementedError(f"TIFF photometric {photo}, sample format {fmt}, "
                              f"bits {bps}, extra samples {extra}")


def _tiff_chunk(lib, raw: bytes, compression: str, size: int) -> np.ndarray:
    """One strip or tile decompressed to (at most) size bytes."""
    if compression == "none":
        return np.frombuffer(raw[:size], np.uint8)
    if compression == "deflate":
        d = zlib.decompressobj()
        return np.frombuffer(d.decompress(raw, size), np.uint8)
    src = np.frombuffer(raw, np.uint8)
    out = np.zeros(size, np.uint8)
    n = _I64(0)
    if compression == "lzw":
        if src.size >= 2 and src[0] == 0 and src[1] & 1:
            raise NotImplementedError("old-style (LSB-first) TIFF LZW")
        err = lib.tiff_lzw_decode(src.ctypes.data, src.size, out.ctypes.data, size,
                                  ctypes.byref(n))
    else:
        err = lib.tiff_packbits_decode(src.ctypes.data, src.size, out.ctypes.data, size,
                                       ctypes.byref(n))
    if err:
        raise ValueError("corrupt TIFF LZW data")
    return out[:n.value]


def decode_tiff(data: bytes) -> Tuple[np.ndarray, str]:
    """TIFF bytes (the first image) -> (array, mode) as
    ``np.asarray(Image.open(...))`` and ``Image.mode`` give them with
    Pillow's TIFF plugin (libtiff for compressed data)."""
    order, tags = _tiff_tags(data)
    width, height = tags[256][0], tags[257][0]
    spp = tags.get(277, (1,))[0]
    photo = tags.get(262, (0,))[0]
    fmt = tags.get(339, (1,))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bps = tags.get(258, (1,))
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    extra = tags.get(338, ())
    if len(bps) != spp:
        raise ValueError("TIFF: unknown data organization")
    if tags.get(266, (1,))[0] != 1:
        raise NotImplementedError("TIFF fill order 2")
    if tags.get(274, (1,))[0] in (5, 6, 7, 8):
        raise NotImplementedError("TIFF orientation that swaps the axes")
    mode, rawmode = _tiff_mode(order, photo, fmt, tuple(bps), tuple(extra))
    comp_code = tags.get(259, (1,))[0]
    if comp_code not in _TIFF_COMPRESSION:
        raise NotImplementedError(f"TIFF compression {comp_code}")
    compression = _TIFF_COMPRESSION[comp_code]
    planar = tags.get(284, (1,))[0] == 2
    predictor = tags.get(317, (1,))[0] if compression in ("lzw", "deflate") else 1
    if predictor not in (1, 2):
        raise NotImplementedError(f"TIFF predictor {predictor}")
    bits = bps[0]
    # Pillow reads a planar image's uncompressed planes with one character
    # of the rawmode each ("L;I" -> "L": no inversion); it refuses or
    # misreads the rest (16-bit planes as bytes at an 8-bit stride), and
    # libtiff refuses planar strips of extra samples that are not alpha
    raw_planar = planar and compression == "none"
    if planar and rawmode.startswith("RGBX"):
        raise NotImplementedError("planar TIFF with unspecified extra samples")
    if raw_planar and (rawmode == "RGBa" or bits == 16 or rawmode[:2] == "P;"):
        raise NotImplementedError(f"uncompressed planar {bits}-bit TIFF in mode {mode}")
    if raw_planar:
        rawmode = {"L;I": "L", "1;I": "1"}.get(rawmode, rawmode)
    if 322 in tags:  # tiles
        cw, ch = tags[322][0], tags[323][0]
        offsets, counts = tags[324], tags[325]
        across = -(-width // cw)
        origins = [((i % across) * cw, (i // across) * ch) for i in range(len(offsets))]
    else:
        cw, ch = width, min(tags.get(278, (height,))[0], height)
        offsets, counts = tags[273], tags.get(279, (len(data),) * len(tags[273]))
        origins = [(0, i * ch) for i in range(len(offsets))]
    planes = spp if planar else 1
    per_plane = len(offsets) // planes
    chunk_spp = 1 if planar else spp
    row_bytes = -(-cw * chunk_spp * bits // 8)
    dtype = np.dtype(order + "u2") if bits == 16 else np.uint8
    samples = np.zeros((spp, height, width) if planar else (height, width, spp),
                       np.uint16 if bits == 16 else np.uint8)
    lib = _lib()
    for i, (off, cnt) in enumerate(zip(offsets, counts)):
        p, j = divmod(i, per_plane)
        x0, y0 = origins[j]
        rows = ch if 322 in tags else min(ch, height - y0)
        buf = _tiff_chunk(lib, data[off:off + cnt], compression, rows * row_bytes)
        if buf.size < rows * row_bytes:
            buf = np.concatenate([buf, np.zeros(rows * row_bytes - buf.size, np.uint8)])
        rowsb = buf.reshape(rows, row_bytes)
        if bits == 16:
            px = rowsb.view(dtype).astype(np.uint16).reshape(rows, cw, chunk_spp)
        elif bits == 8:
            px = rowsb.reshape(rows, cw, chunk_spp)
        else:
            px = _png_samples(rowsb, cw, chunk_spp, bits)
        if predictor == 2:
            px = np.cumsum(px, axis=1, dtype=px.dtype)
        h_in, w_in = min(rows, height - y0), min(cw, width - x0)
        if h_in <= 0 or w_in <= 0:
            continue
        if planar:
            samples[p, y0:y0 + h_in, x0:x0 + w_in] = px[:h_in, :w_in, 0]
        else:
            samples[y0:y0 + h_in, x0:x0 + w_in] = px[:h_in, :w_in]
    if planar:
        samples = samples.transpose(1, 2, 0)
    if rawmode in ("1", "1;I"):
        return (samples[..., 0] != 0) ^ (rawmode == "1;I"), mode
    if rawmode == "L;I":
        return 255 - samples[..., 0], mode
    if mode in ("L", "P"):
        return samples[..., 0], mode
    if mode == "I;16":
        return samples[..., 0].astype("<u2"), mode
    if mode == "I;16B":
        return samples[..., 0].astype(">u2"), mode
    if bits == 16:
        samples = (samples >> 8).astype(np.uint8)  # Pillow's RGB;16: the high byte
    if rawmode.startswith("RGBX"):
        return np.ascontiguousarray(samples[..., :3]), mode
    if rawmode == "RGBa":  # associated alpha (Unpack.c unpackRGBa)
        a = samples[..., 3:].astype(np.int64)
        rgb = np.clip(samples[..., :3].astype(np.int64) * 255 // np.maximum(a, 1), 0, 255)
        rgb = np.where(a == 0, 0, np.where(a == 255, samples[..., :3], rgb))
        return np.concatenate([rgb, a], axis=-1).astype(np.uint8), mode
    return np.ascontiguousarray(samples[..., :len(mode)]), mode


# --- BMP ------------------------------------------------------------------

# bits -> (mode, rawmode) with no bitfields (Pillow's BIT2MODE)
_BMP_BITS = {1: ("P", "P;1"), 4: ("P", "P;4"), 8: ("P", "P"), 16: ("RGB", "BGR;15"),
             24: ("RGB", "BGR"), 32: ("RGB", "BGRX")}
# (bits, masks) -> rawmode of a BI_BITFIELDS file (Pillow's MASK_MODES)
_BMP_MASKS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)): "BGRX",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0x0)): "XBGR",
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)): "BGXR",
    (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)): "ABGR",
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)): "RGBA",
    (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)): "BGRA",
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)): "BGAR",
    (32, (0x0, 0x0, 0x0, 0x0)): "BGRA",
    (24, (0xFF0000, 0xFF00, 0xFF)): "BGR",
    (16, (0xF800, 0x7E0, 0x1F)): "BGR;16",
    (16, (0x7C00, 0x3E0, 0x1F)): "BGR;15",
}


def _bmp_pixels(rows: np.ndarray, width: int, rawmode: str) -> np.ndarray:
    """[h, stride] row bytes -> Pillow's unpacking of rawmode."""
    h = rows.shape[0]
    if rawmode in ("P;1", "1", "P;4"):
        depth = 1 if rawmode != "P;4" else 4
        px = _png_samples(np.ascontiguousarray(rows), width, 1, depth)[..., 0]
        return px != 0 if rawmode == "1" else px
    if rawmode in ("P", "L"):
        return rows[:, :width]
    if rawmode in ("BGR;15", "BGR;16"):
        v = rows[:, :2 * width].reshape(h, width, 2).astype(np.int32)
        px = v[..., 0] | (v[..., 1] << 8)
        g_bits = 6 if rawmode == "BGR;16" else 5
        r = (px >> (5 + g_bits)) & 31
        g = (px >> 5) & ((1 << g_bits) - 1)
        b = px & 31
        return np.stack([r * 255 // 31, g * 255 // ((1 << g_bits) - 1), b * 255 // 31],
                        axis=-1).astype(np.uint8)
    n = 3 if rawmode == "BGR" else 4
    px = rows[:, :n * width].reshape(h, width, n)
    order = [rawmode.index(c) for c in ("RGBA" if "A" in rawmode else "RGB")]
    return np.ascontiguousarray(px[..., order])


def decode_bmp(data: bytes) -> Tuple[np.ndarray, str]:
    """BMP bytes -> (array, mode) as ``np.asarray(Image.open(...))`` and
    ``Image.mode`` give them with Pillow's BMP plugin: a palette image as
    its indices ("P"), or as "L" or "1" where the palette is the grey ramp
    or black and white."""
    if data[:2] != b"BM":
        raise ValueError("not a BMP file")
    (offset,) = struct.unpack("<I", data[10:14])
    (hsize,) = struct.unpack("<I", data[14:18])
    head = data[18:14 + hsize]
    pos = 14 + hsize
    direction = -1
    if hsize == 12:
        width, height, _planes, bits = struct.unpack("<HHHH", head[:8])
        compression, colors, pal_pad = 0, 0, 3
    elif hsize in (40, 52, 56, 64, 108, 124):
        y_flip = head[7] == 0xFF
        direction = 1 if y_flip else -1
        width, h_raw, _planes, bits, compression = struct.unpack("<IIHHI", head[:16])
        height = 2 ** 32 - h_raw if y_flip else h_raw
        (colors,) = struct.unpack("<I", head[28:32])
        pal_pad = 4
    else:
        raise NotImplementedError(f"BMP header of {hsize} bytes")
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in _BMP_BITS:
        raise NotImplementedError(f"{bits}-bit BMP")
    mode, rawmode = _BMP_BITS[bits]
    rle = False
    if compression == 3:
        if len(head) >= 48:
            masks = struct.unpack("<4I" if len(head) >= 52 else "<3I",
                                  head[36:52 if len(head) >= 52 else 48])
        else:
            masks = struct.unpack("<3I", data[pos:pos + 12])
            pos += 12
        masks = tuple(masks) + (0,) * (4 - len(masks))
        key = (bits, masks) if bits == 32 else (bits, masks[:3])
        if key not in _BMP_MASKS:
            raise NotImplementedError("BMP bitfields layout")
        rawmode = _BMP_MASKS[key]
        if bits == 32 and "A" in rawmode:
            mode = "RGBA"
    elif compression in (1, 2):
        rle = True
    elif compression != 0:
        raise NotImplementedError(f"BMP compression {compression}")
    if mode == "P":
        if not 0 < colors <= 65536:
            raise ValueError(f"BMP palette of {colors} colours")
        palette = data[pos:pos + pal_pad * colors]
        ramp = (0, 255) if colors == 2 else range(colors)
        grey = all(palette[i * pal_pad:i * pal_pad + 3] == bytes([v]) * 3
                   for i, v in enumerate(ramp))
        if grey:
            mode = rawmode = "1" if colors == 2 else "L"
    if rle:
        if mode not in ("P", "L"):
            raise NotImplementedError(f"RLE BMP in mode {mode}")
        out = np.zeros(width * height, np.uint8)
        n = _I64(0)
        buf = np.frombuffer(data, np.uint8)
        _lib().bmp_rle_decode(buf.ctypes.data, buf.size, offset, int(compression == 2), width,
                              height, out.ctypes.data, ctypes.byref(n))
        if n.value < width * height:
            raise ValueError("not enough BMP image data")
        px = out.reshape(height, width)
    else:
        stride = ((width * bits + 31) >> 3) & ~3
        if len(data) < offset + stride * height:
            raise ValueError("truncated BMP image data")
        rows = np.frombuffer(data, np.uint8, stride * height, offset).reshape(height, stride)
        px = _bmp_pixels(rows, width, rawmode)
    if direction == -1:
        px = px[::-1]
    return np.ascontiguousarray(px), mode


# --- dispatch -------------------------------------------------------------

def _container(head: bytes) -> str:
    if head[:8] == PNG_SIGNATURE:
        return "png"
    if head[:2] == b"\xff\xd8":
        return "jpeg"
    if head[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+"):
        return "tiff"
    if head[:2] == b"BM":
        return "bmp"
    return "other"


_DECODERS = {"png": decode_png, "jpeg": decode_jpeg, "tiff": decode_tiff, "bmp": decode_bmp}


def decode(data: bytes) -> Tuple[np.ndarray, str]:
    """PNG, JPEG, TIFF or BMP bytes -> (array, PIL mode)."""
    kind = _container(data)
    if kind == "other":
        raise ValueError("not a PNG, JPEG, TIFF or BMP file: the other containers PIL reads "
                         "(GIF, WebP, JPEG 2000, ...) are still to be ported (ROADMAP A)")
    return _DECODERS[kind](data)


def read_image(path: str) -> Tuple[np.ndarray, str]:
    with open(path, "rb") as f:
        return decode(f.read())


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) from the file's header, as ``Image.open(p).size``."""
    with open(path, "rb") as f:
        head = f.read(32)
        kind = _container(head)
        if kind == "png":
            return struct.unpack(">II", head[16:24])
        if kind in ("tiff", "bmp"):
            f.seek(0)
            data = f.read()
            if kind == "tiff":
                _order, tags = _tiff_tags(data)
                return tags[256][0], tags[257][0]
            (hsize,) = struct.unpack("<I", data[14:18])
            if hsize == 12:
                return struct.unpack("<HH", data[18:22])
            width, h_raw = struct.unpack("<II", data[18:26])
            return width, (2 ** 32 - h_raw if data[25] == 0xFF else h_raw)
        if kind != "jpeg":
            raise ValueError(f"{path}: not a PNG, JPEG, TIFF or BMP file")
        f.seek(2)
        while True:
            marker = f.read(2)
            if len(marker) < 2 or marker[0] != 0xFF:
                raise ValueError(f"{path}: no JPEG frame header")
            (n,) = struct.unpack(">H", f.read(2))
            if 0xC0 <= marker[1] <= 0xCF and marker[1] not in (0xC4, 0xC8, 0xCC):
                _p, height, width = struct.unpack(">BHH", f.read(5))
                return width, height
            f.seek(n - 2, 1)


# --- resize (Pillow's Resample.c) ---------------------------------------

_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _weights(in_size: int, out_size: int):
    """precompute_coeffs for BICUBIC (support 2) over the box (0, in_size):
    (xmin [out], float64 weights [out, ksize], each row normalised by its
    sum taken in order), the weights past each output's xmax zero."""
    scale = filterscale = in_size / out_size
    filterscale = max(filterscale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = _bicubic(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5) * ss)
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for x in range(ksize):  # in order, as the C loop sums
        ww = ww + w[:, x]
    return xmin, np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)


def _coeffs(in_size: int, out_size: int):
    """The weights in fixed point, as normalize_coeffs_8bpc rounds them."""
    xmin, w = _weights(in_size, out_size)
    k = np.where(w < 0, -0.5 + w * (1 << _PRECISION_BITS),
                 0.5 + w * (1 << _PRECISION_BITS))
    return xmin, np.trunc(k).astype(np.int64)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass along axis: sum of taps in fixed point, clip8."""
    in_size = img.shape[axis]
    xmin, k = _coeffs(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    tail = (1,) * (src.ndim - 1)
    for x in range(k.shape[1]):
        idx = np.minimum(xmin + x, in_size - 1)
        acc += src[idx] * k[:, x].reshape((-1,) + tail)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _resample_axis_16(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass of ImagingResample{Horizontal,Vertical}_16bpc: float64
    taps summed in order, rounded half away from zero, then the low byte
    (the remainder, clipped) and the high byte (the quotient, clipped)
    written apart."""
    in_size = img.shape[axis]
    xmin, w = _weights(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.float64)
    acc = np.zeros((out_size,) + src.shape[1:])
    tail = (1,) * (src.ndim - 1)
    for x in range(w.shape[1]):
        idx = np.minimum(xmin + x, in_size - 1)
        acc = acc + src[idx] * w[:, x].reshape((-1,) + tail)
    r = np.where(acc >= 0, np.floor(acc + 0.5), -np.floor(np.abs(acc) + 0.5)).astype(np.int64)
    out = np.clip(np.fmod(r, 256), 0, 255) + 256 * np.clip(r >> 8, 0, 255)
    return np.moveaxis(out.astype(np.uint16), 0, axis)


def _bicubic_resize(img: np.ndarray, width: int, height: int) -> np.ndarray:
    if img.shape[1] != width:
        img = _resample_axis(img, width, 1)
    if img.shape[0] != height:
        img = _resample_axis(img, height, 0)
    return img


def _nearest_resize(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """ImagingScaleAffine's nearest sampling: source coordinates stepped
    by accumulation from the first pixel centre."""

    def coords(in_size, out_size):
        step = in_size / out_size
        pos = np.cumsum(np.concatenate([[step * 0.5], np.full(out_size - 1, step)]))
        return np.minimum(pos.astype(np.int64), in_size - 1)

    return img[coords(img.shape[0], height)][:, coords(img.shape[1], width)]


def resize(img: np.ndarray, mode: str, size: Tuple[int, int]) -> np.ndarray:
    """``Image.resize(size)`` with Pillow's default filter: BICUBIC for
    "L", "RGB", "CMYK" and "RGBA" (premultiplied) in fixed point, for
    "I;16" and "I;16B" in float64 (the 16-bit passes read and write both
    as little-endian words, a quirk of Pillow's that this keeps), NEAREST
    for "P" and "1"."""
    width, height = size
    if mode in ("P", "1"):
        return _nearest_resize(img, width, height)
    if mode in ("L", "RGB", "CMYK"):
        return _bicubic_resize(img, width, height)
    if mode in ("I;16", "I;16B"):
        x = np.ascontiguousarray(img).view("<u2") if mode == "I;16B" else img
        if x.shape[1] != width:
            x = _resample_axis_16(x, width, 1)
        if x.shape[0] != height:
            x = _resample_axis_16(x, height, 0)
        x = np.ascontiguousarray(x, np.uint16)
        return x.view(">u2") if mode == "I;16B" else x
    if mode == "RGBA":
        a = img[..., 3:].astype(np.int64)
        tmp = img[..., :3].astype(np.int64) * a + 128
        pre = np.concatenate([((tmp >> 8) + tmp) >> 8, a], axis=-1).astype(np.uint8)
        out = _bicubic_resize(pre, width, height).astype(np.int64)
        alpha = out[..., 3:]
        rgb = np.where(
            (alpha == 255) | (alpha == 0), out[..., :3],
            np.clip(255 * out[..., :3] // np.maximum(alpha, 1), 0, 255))
        return np.concatenate([rgb, alpha], axis=-1).astype(np.uint8)
    raise NotImplementedError(f"resize of a {mode} image")
