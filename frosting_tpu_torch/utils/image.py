"""PNG and baseline-JPEG decoding, and PIL's default resize, without PIL.

The JAX package reads ground-truth images as ``np.asarray(Image.open(p))``
and resizes them with ``im.resize((w, h))`` (``frosting_tpu/scene/
dataset.py``). The port must run where PIL is not installed, so it decodes
the files itself and aims at the same arrays, bit for bit (against Pillow 12.1.0 on
libjpeg-turbo; ``tests/test_torch_image.py``):

* PNG: colour types 0, 2, 3 and 6 at 8 bit, 16-bit grey and RGB(A), grey
  and palette images at 1, 2 and 4 bits, interlaced (Adam7) or not. Each
  comes back in PIL's mode, quirks included: a palette image as its
  indices ("P"), 16-bit grey as uint16 ("I;16"), 16-bit RGB(A) as the high
  byte of each sample, 1-bit grey as bool ("1"), 2- and 4-bit grey scaled
  to 8 bits ("L"). Grey + alpha ("LA"), which no trainer can use, raises
  ValueError.
* JPEG: Huffman-coded sequential and progressive scans (spectral selection,
  successive approximation, end-of-band runs), 8-bit, grey or YCbCr (or
  RGB, as libjpeg decides), sampling 4:4:4, 4:2:2 or 4:2:0, restart
  markers. The arithmetic is libjpeg's default path, which is specified in
  integers: the ``JDCT_ISLOW`` IDCT (``jidctint.c``), "fancy" triangular
  chroma upsampling (``jdsample.c``) and fixed-point YCbCr->RGB tables
  (``jdcolor.c``). EXIF orientation is not applied, as ``np.asarray(
  Image.open(p))`` does not apply it. Arithmetic-coded, lossless,
  hierarchical, 12-bit and CMYK files, and progressive files whose scans
  leave low coefficients unrefined (libjpeg smooths their blocks), raise
  NotImplementedError.
* resize: Pillow's BICUBIC (its default filter) in fixed point with 22
  precision bits, horizontal pass then vertical, each clipped to uint8;
  RGBA resampled premultiplied; palette and 1-bit images by NEAREST, as
  PIL does.

The serial parts, PNG's row filters and JPEG's Huffman decoding, are C++
(``csrc/image_decode.cpp``, built with g++ at first use by ``_build.py``).
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
_SOF_UNSUPPORTED = {
    0xC3: "lossless", 0xC5: "hierarchical",
    0xC6: "hierarchical progressive", 0xC7: "hierarchical lossless",
    0xC9: "arithmetic-coded", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded hierarchical",
    0xCE: "arithmetic-coded hierarchical", 0xCF: "arithmetic-coded hierarchical",
    0xCC: "arithmetic-coded (DAC)",
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
    """One chroma component (its real samples, uint8) upsampled by (h, v)
    in {1, 2} as libjpeg-turbo's default path does: h2v1 and h2v2 "fancy"
    (triangular) where the component is more than 2 samples wide, else by
    replication."""
    if (h_ratio, v_ratio) == (1, 1):
        return plane
    if (h_ratio, v_ratio) not in ((2, 1), (2, 2)):
        raise NotImplementedError(f"JPEG chroma sampling {h_ratio}x{v_ratio}")
    s = plane.astype(np.int32)
    if s.shape[1] <= 2:  # jdsample.c: plain replication
        return np.repeat(np.repeat(plane, v_ratio, axis=0), 2, axis=1)
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


def _decode_scan(lib, data, pos, seg, frame, coefs, huff, restart, coef_bits=None):
    """Huffman-decode the scan whose SOS header is seg and whose data start
    at pos; fills coefs. A progressive frame's scans (coef_bits, per
    component the point transform each coefficient is known to, -1 before
    its first scan) update the blocks in place. Returns the offset where
    the scan's data end."""
    _p, height, width, comps = frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    ns = seg[0]
    index = {c[0]: i for i, c in enumerate(comps)}
    params, arrays = [], []
    for j in range(ns):
        ci = index[seg[1 + 2 * j]]
        td, ta = seg[2 + 2 * j] >> 4, seg[2 + 2 * j] & 15
        _id, h, v, _q = comps[ci]
        arr = coefs[ci]
        if ns == 1:  # a non-interleaved scan: one block per MCU
            params.append((1, 1, td, ta, arr.shape[1]))
        else:
            params.append((h, v, td, ta, arr.shape[1]))
        arrays.append(arr)
    if ns == 1:
        _id, h, v, _q = comps[index[seg[1]]]
        mcus_x = -(-(-(-width * h // hmax)) // 8)
        mcus_y = -(-(-(-height * v // vmax)) // 8)
    else:
        mcus_x = -(-width // (8 * hmax))
        mcus_y = -(-height // (8 * vmax))
    comp = np.array(params, np.int32)
    ptrs = (ctypes.c_void_p * ns)(*[a.ctypes.data for a in arrays])
    buf = np.frombuffer(data, np.uint8)[pos:]
    consumed = _I64(0)
    args = (buf.ctypes.data, buf.size, huff.ctypes.data, ns, comp.ctypes.data, ptrs, mcus_x,
            mcus_y, restart)
    if coef_bits is None:
        err = lib.jpeg_decode_scan(*args, ctypes.byref(consumed))
    else:
        ss, se, ah, al = seg[1 + 2 * ns], seg[2 + 2 * ns], seg[3 + 2 * ns] >> 4, seg[
            3 + 2 * ns] & 15
        err = lib.jpeg_decode_progressive_scan(*args, ss, se, ah, al, ctypes.byref(consumed))
        for j in range(ns):
            coef_bits[index[seg[1 + 2 * j]]][ss:se + 1] = al
    if err:
        raise ValueError(f"corrupt JPEG scan (decoder error {err})")
    return pos + consumed.value


def decode_jpeg(data: bytes) -> Tuple[np.ndarray, str]:
    """Baseline or progressive JPEG bytes -> (array, mode) as
    ``np.asarray(Image.open(...))`` and ``Image.mode`` give them with
    libjpeg's default decoding."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file")
    lib = _lib()
    qtables = {}
    huff = np.zeros((8, 272), np.uint8)
    restart, frame, coefs, coef_bits = 0, None, None, None
    jfif, adobe_transform = False, None
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
                qtables[tq] = table
                i += 1 + size
        elif marker == 0xC4:
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                bits = np.frombuffer(seg[i + 1:i + 17], np.uint8)
                n_vals = int(bits.sum())
                huff[4 * tc + th] = 0
                huff[4 * tc + th, :16] = bits
                huff[4 * tc + th, 16:16 + n_vals] = np.frombuffer(
                    seg[i + 17:i + 17 + n_vals], np.uint8)
                i += 17 + n_vals
        elif marker == 0xDD:
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker in (0xC0, 0xC1, 0xC2):
            frame = _sof(seg)
            precision, height, width, comps = frame
            if precision != 8:
                raise NotImplementedError(f"{precision}-bit JPEG")
            if len(comps) not in (1, 3):
                raise NotImplementedError(f"JPEG with {len(comps)} components (CMYK?)")
            hmax = max(c[1] for c in comps)
            vmax = max(c[2] for c in comps)
            mx, my = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            coefs = [np.zeros((my * c[2], mx * c[1], 64), np.int16) for c in comps]
            if marker == 0xC2:
                coef_bits = np.full((len(comps), 64), -1)
        elif marker == 0xDA:
            if frame is None:
                raise ValueError("JPEG scan before its frame header")
            pos = _decode_scan(lib, data, pos, seg, frame, coefs, huff, restart, coef_bits)
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe_transform = seg[11]
    if frame is None:
        raise ValueError("JPEG without a frame header")
    # jdcoefct.c smoothing_ok: libjpeg smooths the blocks of a progressive
    # image whose first nine AC coefficients are not all refined to the end
    if coef_bits is not None and (coef_bits[:, 0] >= 0).all() and (coef_bits[:, 1:10] != 0).any():
        raise NotImplementedError("progressive JPEG with unrefined coefficients (block smoothing)")
    _p, height, width, comps = frame
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    planes = []
    for (_id, h, v, tq), arr in zip(comps, coefs):
        if hmax % h or vmax % v:
            raise NotImplementedError("JPEG sampling factors that do not divide")
        blocks = _idct_islow(arr, qtables[tq])
        bh, bw = arr.shape[:2]
        plane = blocks.transpose(0, 2, 1, 3).reshape(bh * 8, bw * 8)
        # the component's real samples (jdmaster.c downsampled_width/height)
        plane = plane[:-(-height * v // vmax), :-(-width * h // hmax)]
        planes.append(_upsample(plane, hmax // h, vmax // v)[:height, :width])
    if len(planes) == 1:
        return planes[0], "L"
    ids = tuple(c[0] for c in comps)
    # jdapimin.c default_decompress_parms: RGB only when the file says so
    if jfif:
        rgb = False
    elif adobe_transform is not None:
        rgb = adobe_transform == 0
    else:
        rgb = ids == (82, 71, 66)
    if rgb:
        return np.stack(planes, axis=-1), "RGB"
    return _ycc_to_rgb(*planes), "RGB"


def decode(data: bytes) -> Tuple[np.ndarray, str]:
    """PNG or JPEG bytes -> (array, PIL mode)."""
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data)
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data)
    raise ValueError("neither a PNG nor a JPEG file")


def read_image(path: str) -> Tuple[np.ndarray, str]:
    with open(path, "rb") as f:
        return decode(f.read())


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) from the file's header, as ``Image.open(p).size``."""
    with open(path, "rb") as f:
        head = f.read(32)
        if head[:8] == PNG_SIGNATURE:
            return struct.unpack(">II", head[16:24])
        if head[:2] != b"\xff\xd8":
            raise ValueError(f"{path}: neither a PNG nor a JPEG file")
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


def _coeffs(in_size: int, out_size: int):
    """precompute_coeffs + normalize_coeffs_8bpc for BICUBIC (support 2)
    over the box (0, in_size): (xmin [out], int64 weights [out, ksize]),
    the weights past each output's xmax zero."""
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
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
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
    "L", "RGB" and "RGBA" (premultiplied), NEAREST for "P" and "1"."""
    width, height = size
    if mode in ("P", "1"):
        return _nearest_resize(img, width, height)
    if mode in ("L", "RGB"):
        return _bicubic_resize(img, width, height)
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
