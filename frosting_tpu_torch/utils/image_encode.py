"""Small numpy writers of the TIFF, BMP, JPEG, WebP and GIF variants that
``utils/image.py`` reads, for the tests and ``chip_smoke.py``: PIL cannot
write most of them (tiled and planar TIFF, predictors, BMP bitfields and
RLE, JPEG sampling factors other than 4:4:4, 4:2:2 and 4:2:0, YCCK,
arithmetic coding, lossless JPEG, VP8's simple filter or more than one
token partition, a chosen ALPH filter, a GIF whose LZW table fills), and
the card's machine has no PIL. The port's loaders do not use this module.

The serial parts (JPEG's arithmetic coder, TIFF's and GIF's LZW, VP8L's bit
packing, the VP8 frame writer) are C++ (``csrc/image_encode.cpp``, built
with g++ at first use by ``_build.py``). The JPEG writers use the example
tables of ITU T.81 Annex K.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
import heapq
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from frosting_tpu_torch import _build
from frosting_tpu_torch.utils import image as image_io

_PTR = ctypes.c_void_p
_I64 = ctypes.c_int64

# ITU T.81 Annex K: the example quantisation tables (K.1, K.2; natural
# order) and the typical Huffman tables (K.3-K.6: 16 code counts, symbols)
JPEG_QUANT = (
    np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
              14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
              18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
              49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]),
    np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
              24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32),
)
JPEG_HUFF = {
    "dc0": ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12))),
    "dc1": ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12))),
    "ac0": ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
        0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
        0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1,
        0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18,
        0x19, 0x1A, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
        0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57,
        0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
        0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92,
        0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
        0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
        0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8,
        0xD9, 0xDA, 0xE1, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
        0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA]),
    "ac1": ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
        0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
        0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09,
        0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25,
        0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38,
        0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56,
        0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
        0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
        0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
        0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA,
        0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6,
        0xD7, 0xD8, 0xD9, 0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2,
        0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA]),
}
# libjpeg's jpeg_simple_progression shape, for any number of components:
# (components or None for all, ss, se, ah, al)
PROGRESSION = ((None, 0, 0, 0, 1), ("each", 1, 5, 0, 2), ("each", 6, 63, 0, 2),
               ("each", 1, 63, 2, 1), (None, 0, 0, 1, 0), ("each", 1, 63, 1, 0))


def _lib() -> ctypes.CDLL:
    lib = _build.load("image_encode")
    lib.jpeg_encode_arith_scan.argtypes = [_PTR, _PTR, ctypes.c_int, _PTR, _I64, _I64, _I64,
                                           ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_int, _PTR, _I64]
    lib.jpeg_encode_arith_scan.restype = _I64
    lib.tiff_lzw_encode.argtypes = [_PTR, _I64, _PTR, _I64]
    lib.tiff_lzw_encode.restype = _I64
    _INT = ctypes.c_int
    lib.gif_lzw_encode.argtypes = [_PTR, _I64, _INT, _INT, _PTR, _I64]
    lib.gif_lzw_encode.restype = _I64
    lib.lsb_pack.argtypes = [_PTR, _PTR, _I64, _PTR, _I64]
    lib.lsb_pack.restype = _I64
    lib.vp8_encode.argtypes = [_PTR, _PTR, _PTR] + [_INT] * 7 + [_PTR, _I64]
    lib.vp8_encode.restype = _I64
    return lib


def _seg(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def huff_codes(bits, vals) -> np.ndarray:
    """[256, 2] (code, length) per symbol of a canonical Huffman table."""
    codes, code, k = np.zeros((256, 2), np.int64), 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return codes


def _category(v: np.ndarray):
    """JPEG's magnitude category of each value and its extra bits."""
    s = np.where(v == 0, 0, np.floor(np.log2(np.maximum(np.abs(v), 1))).astype(np.int64) + 1)
    return s, np.where(v < 0, v + (1 << s) - 1, v)


def _pack(key, code, clen, extra, elen) -> bytes:
    """Bit fields (code then extra bits, MSB first), sorted by key into
    stream order, packed, padded with ones, 0xFF bytes stuffed."""
    order = np.argsort(key, kind="stable")
    value = (code[order] << elen[order]) | (extra[order] & ((1 << elen[order]) - 1))
    length = clen[order] + elen[order]
    total = int(length.sum())
    pos = np.arange(total) - np.repeat(np.cumsum(length) - length, length)
    bits = (np.repeat(value, length) >> (np.repeat(length, length) - 1 - pos)) & 1
    bits = np.concatenate([bits, np.ones(-total % 8, np.int64)]).astype(np.uint8)
    return np.packbits(bits).tobytes().replace(b"\xff", b"\xff\x00")


def _huffman_blocks(stream: np.ndarray, table: np.ndarray, comp: np.ndarray) -> bytes:
    """One restart interval of a sequential Huffman scan: stream [n, 64]
    the blocks in stream order (zig-zag order), table their Huffman table
    (0 or 1), comp their component, for the DC predictions."""
    codes = {k: huff_codes(*v) for k, v in JPEG_HUFF.items()}
    dc_codes = np.stack([codes["dc0"], codes["dc1"]])
    ac_codes = np.stack([codes["ac0"], codes["ac1"]])
    dc = stream[:, 0].copy()
    for c in np.unique(comp):
        dc[comp == c] = np.diff(stream[comp == c, 0], prepend=0)
    nblk = len(stream)
    fields = []  # (stream key, code, code length, extra bits, extra length)
    s, extra = _category(dc)
    c = dc_codes[table, s]
    fields.append((np.arange(nblk) * 1024, c[:, 0], c[:, 1], extra, s))
    blk, k = np.nonzero(stream[:, 1:])
    k = k + 1
    prev = np.where(np.r_[True, blk[1:] != blk[:-1]], 0, np.r_[0, k[:-1]])
    run = k - prev - 1
    for j in range(3):  # up to three ZRLs (16 zeros) before a coefficient
        sel = run >= 16 * (j + 1)
        c = ac_codes[table[blk[sel]], 0xF0]
        fields.append((blk[sel] * 1024 + k[sel] * 4 + j, c[:, 0], c[:, 1],
                       np.zeros(sel.sum(), np.int64), np.zeros(sel.sum(), np.int64)))
    s, extra = _category(stream[blk, k])
    c = ac_codes[table[blk], (run % 16) << 4 | s]
    fields.append((blk * 1024 + k * 4 + 3, c[:, 0], c[:, 1], extra, s))
    last = np.zeros(nblk, np.int64)
    last[blk] = k
    eob = np.nonzero(last < 63)[0]
    c = ac_codes[table[eob], 0x00]
    fields.append((eob * 1024 + 1023, c[:, 0], c[:, 1], np.zeros(len(eob), np.int64),
                   np.zeros(len(eob), np.int64)))
    return _pack(*(np.concatenate(f) for f in zip(*fields)))


def _with_restarts(n_mcus: int, restart: int, encode) -> bytes:
    """encode(first MCU, end MCU) for each restart interval, joined by
    RSTn markers."""
    if not restart:
        return encode(0, n_mcus)
    parts = []
    for i, a in enumerate(range(0, n_mcus, restart)):
        if i:
            parts.append(bytes([0xFF, 0xD0 + (i - 1) % 8]))
        parts.append(encode(a, min(a + restart, n_mcus)))
    return b"".join(parts)


# colour -> (component ids, Adobe transform or None for JFIF, each
# component's quantisation and Huffman tables, as libjpeg's
# jpeg_set_colorspace assigns them)
_COLOURS = {"grey": ((1,), None, (0,)), "ycc": ((1, 2, 3), None, (0, 1, 1)),
            "rgb": ((82, 71, 66), 0, (0, 0, 0)), "cmyk": ((67, 77, 89, 75), 0, (0, 0, 0, 0)),
            "ycck": ((1, 2, 3, 4), 2, (0, 1, 1, 0))}


def _ycc(rgb: np.ndarray) -> np.ndarray:
    x = rgb.astype(np.float64)
    return np.stack([x @ [0.299, 0.587, 0.114], x @ [-0.168736, -0.331264, 0.5] + 128,
                     x @ [0.5, -0.418688, -0.081312] + 128], -1)


def _planes(img: np.ndarray, colour: str) -> np.ndarray:
    """[H, W, C] float64 samples of the file's components: "grey" from
    [H, W]; "ycc" and "rgb" from RGB; "cmyk" and "ycck" from the array
    Pillow returns for a CMYK file (which inverts every byte of Adobe's
    CMYK; YCCK's colour bytes come out as its RGB)."""
    x = img.astype(np.float64)
    if colour == "grey":
        return x[..., None]
    if colour == "ycc":
        return _ycc(img)
    if colour == "rgb":
        return x
    if colour == "cmyk":
        return 255.0 - x
    return np.concatenate([_ycc(img[..., :3]), 255.0 - x[..., 3:]], axis=-1)


def _dct_matrix() -> np.ndarray:
    n = np.arange(8)
    return np.sqrt(np.where(n == 0, 1 / 8, 2 / 8))[:, None] * np.cos(
        (2 * n[None, :] + 1) * n[:, None] * np.pi / 16)


def jpeg_coefficients(img: np.ndarray, colour: str, sampling: Sequence[Tuple[int, int]]):
    """The quantised blocks of img as a JPEG frame with the given
    per-component (h, v) sampling: ([rows, cols, 64] int16 natural order
    per component, MCU-padded as libjpeg allocates them, (height, width));
    each component quantised by its Annex K table of _COLOURS."""
    planes = _planes(img, colour)
    h, w = planes.shape[:2]
    hmax = max(s[0] for s in sampling)
    vmax = max(s[1] for s in sampling)
    my, mx = -(-h // (8 * vmax)), -(-w // (8 * hmax))
    planes = np.pad(planes, ((0, my * 8 * vmax - h), (0, mx * 8 * hmax - w), (0, 0)),
                    mode="edge")
    dct = _dct_matrix()
    coefs = []
    for ci, (ch, cv) in enumerate(sampling):
        fy, fx = vmax // cv, hmax // ch
        p = planes[..., ci]
        p = p.reshape(p.shape[0] // fy, fy, p.shape[1] // fx, fx).mean(axis=(1, 3))
        rows, cols = p.shape[0] // 8, p.shape[1] // 8
        b = p.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3) - 128.0
        q = JPEG_QUANT[_COLOURS[colour][2][ci]].reshape(8, 8)
        coefs.append(np.round((dct @ b @ dct.T) / q).reshape(rows, cols, 64).astype(np.int16))
    return coefs, (h, w)


def _frame_header(marker, h, w, ids, sampling, tq, precision=8) -> bytes:
    body = bytes([precision]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") + bytes([len(ids)])
    for cid, (ch, cv), t in zip(ids, sampling, tq):
        body += bytes([cid, ch << 4 | cv, t])
    return _seg(marker, body)


def _app_markers(adobe: Optional[int]) -> bytes:
    if adobe is None:
        return _seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    return _seg(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, adobe]))


def _dqt(tables) -> bytes:
    return b"".join(_seg(0xDB, bytes([t]) + bytes(np.asarray(q)[image_io._NATURAL]
                                                  .astype(np.uint8)))
                    for t, q in tables)


def _dht() -> bytes:
    out = b""
    for cls, name in ((0, "dc0"), (0, "dc1"), (1, "ac0"), (1, "ac1")):
        nbits, vals = JPEG_HUFF[name]
        out += _seg(0xC4, bytes([cls << 4 | int(name[-1])]) + bytes(nbits) + bytes(vals))
    return out


def jpeg(img: np.ndarray, colour: str = "ycc",
         sampling: Optional[Sequence[Tuple[int, int]]] = None, restart: int = 0) -> bytes:
    """A baseline JPEG of img (uint8: [H, W] for "grey", [H, W, 3] for
    "ycc" and "rgb", [H, W, 4] for "cmyk" and "ycck") with per-component
    sampling factors (default 4:2:0 for "ycc", else 1 x 1): float DCT,
    Annex K tables, one interleaved Huffman-coded scan built as one array
    of bit fields, sorted into stream order; a JFIF marker for "grey" and
    "ycc", an Adobe marker (transform 0 or 2) for the others; an RSTn
    marker every `restart` MCUs."""
    ids, adobe, tq = _COLOURS[colour]
    if sampling is None:
        sampling = ((2, 2), (1, 1), (1, 1)) if colour == "ycc" else ((1, 1),) * len(ids)
    coefs, (h, w) = jpeg_coefficients(img, colour, sampling)
    zz = image_io._NATURAL
    # per MCU: each component's v x h blocks in raster order
    my, mx = coefs[0].shape[0] // sampling[0][1], coefs[0].shape[1] // sampling[0][0]
    blocks, comp = [], []
    for ci, ((ch, cv), arr) in enumerate(zip(sampling, coefs)):
        b = arr.reshape(my, cv, mx, ch, 64).transpose(0, 2, 1, 3, 4).reshape(my * mx, cv * ch, 64)
        blocks.append(b[..., zz].astype(np.int64))
        comp.append(np.full(cv * ch, ci))
    stream = np.concatenate(blocks, axis=1)  # [MCUs, blocks per MCU, 64]
    comp = np.concatenate(comp)
    table = np.asarray(tq)[comp]

    def encode(a, b):
        n = b - a
        return _huffman_blocks(stream[a:b].reshape(-1, 64), np.tile(table, n),
                               np.tile(comp, n))

    data = _with_restarts(my * mx, restart, encode)
    sos = bytes([len(ids)]) + b"".join(bytes([cid, t << 4 | t])
                                       for cid, t in zip(ids, tq)) + bytes([0, 63, 0])
    return (b"\xff\xd8" + _app_markers(adobe) + _dqt(enumerate(JPEG_QUANT))
            + _frame_header(0xC0, h, w, ids, sampling, tq) + _dht()
            + (_seg(0xDD, restart.to_bytes(2, "big")) if restart else b"")
            + _seg(0xDA, sos) + data + b"\xff\xd9")


def jpeg_arithmetic(data: bytes, progressive: bool = False, restart: Optional[int] = None,
                    conditioning: Optional[Dict[str, Dict[int, object]]] = None) -> bytes:
    """The arithmetic-coded JPEG of the same coefficients as the DCT JPEG
    data (SOF9, or SOF10 with the scans of PROGRESSION): the same frame,
    quantisation tables and JFIF / Adobe markers; `restart` MCUs between
    RSTn markers (data's own interval by default); conditioning
    {"dc": {table: (L, U)}, "ac": {table: K}} written as a DAC segment."""
    st = image_io._jpeg_read(data)
    if st["kind"] == "lossless":
        raise ValueError("not a DCT JPEG")
    precision, h, w, comps = frame = st["frame"]
    restart = st["restart"] if restart is None else restart
    coefs = st["coefs"]
    cond = np.array([0] * 4 + [1] * 4 + [5] * 4, np.uint8)
    dac = b""
    for tb, (lo, up) in (conditioning or {}).get("dc", {}).items():
        cond[tb], cond[4 + tb] = lo, up
        dac += bytes([tb, up << 4 | lo])
    for tb, k in (conditioning or {}).get("ac", {}).items():
        cond[8 + tb] = k
        dac += bytes([0x10 | tb, k])
    lib = _lib()
    n = len(comps)
    tb = [min(i, 1) for i in range(n)]

    def scan(cis, ss, se, ah, al):
        sos = bytes([len(cis)]) + b"".join(bytes([comps[c][0], tb[c] << 4 | tb[c]])
                                           for c in cis) + bytes([ss, se, ah << 4 | al])
        ns, _cis, comp, ptrs, mcus_x, mcus_y = image_io._scan_layout(sos, frame, coefs)
        cap = sum(c.nbytes for c in coefs) * 2 + 1024
        out = np.empty(cap, np.uint8)
        size = lib.jpeg_encode_arith_scan(ptrs, cond.ctypes.data, ns, comp.ctypes.data, mcus_x,
                                          mcus_y, restart, int(progressive), ss, se, ah, al,
                                          out.ctypes.data, cap)
        if size < 0:
            raise ValueError("arithmetic-coded scan larger than its buffer")
        return _seg(0xDA, sos) + out[:size].tobytes()

    blocks_per_mcu = sum(c[1] * c[2] for c in comps)
    scans = []
    if not progressive:
        groups = [list(range(n))] if blocks_per_mcu <= 10 else [[c] for c in range(n)]
        scans = [scan(g, 0, 63, 0, 0) for g in groups]
    else:
        for which, ss, se, ah, al in PROGRESSION:
            if which is None:
                groups = [list(range(n))] if blocks_per_mcu <= 10 else [[c] for c in range(n)]
            else:
                groups = [[c] for c in range(n)]
            scans += [scan(g, ss, se, ah, al) for g in groups]
    markers = b""
    if st["jfif"]:
        markers += _app_markers(None)
    if st["adobe"] is not None:
        markers += _app_markers(st["adobe"])
    ids = [c[0] for c in comps]
    return (b"\xff\xd8" + markers + _dqt(sorted(st["qtables"].items()))
            + _frame_header(0xCA if progressive else 0xC9, h, w, ids,
                            [(c[1], c[2]) for c in comps], [c[3] for c in comps], precision)
            + (_seg(0xCC, dac) if dac else b"")
            + (_seg(0xDD, restart.to_bytes(2, "big")) if restart else b"")
            + b"".join(scans) + b"\xff\xd9")


def _predict(s: np.ndarray, psv: int, pt: int, first: np.ndarray) -> np.ndarray:
    """The lossless predictions of samples s [H, W] (jdpred.c), the rows
    flagged in first predicted as the first row of a scan."""
    s = s.astype(np.int64)
    ra = np.concatenate([np.zeros((s.shape[0], 1), np.int64), s[:, :-1]], axis=1)
    rb = np.concatenate([np.zeros((1, s.shape[1]), np.int64), s[:-1]], axis=0)
    rc = np.concatenate([np.zeros((1, s.shape[1]), np.int64), ra[:-1]], axis=0)
    pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[psv].copy()
    pred[:, 0] = rb[:, 0]
    pred[first, 0] = 1 << (8 - pt - 1)
    pred[first, 1:] = ra[first, 1:]
    return pred


def jpeg_lossless(img: np.ndarray, psv: int = 1, point_transform: int = 0,
                  restart_rows: int = 0) -> bytes:
    """A lossless JPEG (SOF3, 8 bits) of img ([H, W] grey, or [H, W, 3] RGB
    marked by Adobe transform 0): predictor `psv`, one interleaved
    Huffman-coded scan of the differences (Annex K DC tables), a restart
    every `restart_rows` rows. Decoded, it is img >> point_transform <<
    point_transform."""
    grey = img.ndim == 2
    x = (img[..., None] if grey else img).astype(np.int64) >> point_transform
    h, w, n = x.shape
    first = np.zeros(h, bool)
    first[::restart_rows or h] = True
    diff = np.stack([x[..., c] - _predict(x[..., c], psv, point_transform, first)
                     for c in range(n)], -1).reshape(h * w, n)
    codes = np.stack([huff_codes(*JPEG_HUFF["dc0"]), huff_codes(*JPEG_HUFF["dc1"])])
    table = np.minimum(np.arange(n), 1)

    def encode(a, b):
        d = diff[a:b].reshape(-1)
        s, extra = _category(d)
        if s.max() > 11:
            raise ValueError("a difference past the Annex K table")
        c = codes[np.tile(table, b - a), s]
        return _pack(np.arange(len(d)), c[:, 0], c[:, 1], extra, s)

    restart = restart_rows * w
    data = _with_restarts(h * w, restart, encode)
    ids = (1,) if grey else (82, 71, 66)
    sos = bytes([n]) + b"".join(bytes([cid, min(i, 1) << 4]) for i, cid in enumerate(ids)) \
        + bytes([psv, 0, point_transform])
    dht = b"".join(_seg(0xC4, bytes([t]) + bytes(JPEG_HUFF[f"dc{t}"][0])
                        + bytes(JPEG_HUFF[f"dc{t}"][1])) for t in (0, 1))
    return (b"\xff\xd8" + (b"" if grey else _app_markers(0))
            + _frame_header(0xC3, h, w, ids, ((1, 1),) * n, (0,) * n) + dht
            + (_seg(0xDD, restart.to_bytes(2, "big")) if restart else b"")
            + _seg(0xDA, sos) + data + b"\xff\xd9")


# --- TIFF -----------------------------------------------------------------

def _packbits(row: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(row)
    while i < n:
        j = i
        while j + 1 < n and row[j + 1] == row[i] and j - i < 127:
            j += 1
        if j > i:  # a run of j - i + 1 equal bytes
            out += bytes([(257 - (j - i + 1)) & 0xFF, row[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (j + 1 < n and row[j + 1] == row[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + row[i:j]
        i = j
    return bytes(out)


def tiff(samples: np.ndarray, photometric: int, compression: str = "none",
         predictor: bool = False, tile: Optional[Tuple[int, int]] = None,
         planar: bool = False, rows_per_strip: Optional[int] = None, byteorder: str = "<",
         extra_samples: Sequence[int] = (), colormap: Optional[np.ndarray] = None) -> bytes:
    """A TIFF of samples ([H, W] or [H, W, C]; bool for 1 bit, uint8, or
    uint16 for 16 bits) with photometric interpretation `photometric`:
    compression "none", "lzw", "deflate" or "packbits"; horizontal
    differencing (predictor 2); strips of `rows_per_strip` rows or tiles of
    `tile` = (width, length) pixels, multiples of 16; chunky or planar;
    little- ("<") or big-endian (">"); a colormap [2^bits, 3] of 16-bit
    values for palette images."""
    s = samples[..., None] if samples.ndim == 2 else samples
    h, w, spp = s.shape
    bits = 1 if s.dtype == bool else 16 if s.dtype == np.uint16 else 8
    s = s.astype(np.uint16 if bits == 16 else np.uint8)
    tw, tl = tile if tile else (w, rows_per_strip or max(1, min(h, 8192 // max(1, w * spp))))
    across, down = -(-w // tw), -(-h // tl)
    planes = [s[..., c:c + 1] for c in range(spp)] if planar else [s]
    lzw = _lib() if compression == "lzw" else None
    chunks = []
    for p in planes:
        for j in range(down):
            for i in range(across):
                part = p[j * tl:(j + 1) * tl, i * tw:(i + 1) * tw]
                if tile:  # tiles are whole, padded with zeros
                    part = np.pad(part, ((0, tl - part.shape[0]), (0, tw - part.shape[1]),
                                         (0, 0)))
                if predictor:
                    part = np.diff(part, axis=1, prepend=np.zeros_like(part[:, :1]))
                if bits == 1:
                    raw = np.packbits(part.reshape(part.shape[0], -1), axis=1).tobytes()
                elif bits == 16:
                    raw = part.astype(byteorder + "u2").tobytes()
                else:
                    raw = part.tobytes()
                if compression == "deflate":
                    raw = zlib.compress(raw)
                elif compression == "packbits":
                    stride = len(raw) // part.shape[0]
                    raw = b"".join(_packbits(raw[r * stride:(r + 1) * stride])
                                   for r in range(part.shape[0]))
                elif compression == "lzw":
                    src = np.frombuffer(raw, np.uint8)
                    out = np.empty(src.size * 2 + 64, np.uint8)
                    n = lzw.tiff_lzw_encode(src.ctypes.data, src.size, out.ctypes.data,
                                            out.size)
                    raw = out[:n].tobytes()
                chunks.append(raw)
    code = {"none": 1, "lzw": 5, "deflate": 8, "packbits": 32773}[compression]
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * spp), 259: (3, [code]),
               262: (3, [photometric]), 277: (3, [spp]), 284: (3, [2 if planar else 1])}
    if predictor:
        entries[317] = (3, [2])
    if extra_samples:
        entries[338] = (3, list(extra_samples))
    if colormap is not None:
        entries[320] = (3, list(np.asarray(colormap, np.int64).T.reshape(-1)))
    head = 8
    body = b"".join(chunks)
    offsets = list(head + np.cumsum([0] + [len(c) for c in chunks[:-1]]))
    if tile:
        entries.update({322: (3, [tw]), 323: (3, [tl]), 324: (4, offsets),
                        325: (4, [len(c) for c in chunks])})
    else:
        entries.update({273: (4, offsets), 278: (4, [tl]), 279: (4, [len(c) for c in chunks])})
    ifd_at = head + len(body) + (len(body) % 2)
    fmt = {3: "H", 4: "I"}
    tags = sorted(entries)
    extra_at = ifd_at + 2 + 12 * len(tags) + 4
    ifd, extra = b"", b""
    for t in tags:
        typ, vals = entries[t]
        packed = struct.pack(byteorder + fmt[typ] * len(vals), *[int(v) for v in vals])
        if len(packed) <= 4:
            field = packed.ljust(4, b"\x00")
        else:
            field = struct.pack(byteorder + "I", extra_at + len(extra))
            extra += packed + b"\x00" * (len(packed) % 2)
        ifd += struct.pack(byteorder + "HHI", t, typ, len(vals)) + field
    magic = b"II*\x00" if byteorder == "<" else b"MM\x00*"
    return (magic + struct.pack(byteorder + "I", ifd_at) + body + b"\x00" * (len(body) % 2)
            + struct.pack(byteorder + "H", len(tags)) + ifd + b"\x00\x00\x00\x00" + extra)


# --- BMP ------------------------------------------------------------------

def _rle_row(row: np.ndarray, rle4: bool) -> bytes:
    """One row of BMP RLE8 or RLE4: runs of three or more equal pixels
    (equal pairs for RLE4) as encoded runs, the rest as absolute runs of
    three or more pixels padded to a word, ending with an end of line."""
    out, i, n = bytearray(), 0, len(row)
    while i < n:
        j = i
        while j + 1 < n and row[j + 1] == row[i] and j - i < 254:
            j += 1
        if j - i + 1 >= 3 or n - i < 3:
            count = j - i + 1
            out += bytes([count, (row[i] << 4 | row[i]) if rle4 else row[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 254 and not (j + 2 < n and row[j] == row[j + 1] == row[j + 2]):
            j += 1
        lit = row[i:j]
        if len(lit) < 3:
            out += b"".join(bytes([1, (v << 4 | v) if rle4 else v]) for v in lit)
        else:
            if rle4:
                body = np.pad(lit, (0, len(lit) % 2)).reshape(-1, 2)
                data = bytes((body[:, 0] << 4 | body[:, 1]).astype(np.uint8))
            else:
                data = bytes(lit.astype(np.uint8))
            out += bytes([0, len(lit)]) + data + b"\x00" * (len(data) % 2)
        i = j
    return bytes(out) + b"\x00\x00"


def bmp(pixels: np.ndarray, bits: int, palette: Optional[np.ndarray] = None,
        rle: bool = False, top_down: bool = False, masks: Optional[Sequence[int]] = None,
        header: int = 40) -> bytes:
    """A BMP of pixels ([H, W] indices for 1-8 bits with palette [n, 3];
    [H, W, 3] RGB, or [H, W, 4] RGBA with alpha masks, for 16-32 bits):
    RLE8 / RLE4 with rle, rows top-down (negative height) with top_down,
    BI_BITFIELDS with masks (after a 40-byte header, inside a 108- or
    124-byte one), or an OS/2 12-byte header."""
    h, w = pixels.shape[:2]
    rows = pixels[::-1] if not top_down else pixels
    compression = 0
    if rle:
        compression = 1 if bits == 8 else 2
        data = b"".join(_rle_row(r, bits == 4) for r in rows) + b"\x00\x01"
    else:
        stride = ((w * bits + 31) >> 3) & ~3
        if bits <= 8:
            px = rows.astype(np.uint8)
            if bits < 8:
                shifts = np.arange(8 // bits - 1, -1, -1) * bits
                padded = np.pad(px, ((0, 0), (0, -w % (8 // bits))))
                px = (padded.reshape(h, -1, 8 // bits) << shifts).sum(-1).astype(np.uint8)
            raw = px
        elif masks is None:
            if bits == 16:
                q = rows[..., :3].astype(np.int64) >> 3
                v = q[..., 0] << 10 | q[..., 1] << 5 | q[..., 2]
                raw = np.stack([v & 0xFF, v >> 8], -1).reshape(h, -1).astype(np.uint8)
            else:
                bgr = rows[..., [2, 1, 0]].astype(np.uint8)
                if bits == 32:
                    bgr = np.concatenate([bgr, np.zeros((h, w, 1), np.uint8)], -1)
                raw = bgr.reshape(h, -1)
        else:
            compression = 3
            chans = rows.astype(np.int64)
            if bits == 16:
                widths = [bin(m).count("1") for m in masks[:3]]
                v = np.zeros((h, w), np.int64)
                for c, (m, nb) in enumerate(zip(masks[:3], widths)):
                    shift = (m & -m).bit_length() - 1
                    v |= (chans[..., c] >> (8 - nb)) << shift
                raw = np.stack([v & 0xFF, v >> 8], -1).reshape(h, -1).astype(np.uint8)
            else:
                v = np.zeros((h, w), np.int64)
                for c, m in enumerate(masks):
                    if m and c < chans.shape[-1]:
                        v |= chans[..., c] << ((m & -m).bit_length() - 1)
                raw = v.astype("<u4").view(np.uint8).reshape(h, -1)
        raw = np.pad(raw, ((0, 0), (0, stride - raw.shape[1])))
        data = raw.tobytes()
    pal = b""
    if palette is not None:
        p = np.asarray(palette, np.uint8)[:, [2, 1, 0]]
        if header != 12:
            p = np.concatenate([p, np.zeros((len(p), 1), np.uint8)], -1)
        pal = p.tobytes()
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        height = (2 ** 32 - h) if top_down else h
        info = struct.pack("<IIIHHIIiiII", header, w, height, 1, bits, compression, len(data),
                           2835, 2835, 0 if palette is None else len(palette), 0)
        if masks is not None:
            m = struct.pack("<4I", *(list(masks) + [0] * (4 - len(masks))))
            if header == 40:
                info += m[:12]
            else:
                info += m + b"\x00" * (header - 40 - 16)
        elif header > 40:
            info += b"\x00" * (header - 40)
    offset = 14 + len(info) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(data), 0, 0, offset) + info + pal
            + data)


# --- WebP -----------------------------------------------------------------

def _chunk(fourcc: bytes, payload: bytes) -> bytes:
    return fourcc + struct.pack("<I", len(payload)) + payload + b"\x00" * (len(payload) & 1)


def _riff(chunks: bytes) -> bytes:
    return b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WEBP" + chunks


def _le24(v: int) -> bytes:
    return struct.pack("<I", v)[:3]


def _pack_lsb(values: np.ndarray, nbits: np.ndarray) -> bytes:
    values = np.ascontiguousarray(values, np.uint32)
    nbits = np.ascontiguousarray(nbits, np.uint8)
    cap = int(nbits.sum(dtype=np.int64)) // 8 + 1
    out = np.empty(cap, np.uint8)
    n = _lib().lsb_pack(values.ctypes.data, nbits.ctypes.data, values.size, out.ctypes.data, cap)
    return out[:n].tobytes()


def _huffman_lengths(counts: np.ndarray, limit: int = 15) -> np.ndarray:
    """Prefix code lengths for symbol counts, none longer than limit (the
    counts halved until the Huffman code fits); one used symbol gets 1."""
    counts = np.asarray(counts, np.int64)
    used = np.flatnonzero(counts)
    lengths = np.zeros(counts.size, np.int64)
    if used.size == 1:
        lengths[used] = 1
        return lengths
    c = counts[used].copy()
    while True:
        heap = [(int(v), i, (int(s),)) for i, (v, s) in enumerate(zip(c, used))]
        heapq.heapify(heap)
        depth = dict.fromkeys(used.tolist(), 0)
        k = len(heap)
        while len(heap) > 1:
            a, _, sa = heapq.heappop(heap)
            b, _, sb = heapq.heappop(heap)
            for sym in sa + sb:
                depth[sym] += 1
            heapq.heappush(heap, (a + b, k, sa + sb))
            k += 1
        if max(depth.values()) <= limit:
            for sym, d in depth.items():
                lengths[sym] = d
            return lengths
        c = np.maximum(c // 2, 1)


def _codes_lsb(lengths: np.ndarray) -> np.ndarray:
    """Canonical codes (shorter first, then by symbol), bit-reversed so
    that an LSB-first writer sends each code's first bit first."""
    codes = np.zeros(lengths.size, np.uint32)
    code = 0
    for length in range(1, 16):
        for sym in np.flatnonzero(lengths == length):
            rev = int(format(code, f"0{length}b")[::-1], 2)
            codes[sym] = rev
            code += 1
        code <<= 1
    return codes


# RFC 9649 section 3.7.2.1.2: the order of the code length code lengths
_CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)


def _prefix_code_header(lengths: np.ndarray) -> Tuple[list, list]:
    """The bits that describe a prefix code: a simple code of one symbol,
    or a normal code whose code lengths are sent one by one (no repeat
    codes) under a code-length code of at most 7 bits. Returns (values,
    widths)."""
    used = np.flatnonzero(lengths)
    if used.size <= 1:
        sym = int(used[0]) if used.size else 0
        wide = sym > 1
        return [1, 0, int(wide), sym], [1, 1, 1, 8 if wide else 1]
    cl_lengths = _huffman_lengths(np.bincount(lengths, minlength=19), 7)
    cl_codes = _codes_lsb(cl_lengths)
    vals, widths = [0, 15], [1, 4]
    for sym in _CODE_LENGTH_ORDER:
        vals.append(int(cl_lengths[sym]))
        widths.append(3)
    vals.append(0)  # every symbol's length follows
    widths.append(1)
    if (cl_lengths > 0).sum() == 1:  # one code length: sent in no bits
        return vals, widths
    vals += cl_codes[lengths].tolist()
    widths += cl_lengths[lengths].tolist()
    return vals, widths


def _entropy_image(argb: np.ndarray, level0: bool) -> Tuple[list, list, np.ndarray, np.ndarray]:
    """An entropy-coded image of ARGB pixels as literals under one group of
    prefix codes (no colour cache, no LZ77): (header values, header widths,
    per-pixel code values [n, 4], their widths [n, 4])."""
    a = argb.reshape(-1).astype(np.uint32)
    chans = [(a >> 8) & 0xFF, (a >> 16) & 0xFF, a & 0xFF, a >> 24]  # green, red, blue, alpha
    vals, widths = [0], [1]  # no colour cache
    if level0:
        vals.append(0)  # no meta prefix codes
        widths.append(1)
    pix_vals, pix_widths = [], []
    for i, ch in enumerate(chans):
        counts = np.bincount(ch, minlength=280 if i == 0 else 256)
        lengths = _huffman_lengths(counts)
        hv, hw = _prefix_code_header(lengths)
        vals += hv
        widths += hw
        single = (lengths > 0).sum() == 1
        pix_vals.append(np.zeros(a.size, np.uint32) if single else _codes_lsb(lengths)[ch])
        pix_widths.append(np.zeros(a.size, np.uint8) if single
                          else lengths[ch].astype(np.uint8))
    hv, hw = _prefix_code_header(np.zeros(40, np.int64))  # distance: unused
    vals += hv
    widths += hw
    return vals, widths, np.stack(pix_vals, -1), np.stack(pix_widths, -1)


def _channels(argb: np.ndarray) -> np.ndarray:
    """[h, w] ARGB -> [4, h, w] int16 channels A, R, G, B."""
    return np.stack([(argb >> s) & 0xFF for s in (24, 16, 8, 0)]).astype(np.int16)


def _argb(ch: np.ndarray) -> np.ndarray:
    c = (ch.astype(np.int64) & 0xFF).astype(np.uint32)
    return (c[0] << 24) | (c[1] << 16) | (c[2] << 8) | c[3]


def _vp8l_predictions(ch: np.ndarray):
    """Each of the 14 VP8L predictors at every pixel ([4, h, w] channels,
    neighbours from the image itself; the rightmost pixel's top-right is
    the first pixel of its own row, as the decoder reads it). Yields
    (mode, [4, h, w] prediction); row 0 and column 0 are fixed later."""
    c = ch.astype(np.int32)
    left = np.roll(c, 1, axis=2)
    top = np.roll(c, 1, axis=1)
    tl = np.roll(top, 1, axis=2)
    tr = np.roll(top, -1, axis=2)
    tr[:, :, -1] = c[:, :, 0]
    tr[:, 0, -1] = 0

    def avg(a, b):
        return (a + b) >> 1

    yield 0, np.broadcast_to(np.array([255, 0, 0, 0], np.int32)[:, None, None], c.shape)
    yield 1, left
    yield 2, top
    yield 3, tr
    yield 4, tl
    yield 5, avg(avg(left, tr), top)
    yield 6, avg(left, tl)
    yield 7, avg(left, top)
    yield 8, avg(tl, top)
    yield 9, avg(top, tr)
    yield 10, avg(avg(left, tl), avg(top, tr))
    pick_top = (np.abs(left - tl).sum(0) - np.abs(top - tl).sum(0)) <= 0
    yield 11, np.where(pick_top[None], top, left)
    yield 12, np.clip(left + top - tl, 0, 255)
    a = avg(left, top)
    d = a - tl
    yield 13, np.clip(a + np.where(d < 0, -((-d) >> 1), d >> 1), 0, 255)


def _vp8l_predict(ch: np.ndarray, bits: int) -> Tuple[np.ndarray, np.ndarray]:
    """The predictor transform: per tile of 2^bits pixels the mode of least
    residual, and the residuals ([4, h, w], mod 256). Returns (residual
    channels, the modes' sub-image as ARGB)."""
    _c, h, w = ch.shape
    th, tw = -(-h // (1 << bits)), -(-w // (1 << bits))
    best_cost = np.full((th, tw), np.iinfo(np.int64).max)
    best_mode = np.zeros((th, tw), np.int64)
    preds = {}
    for mode, pred in _vp8l_predictions(ch):
        r = (ch.astype(np.int32) - pred) & 0xFF
        cost = np.minimum(r, 256 - r).sum(0)
        cost = np.pad(cost, ((0, th * (1 << bits) - h), (0, tw * (1 << bits) - w)))
        cost = cost.reshape(th, 1 << bits, tw, 1 << bits).sum((1, 3))
        better = cost < best_cost
        best_cost = np.where(better, cost, best_cost)
        best_mode = np.where(better, mode, best_mode)
        preds[mode] = pred
    full = np.repeat(np.repeat(best_mode, 1 << bits, 0), 1 << bits, 1)[:h, :w]
    pred = np.zeros(ch.shape, np.int32)
    for mode, pm in preds.items():
        pred = np.where((full == mode)[None], pm, pred)
    pred[:, 0, :] = preds[1][:, 0, :]          # row 0: the left pixel
    pred[:, 0, 0] = (255, 0, 0, 0)             # its first pixel: black
    pred[:, 1:, 0] = preds[2][:, 1:, 0]        # column 0: the pixel above
    residual = (ch.astype(np.int32) - pred) & 0xFF
    return residual.astype(np.int16), (0xFF000000 | (best_mode.astype(np.uint32) << 8))


def vp8l_stream(rgba: np.ndarray, predictor: bool = True, subtract_green: bool = True,
                palette: bool = False, pred_bits: int = 4, header: bool = True) -> bytes:
    """A VP8L stream (RFC 9649) of an [h, w, 3 or 4] uint8 image: with
    palette, the colour-indexing transform (at most 256 colours; 2, 4 or 8
    pixels bundled per byte for at most 16); else subtract-green and the
    predictor transform (each tile's mode the one of least residual, all 14
    tried), as asked. Literals under one group of prefix codes. header: the
    0x2f signature and the size (a VP8L chunk), else the headerless stream
    of an ALPH chunk."""
    h, w = rgba.shape[:2]
    a = rgba[..., 3] if rgba.shape[-1] == 4 else np.full((h, w), 255, np.uint8)
    argb = ((a.astype(np.uint32) << 24) | (rgba[..., 0].astype(np.uint32) << 16)
            | (rgba[..., 1].astype(np.uint32) << 8) | rgba[..., 2])
    segments = []  # (values, widths) in stream order

    def bits(vals, widths):
        segments.append((np.array(vals, np.uint32), np.array(widths, np.uint8)))

    def image(argb_image, level0):
        hv, hw, pv, pw_ = _entropy_image(argb_image, level0)
        bits(hv, hw)
        segments.append((pv.reshape(-1), pw_.reshape(-1)))

    if header:
        bits([0x2F, w - 1, h - 1, int((a != 255).any()), 0], [8, 14, 14, 1, 3])
    if palette:
        colours, index = np.unique(argb.reshape(-1), return_inverse=True)
        n = colours.size
        if n > 256:
            raise ValueError(f"{n} colours: colour indexing takes at most 256")
        pbits = 0 if n > 16 else 1 if n > 4 else 2 if n > 2 else 3
        bits([1, 3, n - 1], [1, 2, 8])
        image(_argb(_channels(colours[None]) - _channels(
            np.concatenate([[0], colours[:-1]]).astype(np.uint32)[None])), False)
        index = index.reshape(h, w).astype(np.uint32)
        per = 1 << pbits
        pw = -(-w // per)
        padded = np.zeros((h, pw * per), np.uint32)
        padded[:, :w] = index
        packed = np.zeros((h, pw), np.uint32)
        for k in range(per):
            packed |= padded[:, k::per] << (k * (8 >> pbits))
        argb = 0xFF000000 | (packed << 8)
    else:
        ch = _channels(argb)
        if subtract_green:
            bits([1, 2], [1, 2])
            ch[1] = (ch[1] - ch[2]) & 0xFF
            ch[3] = (ch[3] - ch[2]) & 0xFF
        if predictor:
            bits([1, 0, pred_bits - 2], [1, 2, 3])
            ch, modes = _vp8l_predict(ch, pred_bits)
            image(modes, False)
        argb = _argb(ch)
    bits([0], [1])  # no more transforms
    image(argb, True)
    return _pack_lsb(np.concatenate([v for v, _w in segments]),
                     np.concatenate([w_ for _v, w_ in segments]))


def _rgb_to_yuv(rgb: np.ndarray):
    """BT.601 studio-range Y, and U, V averaged over 2 x 2 pixels, the image
    padded by edge replication to whole macroblocks."""
    h, w = rgb.shape[:2]
    mh, mw = -(-h // 16) * 16, -(-w // 16) * 16
    x = np.pad(rgb.astype(np.float64), ((0, mh - h), (0, mw - w), (0, 0)), mode="edge") / 255.0
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 16 + 65.481 * r + 128.553 * g + 24.966 * b
    u = 128 - 37.797 * r - 74.203 * g + 112.0 * b
    v = 128 + 112.0 * r - 93.786 * g - 18.214 * b

    def down(c):
        return c.reshape(mh // 2, 2, mw // 2, 2).mean((1, 3))

    return [np.ascontiguousarray(np.clip(np.rint(c), 0, 255).astype(np.uint8))
            for c in (y, down(u), down(v))]


def vp8_frame(rgb: np.ndarray, q: int = 20, filter_type: int = 2, level: int = 20,
              sharpness: int = 0, partitions: int = 1) -> bytes:
    """A VP8 key frame of an [h, w, 3] uint8 image: quantiser index q
    (0-127), the normal (2), simple (1) or no (0) loop filter at level and
    sharpness, 1, 2, 4 or 8 token partitions, a 16 x 16 mode or B_PRED
    chosen per macroblock."""
    h, w = rgb.shape[:2]
    y, u, v = _rgb_to_yuv(rgb)
    cap = 4 * y.size + 65536
    out = np.empty(cap, np.uint8)
    n = _lib().vp8_encode(y.ctypes.data, u.ctypes.data, v.ctypes.data, w, h, q, filter_type,
                          level, sharpness, {1: 0, 2: 1, 4: 2, 8: 3}[partitions],
                          out.ctypes.data, cap)
    if n < 0:
        raise ValueError("VP8 frame larger than its buffer")
    return out[:n].tobytes()


def alph_chunk(alpha: np.ndarray, filter_method: int = 0, compressed: bool = True) -> bytes:
    """An ALPH chunk's payload: the [h, w] alpha plane filtered (0 none,
    1 horizontal, 2 vertical, 3 gradient) and stored raw or as a headerless
    VP8L stream (alpha in green; the predictor transform only)."""
    a = alpha.astype(np.int32)
    pred = np.zeros_like(a)
    if filter_method:
        pred[0, 1:] = a[0, :-1]  # the first row: from the left
        pred[1:, 0] = a[:-1, 0]  # the first column: from above
        if filter_method == 1:
            pred[1:, 1:] = a[1:, :-1]
        elif filter_method == 2:
            pred[1:, 1:] = a[:-1, 1:]
        else:
            pred[1:, 1:] = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
    res = ((a - pred) & 0xFF).astype(np.uint8)
    head = bytes([int(compressed) | (filter_method << 2)])
    if not compressed:
        return head + res.tobytes()
    green = np.stack([np.zeros_like(res), res, np.zeros_like(res), np.full_like(res, 255)], -1)
    return head + vp8l_stream(green, subtract_green=False, header=False)


def webp(img: np.ndarray, lossless: bool = True, alpha_filter: int = 3,
         alpha_compressed: bool = True, **options) -> bytes:
    """A still WebP file of an [h, w, 3 or 4] uint8 image: lossless (a VP8L
    chunk; options to vp8l_stream), or lossy (a VP8 chunk; options to
    vp8_frame), with an alpha channel in an ALPH chunk behind a VP8X
    header."""
    h, w = img.shape[:2]
    if lossless:
        return _riff(_chunk(b"VP8L", vp8l_stream(img, **options)))
    frame = _chunk(b"VP8 ", vp8_frame(np.ascontiguousarray(img[..., :3]), **options))
    if img.shape[-1] == 3:
        return _riff(frame)
    vp8x = _chunk(b"VP8X", bytes([0x10, 0, 0, 0]) + _le24(w - 1) + _le24(h - 1))
    return _riff(vp8x + _chunk(b"ALPH", alph_chunk(img[..., 3], alpha_filter,
                                                   alpha_compressed)) + frame)


def webp_animation(frames: Sequence[Tuple[np.ndarray, int, int]], canvas: Tuple[int, int],
                   **options) -> bytes:
    """An animated WebP: a VP8X canvas (w, h) with the alpha and animation
    flags, an ANIM chunk (transparent background, looping), and one ANMF
    per (image, x, y) at that even offset, its image lossless (options to
    vp8l_stream), shown 100 ms, not blended with the canvas, not disposed."""
    cw, ch = canvas
    body = _chunk(b"VP8X", bytes([0x12, 0, 0, 0]) + _le24(cw - 1) + _le24(ch - 1))
    body += _chunk(b"ANIM", b"\x00\x00\x00\x00" + struct.pack("<H", 0))
    for img, x, y in frames:
        if x % 2 or y % 2:
            raise ValueError("ANMF offsets are even")
        h, w = img.shape[:2]
        head = (_le24(x // 2) + _le24(y // 2) + _le24(w - 1) + _le24(h - 1) + _le24(100)
                + bytes([0x02]))
        body += _chunk(b"ANMF", head + _chunk(b"VP8L", vp8l_stream(img, **options)))
    return _riff(body)


# --- GIF ------------------------------------------------------------------

def gif(indices: np.ndarray, palette: Optional[np.ndarray] = None,
        transparency: Optional[int] = None, interlace: bool = False, clear_when_full: bool = True,
        screen: Optional[Tuple[int, int]] = None, offset: Tuple[int, int] = (0, 0),
        local_palette: bool = False) -> bytes:
    """A GIF89a of one image of [h, w] uint8 indices: palette [n, 3] (padded
    to a power of two; None: the grey ramp, which Pillow reads as "L") as
    the global table or the image's local one, a graphic-control extension
    with the transparency index, a comment and a NETSCAPE2.0 block (both
    skipped by a reader), rows interlaced or not, LZW at the table's bits
    (at least 2) with or without a clear code when its table fills."""
    h, w = indices.shape
    top = int(indices.max()) if indices.size else 0
    n = len(palette) if palette is not None else top + 1
    bits = max(1, (max(n, top + 1) - 1).bit_length())
    table = np.zeros((1 << bits, 3), np.uint8)
    if palette is None:
        table[:] = np.arange(1 << bits)[:, None]
    else:
        table[:len(palette)] = palette
    sw, sh = screen if screen is not None else (offset[0] + w, offset[1] + h)
    out = b"GIF89a" + struct.pack("<HHBBB", sw, sh, 0 if local_palette else 0x80 | (bits - 1),
                                  0, 0)
    if not local_palette:
        out += table.tobytes()
    out += b"!\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    out += b"!\xfe\x07comment\x00"
    if transparency is not None:
        out += b"!\xf9\x04" + bytes([1, 0, 0, transparency]) + b"\x00"
    flags = (0x40 if interlace else 0) | ((0x80 | (bits - 1)) if local_palette else 0)
    out += b"," + struct.pack("<HHHHB", offset[0], offset[1], w, h, flags)
    if local_palette:
        out += table.tobytes()
    rows = (np.concatenate([np.arange(0, h, 8), np.arange(4, h, 8), np.arange(2, h, 4),
                            np.arange(1, h, 2)]) if interlace else np.arange(h))
    src = np.ascontiguousarray(indices[rows], np.uint8).reshape(-1)
    size = max(2, bits)
    cap = 2 * src.size + 1024
    lzw = np.empty(cap, np.uint8)
    k = _lib().gif_lzw_encode(src.ctypes.data, src.size, size, int(clear_when_full),
                              lzw.ctypes.data, cap)
    if k < 0:
        raise ValueError("GIF LZW data larger than its buffer")
    data = lzw[:k].tobytes()
    out += bytes([size]) + b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                                    for i in range(0, len(data), 255)) + b"\x00"
    return out + b";"
