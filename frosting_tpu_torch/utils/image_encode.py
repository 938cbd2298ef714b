"""Small numpy writers of the TIFF, BMP and JPEG variants that
``utils/image.py`` reads, for the tests and ``chip_smoke.py``: PIL cannot
write most of them (tiled and planar TIFF, predictors, BMP bitfields and
RLE, JPEG sampling factors other than 4:4:4, 4:2:2 and 4:2:0, YCCK,
arithmetic coding, lossless JPEG), and the card's machine has no PIL. The
port's loaders do not use this module.

The serial parts, JPEG's arithmetic coder and TIFF's LZW, are C++
(``csrc/image_encode.cpp``, built with g++ at first use by ``_build.py``).
The JPEG writers use the example tables of ITU T.81 Annex K.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Dict, Optional, Sequence, Tuple

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
