"""The port's PIL-free image I/O (frosting_tpu_torch.utils.image) against
PIL itself (Pillow 12.1.0 on libjpeg-turbo): PNG (interlaced or not, 1 to
16 bits) and baseline and progressive JPEG decoding and the default
resize, bit for bit, on images made in the test; and the cases it
refuses. TIFF, BMP and the other JPEG variants are in
tests/test_torch_image_formats.py.

The JPEG files are PIL's own (libjpeg-turbo's encoder); the PNGs are
written here with every row filter (None, Sub, Up, Average, Paeth), every
supported colour type and bit depth, and Adam7 interlacing, as PIL's
encoder picks its filters itself and writes neither Adam7 nor 2- or 4-bit
grey."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from frosting_tpu_torch.utils import image as image_io


def _smooth(rng, h, w, c):
    """Smooth colour waves plus noise: JPEG blocks with real AC content."""
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([127 + 100 * np.sin(x / 7.0 + k) * np.cos(y / 5.0 - k)
                  for k in range(c)], -1)
    return np.clip(a + rng.normal(0, 20, (h, w, c)), 0, 255).astype(np.uint8)


def _filter_row(kind, row, prev, bpp):
    """PNG filter `kind` of one row (uint8 arrays), as an encoder applies it."""
    r, p = row.astype(np.int64), prev.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), p[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(r)
    elif kind == 1:
        pred = a
    elif kind == 2:
        pred = p
    elif kind == 3:
        pred = (a + p) >> 1
    else:
        est = a + p - c
        pa, pb, pc = np.abs(est - a), np.abs(est - p), np.abs(est - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, p, c))
    return ((r - pred) % 256).astype(np.uint8)


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
         (0, 1, 1, 2))


def _pack_rows(samples, depth):
    """[h, w, c] samples -> [h, stride] bytes as PNG packs them (MSB first
    below 8 bits, big endian at 16)."""
    h = samples.shape[0]
    if depth == 16:
        return samples.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    flat = samples.reshape(h, -1).astype(np.uint8)
    bits = (flat[..., None] >> np.arange(depth - 1, -1, -1, dtype=np.uint8)) & 1
    return np.packbits(bits.reshape(h, -1), axis=1)


def _png(samples, ctype, depth, palette=None, interlace=0):
    """PNG bytes of samples [H, W, C] (uint8, or uint16 for 16 bit; values
    below 2^depth), rows filtered with types 0-4 in turn; with interlace=1,
    the seven Adam7 passes, each filtered on its own."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)
    out = []
    for x0, y0, dx, dy in ADAM7 if interlace == 1 else ((0, 0, 1, 1),):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:  # an empty pass has no bytes
            continue
        rows = _pack_rows(sub, depth)
        prev = np.zeros(rows.shape[1], np.uint8)
        for y in range(rows.shape[0]):
            kind = y % 5
            out.append(bytes([kind]) + _filter_row(kind, rows[y], prev, bpp).tobytes())
            prev = rows[y]
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        body += _chunk(b"PLTE", palette.tobytes())
    body += _chunk(b"IDAT", zlib.compress(b"".join(out)))
    return b"\x89PNG\r\n\x1a\n" + body + _chunk(b"IEND", b"")


def _pil(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im), im.mode


def _assert_like_pil(data):
    got, mode = image_io.decode(data)
    want, want_mode = _pil(data)
    assert mode == want_mode
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


# (colour type, bit depth, channels)
PNG_CASES = {
    "L8": (0, 8, 1), "RGB8": (2, 8, 3), "P8": (3, 8, 1), "RGBA8": (6, 8, 4),
    "I16": (0, 16, 1), "RGB16": (2, 16, 3), "RGBA16": (6, 16, 4),
}


@pytest.mark.parametrize("case", list(PNG_CASES))
def test_png_every_filter_matches_pil(case):
    """Palette images come back as indices ("P"), 16-bit grey as uint16
    ("I;16"), 16-bit colour as the high byte of each sample, as in PIL."""
    ctype, depth, c = PNG_CASES[case]
    rng = np.random.default_rng(depth + ctype)
    h, w = 23, 37
    top = 65536 if depth == 16 else (40 if ctype == 3 else 256)
    samples = rng.integers(0, top, (h, w, c)).astype(np.uint16 if depth == 16 else np.uint8)
    palette = rng.integers(0, 256, (40, 3)).astype(np.uint8) if ctype == 3 else None
    got = _assert_like_pil(_png(samples, ctype, depth, palette))
    assert got.shape[:2] == (h, w)


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "P"])
def test_png_from_pil_matches_pil(mode):
    arr = _smooth(np.random.default_rng(1), 30, 41, {"L": 1, "RGBA": 4}.get(mode, 3))
    img = Image.fromarray(arr[..., 0] if mode == "L" else arr)
    if mode == "P":
        img = img.quantize(32)
    buf = io.BytesIO()
    img.save(buf, "PNG", optimize=True)
    _assert_like_pil(buf.getvalue())


@pytest.mark.parametrize(
    "mode,subsampling,size,restart",
    [
        ("RGB", 0, (48, 64), 0), ("RGB", 1, (45, 61), 0), ("RGB", 2, (45, 61), 0),
        ("RGB", 2, (17, 9), 0), ("RGB", 2, (3, 2), 0), ("RGB", 1, (16, 16), 0),
        ("RGB", 2, (37, 53), 1), ("RGB", 0, (37, 53), 3), ("RGB", 1, (40, 33), 2),
        ("L", 0, (45, 61), 0), ("L", 0, (37, 53), 2),
    ],
    ids=lambda v: str(v).replace(" ", ""),
)
def test_jpeg_matches_pil_bitwise(mode, subsampling, size, restart):
    """libjpeg's islow IDCT, fancy upsampling and fixed-point colour
    conversion, exactly; restart markers every `restart` MCUs."""
    rng = np.random.default_rng(size[0] * 100 + size[1])
    arr = _smooth(rng, *size, 1 if mode == "L" else 3)
    img = Image.fromarray(arr[..., 0] if mode == "L" else arr)
    for quality in (40, 95):
        buf = io.BytesIO()
        img.save(buf, "JPEG", quality=quality, subsampling=subsampling,
                 restart_marker_blocks=restart)
        data = buf.getvalue()
        assert (b"\xff\xd0" in data) == (restart > 0)
        _assert_like_pil(data)


def _jpeg(mode="RGB", **kw):
    buf = io.BytesIO()
    img = Image.fromarray(_smooth(np.random.default_rng(2), 24, 24, 3))
    img.convert(mode).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _unrefined_progressive():
    """A progressive JPEG of PIL's (libjpeg's simple progression, ten
    scans) cut after its sixth scan: the low AC coefficients' last bit is
    never sent, and libjpeg smooths such blocks."""
    data = _jpeg(progressive=True)
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    assert len(sos) == 10
    return data[:sos[6]] + b"\xff\xd9"


def _patched_sof(data, marker=None, precision=None):
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


def _pil_file(fmt):
    buf = io.BytesIO()
    Image.fromarray(_smooth(np.random.default_rng(2), 24, 24, 3)).save(buf, fmt)
    return buf.getvalue()


# (make the file, the port's exception, whether Pillow refuses it too)
REFUSED = {
    "12-bit": (lambda: _patched_sof(_jpeg(), precision=12), NotImplementedError, True),
    "hierarchical": (lambda: _patched_sof(_jpeg(), marker=0xC5), NotImplementedError, True),
    "LA": (lambda: _png(np.zeros((4, 4, 2), np.uint8), 4, 8), ValueError, False),
    "adam7": (lambda: _png(np.zeros((4, 4, 3), np.uint8), 2, 8, interlace=2), ValueError, True),
    "1-bit": (lambda: _png(np.zeros((4, 1, 3), np.uint8), 2, 1), NotImplementedError, True),
    "gif": (lambda: _pil_file("GIF"), ValueError, False),
    "webp": (lambda: _pil_file("WEBP"), ValueError, False),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_refused_files_raise(case):
    """12-bit: Pillow opens 8-bit JPEGs only; hierarchical: libjpeg refuses
    SOF5-7; adam7: an interlace method that is not Adam7; 1-bit: 1-bit RGB,
    which PNG does not define. Pillow refuses each of these too. Pillow
    reads the others: LA, grey + alpha, which no trainer takes; gif and
    webp, PIL's own files, containers still to be ported (ROADMAP section
    A)."""
    make, error, pil_refuses = REFUSED[case]
    data = make()
    with pytest.raises(error):
        image_io.decode(data)
    if pil_refuses:
        with pytest.raises(Exception):
            _pil(data)
    else:
        _pil(data)


def _arithmetic():
    """PIL's baseline file transcoded to arithmetic coding (SOF9) by the
    port's writer: the same coefficients."""
    from frosting_tpu_torch.utils import image_encode

    return image_encode.jpeg_arithmetic(_jpeg())


@pytest.mark.parametrize("make", [_unrefined_progressive, _arithmetic,
                                  lambda: _jpeg(mode="CMYK")],
                         ids=["progressive", "arithmetic", "cmyk"])
def test_formerly_refused_files_match_pil(make):
    """Files the port refused before it read them: a progressive file whose
    last scans are cut (libjpeg smooths its blocks), an arithmetic-coded
    file, PIL's CMYK file (Adobe's inverted CMYK)."""
    data = make()
    got = _assert_like_pil(data)
    if make is _arithmetic:
        np.testing.assert_array_equal(got, image_io.decode(_jpeg())[0])


# progressive JPEG: (PIL mode, subsampling, extra save options)
PROGRESSIVE_CASES = {
    "grey": ("L", -1, {}),
    "444": ("RGB", 0, {}),
    "420": ("RGB", 2, {}),
    "422-optimized": ("RGB", 1, {"optimize": True}),
    "420-restarts": ("RGB", 2, {"restart_marker_blocks": 3}),
    "444-optimized-restarts-q95": ("RGB", 0, {"optimize": True, "restart_marker_rows": 1,
                                              "quality": 95}),
}


@pytest.mark.parametrize("case", list(PROGRESSIVE_CASES))
def test_progressive_jpeg_matches_pil_bitwise(case):
    """Spectral selection, successive approximation (DC and AC refinement),
    end-of-band runs and restart markers, over odd sizes: PIL's
    progressive files, decoded bit for bit as PIL decodes them."""
    mode, subsampling, extra = PROGRESSIVE_CASES[case]
    img = Image.fromarray(_smooth(np.random.default_rng(3), 45, 67, 3)).convert(mode)
    buf = io.BytesIO()
    kw = {"subsampling": subsampling} if subsampling >= 0 else {}
    img.save(buf, "JPEG", progressive=True, quality=extra.pop("quality", 85), **kw, **extra)
    data = buf.getvalue()
    assert data.count(b"\xff\xda") > 1 and b"\xff\xc2" in data
    assert (b"\xff\xd0" in data) == ("restart_marker_blocks" in extra
                                      or "restart_marker_rows" in extra)
    _assert_like_pil(data)


# (colour type, bit depth, channels) of the Adam7 and sub-8-bit cases
INTERLACED_CASES = {
    "L1": (0, 1, 1), "L2": (0, 2, 1), "L4": (0, 4, 1), "L8": (0, 8, 1), "I16": (0, 16, 1),
    "P1": (3, 1, 1), "P2": (3, 2, 1), "P4": (3, 4, 1), "P8": (3, 8, 1),
    "RGB8": (2, 8, 3), "RGB16": (2, 16, 3), "RGBA8": (6, 8, 4), "RGBA16": (6, 16, 4),
}


@pytest.mark.parametrize("interlace", [0, 1], ids=["plain", "adam7"])
@pytest.mark.parametrize("case", list(INTERLACED_CASES))
def test_png_bit_depths_and_adam7_match_pil(case, interlace):
    """1-bit grey comes back as bool ("1"), 2- and 4-bit grey scaled to 8
    bits ("L"), palette images at any depth as their indices ("P"), as in
    PIL; sizes below one Adam7 block leave passes empty."""
    ctype, depth, c = INTERLACED_CASES[case]
    rng = np.random.default_rng(depth + 17 * ctype)
    for h, w in ((23, 37), (3, 5), (1, 1)):
        samples = rng.integers(0, 1 << depth, (h, w, c)).astype(
            np.uint16 if depth == 16 else np.uint8)
        palette = rng.integers(0, 256, (1 << depth, 3)).astype(np.uint8) if ctype == 3 else None
        got = _assert_like_pil(_png(samples, ctype, depth, palette, interlace))
        assert got.shape[:2] == (h, w)


@pytest.mark.parametrize("bits", [1, 2, 4])
def test_png_from_pil_below_8_bits_matches_pil(bits):
    """PIL's own writer: 1-bit grey (mode "1") and palette images saved
    with bits=1, 2 or 4."""
    rng = np.random.default_rng(bits)
    img = Image.fromarray(rng.integers(0, 1 << bits, (29, 43)).astype(np.uint8), "L").convert("P")
    img.putpalette(rng.integers(0, 256, 3 << bits).tolist())
    buf = io.BytesIO()
    img.save(buf, "PNG", bits=bits)
    assert buf.getvalue()[24] == bits  # the IHDR's bit depth
    _assert_like_pil(buf.getvalue())
    if bits == 1:
        buf = io.BytesIO()
        Image.fromarray(rng.integers(0, 2, (29, 43)).astype(bool)).save(buf, "PNG")
        assert _assert_like_pil(buf.getvalue()).dtype == bool


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "P"])
@pytest.mark.parametrize("size", [(32, 24), (31, 23), (20, 45), (100, 70)],
                         ids=["half", "odd", "mixed", "up"])
def test_resize_matches_pil(mode, size):
    """Image.resize(size): BICUBIC in fixed point (RGBA premultiplied),
    NEAREST for palette images."""
    rng = np.random.default_rng(7)
    arr = _smooth(rng, 48, 64, 4)
    img = Image.fromarray(arr[..., 0] if mode == "L" else arr[..., :3] if mode == "RGB" else arr)
    if mode == "P":
        img = Image.fromarray(arr[..., :3]).quantize(64)
    src = np.asarray(img)
    want = np.asarray(img.resize(size))
    got = image_io.resize(src, mode, size)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_resize_of_1_bit_matches_pil():
    """Image.resize of a mode "1" image: NEAREST, as for palette images."""
    img = Image.fromarray(np.random.default_rng(8).integers(0, 2, (48, 64)).astype(bool))
    for size in ((32, 24), (31, 23), (100, 70)):
        want = np.asarray(img.resize(size))
        got = image_io.resize(np.asarray(img), "1", size)
        assert got.dtype == want.dtype == bool
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["I;16", "I;16B"])
def test_resize_of_16_bit_grey_matches_pil(mode):
    """Image.resize of 16-bit grey: BICUBIC in float64 with Pillow's byte
    clipping (values past 65535 keep their low byte under a high byte of
    255), "I;16B" read as little-endian words, as Pillow does."""
    a = np.random.default_rng(9).integers(0, 65536, (48, 64)).astype(np.uint16)
    img = Image.fromarray(a) if mode == "I;16" else Image.frombytes(
        "I;16B", (64, 48), a.astype(">u2").tobytes())
    for size in ((32, 24), (31, 23), (100, 70), (64, 30)):
        want = np.asarray(img.resize(size))
        got = image_io.resize(np.asarray(img), mode, size)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_image_size_reads_the_header(tmp_path):
    for name, data in (("a.png", _png(np.zeros((7, 11, 3), np.uint8), 2, 8)),
                       ("b.jpg", _jpeg(quality=80))):
        path = tmp_path / name
        path.write_bytes(data)
        with Image.open(path) as im:
            assert image_io.image_size(str(path)) == im.size
