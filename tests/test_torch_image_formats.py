"""The port's TIFF and BMP decoders and the JPEG variants past baseline and
progressive Huffman (frosting_tpu_torch.utils.image) against PIL itself
(Pillow 12.1.0, libtiff for compressed TIFF, libjpeg-turbo 3.1), bit for
bit, on files built in each test: PIL writes what it can (TIFF in every
compression, BMP, CMYK and progressive JPEG); the port's own writer
(frosting_tpu_torch.utils.image_encode, no PIL) writes the rest (tiles,
planar TIFF, predictors, 16-bit colour, BMP RLE and bitfields, JPEG
sampling factors, YCCK, arithmetic coding, lossless JPEG), and PIL must
decode each of those files too. Every file PIL refuses, the port refuses.
Also Image.resize of the new modes, and image_size."""

import io

import numpy as np
import pytest
from PIL import Image

from frosting_tpu_torch.utils import image as image_io
from frosting_tpu_torch.utils import image_encode as enc


def _smooth(seed, h=45, w=67, c=3):
    """Smooth colour waves plus noise (real AC content for the JPEGs)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([127 + 100 * np.sin(x / 7.0 + k) * np.cos(y / 5.0 - k) for k in range(c)], -1)
    return np.clip(a + rng.normal(0, 20, (h, w, c)), 0, 255).astype(np.uint8)


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


def _pil_bytes(img, fmt, **kw):
    buf = io.BytesIO()
    img.save(buf, fmt, **kw)
    return buf.getvalue()


RGB = _smooth(0)
RGBA = _smooth(1, c=4)
U16 = np.random.default_rng(2).integers(0, 65536, (45, 67, 4)).astype(np.uint16)
INDEX = np.random.default_rng(3).integers(0, 16, (45, 67)).astype(np.uint8)
COLORMAP = np.random.default_rng(4).integers(0, 65536, (256, 3))


# --- TIFF -----------------------------------------------------------------

PIL_TIFF_MODES = {
    "L": lambda: Image.fromarray(RGB[..., 0]), "RGB": lambda: Image.fromarray(RGB),
    "RGBA": lambda: Image.fromarray(RGBA), "CMYK": lambda: Image.fromarray(RGB).convert("CMYK"),
    "P": lambda: Image.fromarray(RGB).quantize(40), "1": lambda: Image.fromarray(RGB[..., 0] > 128),
    "I;16": lambda: Image.fromarray(U16[..., 0]),
}


@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "tiff_adobe_deflate", "packbits"])
@pytest.mark.parametrize("mode", list(PIL_TIFF_MODES))
def test_tiff_from_pil_matches_pil(mode, compression):
    """PIL's own TIFFs (strips, chunky, little-endian): palette images as
    their indices, 16-bit grey as uint16, bilevel as bool."""
    _assert_like_pil(_pil_bytes(PIL_TIFF_MODES[mode](), "TIFF", compression=compression))


# (compression, predictor, tile, planar, byte order)
TIFF_LAYOUTS = {
    "lzw-predictor-strips": ("lzw", True, None, False, "<"),
    "deflate-predictor-tiles": ("deflate", True, (32, 16), False, "<"),
    "deflate-planar-tiles-big-endian": ("deflate", True, (16, 32), True, ">"),
    "lzw-planar-strips-big-endian": ("lzw", False, None, True, ">"),
    "packbits-tiles": ("packbits", False, (48, 16), False, ">"),
    "raw-planar-tiles": ("none", False, (32, 32), True, "<"),
    "raw-strips-big-endian": ("none", False, None, False, ">"),
}
# (samples, photometric, extra samples)
TIFF_SAMPLES = {
    "RGB": (RGB, 2, ()), "RGBA": (RGBA, 2, (2,)), "RGBA-associated": (RGBA, 2, (1,)),
    "L": (RGB[..., 0], 1, ()), "L-min-is-white": (RGB[..., 0], 0, ()),
    "I16": (U16[..., 0], 1, ()), "RGB16": (U16[..., :3], 2, ()),
    "RGBA16": (U16, 2, (2,)), "CMYK": (RGBA, 5, ()),
    "P": (INDEX, 3, ()), "bilevel": (RGB[..., 0] > 100, 1, ()),
}


@pytest.mark.parametrize("layout", list(TIFF_LAYOUTS))
@pytest.mark.parametrize("samples", list(TIFF_SAMPLES))
def test_tiff_layouts_match_pil(samples, layout):
    """The writer's TIFFs over every sample kind and layout: LZW, Deflate
    (with horizontal differencing at 8 and 16 bits), PackBits, strips of 7
    rows and tiles, chunky and planar, both byte orders. 16-bit colour
    comes back as the high byte of each sample; big-endian 16-bit grey
    uncompressed as "I;16B" (">u2"). The few layouts PIL refuses or
    misreads (uncompressed planar 16-bit, planar associated alpha), the
    port refuses."""
    arr, photometric, extra = TIFF_SAMPLES[samples]
    compression, predictor, tile, planar, order = TIFF_LAYOUTS[layout]
    predictor = predictor and arr.dtype != bool
    data = enc.tiff(arr, photometric, compression, predictor, tile, planar, 7, order,
                    extra_samples=extra, colormap=COLORMAP if samples == "P" else None)
    raw_planar = planar and compression == "none"
    if raw_planar and (arr.dtype == np.uint16 or samples == "RGBA-associated"):
        with pytest.raises(NotImplementedError):
            image_io.decode(data)
        return
    got = _assert_like_pil(data)
    if samples == "I16" and order == ">" and compression == "none":
        assert image_io.decode(data)[1] == "I;16B" and got.dtype == np.dtype(">u2")


def test_tiff_refusals():
    """Grey + alpha (no trainer takes two channels; PIL reads it); planar
    uncompressed 16-bit grey and min-is-white 16-bit big-endian grey, which
    PIL refuses too."""
    with pytest.raises(ValueError):
        image_io.decode(_pil_bytes(Image.fromarray(RGBA[..., :2], "LA"), "TIFF"))
    for data in (enc.tiff(U16[..., 0], 1, planar=True, tile=(32, 32)),
                 enc.tiff(U16[..., 0], 0, byteorder=">")):
        with pytest.raises(NotImplementedError):
            image_io.decode(data)
        with pytest.raises(Exception):
            _pil(data)


# --- BMP ------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_bmp_from_pil_matches_pil(mode):
    """PIL's BMPs: black-and-white and grey-ramp palettes come back as "1"
    and "L", others as indices ("P"); 32-bit as RGB (the alpha byte
    ignored)."""
    img = {"1": Image.fromarray(RGB[..., 0] > 128), "L": Image.fromarray(RGB[..., 0]),
           "P": Image.fromarray(RGB).quantize(40), "RGB": Image.fromarray(RGB),
           "RGBA": Image.fromarray(RGBA)}[mode]
    _assert_like_pil(_pil_bytes(img, "BMP"))


_PALETTE = np.random.default_rng(5).integers(0, 256, (256, 3))
_GREY = np.stack([np.arange(256)] * 3, -1)
BMP_CASES = {
    "1-bit": lambda w: enc.bmp(INDEX[:, :w] % 2, 1, _PALETTE[:2]),
    "4-bit-top-down": lambda w: enc.bmp(INDEX[:, :w], 4, _PALETTE[:16], top_down=True),
    "8-bit": lambda w: enc.bmp(INDEX[:, :w] * 9, 8, _PALETTE),
    "8-bit-grey": lambda w: enc.bmp(RGB[:, :w, 0], 8, _GREY),
    "8-bit-os2": lambda w: enc.bmp(INDEX[:, :w], 8, _PALETTE, header=12),
    "rle8": lambda w: enc.bmp(RGB[:, :w, 0] // 16, 8, _PALETTE, rle=True),
    "rle8-noise": lambda w: enc.bmp(INDEX[:, :w] * 9, 8, _PALETTE, rle=True),
    "rle4": lambda w: enc.bmp(RGB[:, :w, 1] // 16, 4, _PALETTE[:16], rle=True),
    "rle4-noise": lambda w: enc.bmp(INDEX[:, :w], 4, _PALETTE[:16], rle=True),
    "16-bit-555": lambda w: enc.bmp(RGB[:, :w], 16),
    "16-bit-565-bitfields": lambda w: enc.bmp(RGB[:, :w], 16, masks=(0xF800, 0x7E0, 0x1F)),
    "24-bit": lambda w: enc.bmp(RGB[:, :w], 24),
    "24-bit-top-down": lambda w: enc.bmp(RGB[:, :w], 24, top_down=True),
    "32-bit": lambda w: enc.bmp(RGB[:, :w], 32),
    "32-bit-xbgr": lambda w: enc.bmp(RGB[:, :w], 32, masks=(0xFF000000, 0xFF0000, 0xFF00, 0)),
    "32-bit-rgba-v4": lambda w: enc.bmp(RGBA[:, :w], 32, header=108,
                                        masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
    "32-bit-bgra-v5-top-down": lambda w: enc.bmp(RGBA[:, :w], 32, header=124, top_down=True,
                                                 masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
}


@pytest.mark.parametrize("width", [67, 3])
@pytest.mark.parametrize("case", list(BMP_CASES))
def test_bmp_variants_match_pil(case, width):
    """The writer's BMPs: 1/4/8-bit palettes (indices), a grey ramp ("L"),
    the OS/2 header, RLE8 and RLE4 (runs, absolute runs, odd lengths whose
    last RLE4 pixel Pillow drops), 16-bit 5-5-5 and 5-6-5, 24 and 32 bits
    with BI_BITFIELDS after a 40-byte header or inside a V4 / V5 one,
    bottom-up and top-down rows."""
    _assert_like_pil(BMP_CASES[case](width))


# --- JPEG -----------------------------------------------------------------

SAMPLINGS = {
    "411": ((4, 1), (1, 1), (1, 1)), "440": ((1, 2), (1, 1), (1, 1)),
    "410": ((4, 2), (1, 1), (1, 1)), "31": ((3, 1), (1, 1), (1, 1)),
    "422-440-chroma": ((2, 2), (2, 1), (1, 2)), "chroma-above-luma": ((1, 1), (2, 2), (1, 1)),
    "444": ((1, 1), (1, 1), (1, 1)),
}


@pytest.mark.parametrize("size", [(45, 67), (9, 2)], ids=["45x67", "9x2"])
@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_jpeg_sampling_factors_match_pil(sampling, size):
    """Every integral sampling libjpeg-turbo accepts, with the upsampler
    jdsample.c picks: fancy h2v1 / h1v2 / h2v2, replication below 3
    samples across, and int_upsample's box for the rest."""
    img = _smooth(6, *size)
    _assert_like_pil(enc.jpeg(img, "ycc", SAMPLINGS[sampling]))


def test_jpeg_mcu_over_10_blocks_is_refused_as_pil_refuses():
    data = enc.jpeg(RGB, "ycc", ((4, 4), (1, 1), (1, 1)))
    with pytest.raises(ValueError):
        image_io.decode(data)
    with pytest.raises(OSError):
        _pil(data)


@pytest.mark.parametrize("colour,sampling", [
    ("cmyk", None), ("ycck", None), ("ycck", ((2, 2), (1, 1), (1, 1), (2, 2))),
    ("rgb", None), ("grey", None)])
def test_jpeg_colour_spaces_match_pil(colour, sampling):
    """Adobe CMYK (transform 0) and YCCK (transform 2), which Pillow returns
    as "CMYK" with every byte inverted; RGB marked by Adobe transform 0."""
    img = {"grey": RGB[..., 0], "rgb": RGB}.get(colour, RGBA)
    got = _assert_like_pil(enc.jpeg(img, colour, sampling, restart=5))
    assert 10 * np.log10(255 ** 2 / np.mean((got.astype(float) - img) ** 2)) > 20


def test_jpeg_cmyk_from_pil_matches_pil():
    img = Image.fromarray(RGBA, "RGBA").convert("CMYK")
    for kw in ({"quality": 60}, {"quality": 95, "progressive": True}):
        _assert_like_pil(_pil_bytes(img, "JPEG", **kw))


def _pil_jpeg(**kw):
    return _pil_bytes(Image.fromarray(_smooth(7, 37, 53)), "JPEG", quality=80, **kw)


ARITHMETIC = {
    "sequential": {},
    "sequential-restarts": {"restart": 2},
    "progressive": {"progressive": True},
    "progressive-dac": {"progressive": True,
                        "conditioning": {"dc": {0: (1, 3), 1: (2, 5)}, "ac": {0: 9, 1: 2}}},
    "progressive-restarts": {"progressive": True, "restart": 3},
}


@pytest.mark.parametrize("source", ["420", "444-progressive", "cmyk"])
@pytest.mark.parametrize("case", list(ARITHMETIC))
def test_arithmetic_jpeg_matches_pil_and_its_huffman_file(case, source):
    """PIL's Huffman-coded files transcoded to arithmetic coding (SOF9 and
    SOF10: the Q-coder, DAC conditioning, restarts) by the writer: equal
    to PIL's decode, and to the port's decode of the Huffman file of the
    same coefficients."""
    huff = {"420": lambda: _pil_jpeg(subsampling=2),
            "444-progressive": lambda: _pil_jpeg(subsampling=0, progressive=True),
            "cmyk": lambda: _pil_bytes(Image.fromarray(RGBA, "RGBA").convert("CMYK"), "JPEG")
            }[source]()
    data = enc.jpeg_arithmetic(huff, **ARITHMETIC[case])
    assert (b"\xff\xca" if "progressive" in case else b"\xff\xc9") in data
    got = _assert_like_pil(data)
    np.testing.assert_array_equal(got, image_io.decode(huff)[0])


def _cuts(data):
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    return [data[:i] + b"\xff\xd9" for i in sos[1:]]


@pytest.mark.parametrize("source", ["huffman-420", "huffman-grey", "arithmetic-444"])
def test_progressive_block_smoothing_matches_pil(source):
    """A progressive file cut after each of its scans: libjpeg-turbo smooths
    the blocks whose first nine AC coefficients are not all known to their
    last bit (jdcoefct.c decompress_smooth_data, the 5 x 5 DC window; DC
    interpolation too where no AC coefficient is known)."""
    if source == "huffman-420":
        data = _pil_jpeg(progressive=True, subsampling=2)
    elif source == "huffman-grey":
        data = _pil_bytes(Image.fromarray(_smooth(8, 61, 83)[..., 0]), "JPEG", progressive=True)
    else:
        data = enc.jpeg_arithmetic(_pil_jpeg(subsampling=0), progressive=True)
    cuts = _cuts(data)
    assert len(cuts) >= 5
    for cut in cuts:
        _assert_like_pil(cut)


@pytest.mark.parametrize("psv", range(1, 8))
def test_lossless_jpeg_predictors_match_pil_and_the_source(psv):
    """SOF3, predictors 1-7, RGB (Adobe transform 0): equal to PIL's decode
    and to the source pixels."""
    data = enc.jpeg_lossless(RGB, psv)
    np.testing.assert_array_equal(_assert_like_pil(data), RGB)


def test_lossless_jpeg_point_transform_grey_and_restarts():
    """A point transform of 2 (the samples come back shifted), a grey file,
    a restart every 5 rows (the prediction starts again on each)."""
    data = enc.jpeg_lossless(RGB, 4, point_transform=2)
    np.testing.assert_array_equal(_assert_like_pil(data), RGB >> 2 << 2)
    np.testing.assert_array_equal(_assert_like_pil(enc.jpeg_lossless(RGB[..., 1], 6)),
                                  RGB[..., 1])
    data = enc.jpeg_lossless(RGB, 7, restart_rows=5)
    assert b"\xff\xd0" in data
    np.testing.assert_array_equal(_assert_like_pil(data), RGB)


# --- resize and headers -----------------------------------------------------

def test_resize_of_cmyk_matches_pil():
    """CMYK resizes like RGB (BICUBIC, fixed point, no premultiplication)."""
    img = Image.fromarray(RGB).convert("CMYK")
    for size in ((32, 24), (31, 23), (100, 70)):
        want = np.asarray(img.resize(size))
        np.testing.assert_array_equal(image_io.resize(np.asarray(img), "CMYK", size), want)


def test_image_size_reads_tiff_and_bmp_headers(tmp_path):
    files = {"a.tif": enc.tiff(RGB, 2, "lzw", tile=(32, 16), byteorder=">"),
             "b.bmp": enc.bmp(RGB, 24, top_down=True),
             "c.bmp": enc.bmp(INDEX, 8, _PALETTE, header=12),
             "d.jpg": enc.jpeg_lossless(RGB)}
    for name, data in files.items():
        path = tmp_path / name
        path.write_bytes(data)
        with Image.open(path) as im:
            assert image_io.image_size(str(path)) == im.size


def test_unknown_container_names_the_roadmap():
    with pytest.raises(ValueError, match="ROADMAP"):
        image_io.decode(b"RIFF\x00\x00\x00\x00WEBPVP8 ")
