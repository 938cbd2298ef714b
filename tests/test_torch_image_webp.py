"""The port's WebP and GIF decoders (frosting_tpu_torch.utils.image) against
PIL itself (Pillow 12.1.0 with its bundled libwebp 1.6), bit for bit, on
files built in each test: PIL writes what it can (lossless and lossy WebP
at several methods and qualities, alpha, two-frame animations, GIFs from
RGB, grey and palette images, transparency, interlace); the port's own
writer (frosting_tpu_torch.utils.image_encode, no PIL) writes the rest
(VP8's simple filter and 1-8 token partitions, each ALPH filter raw and
compressed, a first animation frame at an offset, GIFs whose LZW table
fills, small code sizes, local palettes, frames off the screen's corner),
and PIL must decode each of those files to the port's array too. Also
Image.size, Image.resize of the new modes, and one RGBA WebP through both
packages' CameraInfo.image()."""

import io
import struct

import numpy as np
import pytest
from PIL import Image

from frosting_tpu.scene import dataset as jax_dataset
from frosting_tpu_torch import _build
from frosting_tpu_torch.scene import dataset
from frosting_tpu_torch.utils import image as image_io
from frosting_tpu_torch.utils import image_encode as enc


@pytest.fixture(scope="module", autouse=True)
def _host_libraries():
    """The three g++ libraries these tests load, compiled at once."""
    _build.build_all(["image_decode", "image_encode", "webp_decode"])


def _smooth(seed, h=45, w=67, c=3, noise=20):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([127 + 100 * np.sin(x / 7.0 + k) * np.cos(y / 5.0 - k) for k in range(c)], -1)
    return np.clip(a + rng.normal(0, noise, (h, w, c)), 0, 255).astype(np.uint8)


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


def _webp(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _colours(n, h=45, w=67):
    """An image of n distinct colours (colour indexing, bundled when n <= 16)."""
    idx = np.random.default_rng(n).integers(0, n, (h, w))
    return np.random.default_rng(n + 1).integers(0, 256, (n, 3)).astype(np.uint8)[idx]


RGB = _smooth(0)
RGBA = _smooth(1, c=4)


# --- VP8L -------------------------------------------------------------------

@pytest.mark.parametrize("quality", [0, 100])
@pytest.mark.parametrize("method", [0, 4, 6])
def test_lossless_webp_from_pil_matches_pil(method, quality):
    got = _assert_like_pil(_webp(RGB, lossless=True, method=method, quality=quality))
    np.testing.assert_array_equal(got, RGB)


@pytest.mark.parametrize("n", [2, 4, 16, 200])
def test_lossless_webp_colour_indexing_matches_pil(n):
    img = _colours(n)
    np.testing.assert_array_equal(_assert_like_pil(_webp(img, lossless=True)), img)


def test_lossless_webp_rgba_exact_matches_pil():
    np.testing.assert_array_equal(_assert_like_pil(_webp(RGBA, lossless=True, exact=True)), RGBA)


WRITER_VP8L = {
    "predictor+green": {}, "predictor": {"subtract_green": False},
    "green": {"predictor": False}, "literal": {"predictor": False, "subtract_green": False},
    "tiles-4": {"pred_bits": 2}, "palette-2": {"palette": True, "n": 2},
    "palette-3": {"palette": True, "n": 3}, "palette-16": {"palette": True, "n": 16},
    "palette-17": {"palette": True, "n": 17},
}


@pytest.mark.parametrize("case", list(WRITER_VP8L))
def test_lossless_webp_writer_layouts_match_pil(case):
    kw = dict(WRITER_VP8L[case])
    img = _colours(kw.pop("n"), 33, 31) if "n" in kw else _smooth(2, 33, 31)
    np.testing.assert_array_equal(_assert_like_pil(enc.webp(img, **kw)), img)


# --- VP8 --------------------------------------------------------------------

@pytest.mark.parametrize("method", [0, 6])
@pytest.mark.parametrize("quality", [10, 50, 95])
def test_lossy_webp_from_pil_matches_pil(quality, method):
    """PIL's encoder brings segments, B_PRED and the normal filter."""
    _assert_like_pil(_webp(RGB, quality=quality, method=method))


@pytest.mark.parametrize("size", [(1, 1), (9, 1), (1, 7), (17, 9), (33, 31), (48, 64)])
def test_lossy_webp_odd_sizes_match_pil(size):
    """Noise (B_PRED everywhere) and smooth content at sizes that are not
    macroblock multiples, odd widths and heights for the upsampler."""
    h, w = size
    _assert_like_pil(_webp(np.random.default_rng(h * w).integers(0, 256, (h, w, 3)).astype(
        np.uint8), quality=60, method=6))
    _assert_like_pil(_webp(_smooth(h + w, h, w), quality=30))


@pytest.mark.parametrize("partitions", [1, 2, 4, 8])
@pytest.mark.parametrize("filt", ["none", "simple", "normal", "sharp"])
def test_lossy_webp_writer_filters_and_partitions_match_pil(filt, partitions):
    """The simple filter and more than one token partition, which PIL does
    not write; sharpness 6 lowers the interior limit."""
    ftype, level, sharp = {"none": (0, 0, 0), "simple": (1, 20, 0), "normal": (2, 30, 0),
                           "sharp": (2, 63, 6)}[filt]
    img = _smooth(3, 40, 50, noise=8)
    data = enc.webp(img, lossless=False, q=30, filter_type=ftype, level=level, sharpness=sharp,
                    partitions=partitions)
    got = _assert_like_pil(data)
    assert 10 * np.log10(255.0**2 / np.mean((got.astype(float) - img) ** 2)) > 25


# --- VP8X with ALPH -----------------------------------------------------------

@pytest.mark.parametrize("alpha_quality", [30, 100])
def test_lossy_webp_with_alpha_from_pil_matches_pil(alpha_quality):
    _assert_like_pil(_webp(RGBA, quality=70, alpha_quality=alpha_quality))


@pytest.mark.parametrize("compressed", [False, True], ids=["raw", "vp8l"])
@pytest.mark.parametrize("filt", [0, 1, 2, 3], ids=["none", "horizontal", "vertical", "gradient"])
def test_alph_filters_match_pil(filt, compressed):
    img = _smooth(4, 29, 37, 4, noise=10)
    got = _assert_like_pil(enc.webp(img, lossless=False, q=10, alpha_filter=filt,
                                    alpha_compressed=compressed))
    np.testing.assert_array_equal(got[..., 3], img[..., 3])


@pytest.mark.parametrize("canvas", [(40, 29), (37, 31), (36, 29)],
                         ids=["wider", "taller", "narrower"])
@pytest.mark.parametrize("lossless", [True, False], ids=["vp8l", "vp8"])
def test_still_vp8x_frame_off_its_canvas_is_refused(lossless, canvas, tmp_path):
    """A still image behind a VP8X header whose canvas differs from its
    frame: libwebp refuses it, so PIL cannot open it, and the port raises
    ValueError in decode and image_size alike."""
    still = enc.webp(_smooth(4, 29, 37), lossless=lossless)
    w, h = canvas
    vp8x = (b"VP8X" + struct.pack("<I", 10) + bytes(4) + struct.pack("<I", w - 1)[:3]
            + struct.pack("<I", h - 1)[:3])
    body = b"WEBP" + vp8x + still[12:]
    data = b"RIFF" + struct.pack("<I", len(body)) + body
    path = tmp_path / "still.webp"
    path.write_bytes(data)
    with pytest.raises(OSError):
        Image.open(path)
    with pytest.raises(ValueError, match="canvas"):
        image_io.decode(data)
    with pytest.raises(ValueError, match="canvas"):
        image_io.image_size(str(path))


# --- animation --------------------------------------------------------------

@pytest.mark.parametrize("lossless", [False, True])
def test_animated_webp_from_pil_gives_its_first_frame(lossless):
    frames = [Image.fromarray(_smooth(5, 30, 40)), Image.fromarray(_smooth(6, 30, 40))]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=100,
                   lossless=lossless)
    _assert_like_pil(buf.getvalue())


def test_animated_webp_first_frame_smaller_than_its_canvas():
    """PIL's writer crops a first frame with a transparent border to a
    frame at an offset; the port's writer places one at (16, 6). The
    canvas outside the frame is transparent black."""
    first = np.zeros((30, 40, 4), np.uint8)
    first[5:20, 6:30] = _smooth(7, 15, 24, 4)
    first[5:20, 6:30, 3] = 255
    buf = io.BytesIO()
    Image.fromarray(first).save(buf, "WEBP", save_all=True, lossless=True,
                                append_images=[Image.fromarray(_smooth(8, 30, 40, 4))])
    np.testing.assert_array_equal(_assert_like_pil(buf.getvalue()), first)
    frame = _smooth(9, 20, 22, 4)
    data = enc.webp_animation([(frame, 16, 6), (_smooth(10, 30, 40, 4), 0, 0)], (40, 30))
    want = np.zeros((30, 40, 4), np.uint8)
    want[6:26, 16:38] = frame
    np.testing.assert_array_equal(_assert_like_pil(data), want)


# --- GIF --------------------------------------------------------------------

def _gif(img, **kw):
    buf = io.BytesIO()
    img.save(buf, "GIF", **kw)
    return buf.getvalue()


def _min_code_size(data):
    """The LZW minimum code size of a writer's file (after the image
    descriptor and the global table it writes)."""
    flags = data[10]
    pos = 13 + (3 << ((flags & 7) + 1) if flags & 128 else 0)
    while data[pos] == 0x21:
        pos += 2
        while data[pos]:
            pos += 1 + data[pos]
        pos += 1
    return data[pos + 10]


PIL_GIFS = {
    "rgb": lambda: _gif(Image.fromarray(RGB)),
    "quantized": lambda: _gif(Image.fromarray(RGB).quantize(256)),
    "grey": lambda: _gif(Image.fromarray(RGB[..., 0])),
    "transparency": lambda: _gif(Image.fromarray(RGB).quantize(200), transparency=5),
    "interlaced": lambda: _gif(Image.fromarray(RGB).quantize(64), interlace=True),
    "not-interlaced": lambda: _gif(Image.fromarray(RGB).quantize(64), interlace=False),
    "4-colours": lambda: _gif(Image.fromarray(_colours(4)).quantize(4), optimize=True),
    "2-colours": lambda: _gif(Image.fromarray(_colours(2)).quantize(2), optimize=True),
}


@pytest.mark.parametrize("case", list(PIL_GIFS))
def test_gif_from_pil_matches_pil(case):
    _assert_like_pil(PIL_GIFS[case]())


INDEX = np.random.default_rng(11).integers(0, 200, (45, 67)).astype(np.uint8)
PALETTE = np.random.default_rng(12).integers(0, 256, (200, 3)).astype(np.uint8)
WRITER_GIFS = {
    "global": {}, "local": {"local_palette": True}, "interlaced": {"interlace": True},
    "transparency": {"transparency": 7},
    "offset-transparent": {"screen": (80, 60), "offset": (5, 7), "transparency": 3},
    "offset-past-screen": {"screen": (30, 30), "offset": (5, 7)},
    "grey-ramp": {"palette": None},
}


@pytest.mark.parametrize("case", list(WRITER_GIFS))
def test_gif_writer_layouts_match_pil(case):
    kw = dict(WRITER_GIFS[case])
    palette = kw.pop("palette", PALETTE)
    got = _assert_like_pil(enc.gif(INDEX, palette, **kw))
    x, y = kw.get("offset", (0, 0))
    np.testing.assert_array_equal(got[y:y + 45, x:x + 67], INDEX)


@pytest.mark.parametrize("n,code_size", [(2, 2), (4, 2), (16, 4), (5, 3)])
def test_gif_small_code_sizes_match_pil(n, code_size):
    index = np.random.default_rng(n).integers(0, n, (31, 45)).astype(np.uint8)
    data = enc.gif(index, PALETTE[:n])
    assert _min_code_size(data) == code_size
    np.testing.assert_array_equal(_assert_like_pil(data), index)


@pytest.mark.parametrize("clear", [True, False], ids=["clear-when-full", "full-table"])
def test_gif_lzw_table_full_matches_pil(clear):
    """Noise fills the 4096-entry table: the writer either clears it or
    goes on with 12-bit codes and no new entries."""
    index = np.random.default_rng(13).integers(0, 256, (120, 160)).astype(np.uint8)
    data = enc.gif(index, np.random.default_rng(14).integers(0, 256, (256, 3)).astype(np.uint8),
                   clear_when_full=clear)
    np.testing.assert_array_equal(_assert_like_pil(data), index)


# --- sizes, resize, the loader, refusals --------------------------------------

def test_image_size_reads_webp_and_gif_headers(tmp_path):
    files = {"a.webp": _webp(RGB, lossless=True), "b.webp": _webp(RGB, quality=50),
             "c.webp": _webp(RGBA, quality=50),
             "d.webp": enc.webp_animation([(_smooth(1, 10, 12, 4), 4, 2)], (31, 17)),
             "e.gif": _gif(Image.fromarray(RGB).quantize(16)),
             "f.gif": enc.gif(INDEX, PALETTE, screen=(30, 30), offset=(5, 7))}
    for name, data in files.items():
        path = tmp_path / name
        path.write_bytes(data)
        with Image.open(path) as im:
            assert image_io.image_size(str(path)) == im.size


@pytest.mark.parametrize("source", ["webp-rgb", "webp-rgba", "gif-p", "gif-l"])
def test_resize_of_webp_and_gif_modes_matches_pil(source):
    data = {"webp-rgb": lambda: _webp(RGB, quality=60),
            "webp-rgba": lambda: _webp(RGBA, lossless=True),
            "gif-p": lambda: enc.gif(INDEX, PALETTE),
            "gif-l": lambda: enc.gif(INDEX)}[source]()
    arr, mode = image_io.decode(data)
    with Image.open(io.BytesIO(data)) as im:
        for size in ((32, 24), (100, 70)):
            np.testing.assert_array_equal(image_io.resize(arr, mode, size),
                                          np.asarray(im.resize(size)))


@pytest.mark.parametrize("size", [(67, 45), (33, 22)], ids=["native", "resized"])
def test_rgba_webp_through_both_loaders(tmp_path, size):
    """CameraInfo.image() of the JAX package (PIL) and of the port, bitwise:
    the RGBA view composited over white, at its own size and resized."""
    path = tmp_path / "view.webp"
    path.write_bytes(_webp(RGBA, quality=80, alpha_quality=60))
    w, h = size
    want = jax_dataset.CameraInfo(None, str(path), "view", w, h).image()
    got = dataset.CameraInfo(None, str(path), "view", w, h).image()
    assert got.dtype == want.dtype and got.shape == want.shape == (3, h, w)
    np.testing.assert_array_equal(got, want)
