"""The port's COLMAP readers (frosting_tpu_torch.scene.colmap) against the
JAX package's on binary and text models written in the test, and the
focal / field-of-view conversions of frosting_tpu_torch.cameras."""

import math
import struct

import numpy as np
import pytest

from frosting_tpu import cameras as jax_cameras
from frosting_tpu.scene import colmap as jax_colmap
from frosting_tpu_torch import cameras
from frosting_tpu_torch.scene import colmap

# (camera id, model id, model name, width, height, params)
CAMERAS = [
    (1, 1, "PINHOLE", 64, 48, [50.5, 49.25, 31.0, 25.5]),
    (2, 2, "SIMPLE_RADIAL", 40, 30, [33.0, 20.5, 14.0, 0.01]),
    (3, 4, "OPENCV", 80, 60, [70.0, 71.0, 40.5, 29.0, 0.1, -0.02, 0.001, 0.0]),
]


def _model(rng, n_images=5, n_points=40):
    """Images with 1-3 2D points each: both text readers drop blank lines,
    so an image without points would shift the pairing of the lines."""
    imgs = []
    for i in range(n_images):
        q = rng.normal(size=4)
        imgs.append((i + 3, q / np.linalg.norm(q), rng.normal(size=3),
                     CAMERAS[i % 3][0], f"view_{4 - i:02d}.jpg",
                     rng.uniform(0, 60, (int(rng.integers(1, 4)), 2))))
    pts = [(j + 1, rng.normal(size=3), rng.integers(0, 256, 3),
            float(rng.uniform(0, 2)), rng.integers(1, 9, int(rng.integers(0, 5))))
           for j in range(n_points)]
    return imgs, pts


def _write_bin(d, imgs, pts):
    with open(d / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", len(CAMERAS)))
        for cid, mid, _name, w, h, params in CAMERAS:
            f.write(struct.pack("<iiQQ", cid, mid, w, h))
            f.write(struct.pack(f"<{len(params)}d", *params))
    with open(d / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for iid, q, t, cid, name, xy in imgs:
            f.write(struct.pack("<i4d3di", iid, *q, *t, cid))
            f.write(name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(xy)))
            for x, y in xy:
                f.write(struct.pack("<ddq", x, y, -1))
    with open(d / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for pid, xyz, rgb, err, track in pts:
            f.write(struct.pack("<QdddBBBd", pid, *xyz, *rgb, err))
            f.write(struct.pack("<Q", len(track)))
            for img_id in track:
                f.write(struct.pack("<ii", int(img_id), 0))


def _write_txt(d, imgs, pts):
    with open(d / "cameras.txt", "w") as f:
        f.write("# Camera list\n")
        for cid, _mid, name, w, h, params in CAMERAS:
            f.write(f"{cid} {name} {w} {h} " + " ".join(repr(p) for p in params) + "\n")
    with open(d / "images.txt", "w") as f:
        f.write("# Image list with two lines of data per image\n")
        for iid, q, t, cid, name, xy in imgs:
            f.write(f"{iid} " + " ".join(repr(float(v)) for v in (*q, *t))
                    + f" {cid} {name}\n")
            f.write(" ".join(f"{x!r} {y!r} -1" for x, y in xy) + "\n")
    with open(d / "points3D.txt", "w") as f:
        for pid, xyz, rgb, err, track in pts:
            f.write(f"{pid} " + " ".join(repr(float(v)) for v in xyz) + " "
                    + " ".join(str(int(c)) for c in rgb) + f" {err!r} "
                    + " ".join(f"{t} 0" for t in track) + "\n")


def _assert_same(a, b):
    assert type(a).__name__ == type(b).__name__
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif hasattr(a, "__dataclass_fields__"):
        for name in a.__dataclass_fields__:
            _assert_same(getattr(a, name), getattr(b, name))
    else:
        assert a == b


@pytest.mark.parametrize("fmt", ["bin", "txt"])
def test_read_model_matches_jax(tmp_path, fmt):
    imgs, pts = _model(np.random.default_rng(len(fmt)))
    (_write_bin if fmt == "bin" else _write_txt)(tmp_path, imgs, pts)
    got = colmap.read_model(str(tmp_path))
    want = jax_colmap.read_model(str(tmp_path))
    _assert_same(got, want)
    cams, images, xyz, rgb = got
    assert sorted(cams) == [1, 2, 3] and len(images) == 5 and xyz.shape == (40, 3)
    for cam in cams.values():
        if cam.model == "OPENCV":
            assert cam.focal_and_pp() == jax_colmap.ColmapCamera(
                cam.camera_id, cam.model, cam.width, cam.height, cam.params
            ).focal_and_pp()
    for img in images.values():
        np.testing.assert_array_equal(
            img.rotation(),
            jax_colmap.ColmapImage(img.image_id, img.qvec, img.tvec,
                                   img.camera_id, img.name).rotation())


def test_focal_and_fov_conversions_match_jax():
    for fov in (0.1, math.radians(50), 1.3, 2.9):
        for pixels in (1, 64, 1080, 1920.0):
            assert cameras.fov_to_focal(fov, pixels) == jax_cameras.fov_to_focal(fov, pixels)
            f = cameras.fov_to_focal(fov, pixels)
            assert cameras.focal_to_fov(f, pixels) == jax_cameras.focal_to_fov(f, pixels)
            assert math.isclose(cameras.focal_to_fov(f, pixels), fov, rel_tol=1e-12)
