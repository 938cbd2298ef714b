"""The port's scene loaders (frosting_tpu_torch.scene.dataset) against the
JAX package's: a COLMAP scene with PNG (RGB, RGBA, grey, palette), JPEG
(4:2:0, 4:4:4, grey, CMYK), 16-bit grey TIFF and BMP images, with and
without the eval split and at resolution scale 2 (so the resize runs); a
NeRF-synthetic scene of RGBA PNGs; a 3DGS cameras.json. Every camera field
agrees at rtol 1e-6; names, splits, extents and points are equal; the
ground-truth images are equal bit for bit, dtype included (RGBA composites
in float64, as in JAX). The JAX loader's quirks hold in the port too: a
CMYK view composites its K channel as if it were alpha (in float64), and a
16-bit view divided by 255 reaches 257."""

import dataclasses
import json
import struct

import numpy as np
import pytest
from PIL import Image

from frosting_tpu.scene import dataset as jax_dataset
from frosting_tpu_torch.scene import dataset

W, H = 64, 48
# (file name, PIL mode, save options)
IMAGES = [
    ("img_000.png", "RGB", {}), ("img_001.png", "RGBA", {}),
    ("img_002.jpg", "RGB", {"quality": 90}), ("img_003.jpg", "L", {}),
    ("img_004.png", "L", {}), ("img_005.png", "RGBA", {}),
    ("img_006.jpg", "RGB", {"subsampling": 0}), ("img_007.png", "P", {}),
    ("img_008.png", "RGB", {}), ("img_009.tif", "I;16", {"compression": "tiff_lzw"}),
    ("img_010.jpg", "CMYK", {"quality": 90}), ("img_011.bmp", "RGB", {}),
]


def _picture(rng, mode, w, h):
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([127 + 110 * np.sin(x / 6.0 + k) * np.cos(y / 4.0 - k) for k in range(4)], -1)
    a = np.clip(a + rng.normal(0, 15, a.shape), 0, 255).astype(np.uint8)
    if mode == "L":
        return Image.fromarray(a[..., 0])
    if mode == "P":
        return Image.fromarray(a[..., :3]).quantize(48)
    if mode == "I;16":
        return Image.fromarray(a[..., 0].astype(np.uint16) * 257)
    if mode == "CMYK":
        return Image.frombytes("CMYK", (w, h), a.tobytes())
    return Image.fromarray(a[..., :len(mode)])


def _unit(v):
    return v / np.linalg.norm(v)


@pytest.fixture(scope="module")
def colmap_scene(tmp_path_factory):
    d = tmp_path_factory.mktemp("colmap")
    rng = np.random.default_rng(0)
    (d / "images").mkdir()
    (d / "sparse" / "0").mkdir(parents=True)
    for name, mode, opts in IMAGES:
        _picture(rng, mode, W, H).save(d / "images" / name, **opts)
    with open(d / "sparse" / "0" / "cameras.bin", "wb") as f:
        f.write(struct.pack("<QiiQQ4d", 1, 1, 1, W, H, 52.0, 50.5, 30.5, 25.0))
    with open(d / "sparse" / "0" / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(IMAGES)))
        # written out of name order: the loader sorts by name
        for i in rng.permutation(len(IMAGES)):
            q = _unit(rng.normal(size=4))
            f.write(struct.pack("<i4d3di", int(i) + 1, *q, *rng.normal(size=3), 1))
            f.write(IMAGES[i][0].encode() + b"\x00" + struct.pack("<Q", 0))
    with open(d / "sparse" / "0" / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", 50))
        for j in range(50):
            f.write(struct.pack("<QdddBBBdQ", j, *rng.normal(size=3),
                                *rng.integers(0, 256, 3), 0.5, 0))
    return str(d)


def _assert_camera(info, jinfo):
    assert (info.image_name, info.image_path, info.width, info.height) == (
        jinfo.image_name, jinfo.image_path, jinfo.width, jinfo.height)
    for f in dataclasses.fields(info.camera):
        got = getattr(info.camera, f.name).numpy()
        want = np.asarray(getattr(jinfo.camera, f.name))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=f.name)


def _assert_image(info, jinfo, bg=(1.0, 1.0, 1.0)):
    got, want = info.image(bg), jinfo.image(bg)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _assert_scene(scene, jscene):
    for split in ("train_cameras", "test_cameras"):
        assert len(getattr(scene, split)) == len(getattr(jscene, split))
        for info, jinfo in zip(getattr(scene, split), getattr(jscene, split)):
            _assert_camera(info, jinfo)
            _assert_image(info, jinfo)
    for name in ("points", "colors"):
        got, want = getattr(scene, name), getattr(jscene, name)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert scene.spatial_extent == jscene.spatial_extent


@pytest.mark.parametrize("scale,eval_split", [(1, False), (2, True)],
                         ids=["full-all", "half-eval"])
def test_load_colmap_scene_matches_jax(colmap_scene, scale, eval_split):
    kw = dict(resolution_scale=scale, eval_split=eval_split)
    scene = dataset.load_colmap_scene(colmap_scene, device="cpu", **kw)
    jscene = jax_dataset.load_colmap_scene(colmap_scene, **kw)
    _assert_scene(scene, jscene)
    assert len(scene.test_cameras) == (2 if eval_split else 0)
    assert scene.train_cameras[0].image().shape == (3, H // scale, W // scale)
    # RGBA composites in float64, the rest is float32, as the JAX loader gives
    dtypes = {c.image_name: c.image().dtype for c in scene.train_cameras}
    assert dtypes["img_001.png"] == dtypes["img_010.jpg"] == np.float64
    assert dtypes["img_003.jpg"] == dtypes["img_009.tif"] == np.float32
    views = {c.image_name: c for c in scene.train_cameras}
    assert views["img_009.tif"].image().max() > 1.0  # 16-bit values over 255


def test_load_blender_scene_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    frames = []
    (tmp_path / "train").mkdir()
    for i in range(3):
        _picture(rng, "RGBA", 40, 30).save(tmp_path / "train" / f"r_{i}.png")
        eye = np.array([3.0 * np.cos(i), 3.0 * np.sin(i), 1.0])
        fwd = _unit(-eye)
        right = _unit(np.cross(fwd, [0, 0, 1.0]))
        up = np.cross(right, fwd)
        c2w = np.eye(4)
        c2w[:3, :3] = np.stack([right, up, -fwd], 1)  # NeRF: camera looks down -z
        c2w[:3, 3] = eye
        frames.append({"file_path": f"./train/r_{i}", "transform_matrix": c2w.tolist()})
    (tmp_path / "transforms_train.json").write_text(
        json.dumps({"camera_angle_x": 0.69, "frames": frames}))
    kw = dict(n_random_points=500, seed=4)
    scene = dataset.load_blender_scene(str(tmp_path), device="cpu", **kw)
    jscene = jax_dataset.load_blender_scene(str(tmp_path), **kw)
    _assert_scene(scene, jscene)
    _assert_image(scene.train_cameras[1], jscene.train_cameras[1], bg=(0.0, 0.0, 0.0))


def test_load_gs_cameras_json_matches_jax(tmp_path):
    rng = np.random.default_rng(5)
    cams = []
    for i, (w, h) in enumerate([(2400, 1350), (1600, 900), (1000, 2200)]):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        cams.append({"id": i, "img_name": f"c_{2 - i}.png", "width": w, "height": h,
                     "position": rng.normal(size=3).tolist(), "rotation": q.tolist(),
                     "fx": 0.8 * w, "fy": 0.8 * w})
    (tmp_path / "cameras.json").write_text(json.dumps(cams))
    for source in (None, str(tmp_path / "src")):
        infos = dataset.load_gs_cameras_json(str(tmp_path), source, device="cpu")
        jinfos = jax_dataset.load_gs_cameras_json(str(tmp_path), source)
        assert [c.image_name for c in infos] == ["c_0.png", "c_1.png", "c_2.png"]
        # the reference's downscale rule: the longer side at most 1920
        assert max(max(c.width, c.height) for c in infos) == 1920
        for info, jinfo in zip(infos, jinfos):
            _assert_camera(info, jinfo)
