"""The port's scene and serving layer against the JAX reference: PLY
checkpoints both ways, params_from_numpy + activate, the synthetic scene and
camera ring, render_gt_images, and the HTTP viewer on the CPU."""

import dataclasses
import json
import struct
import urllib.error
import urllib.request
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frosting_tpu.raster import RasterConfig as JaxConfig
from frosting_tpu.scene import gaussians as jgs
from frosting_tpu.scene import synthetic as jsyn
from frosting_tpu_torch.raster import RasterConfig, render
from frosting_tpu_torch.scene import gaussians as tgs
from frosting_tpu_torch.scene import synthetic as tsyn
from frosting_tpu_torch.utils import viewer


def _jax_params(capacity=50, live=40, seed=0):
    rng = np.random.default_rng(seed)
    mask = np.zeros(capacity, np.float32)
    mask[rng.permutation(capacity)[:live]] = 1.0
    f32 = jnp.float32
    return jgs.GaussianParams(
        means3d=jnp.asarray(rng.normal(size=(capacity, 3)), f32),
        sh_dc=jnp.asarray(rng.normal(size=(capacity, 1, 3)), f32),
        sh_rest=jnp.asarray(rng.normal(size=(capacity, 15, 3)), f32),
        scales_log=jnp.asarray(rng.normal(size=(capacity, 3)) - 3, f32),
        quats_raw=jnp.asarray(rng.normal(size=(capacity, 4)), f32),
        opacities_raw=jnp.asarray(rng.normal(size=capacity), f32),
        mask=jnp.asarray(mask),
    )


def _fields(p):
    return {
        f.name: np.asarray(getattr(p, f.name).cpu() if torch.is_tensor(getattr(p, f.name))
                           else getattr(p, f.name))
        for f in dataclasses.fields(p)
    }


def _assert_same_params(a, b):
    fa, fb = _fields(a), _fields(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_ply_round_trips_both_ways(tmp_path):
    jp = _jax_params()
    jax_file = tmp_path / "jax.ply"
    jgs.save_ply(jp, str(jax_file))
    # JAX writes, the port reads (with and without extra capacity)
    _assert_same_params(
        tgs.load_ply(str(jax_file), device="cpu"), jgs.load_ply(str(jax_file))
    )
    _assert_same_params(
        tgs.load_ply(str(jax_file), capacity=64, device="cpu"),
        jgs.load_ply(str(jax_file), capacity=64),
    )
    # the port writes the same bytes, and JAX reads them back
    tp = tgs.params_from_numpy(_fields(jp), device="cpu")
    port_file = tmp_path / "port.ply"
    tgs.save_ply(tp, str(port_file))
    assert port_file.read_bytes() == jax_file.read_bytes()
    _assert_same_params(
        jgs.load_ply(str(port_file)), tgs.load_ply(str(port_file), device="cpu")
    )
    ascii_file = tmp_path / "ascii.ply"
    ascii_file.write_bytes(
        b"ply\nformat ascii 1.0\nelement vertex 1\nproperty float x\n"
        b"end_header\n0.5\n"
    )
    with pytest.raises(ValueError, match="unsupported PLY format"):
        tgs.load_ply(str(ascii_file), device="cpu")


def test_params_from_numpy_and_activate():
    jp = _jax_params(seed=1)
    tp = tgs.params_from_numpy(_fields(jp), device="cpu")
    _assert_same_params(tp, jp)
    assert tp.capacity == 50 and int(tp.num_active()) == int(jp.num_active()) == 40
    for name, a, b in zip(
        ["means", "scales", "quats", "opac", "sh"], tgs.activate(tp), jgs.activate(jp)
    ):
        np.testing.assert_allclose(
            a.numpy(), np.asarray(b), atol=1e-6, rtol=1e-5, err_msg=name
        )
    x = np.asarray([0.1, 0.5, 0.9], np.float32)
    np.testing.assert_allclose(
        tgs.inverse_sigmoid(torch.from_numpy(x)).numpy(),
        np.asarray(jgs.inverse_sigmoid(jnp.asarray(x))), atol=1e-6,
    )


def test_synthetic_scene_cameras_and_gt_images():
    for a, b in zip(
        tsyn.gaussian_blob_scene(n=500, seed=3, device="cpu"),
        jsyn.gaussian_blob_scene(n=500, seed=3),
    ):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tcams = tsyn.camera_ring(n_cams=2, radius=2.6, device="cpu")
    jcams = jsyn.camera_ring(n_cams=2, radius=2.6)
    for tc, jc in zip(tcams, jcams):
        for k, v in _fields(jc).items():
            np.testing.assert_allclose(getattr(tc, k).numpy(), v, atol=1e-6, rtol=1e-5)

    kw = dict(width=64, height=48, tile_w=32, tile_h=16, chunk=32, max_instances=8192)
    bg = [0.2, 0.3, 0.1]
    port = tsyn.render_gt_images(
        tsyn.gaussian_blob_scene(n=300, seed=4, device="cpu"), tcams,
        RasterConfig(**kw), bg,
    )
    ref = jsyn.render_gt_images(
        jsyn.gaussian_blob_scene(n=300, seed=4), jcams,
        JaxConfig(backend="jax", **kw), bg,
    )
    assert port.shape == ref.shape == (2, 3, 48, 64)
    np.testing.assert_allclose(port, ref, atol=1e-5, rtol=1e-5)


def test_cuda_requested_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    path = tmp_path / "gs.ply"
    jgs.save_ply(_jax_params(), str(path))
    with pytest.raises((RuntimeError, AssertionError)):
        tgs.load_ply(str(path))
    with pytest.raises((RuntimeError, AssertionError)):
        tsyn.gaussian_blob_scene(n=10)
    with pytest.raises((RuntimeError, AssertionError)):
        viewer.start(lambda: None, RasterConfig(width=32, height=16), port=0,
                     host="127.0.0.1")


def _decode_png(data):
    """8-bit RGB PNG with filter type 0 on every row -> [H, W, 3] uint8."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(kind + body)
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype = ihdr[:4]
    assert (depth, ctype) == (8, 2)
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def _get(base, path):
    with urllib.request.urlopen(base + path, timeout=60) as r:
        return r.status, r.headers["Content-Type"], r.read()


def test_viewer_serves_the_ports_render():
    model = tsyn.gaussian_blob_scene(n=400, seed=5, device="cpu")
    cfg = RasterConfig(width=96, height=64, chunk=32, max_instances=1 << 14)
    server = viewer.start(
        lambda: model, cfg, port=0, host="127.0.0.1", device="cpu"
    )
    try:
        base = "http://127.0.0.1:%d" % server.server_address[1]
        status, ctype, body = _get(base, "/render?az=0.7&el=0.4&r=3.2")
        assert (status, ctype) == (200, "image/png")
        got = _decode_png(body)
        cam = viewer._orbit_camera(0.7, 0.4, 3.2, device="cpu")
        img = render(*model, cam, cfg).image
        want = (torch.clamp(img, 0, 1) * 255).to(torch.uint8).permute(1, 2, 0).numpy()
        assert got.shape == (64, 96, 3)
        np.testing.assert_array_equal(got, want)
        assert got.std() > 1.0

        status, ctype, body = _get(base, "/state")
        assert status == 200 and json.loads(body) == {"n_gaussians": 400}
        status, ctype, body = _get(base, "/")
        assert status == 200 and ctype == "text/html" and b"/render" in body
        for path, code in (("/nope", 404), ("/render?az=x", 400)):
            with pytest.raises(urllib.error.HTTPError) as e:
                _get(base, path)
            assert e.value.code == code
    finally:
        server.shutdown()
        server.server_close()
