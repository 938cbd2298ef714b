"""Stage 6, the textured mesh (frosting_tpu_torch.extract.texture and
stages_cli extract-texture), against the JAX package's on the CPU.

The frosting model is built in numpy around an icosphere shell. Where a JAX
function takes a render function, it is handed the port's renders, and its
mesh rasterizer is handed the port's fragments (the rasterizers agree up to
edge ties: tests/test_torch_mesh.py), so JAX compiles no render and both
bakes see the same pixels.
"""

import dataclasses
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from frosting_tpu.extract import texture as jax_texture
from frosting_tpu.ops import mesh_raster as jax_raster
from frosting_tpu.raster import RasterConfig as JaxConfig
from frosting_tpu.scene import synthetic as jax_synthetic
from frosting_tpu_torch import stages_cli
from frosting_tpu_torch.cameras import camera_from_numpy
from frosting_tpu_torch.extract import texture
from frosting_tpu_torch.models import frosting
from frosting_tpu_torch.ops import mesh_raster
from frosting_tpu_torch.raster import RasterConfig, render
from frosting_tpu_torch.train import checkpoint
from frosting_tpu_torch.utils import image as image_io
from tests.test_mesh import icosphere
from tests.test_torch_stages_cli import _write_scene

torch.set_num_threads(1)
RASTER = dict(width=64, height=48, chunk=32, max_instances=1 << 13)
N = 1500
S = 64  # texture size


def _state(seed=0, subdiv=2):
    """(params, meta) numpy dicts: an icosphere shell with offsets and N
    Gaussians in sorted random cells, coloured by position."""
    v, f = icosphere(subdiv)
    rng = np.random.default_rng(seed)
    v = (v * rng.uniform(0.98, 1.02, (len(v), 1))).astype(np.float32)
    cell_idx = np.sort(rng.integers(0, len(f), N)).astype(np.int32)
    sh = rng.normal(0.0, 0.05, (N, 16, 3)).astype(np.float32)
    sh[:, 0] = ((v[f[cell_idx]].mean(axis=1) + 1.5) / 3.0 - 0.5) / 0.28209479177387814
    params = {
        "shell_verts": v,
        "inner_dist": -rng.uniform(0.03, 0.06, len(v)).astype(np.float32),
        "outer_dist": rng.uniform(0.03, 0.06, len(v)).astype(np.float32),
        "bary_logits": rng.normal(0, 1, (N, 6)).astype(np.float32),
        "scales_log": np.log(rng.uniform(0.03, 0.06, (N, 3))).astype(np.float32),
        "quats_raw": rng.normal(size=(N, 4)).astype(np.float32),
        "opacities_raw": rng.uniform(0.5, 2.5, N).astype(np.float32),
        "sh_dc": sh[:, :1], "sh_rest": sh[:, 1:], "bg": None,
    }
    meta = {"faces": f.astype(np.int32), "cell_idx": cell_idx,
            "cell_bounds": np.searchsorted(cell_idx, np.arange(len(f) + 1)).astype(np.int32)}
    return params, meta


@pytest.fixture(scope="module")
def baked():
    """The views (JAX cameras and the port's copies), the port's renders and
    fragments of each, and the port's bake (texture, UVs, stats)."""
    params, meta = _state()
    p = frosting.params_from_numpy(params, device="cpu")
    m = frosting.meta_from_numpy(meta, device="cpu")
    jcams = jax_synthetic.camera_ring(n_cams=3, radius=3.0)
    cams = [camera_from_numpy({f.name: np.asarray(getattr(c, f.name))
                               for f in dataclasses.fields(c)}, device="cpu") for c in jcams]
    rcfg = RasterConfig(**RASTER)
    with torch.no_grad():
        model = frosting.activate_frosting(p, m)
        images = [torch.clamp(render(*model, c, rcfg).image, 0.0, 1.0) for c in cams]
        frags = [mesh_raster.rasterize_mesh(p.shell_verts, m.faces, c, rcfg) for c in cams]
        fill = texture.face_average_sh_colors(
            p.shell_verts[m.faces].mean(dim=1), model[0], model[4][:, :1])
    it = iter(images)
    stats = {}
    tex, uvs = texture.bake_texture(p.shell_verts, m.faces, lambda cam: next(it), cams, rcfg,
                                    S, fill, stats)
    return params, meta, jcams, images, frags, fill, tex, uvs, stats


@pytest.mark.parametrize("n_faces", [1, 2, 7, 320, 12345])
def test_uv_atlas_is_bitwise_jax(n_faces):
    got, bps = texture.uv_atlas(n_faces, S)
    want, jbps = jax_texture.uv_atlas(n_faces, S)
    assert got.dtype == want.dtype == np.float64 and bps == jbps
    np.testing.assert_array_equal(got, want)


def test_bake_texture_matches_jax(baked, monkeypatch):
    """JAX's bake_texture on the port's renders and fragments: the texel
    counts bitwise equal to those JAX's accumulate gives those fragments
    (its own arithmetic, replayed here), the texture within 1e-6, the
    unseen texels' fill colours equal."""
    params, meta, jcams, images, frags, fill, tex, uvs, stats = baked
    by_cam = {id(c): i for i, c in enumerate(jcams)}

    def fragments(verts, faces, cam, cfg):
        fr = frags[by_cam[id(cam)]]
        return jax_raster.Fragments(pix_to_face=jnp.asarray(fr.pix_to_face.numpy(), jnp.int32),
                                    zbuf=jnp.asarray(fr.zbuf.numpy()),
                                    bary=jnp.asarray(fr.bary.numpy()))

    monkeypatch.setattr(jax_texture.mesh_raster, "rasterize_mesh", fragments)
    jcfg = JaxConfig(backend="jax", **RASTER)
    it = iter(images)
    want_tex, want_uvs = jax_texture.bake_texture(
        jnp.asarray(params["shell_verts"]), jnp.asarray(meta["faces"]),
        lambda cam: next(it).numpy(), jcams, jcfg, S, fill)
    np.testing.assert_array_equal(uvs, want_uvs)
    # JAX's accumulate: the texel of each covered pixel, in its arithmetic
    uvs_j = jnp.asarray(want_uvs, jnp.float32)
    want_cnt = np.zeros(S * S, np.int64)
    for fr in frags:
        pf = jnp.asarray(fr.pix_to_face.numpy().reshape(-1))
        br = jnp.asarray(fr.bary.numpy().reshape(-1, 3))
        uv = jnp.sum(uvs_j[jnp.maximum(pf, 0)] * br[..., None], axis=1)
        tx = jnp.clip(uv[:, 0] * S, 0, S - 1)
        ty = jnp.clip((1.0 - uv[:, 1]) * S, 0, S - 1)
        tid = np.asarray(ty.astype(jnp.int32) * S + tx.astype(jnp.int32))
        want_cnt += np.bincount(tid[np.asarray(pf) >= 0], minlength=S * S)
    got_cnt = stats["texel_counts"].reshape(-1)
    np.testing.assert_array_equal(got_cnt, want_cnt.astype(np.float32))
    assert 0.02 < stats["seen_share"] == (want_cnt > 0).mean() < 0.9
    assert tex.dtype == want_tex.dtype == np.float32 and tex.shape == (S, S, 3)
    np.testing.assert_allclose(tex, want_tex, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tex[got_cnt.reshape(S, S) == 0],
                                  want_tex[want_cnt.reshape(S, S) == 0])


def test_face_average_sh_colors_matches_jax(baked):
    """The exact device KNN (k = 1) against JAX's cKDTree on the same
    activated Gaussians: the same nearest Gaussian for every face centre (no
    ties here), so equal colours."""
    params, meta, _jcams, _images, _frags, fill, *_ = baked
    with torch.no_grad():
        means, _s, _q, _o, sh = frosting.activate_frosting(
            frosting.params_from_numpy(params, device="cpu"),
            frosting.meta_from_numpy(meta, device="cpu"))
    fc = params["shell_verts"][meta["faces"]].mean(axis=1)
    want = jax_texture.face_average_sh_colors(fc, means.numpy(), sh[:, :1].numpy())
    assert fill.shape == want.shape == (len(meta["faces"]), 3)
    np.testing.assert_allclose(fill, want, rtol=0, atol=1e-7)


def test_export_obj_writes_the_jax_packages_bytes(tmp_path, baked):
    """OBJ and MTL byte for byte JAX's writer's on the bake and on values
    at %.6f's rounding edges (negative zeros, halves of the last place);
    the PNG decodes to the pixels PIL decodes from JAX's."""
    params, meta, *_rest, tex, uvs, _stats = baked
    rng = np.random.default_rng(3)
    edge = np.array([-0.0, 0.0, 0.0000005, -0.0000005, 0.1234565, 1e-7, -1e-7, 2.5e-6],
                    np.float32)
    verts = np.concatenate([params["shell_verts"], edge.reshape(-1, 1).repeat(3, 1),
                            rng.normal(0, 50, (40, 3)).astype(np.float32)])
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
    jax_texture.export_obj(str(tmp_path / "jax" / "mesh.obj"), verts, meta["faces"], uvs, tex)
    texture.export_obj(str(tmp_path / "port" / "mesh.obj"), verts, meta["faces"], uvs, tex)
    for name in ("mesh.obj", "mesh.mtl"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    got, mode = image_io.read_image(str(tmp_path / "port" / "mesh.png"))
    assert mode == "RGB"
    np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path / "jax" / "mesh.png")))


@pytest.mark.parametrize("fmt", ["v %.6f %.6f %.6f\n", "vt %.6f %.6f\n",
                                 "f %d/%d %d/%d %d/%d\n"], ids=["v", "vt", "f"])
def test_obj_lines_are_pythons_percent_bytes(fmt, monkeypatch):
    """texture._write_rows, the OBJ's lines a block of rows at a time by
    Python's `%`, equals the JAX writer's one f-string per line byte for
    byte on float32 and float64 values across magnitudes, exact ties of
    %.6f (dyadic halves of the last place), values rounding up to the next
    unit, negative zeros, 13-digit and non-finite values and integers of
    every width, over blocks of 500 rows and a last, shorter one."""
    rng = np.random.default_rng(7)
    k = fmt.count("%")
    if "d" in fmt:
        rows = np.concatenate([rng.integers(0, 10 ** rng.integers(1, 11, 3000)[:, None], (3000, k)),
                               np.zeros((2, k), np.int64), np.full((1, k), 2 ** 40)])
        tables = [rows]
    else:
        vals = np.concatenate([
            rng.normal(0, 1, 4000), rng.normal(0, 1e4, 1000), rng.uniform(-1e-6, 1e-6, 1000),
            rng.normal(0, 3, 3000).astype(np.float32), np.arange(-2000, 2000) / 2e6,
            [1 / 128, -1 / 128, 0.9999995, 999999.9999995, -0.0, 0.0, 2.5e-7, 5e-324]])
        rows = vals[: len(vals) // k * k].reshape(-1, k)
        special = np.array([[1e13] * k, [np.inf] * k, [np.nan] * k])
        tables = [np.concatenate([rows, special]),
                  rng.normal(0, 3, (700, k)).astype(np.float32)]
    monkeypatch.setattr(texture, "OBJ_ROWS", 500)
    line = fmt.replace("%.6f", "{:.6f}").replace("%d", "{}")
    for table in tables:
        buf = io.BytesIO()
        texture._write_rows(buf, fmt, table)
        want = "".join(line.format(*row) for row in table).encode()
        assert buf.getvalue() == want


def test_extract_texture_on_the_cpu(tmp_path):
    """stages_cli extract-texture --device cpu on a frosting.npz: mesh.obj,
    mesh.mtl and mesh.png, the OBJ with the shell's vertex and face counts
    and one UV per face corner, the PNG the bake's texture; without
    --device cpu a machine with no CUDA device refuses the command."""
    scene_dir = _write_scene(str(tmp_path / "scene"), n_cams=3, size=48)
    out = tmp_path / "out"
    out.mkdir()
    params, meta = _state(subdiv=1)
    p = frosting.params_from_numpy(params, device="cpu")
    m = frosting.meta_from_numpy(meta, device="cpu")
    checkpoint.save_frosting(str(out / "frosting.npz"), p, m)
    common = ["-s", scene_dir, "-o", str(out), "--max-instances", "65536", "--chunk", "32",
              "--texture-size", "32"]
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            stages_cli.main(["extract-texture", *common])
    res = stages_cli.main(["extract-texture", *common, "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["frosting.npz", "mesh.mtl", "mesh.obj", "mesh.png"]
    assert 0 < res["seen_share"] < 1 and res["texel_counts"].shape == (32, 32)
    assert {"fill colours (KNN)", "bake (render + mesh raster + texel sums)",
            "OBJ + MTL + PNG write"} <= set(res["timings_ms"])
    lines = (out / "mesh.obj").read_text().splitlines()
    kinds = [line.split()[0] for line in lines]
    nv, nf = len(params["shell_verts"]), len(meta["faces"])
    assert lines[:2] == ["mtllib mesh.mtl", "usemtl material_0"]
    assert (kinds.count("v"), kinds.count("vt"), kinds.count("f")) == (nv, 3 * nf, nf)
    v = np.array([[float(x) for x in line.split()[1:]] for line in lines if line[:2] == "v "])
    np.testing.assert_allclose(v, params["shell_verts"], atol=5e-7)
    png, mode = image_io.read_image(str(out / "mesh.png"))
    assert mode == "RGB" and png.shape == (32, 32, 3)
