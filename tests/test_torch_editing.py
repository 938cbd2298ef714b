"""The editing runtime (frosting_tpu_torch.models.editing) and the Blender
CLI (frosting_tpu_torch.blender_cli) against the JAX package's on the CPU.

The frosting model is tests/test_torch_texture.py's (an icosphere shell and
1500 Gaussians, built in numpy); the edit bends its upper half by 25
degrees about the x axis and stretches a cap of it past the deformation
threshold. The JAX functions are jitted once per configuration, by the
module's jitted wrappers, which the JAX CLI's run also calls: its
adaptation at the median rescale and its render share their compiles with
the tests of those functions.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from frosting_tpu import blender_cli as jax_cli
from frosting_tpu.cameras import look_at_camera as jax_look_at
from frosting_tpu.models import editing as jax_editing
from frosting_tpu.models import frosting as jax_frosting
from frosting_tpu.raster import RasterConfig as JaxConfig
from frosting_tpu.scene.gaussians import GaussianParams as JaxGaussianParams
from frosting_tpu_torch import blender_cli
from frosting_tpu_torch.cameras import look_at_camera
from frosting_tpu_torch.models import editing, frosting
from frosting_tpu_torch.raster import RasterConfig
from frosting_tpu_torch.train import checkpoint
from frosting_tpu_torch.utils import image as image_io
from tests.test_torch_texture import _state

torch.set_num_threads(1)
RASTER = dict(width=64, height=48, chunk=32, max_instances=1 << 13)
EDITED = ("means", "cov6", "opacities", "sh", "sh_rotations")
# the JAX CLI's render configuration (blender_cli.py: chunk 128) at the
# package's 64x48 and the CLI test's --max-instances
CLI_RASTER = dict(width=64, height=48, chunk=128, max_instances=1 << 14)
JAX_ADAPT = jax.jit(jax_editing.adapt_frosting,
                    static_argnames=("deformation_threshold", "thickness_rescale"))
JAX_ADAPT_SIMPLE = jax.jit(jax_editing.adapt_frosting_simple,
                           static_argnames=("thickness_rescale",))
JAX_RENDER = jax.jit(jax_editing.render_edited, static_argnames=("rcfg", "active_sh_degree"))


def _bend(v, angle=np.radians(25.0), stretch=2.6):
    """The upper half (z > 0) turned by `angle` about the x axis, weights
    blended over |z| < 0.3; then the cap y > 0.8 stretched along y."""
    w = np.clip((v[:, 2] + 0.3) / 0.6, 0.0, 1.0)[:, None]
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    out = (1 - w) * v + w * (v @ rot.T)
    cap = out[:, 1] > 0.8
    out[cap, 1] = 0.8 + (out[cap, 1] - 0.8) * stretch
    return out.astype(np.float32)


def _models():
    params, meta = _state()
    jp = jax_frosting.FrostingParams(
        **{k: jnp.asarray(a) for k, a in params.items() if k != "bg"}, bg=None)
    jm = jax_frosting.FrostingMeta(**{k: jnp.asarray(a) for k, a in meta.items()})
    return (params, meta, jp, jm, frosting.params_from_numpy(params, device="cpu"),
            frosting.meta_from_numpy(meta, device="cpu"))


def _quats_close(got, want, tol):
    """Rotations equal: each quaternion within tol of JAX's or of its
    negation (q and -q are one rotation)."""
    err = np.minimum(np.abs(got - want).max(-1), np.abs(got + want).max(-1))
    assert err.max() <= tol, err.max()


def _assert_edited_close(got, want):
    """Means and cov6 within 1e-5 of their largest magnitude, opacities
    within 1e-6 with the same Gaussians masked to 0, SH equal, SH rotations
    equal as rotations within 1e-5."""
    got = {k: getattr(got, k).numpy() for k in EDITED}
    want = {k: np.asarray(getattr(want, k)) for k in EDITED}
    for k in ("means", "cov6"):
        assert got[k].shape == want[k].shape, k
        err = np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
        assert err <= 1e-5, (k, err)
    np.testing.assert_array_equal(got["opacities"] == 0, want["opacities"] == 0)
    np.testing.assert_allclose(got["opacities"], want["opacities"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got["sh"], want["sh"])
    _quats_close(got["sh_rotations"], want["sh_rotations"], 1e-5)


@pytest.mark.parametrize("mode", ["median", "triangle", "none"])
def test_adapt_frosting_matches_jax(mode):
    """The complex adaptation of the bent shell, field by field (the
    stretched cap masks some Gaussians); then the identity edit: the
    frosting's own means and covariances, no Gaussian masked."""
    params, meta, jp, jm, p, m = _models()
    new = _bend(params["shell_verts"])

    def adapt(jp, jm, verts, thickness_rescale):
        # the JAX CLI's call: its default threshold, and its composite
        # scene's meta, which has no cell_bounds (adapt_frosting reads none)
        return JAX_ADAPT(jp, jm._replace(cell_bounds=None), verts, deformation_threshold=2.0,
                         thickness_rescale=thickness_rescale)

    want = adapt(jp, jm, jnp.asarray(new), thickness_rescale=mode)
    got = editing.adapt_frosting(p, m, torch.from_numpy(new), thickness_rescale=mode)
    _assert_edited_close(got, want)
    assert 0 < int((got.opacities == 0).sum()) < len(got.opacities)
    same = editing.adapt_frosting(p, m, p.shell_verts, thickness_rescale=mode)
    _assert_edited_close(same, adapt(jp, jm, jp.shell_verts, thickness_rescale=mode))
    assert not bool((same.opacities == 0).any())


@pytest.mark.parametrize("mode", ["median", "triangle", "none"])
def test_adapt_frosting_simple_matches_jax(mode):
    params, meta, jp, jm, p, m = _models()
    new = _bend(params["shell_verts"])
    want = JAX_ADAPT_SIMPLE(jp, jm, jnp.asarray(new), thickness_rescale=mode)
    got = editing.adapt_frosting_simple(p, m, torch.from_numpy(new), thickness_rescale=mode)
    _assert_edited_close(got, want)


def test_median_and_thickness_factors_match_jax():
    """The median of an even count is the mean of the middle two, as
    jnp.median gives it; the factors of each mode within 1e-6."""
    x = np.float32([3.0, 1.0, 4.0, 1.5, 9.0, 2.5])
    assert float(editing.median_midpoint(torch.from_numpy(x))) == float(jnp.median(x)) == 2.75
    params, meta, *_ = _models()
    ref, new = params["shell_verts"], _bend(params["shell_verts"])
    for mode in ("median", "triangle", "none"):
        want = np.asarray(jax_editing.thickness_rescale_factors(
            jnp.asarray(ref), jnp.asarray(new), jnp.asarray(meta["faces"]), mode))
        got = editing.thickness_rescale_factors(torch.from_numpy(ref), torch.from_numpy(new),
                                                torch.from_numpy(meta["faces"]), mode).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=mode)


def test_render_edited_matches_jax():
    """The same edited Gaussians (the port's adaptation) rendered by both
    packages, at the JAX CLI's configuration: images within 1e-5."""
    params, _meta, _jp, _jm, p, m = _models()
    eg = editing.adapt_frosting(p, m, torch.from_numpy(_bend(params["shell_verts"])))
    eye = [0.3, -0.4, -3.2]
    want = np.asarray(JAX_RENDER(jax_editing.EditedGaussians(
        *(jnp.asarray(getattr(eg, k).numpy()) for k in EDITED)),
        jax_look_at(eye=eye, target=[0, 0, 0]), JaxConfig(**CLI_RASTER), bg=None,
        active_sh_degree=3).image)
    got = editing.render_edited(eg, look_at_camera(eye=eye, target=[0, 0, 0], device="cpu"),
                                RasterConfig(**CLI_RASTER)).image.numpy()
    assert got.std() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _background(n=40, seed=5):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    sh = rng.normal(0.0, 0.2, (n, 16, 3)).astype(np.float32)
    return {"means3d": (1.5 * d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32),
            "sh_dc": sh[:, :1], "sh_rest": sh[:, 1:],
            "scales_log": np.log(rng.uniform(0.03, 0.08, (n, 3))).astype(np.float32),
            "quats_raw": rng.normal(size=(n, 4)).astype(np.float32),
            "opacities_raw": rng.uniform(-1.0, 1.0, n).astype(np.float32),
            "mask": np.ones(n, np.float32)}


def test_lbs_and_composite_scene_match_jax():
    """lbs_pose_verts within 1e-6; build_composite_scene of two models with
    world transforms (the second carries background Gaussians) field by
    field, the faces and cells offset exactly, the background transformed
    within 1e-6 (its quaternions with JAX's signs); background_to_edited and
    pose_composite alike."""
    rng = np.random.default_rng(4)
    v = rng.normal(size=(50, 3)).astype(np.float32)
    w = rng.uniform(size=(50, 3)).astype(np.float32)
    w /= w.sum(1, keepdims=True)
    rest = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    rest[:, :3, 3] = rng.normal(size=(3, 3))
    pose = rest.copy()
    pose[:, :3, :3] = np.asarray(jax.vmap(lambda q: jax_editing.quat_ops.to_matrix(
        jax_editing.quat_ops.normalize(q)))(jnp.asarray(rng.normal(size=(3, 4)), jnp.float32)))
    want = np.asarray(jax_editing.lbs_pose_verts(*(jnp.asarray(a) for a in (v, w, rest, pose))))
    got = editing.lbs_pose_verts(*(torch.from_numpy(a) for a in (v, w, rest, pose))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    params, meta, jp, jm, p, m = _models()
    bg = _background()
    jbg = JaxGaussianParams(**{k: jnp.asarray(a) for k, a in bg.items()})
    jp2 = dataclasses.replace(jp, bg=jbg)
    p2 = frosting.params_from_numpy(dict(params, bg=bg), device="cpu")
    T = [np.eye(4, dtype=np.float32), np.eye(4, dtype=np.float32)]
    T[1][:3, :3] = 1.3 * pose[0, :3, :3]
    T[1][:3, 3] = [0.5, -1.0, 2.0]
    want = jax_editing.build_composite_scene([(jp, jm), (jp2, jm)], world_transforms=T)
    got = editing.build_composite_scene([(p, m), (p2, m)], world_transforms=T)
    np.testing.assert_array_equal(got.vert_ranges, want.vert_ranges)
    np.testing.assert_array_equal(got.gauss_ranges, want.gauss_ranges)
    for k in ("faces", "cell_idx"):
        np.testing.assert_array_equal(getattr(got.meta, k).numpy(),
                                      np.asarray(getattr(want.meta, k)))
    gb = got.meta.cell_bounds.numpy()
    np.testing.assert_array_equal(gb, np.searchsorted(got.meta.cell_idx.numpy(),
                                                      np.arange(len(got.meta.faces) + 1)))
    for f in dataclasses.fields(got.params):
        if f.name != "bg":
            np.testing.assert_allclose(getattr(got.params, f.name).numpy(),
                                       np.asarray(getattr(want.params, f.name)),
                                       rtol=1e-6, atol=1e-6, err_msg=f.name)
    for f in dataclasses.fields(got.params.bg):
        np.testing.assert_allclose(getattr(got.params.bg, f.name).numpy(),
                                   np.asarray(getattr(want.params.bg, f.name)),
                                   rtol=1e-6, atol=1e-6, err_msg=f.name)
    be, jbe = editing.background_to_edited(got.params.bg), jax_editing.background_to_edited(
        want.params.bg)
    for k in EDITED:
        np.testing.assert_allclose(getattr(be, k).numpy(), np.asarray(getattr(jbe, k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    nv = len(params["shell_verts"])
    new = _bend(params["shell_verts"])
    np.testing.assert_array_equal(
        editing.pose_composite(got, 1, torch.from_numpy(new)).numpy(),
        np.asarray(jax_editing.pose_composite(want, 1, jnp.asarray(new))))
    assert got.params.shell_verts.shape[0] == 2 * nv


def _package(path, tpose, n_frames=2, size=(64, 48), extra_groups=False):
    """One armatured mesh with two bones: "fixed" (the identity) and "bend",
    which turns the upper half by up to 25 degrees about the x axis over
    the frames, its weight blended over |z| < 0.3; a static camera at +3.2 z
    looking down -z. With extra_groups, some vertices also list a group that
    is no bone and a bone twice (the later entry counts)."""
    z = tpose[:, 2]
    wb = np.clip((z + 0.3) / 0.6, 0.0, 1.0)
    groups, weights = [], []
    for i, b in enumerate(wb.tolist()):
        g, w = ["fixed", "bend"], [1.0 - b, b]
        if extra_groups and i % 3 == 0:
            g, w = g + ["not_a_bone", "bend"], w + [0.7, 2.0 * b]
        if extra_groups and i % 7 == 0:
            g, w = [], []
        groups.append(g)
        weights.append(w)
    eye = np.eye(4).tolist()
    poses = []
    for t in range(n_frames):
        a = np.radians(25.0) * t / max(n_frames - 1, 1)
        m = np.eye(4)
        m[1:3, 1:3] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        poses.append(m.tolist())
    cam = [[1.0, 0, 0, 0], [0, 1.0, 0, 0], [0, 0, 1.0, 3.2], [0, 0, 0, 1.0]]
    package = {
        "camera": {"lens": [50.0] * n_frames, "sensor_width": 36.0, "width": size[0],
                   "height": size[1], "matrix_world": [cam] * n_frames},
        "bones": [{
            "vertex": {"tpose_points": tpose.tolist(), "groups": groups, "weights": weights,
                       "matrix_world": eye},
            "armature": {"rest_bones": {"fixed": eye, "bend": eye},
                         "pose_bones": {"fixed": [eye] * n_frames, "bend": poses}},
        }],
    }
    with open(path, "w") as f:
        json.dump(package, f)


def test_load_blender_package_matches_jax(tmp_path):
    """The vectorised loader gives JAX's arrays exactly, vertices with a
    group that is no bone, a bone listed twice or no group at all
    included."""
    params, *_ = _models()
    path = str(tmp_path / "package.json")
    _package(path, params["shell_verts"], n_frames=3, extra_groups=True)
    got, want = editing.load_blender_package(path), jax_editing.load_blender_package(path)
    assert got["raw"] == want["raw"] and len(got["meshes"]) == len(want["meshes"]) == 1
    for k, w in want["meshes"][0].items():
        g = got["meshes"][0][k]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            assert g == w, k
    assert (got["meshes"][0]["weights"].sum(1) == 0).any()


def test_blender_cli_matches_jax_cli(tmp_path, monkeypatch):
    """blender_cli --device cpu and the JAX CLI on the same package and
    checkpoint: every frame's pixels within 1 level of JAX's on >= 99.9% of
    the pixels; the first (identity pose) frame also equal to the direct
    render of the model. Then the simple adaptation and occlusion culling
    render every frame, and without --device cpu a machine with no CUDA
    device refuses the command."""
    params, meta, _jp, _jm, p, m = _models()
    ckpt = str(tmp_path / "model.npz")
    checkpoint.save_frosting(ckpt, p, m)
    pkg = str(tmp_path / "package.json")
    _package(pkg, params["shell_verts"])
    argv = ["--package", pkg, "--checkpoints", ckpt, "--max-instances",
            str(CLI_RASTER["max_instances"])]
    # the JAX CLI's adaptation and render, jitted (it calls them eagerly)
    monkeypatch.setattr(jax_editing, "adapt_frosting", JAX_ADAPT)
    monkeypatch.setattr(jax_editing, "render_edited", JAX_RENDER)
    jax_cli.main([*argv, "--out", str(tmp_path / "jax")])
    monkeypatch.undo()
    res = blender_cli.main([*argv, "--out", str(tmp_path / "port"), "--device", "cpu"])
    assert [f["frame"] for f in res["frames"]] == [0, 1]
    assert not any(f["overflow"] for f in res["frames"])
    for i in range(2):
        name = f"frame_{i:05d}.png"
        got, mode = image_io.read_image(str(tmp_path / "port" / name))
        want = np.asarray(Image.open(tmp_path / "jax" / name))
        assert mode == "RGB" and got.shape == want.shape == (48, 64, 3) and got.std() > 5
        diff = np.abs(got.astype(int) - want.astype(int))
        assert (diff <= 1).mean() >= 0.999, (i, (diff > 1).mean())
    cam = blender_cli.package_camera(editing.load_blender_package(pkg), 0, 64, 48, "cpu")
    with torch.no_grad():
        direct = frosting.to_gaussians(p, m)
        from frosting_tpu_torch.raster import render
        img = render(*direct, cam, RasterConfig(**CLI_RASTER)).image.numpy()
    first, _ = image_io.read_image(str(tmp_path / "port" / "frame_00000.png"))
    diff = np.abs(first.astype(int) - (np.clip(img, 0, 1).transpose(1, 2, 0) * 255).astype(int))
    assert (diff <= 1).mean() >= 0.999

    for extra in (["--adaptation", "simple"], ["--occlusion-culling"]):
        out = str(tmp_path / extra[-1])
        res = blender_cli.main([*argv, "--out", out, "--device", "cpu", *extra])
        assert sorted(os.listdir(out)) == ["frame_00000.png", "frame_00001.png"]
        assert (res["culled_capacity"] is not None) == (extra == ["--occlusion-culling"])
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            blender_cli.main([*argv, "--out", str(tmp_path / "cuda")])


def test_export_frame_as_ply(tmp_path):
    """--export-frame-as-ply: that frame's edited Gaussians as a PLY, its
    covariances eigendecomposed into scales and rotations that rebuild them
    (R diag(s^2) R^T within 1e-5 of the largest entry, as JAX's
    edited_to_gaussian_params does), means, opacities and SH as adapted;
    no PNG for that frame."""
    from frosting_tpu_torch.ops import cov as cov_ops
    from frosting_tpu_torch.ops import quat as quat_ops
    from frosting_tpu_torch.scene import gaussians as gauss_lib

    params, meta, _jp, _jm, p, m = _models()
    ckpt = str(tmp_path / "model.npz")
    checkpoint.save_frosting(ckpt, p, m)
    pkg = str(tmp_path / "package.json")
    _package(pkg, params["shell_verts"])
    out = tmp_path / "frames"
    blender_cli.main(["--package", pkg, "--checkpoints", ckpt, "--out", str(out),
                      "--export-frame-as-ply", "1", "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["frame_00000.png", "frame_00001.ply"]
    back = gauss_lib.load_ply(str(out / "frame_00001.ply"), device="cpu")
    pk = editing.load_blender_package(pkg)["meshes"][0]
    verts = editing.lbs_pose_verts(*(torch.from_numpy(pk[k]) for k in (
        "tpose_points", "weights", "rest_matrices")), torch.from_numpy(pk["pose_matrices"][:, 1]))
    eg = editing.adapt_frosting(p, m, verts)
    rebuilt = cov_ops.cov3d_from_scale_quat(torch.exp(back.scales_log),
                                            quat_ops.normalize(back.quats_raw))
    assert (rebuilt - eg.cov6).abs().max() <= 1e-5 * eg.cov6.abs().max()
    np.testing.assert_array_equal(back.means3d.numpy(), eg.means.numpy())
    np.testing.assert_allclose(torch.sigmoid(back.opacities_raw).numpy(),
                               torch.clamp(eg.opacities, 1e-5, 1 - 1e-5).numpy(), atol=1e-6)
    np.testing.assert_array_equal(back.sh_dc.numpy(), eg.sh[:, :1].numpy())
