"""Frosting refinement (frosting_tpu_torch.train.frosting_trainer, stage
5), its checkpoint and PLY export, and the train-frosting / render commands,
against the JAX package's on the CPU.

The state is built in numpy around an icosphere shell (642 vertices, 3000
frosting Gaussians, 60 background Gaussians); the ground truth views are
renders of a sphere of Gaussians by the port (inputs of both packages
alike). The JAX side renders with RasterConfig(backend="jax",
bwd_sort_bf16=False), and each jitted JAX step is compiled once per
configuration.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frosting_tpu import pipeline as jax_pipeline
from frosting_tpu.models import frosting as jax_frosting
from frosting_tpu.ops import mesh as jax_mesh
from frosting_tpu.ops import mesh_raster as jax_mesh_raster
from frosting_tpu.raster import RasterConfig as JaxConfig
from frosting_tpu.scene import synthetic as jax_synthetic
from frosting_tpu.scene.gaussians import GaussianParams as JaxGaussianParams
from frosting_tpu.train import checkpoint as jax_checkpoint
from frosting_tpu.train import frosting_trainer as jax_trainer
from frosting_tpu_torch import pipeline, stages_cli
from frosting_tpu_torch.cameras import camera_from_numpy
from frosting_tpu_torch.models import frosting
from frosting_tpu_torch.ops import mesh as mesh_ops
from frosting_tpu_torch.raster import RasterConfig, render
from frosting_tpu_torch.scene import gaussians as gauss_lib
from frosting_tpu_torch.scene import synthetic
from frosting_tpu_torch.train import checkpoint, frosting_trainer
from frosting_tpu_torch.utils import image as image_io
from frosting_tpu_torch.utils import ply as ply_io
from tests.test_mesh import icosphere
from tests.test_torch_mesh import JAX_RASTERIZE_JIT
from tests.test_torch_stages_cli import _write_scene

torch.set_num_threads(1)
EXTENT = 3.5
# ~4100 instances a view: the JAX backend's work grows with the capacity
RASTER = dict(width=64, height=48, chunk=32, max_instances=1 << 13)
N, N_BG = 3000, 60
# the culled capacity's safety factor and a capacity above what it gives
SAFETY, DERIVE_CAPACITY = 64.0, 1 << 17


def _state(seed=0):
    """(params, meta) as numpy dicts: an icosphere shell with offsets, 3000
    Gaussians in sorted random cells, 60 background Gaussians at r 1.3-1.6
    (two of them masked out)."""
    v, f = icosphere(3)
    rng = np.random.default_rng(seed)
    v = (v * rng.uniform(0.99, 1.01, (len(v), 1))).astype(np.float32)
    f = f.astype(np.int32)
    cell_idx = np.sort(rng.integers(0, len(f), N)).astype(np.int32)
    q = rng.normal(size=(N, 4)).astype(np.float32)
    sh = rng.normal(0.0, 0.1, (N, 16, 3)).astype(np.float32)
    sh[:, 0] += 0.6
    d = rng.normal(size=(N_BG, 3))
    bq = rng.normal(size=(N_BG, 4)).astype(np.float32)
    bsh = rng.normal(0.0, 0.2, (N_BG, 16, 3)).astype(np.float32)
    bg = {
        "means3d": (d / np.linalg.norm(d, axis=1, keepdims=True)
                    * rng.uniform(1.3, 1.6, (N_BG, 1))).astype(np.float32),
        "sh_dc": bsh[:, :1], "sh_rest": bsh[:, 1:],
        "scales_log": np.log(rng.uniform(0.03, 0.08, (N_BG, 3))).astype(np.float32),
        "quats_raw": bq,
        "opacities_raw": rng.uniform(-1.0, 1.0, N_BG).astype(np.float32),
        "mask": (np.arange(N_BG) >= 2).astype(np.float32),
    }
    params = {
        "shell_verts": v,
        "inner_dist": -rng.uniform(0.03, 0.06, len(v)).astype(np.float32),
        "outer_dist": rng.uniform(0.03, 0.06, len(v)).astype(np.float32),
        "bary_logits": rng.normal(0, 1, (N, 6)).astype(np.float32),
        "scales_log": np.log(rng.uniform(0.02, 0.04, (N, 3))).astype(np.float32),
        "quats_raw": q,
        "opacities_raw": rng.uniform(-1.0, 2.0, N).astype(np.float32),
        "sh_dc": sh[:, :1], "sh_rest": sh[:, 1:],
        "bg": bg,
    }
    meta = {"faces": f, "cell_idx": cell_idx,
            "cell_bounds": np.searchsorted(cell_idx, np.arange(len(f) + 1)).astype(np.int32)}
    return params, meta


def _jax_state(params, meta):
    own = {k: jnp.asarray(a) for k, a in params.items() if k != "bg"}
    bg = JaxGaussianParams(**{k: jnp.asarray(a) for k, a in params["bg"].items()})
    return (jax_frosting.FrostingParams(**own, bg=bg),
            jax_frosting.FrostingMeta(**{k: jnp.asarray(a) for k, a in meta.items()}))


def _port_state(params, meta):
    return (frosting.params_from_numpy(params, device="cpu"),
            frosting.meta_from_numpy(meta, device="cpu"))


def _groups_np(p):
    return {k: v.detach().numpy() for k, v in frosting_trainer.param_groups(p).items()}


def _jax_groups_np(jp):
    out = {f.name: np.asarray(getattr(jp, f.name)) for f in dataclasses.fields(jp) if f.name != "bg"}
    out.update({f"bg_{f.name}": np.asarray(getattr(jp.bg, f.name))
                for f in dataclasses.fields(jp.bg)})
    return out


def _jax_adam(opt_state, group):
    """(mu, nu, count) of one group of the JAX optimizer state."""
    adam = opt_state.inner_states[group].inner_state[0]

    def leaf(t):
        return getattr(t.bg, group[3:]) if group.startswith("bg_") else getattr(t, group)

    return np.asarray(leaf(adam.mu)), np.asarray(leaf(adam.nu)), int(adam.count)


@pytest.fixture(scope="module")
def views():
    """JAX cameras and the port's copies, the ground truth (a sphere of 1500
    Gaussians coloured by position, rendered by the port) and the JAX
    package's visibility mask of the state's shell from the first camera."""
    jcams = jax_synthetic.camera_ring(n_cams=3, radius=3.2)
    cams = [camera_from_numpy({f.name: np.asarray(getattr(c, f.name))
                               for f in dataclasses.fields(c)}, device="cpu") for c in jcams]
    rng = np.random.default_rng(1)
    d = rng.normal(size=(1500, 3))
    means = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    sh = np.zeros((1500, 16, 3), np.float32)
    sh[:, 0] = (means + 1.5) / 3.0
    quats = np.zeros((1500, 4), np.float32)
    quats[:, 0] = 1.0
    gt_model = tuple(torch.from_numpy(a) for a in (
        means, np.full((1500, 3), 0.05, np.float32), quats, np.full((1500,), 0.9, np.float32), sh))
    gt = synthetic.render_gt_images(gt_model, cams, RasterConfig(**RASTER), np.zeros(3, np.float32))
    jcfg = JaxConfig(backend="jax", bwd_sort_bf16=False, **RASTER)
    jp, jm = _jax_state(*_state())
    # it reads only pix_to_face: the jitted rasterizer (tests/test_torch_mesh.py)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_mesh_raster, "rasterize_mesh", JAX_RASTERIZE_JIT)
        vis = jax_trainer.precompute_visibility(jp, jm, jcams[:1], jcfg)
    return jcams, cams, gt, jcfg, vis


def test_precompute_visibility_matches_jax(views):
    """Masks equal on all but 0.5% of the Gaussians (the mesh rasterizer may
    give a pixel on an edge the other face: tests/test_torch_mesh.py)."""
    jcams, cams, _gt, _jcfg, want = views
    p, m = _port_state(*_state())
    got = frosting_trainer.precompute_visibility(p, m, cams[:1], RasterConfig(**RASTER)).numpy()
    assert got.shape == want.shape == (1, N + N_BG)
    assert 0.2 < want[:, :N].mean() < 0.8 and (want[:, N:] == 1).all()
    assert (got != want).mean() <= 0.005


def test_derive_culled_config_matches_jax(views):
    """The capacity derived from the culled instance counts equals JAX's.
    The safety factor puts it above autotune's floor (1 << 16), so it is
    the largest count times the factor: equal capacities mean equal counts
    (a count one apart moves the capacity by the factor, past the rounding
    to a chunk)."""
    jcams, cams, _gt, jcfg, vis = views
    jp, jm = _jax_state(*_state())
    p, m = _port_state(*_state())
    rcfg = RasterConfig(**dict(RASTER, max_instances=DERIVE_CAPACITY))
    jcfg = dataclasses.replace(jcfg, max_instances=DERIVE_CAPACITY)
    want = jax_trainer.derive_culled_config(jp, jm, jcams[:1], jnp.asarray(vis), jcfg,
                                            safety=SAFETY)
    got = frosting_trainer.derive_culled_config(p, m, cams[:1], torch.from_numpy(vis), rcfg,
                                                safety=SAFETY)
    assert (1 << 16) < got.max_instances == want.max_instances < rcfg.max_instances


# The largest step of each group's learning rate (the schedules start at
# their initial value).
LRS = {"inner_dist": 1.6e-4 * EXTENT, "outer_dist": 1.6e-4 * EXTENT, "bary_logits": 5e-3,
       "sh_dc": 2.5e-3, "sh_rest": 2.5e-3 / 20, "opacities_raw": 0.05, "scales_log": 5e-3,
       "quats_raw": 1e-3, "bg_means3d": 1.6e-4 * EXTENT}


def _assert_close_but_few(got, want, what):
    """At most 1% of the elements (or 2, in a group as small as the
    background's) past 1e-5 of max |want| + 2e-4 |want|."""
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want)
    off = err > 1e-5 * scale + 2e-4 * np.abs(want)
    assert off.sum() <= max(1e-2 * off.size, 2), (what, int(off.sum()), err.max() / scale)


# The render's gradients agree with JAX's to 5e-4 of their largest
# magnitude (tests/test_torch_render_grad.py), and so, on every element, do
# the first step's moments (mu = 0.1 g, nu = 0.001 g^2, each against its
# own largest magnitude). The later steps take their gradients at
# parameters that already differ (below): twice that.
GRAD_PARITY = 5e-4
MOMENT_CAP = (GRAD_PARITY, 2 * GRAD_PARITY)
# A gradient of less than this share of its group's largest is "near zero"
# at the first step, and at a later one (whose parameters differ already).
NEAR_ZERO = (1e-3, 1e-2)
B1 = 0.9  # Adam's first-moment decay in both packages


@pytest.mark.parametrize("learn_shell", [False, True], ids=["frozen_shell", "learn_shell"])
def test_train_steps_match_jax(views, learn_shell):
    """From the same state, three steps against JAX's frosting_train_step
    with the shell regulariser on (views 0, 0 culled by its visibility
    mask, and 2), the shell frozen or learned. After each: the loss to
    1e-5, the Adam counts equal, frozen groups unchanged, and per group:

    - the Adam moments within MOMENT_CAP of their largest magnitude on
      every element, and within 1e-5 of it plus 2e-4 relative on all but
      1% (2 of a background group's 180): the share and relative part of
      test_torch_gs_trainer.py (1e-4 there; the second moment squares the
      gradient). 1e-5 alone does not hold: the render's gradients agree
      with JAX's to 5e-4 normalised, not 1e-5 (sums in another order,
      stop-threshold flips).
    - the parameters within 1e-5 of their largest magnitude wherever JAX's
      gradient has been above NEAR_ZERO of its group's largest at every
      step so far (after the first step, also with the 1% share above),
      and within two learning rates per step taken everywhere. A first
      Adam step moves an element by
      lr * g / (|g| + 1e-15): where g is round-off (a Gaussian that barely
      covers a pixel) the packages may move it by different fractions of
      lr, in either direction, and the later steps' gradients start from
      that difference.

    JAX's gradients are read back from its first moments, g_s = (mu_s -
    B1 mu_{s-1}) / (1 - B1)."""
    jcams, cams, gt, jcfg, vis = views
    cfg_kw = dict(learn_shell=learn_shell, regularize_shell=True, lr_max_steps=100)
    jcfg_t = jax_trainer.FrostingTrainConfig(**cfg_kw)
    cfg = frosting_trainer.FrostingTrainConfig(**cfg_kw)
    jp, jm = _jax_state(*_state())
    p, m = _port_state(*_state())
    tx = jax_trainer.make_frosting_optimizer(jcfg_t, EXTENT)
    jstate = tx.init(jp)
    opt = frosting_trainer.make_frosting_optimizer(cfg, EXTENT, background=True)
    state = opt.init(frosting_trainer.param_groups(p))
    assert ("inner_dist" in opt.groups) == learn_shell and "bg_mask" not in opt.groups
    nc = jax_mesh.adjacent_face_pairs(np.asarray(jm.faces))
    before = _groups_np(p)
    rcfg = RasterConfig(**RASTER)
    mu_prev = {g: 0.0 for g in opt.groups}
    least_grad = {}  # per element, the least |g_jax| / max |g_jax| so far
    for step, ci in enumerate([0, 0, 2]):
        mask = vis[0] if step == 1 else np.ones(N + N_BG, np.float32)
        jp, jstate, jaux = jax_trainer.frosting_train_step(
            jp, jstate, jm, jcams[ci], jnp.asarray(gt[ci]), jnp.asarray(mask), tx, jcfg,
            jcfg_t, 3, jnp.asarray(nc))
        aux = frosting_trainer.train_step(
            p, state, m, cams[ci], torch.from_numpy(gt[ci]), torch.from_numpy(mask), opt,
            rcfg, cfg, 3, mesh_ops.pair_incidence(torch.from_numpy(nc), len(jm.faces)))
        assert not bool(aux["overflow"]) and not bool(jaux["overflow"])
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
        got, want = _groups_np(p), _jax_groups_np(jp)
        for g in got:
            if g not in opt.groups:
                np.testing.assert_array_equal(got[g], before[g], err_msg=g)
        for g in opt.groups:
            mu, nu, count = _jax_adam(jstate, g)
            assert int(state.count[g]) == count == step + 1
            cap = MOMENT_CAP[min(step, 1)]
            for a, b, what in ((state.mu[g].numpy(), mu, "mu"), (state.nu[g].numpy(), nu, "nu")):
                _assert_close_but_few(a, b, (g, what, step))
                err = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
                assert err <= cap, (g, what, step, err)
            grad = np.abs(mu - B1 * mu_prev[g]) / (1.0 - B1)
            mu_prev[g] = mu
            rel = grad / max(grad.max(), 1e-30)
            least_grad[g] = rel if step == 0 else np.minimum(least_grad[g], rel)
            if step == 0:
                _assert_close_but_few(got[g], want[g], (g, step))
            err = np.abs(got[g] - want[g])
            off = err > 1e-5 * max(np.abs(want[g]).max(), 1e-30)
            assert (least_grad[g][off] < NEAR_ZERO[min(step, 1)]).all(), (
                g, step, int(off.sum()), least_grad[g][off].max())
            lr = LRS.get(g, LRS.get(g[3:]))
            assert err.max() <= 2 * lr * (step + 1) + 1e-6, (g, step)


def test_frosting_checkpoints_load_in_both_packages(tmp_path):
    """save_frosting of either package loads exactly in the other, with the
    same keys in the same order and the same dtypes."""
    params, meta = _state()
    jp, jm = _jax_state(params, meta)
    p, m = _port_state(params, meta)
    jax_path, port_path = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jax_checkpoint.save_frosting(jax_path, jp, jm)
    checkpoint.save_frosting(port_path, p, m)
    with np.load(jax_path) as a, np.load(port_path) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    lp, lm = checkpoint.load_frosting(jax_path, device="cpu")
    for k, v in frosting_trainer.param_groups(lp).items():
        np.testing.assert_array_equal(v.numpy(), _jax_groups_np(jp)[k], err_msg=k)
    for k in ("faces", "cell_idx", "cell_bounds"):
        np.testing.assert_array_equal(getattr(lm, k).numpy(), meta[k], err_msg=k)
    jlp, jlm = jax_checkpoint.load_frosting(port_path)
    for k, v in _jax_groups_np(jlp).items():
        np.testing.assert_array_equal(v, _groups_np(p)[k], err_msg=k)
    for k in ("faces", "cell_idx", "cell_bounds"):
        np.testing.assert_array_equal(np.asarray(getattr(jlm, k)), meta[k], err_msg=k)


def test_export_frosting_ply_writes_the_jax_packages_bytes(tmp_path):
    """The port's PLY of a model equals, byte for byte, what the JAX
    package's writer makes of the port's activated arrays; JAX's own
    export of the same model agrees to 1e-5."""
    p, m = _port_state(*_state())
    jp, jm = _jax_state(*_state())
    pipeline.export_frosting_ply(p, m, str(tmp_path / "port.ply"))
    with torch.no_grad():
        arrays = [a.numpy() for a in frosting.to_gaussians(p, m)]
    jax_pipeline.export_gaussians_ply(*arrays, str(tmp_path / "want.ply"))
    assert (tmp_path / "port.ply").read_bytes() == (tmp_path / "want.ply").read_bytes()
    jax_pipeline.export_frosting_ply(jp, jm, str(tmp_path / "jax.ply"))
    got = ply_io.read_ply(str(tmp_path / "port.ply"))["vertex"]
    want = ply_io.read_ply(str(tmp_path / "jax.ply"))["vertex"]
    assert list(got) == list(want) and len(got["x"]) == N + N_BG
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5, err_msg=k)


def test_train_frosting_then_render_on_the_cpu(tmp_path):
    """stages_cli train-frosting with every flag, then render, on a scene on
    disk with --device cpu: the artifacts load back in both packages, a
    PNG decodes to the in-process render of frosting.npz, and without
    --device cpu a machine with no CUDA device refuses the command."""
    scene_dir = _write_scene(str(tmp_path / "scene"), n_cams=4, size=48)
    out = tmp_path / "out"
    out.mkdir()
    # sugar.ply: the scene's own Gaussians (_write_scene's draws)
    rng = np.random.default_rng(0)
    d = rng.normal(size=(400, 3))
    means = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    sh = np.zeros((400, 16, 3), np.float32)
    sh[:, 0] = (means + 1.5) / 3.0
    raw = {"means3d": means, "sh_dc": sh[:, :1], "sh_rest": sh[:, 1:],
           "scales_log": np.full((400, 3), np.log(0.06), np.float32),
           "quats_raw": np.tile(np.float32([1, 0, 0, 0]), (400, 1)),
           "opacities_raw": np.full((400,), np.log(0.9 / 0.1), np.float32),
           "mask": np.ones(400, np.float32)}
    gauss_lib.save_ply(gauss_lib.params_from_numpy(raw, device="cpu"), str(out / "sugar.ply"))
    v, f = icosphere(3)
    stages_cli.save_mesh(str(out / "shell.ply"), v.astype(np.float32), f)
    common = ["-s", scene_dir, "-o", str(out), "--max-instances", "65536", "--chunk", "32"]
    flags = ["--gaussians", "2000", "--iterations", "4", "--use-background",
             "--occlusion-culling", "--learn-shell", "--regularize-shell"]
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            stages_cli.main(["train-frosting", *common, *flags])
    res = stages_cli.main(["train-frosting", *common, "--device", "cpu", *flags])
    hist = res["history"]
    assert [h["iter"] for h in hist] == [4] and np.isfinite(hist[0]["loss"])
    assert hist[0]["overflow_steps"] == 0 and "init" in res["timings_ms"]
    assert 0 < res["culled_max_instances"] <= 65536
    init_p, _init_m = res["init"]
    p, m = checkpoint.load_frosting(str(out / "frosting.npz"), device="cpu")
    assert p.bary_logits.shape == (2000, 6) and p.bg is not None
    assert not torch.equal(p.outer_dist, init_p.outer_dist)  # the shell trained
    jp, jm = jax_checkpoint.load_frosting(str(out / "frosting.npz"))
    np.testing.assert_array_equal(np.asarray(jp.bary_logits), p.bary_logits.numpy())
    ply = ply_io.read_ply(str(out / "frosting.ply"))["vertex"]
    assert len(ply["x"]) == 2000 + p.bg.capacity and np.isfinite(ply["x"]).all()

    stages_cli.main(["render", *common, "--device", "cpu"])
    assert sorted(os.listdir(out / "renders")) == [f"train_{i:05d}.png" for i in range(4)]
    _scene, cams, _gt, rcfg = stages_cli._load_scene(
        stages_cli.build_parser().parse_args(["render", *common, "--device", "cpu"]))
    with torch.no_grad():
        img = np.clip(render(*frosting.to_gaussians(p, m), cams[2], rcfg).image.numpy(), 0, 1)
    got, mode = image_io.read_image(str(out / "renders" / "train_00002.png"))
    assert mode == "RGB"
    np.testing.assert_array_equal(got, (img.transpose(1, 2, 0) * 255).astype(np.uint8))
