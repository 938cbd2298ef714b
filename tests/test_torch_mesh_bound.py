"""Refined SuGaR: the mesh-bound Gaussians (frosting_tpu_torch.models.
mesh_bound), their trainer (train/refined_sugar.py), the quaternion ops it
needs (ops/quat.py from_matrix, multiply) and stages_cli
train-refined-sugar, against the JAX package's on the CPU.

The mesh is an icosphere built in numpy; the ground truth views are the
port's renders of a sphere of Gaussians (inputs of both packages alike).
The JAX side renders with RasterConfig(backend="jax", bwd_sort_bf16=False);
each jitted JAX step compiles once per configuration.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frosting_tpu import pipeline as jax_pipeline
from frosting_tpu.models import mesh_bound as jax_mb
from frosting_tpu.ops import quat as jax_quat
from frosting_tpu.raster import RasterConfig as JaxConfig
from frosting_tpu.scene import synthetic as jax_synthetic
from frosting_tpu.scene.gaussians import GaussianParams as JaxGaussianParams
from frosting_tpu.train import checkpoint as jax_checkpoint
from frosting_tpu.train import refined_sugar as jax_rs
from frosting_tpu_torch import pipeline, stages_cli
from frosting_tpu_torch.cameras import camera_from_numpy
from frosting_tpu_torch.models import mesh_bound
from frosting_tpu_torch.ops import quat
from frosting_tpu_torch.raster import RasterConfig
from frosting_tpu_torch.scene import gaussians as gauss_lib
from frosting_tpu_torch.scene import synthetic
from frosting_tpu_torch.train import refined_sugar
from frosting_tpu_torch.utils import ply as ply_io
from tests.test_mesh import icosphere
from tests.test_torch_frosting_trainer import B1, GRAD_PARITY, MOMENT_CAP, NEAR_ZERO
from tests.test_torch_stages_cli import _write_scene

torch.set_num_threads(1)
EXTENT = 3.0
RASTER = dict(width=64, height=48, chunk=32, max_instances=1 << 13)
FIELDS = [f.name for f in dataclasses.fields(jax_mb.MeshBoundParams)]


def _mesh(subdiv=2, seed=0):
    v, f = icosphere(subdiv)
    rng = np.random.default_rng(seed)
    return (v * rng.uniform(0.97, 1.03, (len(v), 1))).astype(np.float32), f


def _rotations(n, seed=0):
    """[n, 3, 3] float32: random rotations, then the identity and the 180
    degree turns about each axis (where candidates tie) and near them."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    special = np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1],
                        [1, 1, 0, 0], [0, 1, 1, 0], [1, 1, 1, 1], [0, 1, 1, 1e-4]], np.float32)
    q = np.concatenate([q, special])
    return np.asarray(jax_quat.to_matrix(jax_quat.normalize(jnp.asarray(q))))


def test_from_matrix_and_multiply_match_jax():
    """Each quaternion within 1e-6 of JAX's with JAX's sign (its branch, the
    argmax over the four candidates, taken the same way); the Hamilton
    product within 1e-6."""
    R = _rotations(4000)
    got = quat.from_matrix(torch.from_numpy(R.copy())).numpy()
    want = np.asarray(jax_quat.from_matrix(jnp.asarray(R)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    a, b = want[:-1], want[1:]
    np.testing.assert_allclose(quat.multiply(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                               np.asarray(jax_quat.multiply(jnp.asarray(a), jnp.asarray(b))),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("npt", [1, 3, 4, 6])
def test_init_and_activate_mesh_bound_match_jax(npt):
    """init_mesh_bound's parameters (dtypes and values) and thickness equal
    JAX's; activate_mesh_bound on moved vertices, scales and rotations within
    1e-6 of JAX's (its quaternions with JAX's signs)."""
    v, f = _mesh()
    cols = ((v + 1.5) / 3.0).astype(np.float32)
    jp, jm = jax_mb.init_mesh_bound(v, f, n_per_triangle=npt, vertex_colors=cols)
    p, m = mesh_bound.init_mesh_bound(v, f, n_per_triangle=npt, vertex_colors=cols,
                                      device="cpu")
    assert m.thickness == jm.thickness and m.n_per_triangle == npt
    for k in FIELDS:
        want = np.asarray(getattr(jp, k))
        got = getattr(p, k).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7, err_msg=k)
    rng = np.random.default_rng(npt)
    moved = {k: np.asarray(getattr(jp, k)) for k in FIELDS}
    moved["verts"] = moved["verts"] + rng.normal(0, 0.01, moved["verts"].shape).astype(np.float32)
    moved["complex_rot"] = rng.normal(size=moved["complex_rot"].shape).astype(np.float32)
    moved["plane_scales_log"] = moved["plane_scales_log"] + rng.normal(
        0, 0.3, moved["plane_scales_log"].shape).astype(np.float32)
    want = jax.jit(lambda p: jax_mb.activate_mesh_bound(p, jm))(
        jax_mb.MeshBoundParams(**{k: jnp.asarray(a) for k, a in moved.items()}))
    got = mesh_bound.activate_mesh_bound(mesh_bound.params_from_numpy(moved, device="cpu"),
                                         mesh_bound.meta_from_numpy(jm, device="cpu"))
    for name, g, w in zip(("means", "scales", "quats", "opacities", "sh"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def views():
    """JAX cameras and the port's copies; the ground truth: a sphere of 1500
    Gaussians coloured by position, rendered by the port."""
    jcams = jax_synthetic.camera_ring(n_cams=3, radius=EXTENT)
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
    return jcams, cams, gt


# The share of elements allowed past 1e-5 of the largest magnitude + 2e-4
# relative (tests/test_torch_frosting_trainer.py: 1%): 2% here. The
# rotations' gradients pass from_matrix's divisions and flat covariances
# (the normal axis 1e-4 of the extent), which spread the render's
# round-off over more elements (1.04% of complex_rot's first moments on
# the CPU, all within MOMENT_CAP).
CLOSE_SHARE = 2e-2


def _assert_close_but_few(got, want, what):
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want)
    off = err > 1e-5 * scale + 2e-4 * np.abs(want)
    assert off.sum() <= max(CLOSE_SHARE * off.size, 2), (what, int(off.sum()), err.max() / scale)


# The largest step of each group's learning rate (the schedules start at
# their initial value).
LRS = {"verts": 1.6e-4 * EXTENT, "plane_scales_log": 5e-3, "complex_rot": 1e-3,
       "opacities_raw": 0.05, "sh_dc": 2.5e-3, "sh_rest": 2.5e-3 / 20}


@pytest.mark.parametrize("learn_verts", [False, True], ids=["frozen_verts", "learn_verts"])
def test_refined_sugar_steps_match_jax(views, learn_verts):
    """From the same state, three steps against JAX's mesh_bound_train_step
    (views 0, 1, 2), the vertices frozen or learned, held as
    tests/test_torch_frosting_trainer.py holds the Frosting steps: the loss
    to 1e-5, the Adam counts equal, a frozen group unchanged, each group's
    moments within MOMENT_CAP of their largest magnitude (the render's
    GRAD_PARITY gradient parity) and within 1e-5 plus 2e-4 relative on all
    but CLOSE_SHARE, its parameters within 1e-5 of their largest magnitude wherever
    JAX's gradient has been above NEAR_ZERO of the group's largest, and
    within two learning rates per step everywhere. The state is JAX's init
    with its in-plane scales, rotations and higher SH bands drawn apart."""
    assert MOMENT_CAP[0] == GRAD_PARITY
    jcams, cams, gt = views
    v, f = _mesh()
    cols = ((v + 1.5) / 3.0).astype(np.float32)
    jp, jm = jax_mb.init_mesh_bound(v, f, n_per_triangle=3, vertex_colors=cols)
    # unequal in-plane scales and turned rotations: at init the two scales
    # are equal and the rotation (1, 0), where the loss's gradient in the
    # rotation is 0 in exact arithmetic and round-off in both packages. And
    # higher SH bands: from 0, a parameter is of the size of Adam's steps,
    # whose round-off 1e-5 of its largest magnitude does not cover
    # (every leaf a strong float32 array: a weak-typed leaf changes type at
    # the first step, and JAX would compile its step again)
    rng = np.random.default_rng(2)
    jp = jax_mb.MeshBoundParams(**{k: jnp.asarray(np.asarray(getattr(jp, k), np.float32))
                                   for k in FIELDS})
    jp = dataclasses.replace(
        jp, plane_scales_log=jp.plane_scales_log + jnp.asarray(
            rng.normal(0, 0.4, jp.plane_scales_log.shape), jnp.float32),
        complex_rot=jnp.asarray(rng.normal(size=jp.complex_rot.shape), jnp.float32),
        sh_rest=jnp.asarray(rng.normal(0, 0.1, jp.sh_rest.shape), jnp.float32))
    p = mesh_bound.params_from_numpy(jp, device="cpu")
    m = mesh_bound.meta_from_numpy(jm, device="cpu")
    cfg_kw = dict(learn_verts=learn_verts, lr_max_steps=100)
    jcfg_t = jax_rs.MeshBoundTrainConfig(**cfg_kw)
    cfg = refined_sugar.MeshBoundTrainConfig(**cfg_kw)
    tx = jax_rs.make_mesh_bound_optimizer(jcfg_t, EXTENT)
    jstate = tx.init(jp)
    opt = refined_sugar.make_mesh_bound_optimizer(cfg, EXTENT)
    state = opt.init(refined_sugar.param_groups(p))
    assert ("verts" in opt.groups) == learn_verts
    jcfg = JaxConfig(backend="jax", bwd_sort_bf16=False, **RASTER)
    rcfg = RasterConfig(**RASTER)
    before = {k: t.numpy().copy() for k, t in refined_sugar.param_groups(p).items()}
    mu_prev = {g: 0.0 for g in opt.groups}
    least_grad = {}
    for step, ci in enumerate([0, 1, 2]):
        jp, jstate, jaux = jax_rs.mesh_bound_train_step(
            jp, jstate, jm.faces, jcams[ci], jnp.asarray(gt[ci]), tx, jcfg, jcfg_t, 3,
            jm.thickness)
        aux = refined_sugar.train_step(p, state, m, cams[ci], torch.from_numpy(gt[ci]), opt,
                                       rcfg, cfg)
        assert not bool(aux["overflow"]) and not bool(jaux["overflow"])
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
        got = {k: t.numpy() for k, t in refined_sugar.param_groups(p).items()}
        want = {k: np.asarray(getattr(jp, k)) for k in FIELDS}
        for g in got:
            if g not in opt.groups:
                np.testing.assert_array_equal(got[g], before[g], err_msg=g)
        for g in opt.groups:
            adam = jstate.inner_states[g].inner_state[0]
            mu, nu = np.asarray(getattr(adam.mu, g)), np.asarray(getattr(adam.nu, g))
            assert int(state.count[g]) == int(adam.count) == step + 1
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
            assert err.max() <= 2 * LRS[g] * (step + 1) + 1e-6, (g, step)


def test_train_refined_sugar_on_the_cpu(tmp_path):
    """stages_cli train-refined-sugar --device cpu: its initial model equal
    to the JAX pipeline's (vertex colours from the nearest coarse Gaussian,
    exact in both at this size), refined_sugar.npz with JAX's keys, dtypes
    and shapes loading in JAX's load_npz, refined_sugar.ply with one row per
    Gaussian; without --device cpu a machine with no CUDA device refuses the
    command."""
    scene_dir = _write_scene(str(tmp_path / "scene"), n_cams=3, size=48)
    out = tmp_path / "out"
    out.mkdir()
    rng = np.random.default_rng(0)
    d = rng.normal(size=(400, 3))
    means = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    sh = np.zeros((400, 16, 3), np.float32)
    sh[:, 0] = rng.normal(0, 0.5, (400, 3))
    raw = {"means3d": means, "sh_dc": sh[:, :1], "sh_rest": sh[:, 1:],
           "scales_log": np.full((400, 3), np.log(0.06), np.float32),
           "quats_raw": np.tile(np.float32([1, 0, 0, 0]), (400, 1)),
           "opacities_raw": np.full((400,), np.log(0.9 / 0.1), np.float32),
           "mask": np.ones(400, np.float32)}
    gauss_lib.save_ply(gauss_lib.params_from_numpy(raw, device="cpu"), str(out / "sugar.ply"))
    v, f = _mesh(subdiv=1)
    stages_cli.save_mesh(str(out / "shell.ply"), v, f)
    common = ["-s", scene_dir, "-o", str(out), "--max-instances", "65536", "--chunk", "32",
              "--iterations", "3", "--gaussians-per-triangle", "3"]
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            stages_cli.main(["train-refined-sugar", *common])
    res = stages_cli.main(["train-refined-sugar", *common, "--device", "cpu"])
    hist = res["history"]
    assert [h["iter"] for h in hist] == [3] and np.isfinite(hist[0]["loss"])
    assert hist[0]["overflow_steps"] == 0 and "refine loop" in res["timings_ms"]

    jraw = JaxGaussianParams(**{k: jnp.asarray(a) for k, a in raw.items()})
    jinit, _jm, _h = jax_pipeline.train_refined_sugar(
        v, f, jnp.asarray(means), jraw, 1.0, [], np.zeros((0, 3, 48, 48), np.float32), None,
        iterations=0, n_per_triangle=3, log_fn=None)
    init, _m, hist0 = pipeline.train_refined_sugar(
        v, f, torch.from_numpy(means), gauss_lib.params_from_numpy(raw, device="cpu"), 1.0, [],
        np.zeros((0, 3, 48, 48), np.float32), None, iterations=0, n_per_triangle=3,
        log_fn=None, device="cpu")
    assert hist0 == []
    for k in FIELDS:
        np.testing.assert_allclose(getattr(init, k).numpy(), np.asarray(getattr(jinit, k)),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    jax_checkpoint.save_npz(str(tmp_path / "jax.npz"), jinit)
    with np.load(out / "refined_sugar.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
    back = jax_checkpoint.load_npz(str(out / "refined_sugar.npz"), jinit)
    trained = res["trained"][0]
    for k in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, k)), getattr(trained, k).numpy())
    np.testing.assert_array_equal(trained.verts.numpy(), v)  # the vertices stay
    ply = ply_io.read_ply(str(out / "refined_sugar.ply"))["vertex"]
    assert len(ply["x"]) == 3 * len(f) and all(np.isfinite(ply[k]).all() for k in ply)
    assert sorted(os.listdir(out)) == ["refined_sugar.npz", "refined_sugar.ply", "shell.ply",
                                       "sugar.ply"]
