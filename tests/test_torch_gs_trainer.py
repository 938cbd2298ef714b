"""The port's 3DGS trainer (frosting_tpu_torch.train.gs_trainer) against
the JAX reference's train_step, and end to end on a synthetic scene, on the
CPU (the port's twin of tests/test_gs_trainer.py); with its checkpoints and
profiling helpers."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frosting_tpu.raster import RasterConfig as JaxConfig
from frosting_tpu.scene import synthetic as jax_synthetic
from frosting_tpu.train import gs_trainer as jax_trainer
from frosting_tpu_torch.cameras import camera_from_numpy
from frosting_tpu_torch.raster import RasterConfig
from frosting_tpu_torch.scene import synthetic
from frosting_tpu_torch.train import checkpoint, gs_trainer
from frosting_tpu_torch.train import optimizer as port_opt
from frosting_tpu_torch.utils import profiling
from tests.test_torch_optimizer import adam_parts, numpy_fields

EXTENT = 3.3
RASTER = dict(width=64, height=64, chunk=32, max_instances=8192)


@pytest.fixture(scope="module")
def views():
    """Ground truth views of the JAX package's gaussian_blob_scene(400) and
    a 400-point init from it, shared by both packages and the module's
    tests. The views are inputs of both trainers alike, so the port renders
    them (no JAX render compile)."""
    jcfg = JaxConfig(backend="jax", bwd_sort_bf16=False, **RASTER)
    gt = jax_synthetic.gaussian_blob_scene(n=400, seed=0)
    jcams = jax_synthetic.camera_ring(n_cams=6, radius=3.0)
    tcams = [camera_from_numpy(
        {f.name: np.asarray(getattr(c, f.name)) for f in dataclasses.fields(c)},
        device="cpu") for c in jcams]
    gt_imgs = synthetic.render_gt_images(
        tuple(torch.from_numpy(np.array(a)) for a in gt), tcams,
        RasterConfig(**RASTER), np.zeros(3, np.float32))
    pts, cols = jax_synthetic.degraded_init(gt, keep=1.0, jitter=0.03)
    return jcfg, jcams, tcams, gt_imgs, pts, cols


def test_train_steps_match_jax(views):
    """Three steps from the same init, on the same views in the same order.

    Tolerance: the first step's Adam update is lr * g / (|g| + 1e-15), the
    sign of the gradient, so an element whose gradient is round-off (the
    rotation of an isotropic Gaussian, a barely covered pixel) may move by
    +-lr in one package and -+lr in the other. All but 1% of each field's
    elements agree to 1e-5 + 1e-4 relative; none is further apart than two
    learning rates per step taken."""
    jcfg, jcams, tcams, gt_imgs, pts, cols = views
    cfg = gs_trainer.GSTrainConfig(capacity=512)
    jstate, tx = jax_trainer.init_state(pts, cols, EXTENT, jax_trainer.GSTrainConfig(capacity=512))
    state, opt = gs_trainer.init_state(pts, cols, EXTENT, cfg, device="cpu")
    order = np.random.default_rng(0).permutation(len(jcams))
    lrs = {"means3d": 1.6e-4 * EXTENT, "sh_dc": 2.5e-3, "sh_rest": 2.5e-3 / 20,
           "opacities_raw": 0.05, "scales_log": 5e-3, "quats_raw": 1e-3}
    for step, deg in enumerate((0, 1, 1)):
        ci = int(order[step])
        jstate, jm = jax_trainer.train_step(
            jstate, jcams[ci], jnp.asarray(gt_imgs[ci]), tx, jcfg,
            jax_trainer.GSTrainConfig(capacity=512), deg,
        )
        state, m = gs_trainer.train_step(
            state, tcams[ci], torch.from_numpy(gt_imgs[ci]), opt,
            RasterConfig(**RASTER), cfg, deg,
        )
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        for g in port_opt.GROUPS:
            got = getattr(state.params, g).numpy()
            want = np.asarray(getattr(jstate.params, g))
            err = np.abs(got - want)
            off = err > 1e-5 + 1e-4 * np.abs(want)
            assert off.mean() <= 0.01, (g, step, off.sum())
            assert err.max() <= 2 * lrs[g] * (step + 1) + 1e-6, (g, step, err.max())
        _, _, count = adam_parts(jstate.opt_state)
        assert {g: int(c) for g, c in state.opt_state.count.items()} == count


def test_logged_overflow_is_the_log_steps_own_flag_as_in_jax(views):
    """A capacity between the views' instance counts (637-717 at the init):
    the 2nd and 3rd steps' views overflow, the 4th's does not. Each log
    step's overflow is that step's own flag in both packages."""
    jcfg, jcams, tcams, gt_imgs, pts, cols = views
    raster = dict(RASTER, max_instances=704)
    cfg = dict(capacity=512, iterations=6, log_every=2, densify_from=100)
    _, jhist = jax_trainer.train(
        jcams, gt_imgs, pts, cols, EXTENT,
        dataclasses.replace(jcfg, max_instances=704),
        jax_trainer.GSTrainConfig(**cfg), log_fn=None,
    )
    _, hist = gs_trainer.train(
        tcams, gt_imgs, pts, cols, EXTENT, RasterConfig(**raster),
        gs_trainer.GSTrainConfig(**cfg), log_fn=None, device="cpu",
    )
    want = [h["overflow"] for h in jhist]
    assert True in want and False in want, want
    assert [h["iter"] for h in hist] == [h["iter"] for h in jhist]
    assert [h["overflow"] for h in hist] == want


def test_nan_ground_truth_leaves_the_state_untouched():
    rcfg = RasterConfig(**RASTER)
    scene = synthetic.gaussian_blob_scene(n=400, seed=0, device="cpu")
    tcams = synthetic.camera_ring(n_cams=2, radius=3.0, device="cpu")
    gt_imgs = synthetic.render_gt_images(scene, tcams, rcfg, np.zeros(3, np.float32))
    pts, cols = synthetic.degraded_init(scene, keep=1.0, jitter=0.03)
    cfg = gs_trainer.GSTrainConfig(capacity=512)
    state, opt = gs_trainer.init_state(pts, cols, EXTENT, cfg, device="cpu")
    gt = torch.from_numpy(gt_imgs[0])
    gs_trainer.train_step(state, tcams[0], gt, opt, rcfg, cfg, 0)
    before = gs_trainer.clone_state(state)
    bad = gt.clone()
    bad[0, 10, 10] = float("nan")
    state, m = gs_trainer.train_step(state, tcams[1], bad, opt, rcfg, cfg, 0)
    assert not np.isfinite(float(m["loss"]))
    for f in numpy_fields(state.params):
        assert torch.equal(getattr(state.params, f), getattr(before.params, f)), f
    for g in port_opt.GROUPS:
        assert torch.equal(state.opt_state.mu[g], before.opt_state.mu[g]), g
        assert torch.equal(state.opt_state.nu[g], before.opt_state.nu[g]), g
        assert int(state.opt_state.count[g]) == int(before.opt_state.count[g]) == 1
    assert torch.equal(state.dstate.grad_accum, before.dstate.grad_accum)


def test_train_recovers_synthetic_scene(tmp_path):
    rcfg = RasterConfig(**RASTER)
    gt = synthetic.gaussian_blob_scene(n=400, seed=0, device="cpu")
    cams = synthetic.camera_ring(n_cams=10, radius=3.0, device="cpu")
    gt_imgs = synthetic.render_gt_images(gt, cams, rcfg, np.zeros(3, np.float32))
    pts, cols = synthetic.degraded_init(gt, keep=0.5, jitter=0.08)
    cfg = gs_trainer.GSTrainConfig(
        iterations=150,
        capacity=2048,
        densify_from=100,
        densification_interval=100,
        opacity_reset_interval=10_000,
        sh_increase_interval=100,
        log_every=100,
        checkpoint_dir=str(tmp_path / "ckpt"),
        checkpoint_every=50,
        metrics_jsonl=str(tmp_path / "metrics.jsonl"),
    )
    state, history = gs_trainer.train(
        cams, gt_imgs, pts, cols, EXTENT, rcfg, cfg, log_fn=None, device="cpu"
    )
    metrics = gs_trainer.evaluate(state, cams, gt_imgs, rcfg, cfg)
    # history[0] is logged at iter 100, already part-trained; require clear
    # further improvement and a good absolute reconstruction
    first_psnr = history[0]["psnr"]
    assert metrics["psnr"] > 24.0, (first_psnr, metrics)
    assert metrics["psnr"] > first_psnr + 1.0
    assert not history[-1]["overflow"]
    assert int(state.params.num_active()) > len(pts)  # densify added Gaussians

    # the checkpoints and the metrics log
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [100, 150]
    final = checkpoint.load_npz(str(tmp_path / "ckpt" / "gs_final.npz"), device="cpu")
    for f in numpy_fields(final):
        assert torch.equal(getattr(final, f), getattr(state.params, f)), f
    assert (tmp_path / "ckpt" / "gs_0000100.npz").exists()


def test_checkpoint_npz_round_trips_with_jax(tmp_path):
    """A .npz of the JAX trainer's params loads in the port and back."""
    from frosting_tpu.scene.gaussians import create_from_pcd as jax_create
    from frosting_tpu.train import checkpoint as jax_checkpoint

    rng = np.random.default_rng(0)
    jp = jax_create(rng.uniform(size=(30, 3)).astype(np.float32),
                    rng.uniform(size=(30, 3)).astype(np.float32), 32)
    jax_checkpoint.save_npz(str(tmp_path / "jax.npz"), jp)
    p = checkpoint.load_npz(str(tmp_path / "jax.npz"), device="cpu")
    for f, a in numpy_fields(jp).items():
        np.testing.assert_array_equal(getattr(p, f).numpy(), a, err_msg=f)
    checkpoint.save_npz(str(tmp_path / "port.npz"), p)
    back = jax_checkpoint.load_npz(str(tmp_path / "port.npz"), jp)
    for f, a in numpy_fields(jp).items():
        np.testing.assert_array_equal(np.asarray(getattr(back, f)), a, err_msg=f)


def test_profiling_helpers(tmp_path):
    timer = profiling.StepTimer(pixels_per_step=64 * 64)
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("step"):
            torch.ones(8).sum()
        stats = timer.tick()
    assert (tmp_path / "trace" / "trace.json").exists()
    assert stats["step_ms"] > 0 and stats["mpix_per_s"] > 0
    if not torch.cuda.is_available():
        assert profiling.device_memory_stats() == {}
