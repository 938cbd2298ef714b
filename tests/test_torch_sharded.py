"""The port's sharded steps (frosting_tpu_torch.parallel) on four gloo ranks
on the CPU, against the JAX package's sharded steps on its virtual CPU
devices (tests/conftest.py) and against the port's single-process steps:
the twin of tests/test_sharded.py, at its sizes (64 x 64, 32 x 16 tiles,
300 Gaussians, capacity 512).

One module-scoped fixture starts the four ranks (tests/torch_sharded_worker.py)
first, then writes their inputs, and compiles the JAX references while they
run; the ranks run every scenario once and write numpy results, which the
tests only compare. The JAX side takes the port's exact KNN and the port's
renders of the ground truth as inputs, so no JAX render compile is spent
outside the sharded steps.

Tolerances: a sharded step against JAX's, the port's parity rule for a step
(loss rtol 1e-5; at most 1% of each field's values off by more than 1e-5 +
1e-4 |want|, none by more than 2 learning rates: the first Adam update is
lr * sign(g), so a round-off gradient flips a value by 2 lr); against the
port's single-process batch-mean step, tests/test_sharded.py's bounds (loss
rtol 2e-4, update cosine > 0.999); one route against another (shard_params,
the exchange) loss rtol 1e-5 and cosine > 0.9999.

The multi-device pipeline's stages (frosting_tpu_torch.parallel.pipeline,
the port of scripts/pipeline_multichip.py) run in the same ranks, on a
ring of 4 cameras: stages 1, 2 and 5 for 3 iterations each from inputs
handed to JAX too, stages 3-4 on stage 2's result, and the whole run as
its entry point makes it.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from frosting_tpu.models import frosting as jax_frosting
from frosting_tpu.ops import ssim as jax_ssim
from frosting_tpu.parallel import sharded_frosting as jax_sf
from frosting_tpu.parallel import sharded_sugar as jax_ssg
from frosting_tpu.parallel import sharded_train as jax_st
from frosting_tpu.raster import RasterConfig as JaxConfig
from frosting_tpu.scene import synthetic as jax_synthetic
from frosting_tpu.scene.gaussians import GaussianParams as JaxGaussianParams
from frosting_tpu.train import frosting_trainer as jax_ftrainer
from frosting_tpu.train import gs_trainer as jax_trainer
from frosting_tpu.train import optimizer as jax_opt
from frosting_tpu.train import sugar_trainer as jax_sugar
from frosting_tpu_torch.cameras import camera_from_numpy
from frosting_tpu_torch.models import frosting as frosting_lib
from frosting_tpu_torch.models import sugar as sugar_lib
from frosting_tpu_torch.ops.ssim import ssim
from frosting_tpu_torch.parallel import __main__ as dryrun
from frosting_tpu_torch.parallel import pipeline, report
from frosting_tpu_torch.raster import RasterConfig
from frosting_tpu_torch.scene import gaussians as gauss_lib
from frosting_tpu_torch.scene import synthetic
from frosting_tpu_torch.train import densify as densify_lib
from frosting_tpu_torch.train import frosting_trainer, gs_trainer, sugar_trainer
from frosting_tpu_torch.train import optimizer as opt_lib
from tests.torch_sharded_worker import (
    EXTENT,
    PIPE_CAMS,
    PIPE_ENTROPY_FRACTION,
    PIPE_FORCED,
    PIPE_ITERS,
    PIPE_KNN_EVERY,
    PIPE_STAGE2_RUNS,
    RASTER,
    SDF_SAMPLES,
)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_sharded_worker.py"
N_RANKS = 4
LRS = {"means3d": 1.6e-4 * EXTENT, "sh_dc": 2.5e-3, "sh_rest": 2.5e-3 / 20,
       "opacities_raw": 0.05, "scales_log": 5e-3, "quats_raw": 1e-3}
FROSTING_LRS = {"bary_logits": 5e-3, "sh_dc": 2.5e-3, "sh_rest": 2.5e-3 / 20,
                "opacities_raw": 0.05, "scales_log": 5e-3, "quats_raw": 1e-3,
                "bg_means3d": 1.6e-4 * 3.5, "bg_sh_dc": 2.5e-3, "bg_sh_rest": 2.5e-3 / 20,
                "bg_opacities_raw": 0.05, "bg_scales_log": 5e-3, "bg_quats_raw": 1e-3}

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 virtual devices")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _save(path, arrays):
    tmp = str(path) + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _icosphere_shell():
    return dryrun._icosphere(2)


def _inputs():
    """The scenarios' inputs as numpy: JAX's scene, cameras and init state,
    the port's GT renders and exact KNN, a random Frosting model with
    background Gaussians, and two images for the strip SSIM."""
    gt = jax_synthetic.gaussian_blob_scene(n=300, seed=2)
    jcams = jax_synthetic.camera_ring(n_cams=2, radius=3.0)
    inp = {}
    for i, c in enumerate(jcams):
        for f in dataclasses.fields(c):
            inp[f"cam{i}_{f.name}"] = np.asarray(getattr(c, f.name))
    tcams = [camera_from_numpy({f.name: np.asarray(getattr(c, f.name))
                                for f in dataclasses.fields(c)}, device="cpu") for c in jcams]
    scene = tuple(torch.from_numpy(np.array(a)) for a in gt)
    for k, a in zip(("means", "scales", "quats", "opac", "sh"), scene):
        inp[f"scene_{k}"] = a.numpy()
    inp["gt"] = synthetic.render_gt_images(scene, tcams, RasterConfig(**RASTER),
                                           np.zeros(3, np.float32))
    pts, cols = jax_synthetic.degraded_init(gt, keep=0.9, jitter=0.02)
    jstate, _ = jax_trainer.init_state(pts, cols, EXTENT, jax_trainer.GSTrainConfig(capacity=512))
    for f in dataclasses.fields(jstate.params):
        inp[f"params_{f.name}"] = np.asarray(getattr(jstate.params, f.name))
    params = gauss_lib.params_from_numpy(
        {k[7:]: v for k, v in inp.items() if k.startswith("params_")}, device="cpu")
    inp["knn_idx"] = sugar_trainer.compute_knn(params, 8).numpy().astype(np.int32)

    # the pipeline's stages: a ring of 4 cameras, batches of 2 drawn as the
    # script draws them, stage 1 from the script's degraded init (keep 0.7)
    pcams = jax_synthetic.camera_ring(n_cams=PIPE_CAMS, radius=3.0)
    for j, c in enumerate(pcams):
        for f in dataclasses.fields(c):
            inp[f"pcam{j}_{f.name}"] = np.asarray(getattr(c, f.name))
    inp["pipe_gt"] = synthetic.render_gt_images(
        scene, [camera_from_numpy({f.name: np.asarray(getattr(c, f.name))
                                   for f in dataclasses.fields(c)}, device="cpu")
                for c in pcams], RasterConfig(**RASTER), np.zeros(3, np.float32))
    schedule = pipeline.batch_schedule(PIPE_CAMS, 2, (PIPE_ITERS,) * 3)
    for name, b in zip(("b1", "b2", "b5"), schedule):
        inp[f"pipe_{name}"] = np.asarray(b)
    # stage 2 from the init with the scene's anisotropic scales, rotations
    # and opacities, as a trained 3DGS state has them, and from the
    # isotropic init itself
    live = inp["params_mask"] > 0.5
    n_live = int(live.sum())
    for f in dataclasses.fields(jstate.params):
        inp[f"p2_params_{f.name}"] = inp[f"params_{f.name}"].copy()
    inp["p2_params_scales_log"][live] = np.log(inp["scene_scales"][:n_live])
    inp["p2_params_quats_raw"][live] = inp["scene_quats"][:n_live]
    opac = inp["scene_opac"][:n_live]
    inp["p2_params_opacities_raw"][live] = np.log(opac / (1.0 - opac))
    for f in dataclasses.fields(jstate.params):
        inp[f"p2i_params_{f.name}"] = inp[f"params_{f.name}"].copy()
    pts7, cols7 = jax_synthetic.degraded_init(gt, keep=0.7, jitter=0.05)
    jstate7, _ = jax_trainer.init_state(pts7, cols7, EXTENT,
                                        jax_trainer.GSTrainConfig(capacity=512))
    for f in dataclasses.fields(jstate7.params):
        inp[f"p1_params_{f.name}"] = np.asarray(getattr(jstate7.params, f.name))

    rng = np.random.default_rng(11)
    verts, faces = _icosphere_shell()
    n, nb = 1024, 64
    cell = np.sort(rng.integers(0, len(faces), n)).astype(np.int32)
    inp.update({
        "f_shell_verts": verts, "f_inner_dist": np.full(len(verts), -0.05, np.float32),
        "f_outer_dist": np.full(len(verts), 0.05, np.float32),
        "f_bary_logits": rng.normal(size=(n, 6)).astype(np.float32),
        "f_scales_log": np.log(rng.uniform(0.02, 0.06, (n, 3))).astype(np.float32),
        "f_quats_raw": rng.normal(size=(n, 4)).astype(np.float32),
        "f_opacities_raw": rng.normal(size=n).astype(np.float32),
        "f_sh_dc": rng.uniform(-1, 1, (n, 1, 3)).astype(np.float32),
        "f_sh_rest": (rng.normal(size=(n, 15, 3)) * 0.05).astype(np.float32),
        "meta_faces": faces, "meta_cell_idx": cell,
        "meta_cell_bounds": np.searchsorted(cell, np.arange(len(faces) + 1)).astype(np.int32),
    })
    d = rng.normal(size=(nb, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    bg = gauss_lib.create_from_pcd((d * rng.uniform(1.4, 2.2, (nb, 1))).astype(np.float32),
                                   rng.uniform(0.2, 0.8, (nb, 3)), nb, device="cpu")
    for f in dataclasses.fields(bg):
        inp[f"fbg_{f.name}"] = getattr(bg, f.name).numpy()
    inp["ssim_a"] = rng.uniform(size=(3, 64, 64)).astype(np.float32)
    inp["ssim_b"] = np.clip(inp["ssim_a"] + rng.normal(scale=0.1, size=(3, 64, 64)),
                            0, 1).astype(np.float32)
    return inp, (jstate, jstate7)


def _pipe_phases():
    n_entropy = int(round(PIPE_ENTROPY_FRACTION * PIPE_ITERS))
    return ["entropy" if it < n_entropy else "sdf" for it in range(PIPE_ITERS)]


def _sdf_draws():
    """JAX's per-device draws of its sharded sdf phase:
    fold_in(key, data_idx * n_tile + tile_idx), split into the uniform and
    the normal draw, as sample_points_in_gaussians splits it."""
    key = jax.random.key(1)
    n = max(256, SDF_SAMPLES // N_RANKS)
    out = {}
    for i in range(N_RANKS):
        k1, k2 = jax.random.split(jax.random.fold_in(key, i))
        out[f"u{i}"] = np.asarray(jax.random.uniform(k1, (n,)))
        out[f"eps{i}"] = np.asarray(jax.random.normal(k2, (n, 3)))
    # the pipeline's stage 2, as the script keys it: key(0) split once an
    # iteration, the step's key folded with each device's index
    key = jax.random.key(0)
    for it, phase in enumerate(_pipe_phases()):
        key, sub_key = jax.random.split(key)
        if phase != "sdf":
            continue
        for i in range(N_RANKS):
            k1, k2 = jax.random.split(jax.random.fold_in(sub_key, i))
            out[f"pipe_u{it}_{i}"] = np.asarray(jax.random.uniform(k1, (n,)))
            out[f"pipe_eps{it}_{i}"] = np.asarray(jax.random.normal(k2, (n, 3)))
    return out


# The 3DGS, SuGaR and strip-SSIM references compile at XLA's backend (LLVM)
# optimisation level 1: ~40% less compile time than the default level, and
# bitwise the same results (checked against the default level). The
# Frosting steps' results move by up to 4e-6 there, so they keep the default.
FAST_COMPILE = {"xla_backend_optimization_level": 1}


def _fast(fn):
    """fn, a jitted JAX function, compiled at FAST_COMPILE on its first
    call's arguments; later calls must match their shapes and shardings."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(fn.lower(*args).compile(FAST_COMPILE))
        return compiled[0](*args)

    return call


def _jax_references(inp, jstates, tmp):
    """Each JAX sharded step once, on make_mesh(2, 2) (the strip SSIM on
    1 x 4), compiled in threads; and the pipeline's stages 1, 2 and 5 as
    scripts/pipeline_multichip.py runs them, stages 1 and 2 on the steps
    compiled for the single steps."""
    jstate, jstate7 = jstates
    jcfg = JaxConfig(backend="jax", bwd_sort_bf16=False, **RASTER)
    mesh = jax_st.make_mesh(n_data=2, n_tile=2)
    jcams = jax_synthetic.camera_ring(n_cams=2, radius=3.0)
    cams_s, gts_s = jax_st.shard_batch(mesh, jax_st.stack_cameras(jcams), jnp.asarray(inp["gt"]))
    pcams = jax_synthetic.camera_ring(n_cams=PIPE_CAMS, radius=3.0)
    tx = jax_opt.make_gs_optimizer(EXTENT)
    gs_step = _fast(jax_st.make_sharded_train_step(
        tx, jcfg, jax_trainer.GSTrainConfig(capacity=512), mesh))
    scfg = jax_sugar.SugarTrainConfig(method="density", n_sdf_samples=SDF_SAMPLES, knn_k=8,
                                      spatial_extent=EXTENT)
    sugar_steps = {ph: _fast(jax_ssg.make_sharded_sugar_step(tx, jcfg, scfg, mesh, ph))
                   for ph in ("photo", "entropy", "sdf")}
    ref = {}

    def batch(sel):
        return jax_st.shard_batch(mesh, jax_st.stack_cameras([pcams[i] for i in sel]),
                                  jnp.asarray(inp["pipe_gt"][sel]))

    def host(tree):
        """A step's result as the host arrays its first call took: a result
        replicated over the mesh is another input sharding, which would
        compile the step again."""
        return jax.tree.map(lambda x: jnp.asarray(np.asarray(x)), tree)

    def gs():
        new, m = gs_step(jstate, cams_s, gts_s)
        ref["gs_loss"] = float(m["loss"])
        ref["gs"] = {g: np.asarray(getattr(new.params, g)) for g in opt_lib.GROUPS}
        state, losses = jstate7, []
        for sel in inp["pipe_b1"]:
            state, m = gs_step(host(state), *batch(sel))
            losses.append(float(m["loss"]))
        ref["p1_loss"] = losses
        ref["p1"] = {g: np.asarray(getattr(state.params, g)) for g in opt_lib.GROUPS}

    def sugar(phase):
        p, _o, m = sugar_steps[phase](
            jstate.params, tx.init(jstate.params), cams_s, gts_s,
            jnp.asarray(inp["knn_idx"]), jax.random.key(1))
        ref[f"sugar_{phase}_loss"] = float(m["loss"])
        ref[f"sugar_{phase}"] = {g: np.asarray(getattr(p, g)) for g in opt_lib.GROUPS}

    def pipe_sugar(run):
        """Stage 2 from the parameters ``run``_params_, on the KNN of each
        of the port's refreshes (the artifact both sides take: JAX's own
        search is approximate, and an exact one on either side's parameters
        may differ where the two sides' parameters do). A run of
        PIPE_FORCED starts each step from the port's parameters before it;
        the Adam moments stay JAX's own, made from its gradients at the
        port's parameters."""
        from tests.torch_sharded_worker import wait_for

        p = JaxGaussianParams(**{f.name: jnp.asarray(inp[f"{run}_params_{f.name}"])
                                 for f in dataclasses.fields(JaxGaussianParams)})
        o, key, losses, knn = tx.init(p), jax.random.key(0), [], None
        for it, (phase, sel) in enumerate(zip(_pipe_phases(), inp["pipe_b2"])):
            if it % PIPE_KNN_EVERY == 0:
                knn = wait_for(str(tmp / f"{run}_knn{it}.npz"), timeout=300.0)[f"it{it}"]
            if run in PIPE_FORCED and it > 0:
                port = wait_for(str(tmp / f"{run}_params{it}.npz"), timeout=300.0)
                p = JaxGaussianParams(**{k: jnp.asarray(v) for k, v in port.items()})
            key, sub_key = jax.random.split(key)
            p, o, m = sugar_steps[phase](host(p), host(o), *batch(sel), jnp.asarray(knn),
                                         sub_key)
            losses.append(float(m["loss"]))
        ref[f"{run}_loss"] = losses
        ref[run] = {g: np.asarray(getattr(p, g)) for g in opt_lib.GROUPS}

    def jax_fparams(with_bg):
        own = {k[2:]: jnp.asarray(v) for k, v in inp.items() if k.startswith("f_")}
        bg = JaxGaussianParams(**{k[4:]: jnp.asarray(v) for k, v in inp.items()
                                  if k.startswith("fbg_")}) if with_bg else None
        meta = jax_frosting.FrostingMeta(jnp.asarray(inp["meta_faces"]),
                                         jnp.asarray(inp["meta_cell_idx"]),
                                         jnp.asarray(inp["meta_cell_bounds"]))
        return jax_frosting.FrostingParams(**own, bg=bg), meta

    def frosting():
        """The replicated layout: JAX's own test holds its shard_params
        step to this one (loss rtol 1e-5, cosine > 0.9999)."""
        fparams, meta = jax_fparams(True)
        tcfg = jax_ftrainer.FrostingTrainConfig(iterations=1, lr_max_steps=10)
        ftx = jax_ftrainer.make_frosting_optimizer(tcfg, 3.5)
        p, _o, m = jax_sf.make_sharded_frosting_step(ftx, jcfg, tcfg, mesh, meta)(
            fparams, ftx.init(fparams), cams_s, gts_s)
        ref["f_loss"] = float(m["loss"])
        groups = {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)
                  if f.name != "bg"}
        groups.update({f"bg_{f.name}": np.asarray(getattr(p.bg, f.name))
                       for f in dataclasses.fields(p.bg)})
        ref["f"] = groups

    def pipe_frosting():
        """Stage 5: shard_params and the primitive exchange (a cap of
        max_instances / n_tile), lr_max_steps = the iterations."""
        fparams, meta = jax_fparams(False)
        cfg = jax_ftrainer.FrostingTrainConfig(iterations=PIPE_ITERS, lr_max_steps=PIPE_ITERS)
        ftx = jax_ftrainer.make_frosting_optimizer(cfg, EXTENT)
        p = jax_sf.shard_frosting_params(mesh, fparams)
        o = ftx.init(p)
        step = jax_sf.make_sharded_frosting_step(
            ftx, jcfg, cfg, mesh, meta, shard_params=True, primitive_exchange=True,
            exchange_cap=jcfg.max_instances // 2)
        losses = []
        for sel in inp["pipe_b5"]:
            p, o, m = step(p, o, *batch(sel))
            losses.append(float(m["loss"]))
        ref["p5_loss"] = losses
        ref["p5"] = {f.name: np.asarray(getattr(p, f.name)) for f in dataclasses.fields(p)
                     if f.name != "bg"}

    def strips():
        row = jax_st.make_mesh(n_data=1, n_tile=4)
        fn = _fast(jax.jit(jax.shard_map(
            lambda a, b: jax_ssim.ssim_strips(a, b, "tile")[None], mesh=row,
            in_specs=(P(None, "tile", None), P(None, "tile", None)), out_specs=P("tile"))))
        a, b = jnp.asarray(inp["ssim_a"]), jnp.asarray(inp["ssim_b"])
        ref["ssim_strips"] = np.asarray(fn(a, b))
        ref["ssim_full"] = float(jax_ssim.ssim(a, b))

    with ThreadPoolExecutor(8) as pool:
        jobs = {name: pool.submit(job) for name, job in [
            ("pipe_frosting", pipe_frosting), ("gs", gs), ("frosting", frosting),
            ("strips", strips)] + [(ph, lambda ph=ph: sugar(ph))
                                   for ph in ("photo", "entropy", "sdf")]}

        def pipe_sugar_when_compiled(run):
            for ph in ("entropy", "sdf"):
                jobs[ph].result()
            pipe_sugar(run)

        for run in PIPE_STAGE2_RUNS:
            jobs[run] = pool.submit(pipe_sugar_when_compiled, run)
        for job in jobs.values():
            job.result()
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, JAX references, each rank's results): the ranks start
    first, the JAX references compile while they run."""
    tmp = tmp_path_factory.mktemp("sharded")
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(N_RANKS)]
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(N_RANKS), str(port),
                               str(tmp)], cwd=ROOT, env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(N_RANKS)]
    try:
        inp, jstates = _inputs()
        _save(tmp / "inputs.npz", inp)
        _save(tmp / "draws.npz", _sdf_draws())
        ref = _jax_references(inp, jstates, tmp)
        for r, proc in enumerate(procs):
            code = proc.wait(timeout=300)
            logs[r].close()
            assert code == 0, (tmp / f"rank{r}.log").read_text()[-4000:]
        results = []
        for r in range(N_RANKS):
            with np.load(tmp / f"rank{r}.npz") as z:
                results.append({k: z[k] for k in z.files})
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    yield inp, ref, results


def _by_block(results, key):
    """The whole array from each rank's block of key, in PRIM_SPEC order."""
    blocks = sorted((int(r["flat_index"]), r[key]) for r in results)
    return np.concatenate([b for _, b in blocks])


def _cosine(a, b):
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


def _parity(got, want, lr, what):
    err = np.abs(got - want)
    off = err > 1e-5 + 1e-4 * np.abs(want)
    assert off.mean() <= 0.01, (what, off.sum(), err.max())
    assert err.max() <= 2 * lr + 1e-6, (what, err.max())


def test_ssim_strips_match_the_full_image_and_jax(runs):
    inp, ref, results = runs
    strips = np.asarray([float(r["ssim_strip"]) for r in sorted(
        results, key=lambda r: int(r["row_index"]))])
    full = float(ssim(torch.from_numpy(inp["ssim_a"]), torch.from_numpy(inp["ssim_b"])))
    np.testing.assert_allclose(strips, ref["ssim_strips"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(strips.mean(), full, rtol=1e-5)
    np.testing.assert_allclose(full, ref["ssim_full"], rtol=1e-5)


def test_replicated_step_matches_jax(runs):
    _inp, ref, results = runs
    r = results[0]
    assert float(r["gs_overflow_0"]) == 0
    np.testing.assert_allclose(float(r["gs_loss_0"]), ref["gs_loss"], rtol=1e-5)
    for g in opt_lib.GROUPS:
        _parity(r[f"gs0_params_{g}"], ref["gs"][g], LRS[g], g)


def test_replicated_step_matches_the_single_process_batch_mean(runs):
    inp, _ref, results = runs
    state = _fresh_state(inp)
    before = _flat({g: inp[f"params_{g}"] for g in opt_lib.GROUPS})
    cams = [camera_from_numpy({k[5:]: v for k, v in inp.items() if k.startswith(f"cam{i}_")},
                              device="cpu") for i in range(2)]
    opt = opt_lib.make_gs_optimizer(EXTENT)
    cfg = gs_trainer.GSTrainConfig(capacity=512)
    m = report.reference_gs_step(state, cams, [torch.from_numpy(g) for g in inp["gt"]], opt,
                                 RasterConfig(**RASTER), cfg)
    r = results[0]
    np.testing.assert_allclose(float(r["gs_loss_0"]), float(m["loss"]), rtol=2e-4)
    got = _flat({g: r[f"gs0_params_{g}"] for g in opt_lib.GROUPS}) - before
    want = _flat({g: getattr(state.params, g).numpy() for g in opt_lib.GROUPS}) - before
    assert _cosine(got, want) > 0.999
    # the densify statistics: the probe gradients summed, the radii's maximum
    np.testing.assert_allclose(r["gs0_grad_accum"], state.dstate.grad_accum.numpy(),
                               rtol=1e-4, atol=1e-7)
    np.testing.assert_array_equal(r["gs0_max_radii"], state.max_radii.numpy())


def test_replicated_parameters_are_bitwise_equal_across_ranks_and_runs(runs):
    _inp, _ref, results = runs
    keys = [k for k in results[0] if k.startswith("gs0_")]
    for r in results:
        for k in keys:
            np.testing.assert_array_equal(r[k], results[0][k], err_msg=k)
            np.testing.assert_array_equal(r[k.replace("gs0_", "gs1_")], r[k], err_msg=k)
        assert r["gs_loss_1"] == r["gs_loss_0"]
    for name in ("replicated",):
        for k in [k for k in results[0] if k.startswith(f"f_{name}_")]:
            for r in results:
                np.testing.assert_array_equal(r[k], results[0][k], err_msg=k)


def test_shard_params_matches_replicated(runs):
    inp, _ref, results = runs
    cap = inp["params_means3d"].shape[0]
    for r in results:
        for k in ("params_means3d", "mu_means3d", "nu_sh_rest", "grad_accum", "max_radii"):
            assert r[f"shard_{k}"].shape[0] == cap // N_RANKS, k
    assert float(results[0]["shard_loss"]) == pytest.approx(float(results[0]["gs_loss_0"]),
                                                            rel=1e-5)
    before = _flat({g: inp[f"params_{g}"] for g in opt_lib.GROUPS})
    got = _flat({g: _by_block(results, f"shard_params_{g}") for g in opt_lib.GROUPS}) - before
    want = _flat({g: results[0][f"gs0_params_{g}"] for g in opt_lib.GROUPS}) - before
    assert _cosine(got, want) > 0.9999
    np.testing.assert_allclose(_by_block(results, "shard_grad_accum"),
                               results[0]["gs0_grad_accum"], rtol=1e-4, atol=1e-7)
    np.testing.assert_array_equal(_by_block(results, "shard_max_radii"),
                                  results[0]["gs0_max_radii"])


def test_sharded_densify_is_the_single_process_densify_of_each_shard(runs):
    """Each rank's densify equals the port's densify_and_prune on its shard
    with its draws, bit for bit; the summed info grows the cloud."""
    _inp, _ref, results = runs
    total = np.zeros(4, np.int64)
    for r in results:
        pre = {k[4:]: v for k, v in r.items() if k.startswith("pre_")}
        state = gs_trainer.state_from_numpy(
            {k[7:]: v for k, v in pre.items() if k.startswith("params_")},
            {g: pre[f"mu_{g}"] for g in opt_lib.GROUPS},
            {g: pre[f"nu_{g}"] for g in opt_lib.GROUPS}, {g: 4 for g in opt_lib.GROUPS},
            pre, pre["max_radii"], device="cpu")
        params, _dstate, info = densify_lib._densify_and_prune(
            state.params, state.opt_state, state.dstate, torch.from_numpy(r["densify_eps1"]),
            torch.from_numpy(r["densify_eps2"]), EXTENT,
            densify_lib.DensifyConfig(grad_threshold=1e-6), 0.0, state.max_radii)
        for g in opt_lib.GROUPS + ("mask",):
            np.testing.assert_array_equal(r[f"post_params_{g}"], getattr(params, g).numpy())
        for g in opt_lib.GROUPS:
            np.testing.assert_array_equal(r[f"post_mu_{g}"], state.opt_state.mu[g].numpy())
        assert not r["post_grad_accum"].any() and not r["post_max_radii"].any()
        total += np.asarray([int(v) for v in info])
    for r in results:
        np.testing.assert_array_equal(r["densify_info"], total)
    n_clone_split = total[0] + total[1]
    assert n_clone_split > 0
    grown = sum(r["post_params_mask"].sum() for r in results)
    assert grown > sum(r["pre_params_mask"].sum() for r in results)
    assert np.isfinite(float(results[0]["post_densify_loss"]))


def test_exchange_matches_the_all_gather(runs):
    inp, _ref, results = runs
    r = results[0]
    assert float(r["x_overflow"]) == 0
    np.testing.assert_allclose(float(r["x_exchange_loss"]), float(r["x_gather_loss"]),
                               rtol=1e-5)
    before = inp["params_means3d"]
    assert _cosine(r["x_exchange_means"] - before, r["x_gather_means"] - before) > 0.9999


@pytest.mark.parametrize("phase", ["photo", "entropy", "sdf"])
def test_sugar_phase_matches_jax(runs, phase):
    """sdf: the density mode, each rank on JAX's own per-device draws."""
    inp, ref, results = runs
    r = results[0]
    np.testing.assert_allclose(float(r[f"sugar_{phase}_loss"]), ref[f"sugar_{phase}_loss"],
                               rtol=1e-5)
    for g in opt_lib.GROUPS:
        _parity(r[f"sugar_{phase}_{g}"], ref[f"sugar_{phase}"][g], LRS[g], (phase, g))
        for other in results[1:]:
            np.testing.assert_array_equal(other[f"sugar_{phase}_{g}"], r[f"sugar_{phase}_{g}"])
    if phase != "photo":
        assert float(r[f"sugar_{phase}_loss"]) > float(r["sugar_photo_loss"])


def test_depth_strips_assemble_the_full_depth_render(runs):
    """As tests/test_sharded.py's test_strip_depth_assembly_matches_full_render."""
    inp, _ref, results = runs
    model = tuple(torch.from_numpy(inp[f"scene_{k}"]) for k in
                  ("means", "scales", "quats", "opac"))
    cam = camera_from_numpy({k[5:]: v for k, v in inp.items() if k.startswith("cam0_")},
                            device="cpu")
    want, _n, _acc = sugar_lib.render_depth_normal_maps(*model, cam, RasterConfig(**RASTER),
                                                        normals=False)
    for r in results:
        np.testing.assert_allclose(r["depth"], want.numpy(), rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module")
def frosting_reference(runs):
    """The port's single-process step on the two cameras' mean loss
    (parallel.__main__.reference_frosting_step) from the Frosting inputs:
    {group: tensor after the step}."""
    inp, _ref, _results = runs
    p = frosting_lib.params_from_numpy(
        dict({k[2:]: v for k, v in inp.items() if k.startswith("f_")},
             bg={k[4:]: v for k, v in inp.items() if k.startswith("fbg_")}), device="cpu")
    meta = frosting_lib.make_meta(inp["meta_faces"], inp["meta_cell_idx"],
                                  inp["meta_cell_bounds"], n_verts=p.shell_verts.shape[0],
                                  device="cpu")
    cfg = frosting_trainer.FrostingTrainConfig(iterations=1, lr_max_steps=10)
    opt = frosting_trainer.make_frosting_optimizer(cfg, 3.5, background=True)
    state = opt.init(frosting_trainer.param_groups(p))
    cams = [camera_from_numpy({k[5:]: v for k, v in inp.items() if k.startswith(f"cam{i}_")},
                              device="cpu") for i in range(2)]
    m = dryrun.reference_frosting_step(p, state, meta, cams,
                                       [torch.from_numpy(g) for g in inp["gt"]], opt,
                                       RasterConfig(**RASTER), cfg)
    return float(m["loss"]), {g: v.numpy() for g, v in frosting_trainer.param_groups(p).items()}


@pytest.mark.parametrize("name", ["replicated", "shard"])
def test_frosting_step_with_background_matches_jax(runs, frosting_reference, name):
    """The sharded Frosting step with background Gaussians, replicated and
    with shard_params (each rank's blocks assembled; the Adam moments
    sharded too):

    - against JAX's sharded step (replicated layout; JAX's own test holds
      its shard_params step to it): the loss to 1e-5, the update's cosine
      > 0.999 (tests/test_sharded.py's bound), every value within two
      learning rates. The element-wise rule does not hold against JAX here
      for the port's single-process step either: 38 of the 3072 scale
      values, whose gradients are below 0.3% of their group's largest, take
      first Adam steps (lr * g / |g|) apart, JAX's gradient 0 where the
      port's is ~1e-7;
    - against the port's single-process batch-mean step: the port's parity
      rule for a step (loss rtol 1e-5; at most 1% of each group's values off
      by more than 1e-5 + 1e-4 |want|, none by more than 2 lr)."""
    inp, ref, results = runs
    ref_loss, single = frosting_reference
    r = results[0]
    np.testing.assert_allclose(float(r[f"f_{name}_loss"]), ref["f_loss"], rtol=1e-5)
    np.testing.assert_allclose(float(r[f"f_{name}_loss"]), ref_loss, rtol=1e-5)
    got = {g: _by_block(results, f"f_{name}_{g}") if name == "shard" else r[f"f_{name}_{g}"]
           for g in FROSTING_LRS}
    for g, lr in FROSTING_LRS.items():
        assert np.abs(got[g] - ref["f"][g]).max() <= 2 * lr + 1e-6, g
        _parity(got[g], single[g], lr, g)
    before = np.concatenate([inp[f"fbg_{g[3:]}" if g.startswith("bg_") else f"f_{g}"].ravel()
                             for g in FROSTING_LRS])
    flat = np.concatenate([got[g].ravel() for g in FROSTING_LRS])
    jax_flat = np.concatenate([ref["f"][g].ravel() for g in FROSTING_LRS])
    assert _cosine(flat - before, jax_flat - before) > 0.999
    for g in ("shell_verts", "inner_dist", "outer_dist"):
        np.testing.assert_array_equal(r[f"f_{name}_{g}"], inp[f"f_{g}"])  # frozen
    assert np.abs(got["bg_sh_dc"] - inp["fbg_sh_dc"]).max() > 0  # the background trains
    if name == "shard":
        assert int(r["f_shard_mu_rows"]) == inp["f_bary_logits"].shape[0] // N_RANKS


def _fresh_state(inp):
    cap = inp["params_means3d"].shape[0]
    zeros = {g: np.zeros_like(inp[f"params_{g}"]) for g in opt_lib.GROUPS}
    return gs_trainer.state_from_numpy(
        {k[7:]: v for k, v in inp.items() if k.startswith("params_")}, zeros, zeros,
        {g: 0 for g in opt_lib.GROUPS}, {"grad_accum": np.zeros(cap), "denom": np.zeros(cap)},
        np.zeros(cap), device="cpu")


def _flat(groups):
    return np.concatenate([np.ravel(groups[g]) for g in opt_lib.GROUPS])


def test_frosting_params_map_shards_the_primitive_leaves_only(runs):
    """map_frosting_params sends the vertex leaves to `rep` and every
    primitive leaf, the background's included, to `big`;
    shard_frosting_params keeps the vertex leaves whole and cuts each
    primitive leaf to this rank's block (block 2 of 4 here)."""
    import types

    from frosting_tpu_torch.parallel import sharded_frosting as sf

    inp, _ref, _results = runs
    p = frosting_lib.params_from_numpy(
        dict({k[2:]: v for k, v in inp.items() if k.startswith("f_")},
             bg={k[4:]: v for k, v in inp.items() if k.startswith("fbg_")}), device="cpu")
    seen = sf.map_frosting_params(p, lambda x: "big", lambda x: "rep")
    assert seen.shell_verts == seen.inner_dist == seen.outer_dist == "rep"
    assert all(getattr(seen, f) == "big" for f in ("bary_logits", "scales_log", "quats_raw",
                                                   "opacities_raw", "sh_dc", "sh_rest"))
    assert all(getattr(seen.bg, f.name) == "big" for f in dataclasses.fields(seen.bg))
    share = sf.shard_frosting_params(types.SimpleNamespace(size=4, flat_index=2), p)
    for g, v in frosting_trainer.param_groups(share).items():
        whole = frosting_trainer.param_groups(p)[g]
        if g in sf.VERTEX_LEAVES:
            assert torch.equal(v, whole), g
        else:
            n = whole.shape[0] // 4
            assert torch.equal(v, whole[2 * n:3 * n]), g


# --- the pipeline's stages (frosting_tpu_torch.parallel.pipeline) ---
#
# Stages 1, 2 and 5 start from inputs handed to JAX too and run 3
# iterations each (stage 2: its entropy -> sdf switch after the first, its
# KNN recomputed at iterations 0 and 2); stages 3 and 4 run on stage 2's
# result (the Frosting init's draws differ from JAX's by design). Held to
# JAX by the port's step rule over several steps, as
# tests/test_torch_gs_trainer.py's test_train_steps_match_jax holds three:
# every loss to rtol 1e-5, at most 1% of each field's values off by more
# than 1e-5 + 1e-4 |want|, none by more than two learning rates a step.


def _pipe_parity(got, want, lrs, steps, what):
    for g, lr in lrs.items():
        err = np.abs(got[g] - want[g])
        off = err > 1e-5 + 1e-4 * np.abs(want[g])
        assert off.mean() <= 0.01, (what, g, off.sum())
        assert err.max() <= 2 * lr * steps + 1e-6, (what, g, err.max())


def _equal_on_every_rank(results, keys):
    for k in keys:
        for r in results[1:]:
            np.testing.assert_array_equal(r[k], results[0][k], err_msg=k)


@pytest.mark.parametrize("stage", ["p1", "p2", "p2i"])
def test_pipeline_stage_matches_jax(runs, stage):
    """Stage 1 (the replicated 3DGS step from the script's degraded init)
    and stage 2 (coarse SuGaR, each rank on JAX's own sdf draws, both sides
    on the KNN of the port's refreshes) from that init with the scene's
    anisotropic scales (p2) and from the isotropic init itself (p2i, each
    of JAX's steps from the port's parameters before it): losses,
    parameters, every rank's copy bitwise equal."""
    _inp, ref, results = runs
    r = results[0]
    np.testing.assert_allclose(r[f"{stage}_loss"], ref[f"{stage}_loss"], rtol=1e-5)
    _pipe_parity({g: r[f"{stage}_{g}"] for g in opt_lib.GROUPS}, ref[stage], LRS, PIPE_ITERS,
                 stage)
    _equal_on_every_rank(results, [f"{stage}_{g}" for g in opt_lib.GROUPS])
    if stage != "p1":
        assert list(r[f"{stage}_phases"]) == _pipe_phases() == ["entropy", "sdf", "sdf"]


def test_pipeline_stage3_compacts_activates_and_broadcasts_the_shell(runs):
    """The live rows of stage 2's result, activated as JAX activates them
    (to 1e-6); the shell extracted on rank 0, bitwise the same on every
    rank, within its 400-vertex target."""
    from frosting_tpu.scene.gaussians import activate as jax_activate

    _inp, _ref, results = runs
    r = results[0]
    live = r["p2_mask"] > 0.5
    rows = JaxGaussianParams(**{f.name: jnp.asarray(r[f"p2_{f.name}"][live])
                                for f in dataclasses.fields(JaxGaussianParams)})
    want = jax_activate(rows)
    for name, w in zip(("means", "scales", "quats", "opac"), want):
        assert r[f"p3_{name}"].shape[0] == live.sum()
        np.testing.assert_allclose(r[f"p3_{name}"], np.asarray(w), rtol=1e-6, atol=1e-6)
    _equal_on_every_rank(results, ["p3_verts", "p3_faces", "p3_means"])
    assert 100 < len(r["p3_verts"]) <= 400 and r["p3_faces"].max() < len(r["p3_verts"])
    assert np.isfinite(r["p3_verts"]).all()


def test_pipeline_stage4_broadcast_is_bitwise_on_every_rank(runs):
    """The Frosting init of rank 0, parameters and meta, equal on every
    rank after the broadcast; on the broadcast shell, 1024 Gaussians sorted
    by cell."""
    _inp, _ref, results = runs
    r = results[0]
    keys = [k for k in r if k.startswith("p4_")]
    assert len(keys) == 12
    _equal_on_every_rank(results, keys)
    np.testing.assert_array_equal(r["p4_shell_verts"], r["p3_verts"])
    np.testing.assert_array_equal(r["p4_meta_faces"], r["p3_faces"])
    ci = r["p4_meta_cell_idx"]
    assert len(ci) == r["p4_bary_logits"].shape[0] == 1024 and (np.diff(ci) >= 0).all()
    np.testing.assert_array_equal(r["p4_meta_cell_bounds"],
                                  np.searchsorted(ci, np.arange(len(r["p3_faces"]) + 1)))
    assert float(r["p4_outer_dist"].mean()) > 0 > float(r["p4_inner_dist"].mean())


def test_pipeline_stage5_matches_jax(runs):
    """Stage 5, shard_params with the primitive exchange: every rank holds
    1024 / 4 rows of the parameters and both Adam moments; the assembled
    blocks against JAX's sharded step; the shell frozen and equal
    everywhere."""
    inp, ref, results = runs
    r = results[0]
    for res in results:
        np.testing.assert_array_equal(res["p5_rows"], [1024 // N_RANKS] * 3)
    np.testing.assert_allclose(r["p5_loss"], ref["p5_loss"], rtol=1e-5)
    lrs = {k: v for k, v in FROSTING_LRS.items() if not k.startswith("bg_")}
    got = {g: _by_block(results, f"p5_{g}") for g in lrs}
    _pipe_parity(got, ref["p5"], lrs, PIPE_ITERS, "p5")
    for g in ("shell_verts", "inner_dist", "outer_dist"):
        _equal_on_every_rank(results, [f"p5_{g}"])
        np.testing.assert_array_equal(r[f"p5_{g}"], inp[f"f_{g}"])


def test_pipeline_eval_renders_the_gathered_model_on_rank_0(runs):
    """run_eval's PSNRs (rank 0 only) are the single-process render of the
    model assembled from every rank's stage-5 blocks."""
    inp, _ref, results = runs
    assert all(len(res["p5_psnr"]) == 0 for res in results[1:])
    d = {g: _by_block(results, f"p5_{g}") for g in FROSTING_LRS if not g.startswith("bg_")}
    d.update({g: results[0][f"p5_{g}"] for g in ("shell_verts", "inner_dist", "outer_dist")})
    p = frosting_lib.params_from_numpy(d, device="cpu")
    meta = frosting_lib.make_meta(inp["meta_faces"], inp["meta_cell_idx"],
                                  inp["meta_cell_bounds"], n_verts=p.shell_verts.shape[0],
                                  device="cpu")
    from frosting_tpu_torch.ops.ssim import psnr
    from frosting_tpu_torch.raster import render

    with torch.no_grad():
        model = frosting_lib.activate_frosting(p, meta)
        want = []
        for j in (0, 1):
            cam = camera_from_numpy({k[6:]: v for k, v in inp.items()
                                     if k.startswith(f"pcam{j}_")}, device="cpu")
            img = render(*model, cam, RasterConfig(**RASTER), bg=torch.zeros(3)).image
            want.append(float(psnr(torch.clamp(img, 0, 1), torch.from_numpy(inp["pipe_gt"][j]))))
    np.testing.assert_allclose(results[0]["p5_psnr"], want, rtol=1e-6)


def test_pipeline_entry_result_has_the_keys_of_pipeline_mc_json(runs):
    """The whole run as the entry point makes it (pipeline.run_checked on
    2 x 2): the result's keys, nested, are PIPELINE_MC.json's; no check
    failed (finite losses, no overflow, stage 1's first step held on rank 0
    against the single-process batch-mean step, the replicated and
    broadcast tensors' digests equal on every rank, 1024 / 4 rows a
    rank)."""
    _inp, _ref, results = runs
    result = json.loads(str(results[0]["pmc_result"]))
    with open(ROOT / "PIPELINE_MC.json") as fh:
        jax_result = json.load(fh)

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) else None for k, v in d.items()}

    assert keys(result) == keys(jax_result)
    assert json.loads(str(results[0]["pmc_failed"])) == []
    st_ = result["stages"]
    assert st_["refine_sharded"]["param_shard_rows_per_chip"] == 1024 // N_RANKS
    assert st_["refine_sharded"]["route"] == jax_result["stages"]["refine_sharded"]["route"]
    assert st_["frosting_init"]["n_gaussians"] == 1024 and result["mesh"] == "2x2"
    assert np.isfinite(result["eval_psnr"])
    reports = json.loads(str(results[0]["pmc_reports"]))
    assert [rep["rank"] for rep in reports] == list(range(N_RANKS))
    for rep in reports:
        assert rep["digests"] == reports[0]["digests"]
        assert set(rep["stages"]) == {"scene", "gs_sharded", "sugar_sharded", "shell",
                                      "frosting_init", "refine_sharded", "eval"}
        assert rep["stages"]["gs_sharded"]["steps"] == 3
        assert ("first_step" in rep["stages"]["gs_sharded"]) == (rep["rank"] == 0)
        assert rep["stages"]["shell"]["collectives"]["broadcast_calls"] == 2
    held = reports[0]["stages"]["gs_sharded"]["first_step"]
    assert held["ok"] and held["update_cosine"] > 0.999, held
    assert all(json.loads(str(r["pmc_result"])) is None for r in results[1:])
