"""The port's six-stage pipeline (frosting_tpu_torch.pipeline.run_pipeline)
and its stage cache on the CPU. One run, made once for the module and
shared: stages 1-5 fresh at the --tiny preset's widths with the depth cut
(3DGS 10, SuGaR 108-118 through the entropy phase, the hard prune and the
sdf phase, refinement 3 iterations; stage 3 at 7 ray samples a pixel, not
21, and Poisson 16^3 to 1000 vertices: its CPU query KNN is most of the
run's time) on a 64x64, 8-view scene with one view held out. Then

- the result's keys, against the keys JAX's run_pipeline sets (read from
  its source: JAX's pipeline is not run here);
- the compaction against numpy's mask indexing;
- the cache files in JAX's names and keys: sugar_params.npz read by np.load
  under JAX's GaussianParams field names, shell.npz's verts / faces /
  poisson_res, frosting_init.npz read by JAX's checkpoint.load_frosting;
- a rerun from the cache: the three resume log lines, no history of the
  skipped stages, and refined params bitwise equal to the first run's;
- a cache written by the JAX package's code (its GaussianParams fields, its
  shell.npz keys, its checkpoint.save_frosting) resumed by the port: the
  same refined params bitwise;
- the CLI's writer (cli.write_outputs, --eval --export-obj) on the first
  run: every file read back by the port's loaders, shell.ply byte for byte
  what the JAX package's PLY writer writes for the same arrays, and
  metrics.json equal to what the writer returns."""

import ast
import dataclasses
import inspect
import json
import os

import numpy as np
import pytest
import torch

from frosting_tpu import pipeline as jax_pipeline
from frosting_tpu.scene.gaussians import GaussianParams as JaxGaussianParams
from frosting_tpu.train import checkpoint as jax_checkpoint
from frosting_tpu.utils import ply as jax_ply
from frosting_tpu_torch import cli, pipeline
from frosting_tpu_torch.scene import gaussians as gauss_lib
from frosting_tpu_torch.train import checkpoint, frosting_trainer

from test_torch_stages_cli import _write_scene

torch.set_num_threads(1)  # as every port test file: workers share the cores

RESUMED = ["=== stages 1-2: resumed from cache ===", "=== stage 3: resumed from cache ===",
           "=== stage 4: resumed from cache ===", "=== stage 5: frosting refinement ==="]


def _jax_result_keys():
    """The keys run_pipeline's JAX source assigns in `out[...] = ...`."""
    tree = ast.parse(inspect.getsource(jax_pipeline.run_pipeline))
    return {n.slice.value for n in ast.walk(tree)
            if isinstance(n, ast.Subscript) and isinstance(n.ctx, ast.Store)
            and isinstance(n.value, ast.Name) and n.value.id == "out"}


POISSON = 16


def _config(args, extent):
    cfg = cli.build_config(args, extent)
    return dataclasses.replace(
        cfg,
        gs=dataclasses.replace(cfg.gs, iterations=10, log_every=5),
        sugar=dataclasses.replace(cfg.sugar, start_iteration=108, iterations=118, log_every=5),
        shell=dataclasses.replace(cfg.shell, poisson_resolution=POISSON, target_vertices=1000,
                                  n_ray_samples=7),
        refine=dataclasses.replace(cfg.refine, iterations=3, lr_max_steps=3, log_every=3))


def _run(scene, cams, gt, rcfg, cfg, cache_dir):
    logs = []
    out = pipeline.run_pipeline(cams, gt, scene.points, scene.colors, scene.spatial_extent,
                                rcfg, cfg, cache_dir=cache_dir, device="cpu",
                                log_fn=logs.append)
    return out, [line for line in logs if line.startswith("===")]


def _assert_groups_equal(a, b):
    ga, gb = frosting_trainer.param_groups(a), frosting_trainer.param_groups(b)
    assert ga.keys() == gb.keys()
    for k in ga:
        assert torch.equal(ga[k], gb[k]), k


@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    """One fresh run with a cache: the tmp dir, the parsed CLI flags, the
    scene's (scene, cams, gt, rcfg, out_dir), config, cache dir, result
    and stage log lines."""
    tmp = tmp_path_factory.mktemp("pipeline")
    scene_dir = _write_scene(str(tmp / "scene"))
    args = cli.build_parser().parse_args(
        ["-s", scene_dir, "-o", str(tmp / "output"), "--tiny", "--eval", "--export-obj",
         "--device", "cpu"])
    loaded = cli.load_scene(args)
    scene, cams, gt, rcfg, _out_dir = loaded
    cfg = _config(args, scene.spatial_extent)
    cache = str(tmp / "cache")
    out, logs = _run(scene, cams, gt, rcfg, cfg, cache)
    return {"tmp": tmp, "args": args, "loaded": loaded, "cfg": cfg, "cache": cache,
            "out": out, "logs": logs}


def test_fresh_run_runs_every_stage_and_sets_jax_result_keys(fresh):
    scene, cams = fresh["loaded"][:2]
    out = fresh["out"]
    assert len(cams) == 7 and len(scene.test_cameras) == 1
    # refined SuGaR (stage 3b) is off
    assert fresh["logs"] == [
        "=== stage 1: vanilla 3DGS ===", "=== stage 2: coarse SuGaR ===",
        "=== stage 3: shell extraction ===", "=== stage 4: frosting init ===",
        "=== stage 5: frosting refinement ==="]
    assert set(out) == {k for k in _jax_result_keys() if not k.startswith("refined_sugar")}
    assert [h["iter"] for h in out["sugar_history"]] == [110, 115, 118]
    assert out["sugar_history"][-1]["n_active"] < 400  # the prune at 115 ran
    assert len(out["shell_verts"]) <= 1000 and out["shell_poisson_resolutions"] == [POISSON]
    fparams = out["frosting_params"]
    assert fparams.bary_logits.shape[0] == 4096
    assert all(torch.isfinite(v).all() for v in frosting_trainer.param_groups(fparams).values())


def test_compaction_is_numpy_mask_indexing(fresh):
    sugar = fresh["out"]["sugar_params"]
    mask = sugar.mask.numpy() > 0.5
    assert 0 < mask.sum() < len(mask)
    live = pipeline.compact(sugar)
    for f in dataclasses.fields(sugar):
        np.testing.assert_array_equal(getattr(live, f.name).numpy(),
                                      getattr(sugar, f.name).numpy()[mask])


def test_cache_files_have_jax_names_and_keys(fresh):
    out, cache = fresh["out"], fresh["cache"]
    sugar = out["sugar_params"]
    with np.load(os.path.join(cache, "sugar_params.npz")) as z:
        assert set(z.files) == {f.name for f in dataclasses.fields(JaxGaussianParams)}
        for f in dataclasses.fields(sugar):
            np.testing.assert_array_equal(z[f.name], getattr(sugar, f.name).numpy())
    with np.load(os.path.join(cache, "shell.npz")) as z:
        assert set(z.files) == {"verts", "faces", "poisson_res"}
        np.testing.assert_array_equal(z["verts"], out["shell_verts"])
        np.testing.assert_array_equal(z["faces"], out["shell_faces"])
        assert z["poisson_res"].tolist() == [POISSON] and z["poisson_res"].dtype == np.int64
    jparams, jmeta = jax_checkpoint.load_frosting(os.path.join(cache, "frosting_init.npz"))
    init, init_meta = checkpoint.load_frosting(os.path.join(cache, "frosting_init.npz"),
                                               device="cpu")
    for f in dataclasses.fields(init):
        if f.name != "bg":
            np.testing.assert_array_equal(np.asarray(getattr(jparams, f.name)),
                                          getattr(init, f.name).numpy())
    assert jparams.bg is None and init.bg is None
    np.testing.assert_array_equal(np.asarray(jmeta.faces), init_meta.faces.numpy())
    np.testing.assert_array_equal(np.asarray(jmeta.cell_idx), init_meta.cell_idx.numpy())
    np.testing.assert_array_equal(np.asarray(jmeta.cell_bounds), init_meta.cell_bounds.numpy())


def test_cli_writer_outputs_read_back(fresh):
    tmp_path, args, out = fresh["tmp"], fresh["args"], fresh["out"]
    scene, cams, _gt, rcfg, out_dir = fresh["loaded"]
    fparams = out["frosting_params"]
    res = cli.write_outputs(args, out, scene, cams, rcfg, out_dir)
    assert out_dir == os.path.join(str(tmp_path / "output"), "scene")
    assert sorted(os.listdir(out_dir)) == [
        "frosting.npz", "frosting.ply", "gs.ply", "mesh.mtl", "mesh.obj", "mesh.png",
        "metrics.json", "shell.ply", "sugar.ply"]
    back = gauss_lib.load_ply(os.path.join(out_dir, "gs.ply"), device="cpu")
    assert back.capacity == int(out["gs_state"].params.num_active())
    back = gauss_lib.load_ply(os.path.join(out_dir, "sugar.ply"), device="cpu")
    assert back.capacity == int((out["sugar_params"].mask > 0.5).sum())
    v = out["shell_verts"]
    jax_ply.write_ply(str(tmp_path / "shell_jax.ply"), {"x": v[:, 0], "y": v[:, 1], "z": v[:, 2]},
                      faces=out["shell_faces"])
    assert (tmp_path / "shell_jax.ply").read_bytes() == open(
        os.path.join(out_dir, "shell.ply"), "rb").read()
    loaded, _ = checkpoint.load_frosting(os.path.join(out_dir, "frosting.npz"), device="cpu")
    _assert_groups_equal(loaded, fparams)
    frosting_ply = jax_ply.read_ply(os.path.join(out_dir, "frosting.ply"))["vertex"]
    assert len(frosting_ply["x"]) == 4096
    obj = open(os.path.join(out_dir, "mesh.obj")).read().splitlines()
    assert obj[0] == "mtllib mesh.mtl"
    assert sum(line.startswith("f ") for line in obj) == len(out["shell_faces"])
    with open(os.path.join(out_dir, "metrics.json")) as fh:
        assert json.load(fh) == res
    assert res["n_views"] == 1 and res["lpips"] is None
    assert np.isfinite(res["psnr"]) and 0 < res["ssim"] <= 1


def test_rerun_resumes_from_its_cache_bitwise(fresh):
    scene, cams, gt, rcfg, _out_dir = fresh["loaded"]
    out = fresh["out"]
    again, logs = _run(scene, cams, gt, rcfg, fresh["cfg"], fresh["cache"])
    assert logs == RESUMED
    assert not {"gs_state", "gs_history", "sugar_history"} & set(again)
    _assert_groups_equal(again["frosting_params"], out["frosting_params"])
    np.testing.assert_array_equal(again["shell_faces"], out["shell_faces"])


def test_a_jax_written_cache_resumes_bitwise(fresh):
    scene, cams, gt, rcfg, _out_dir = fresh["loaded"]
    out, sugar = fresh["out"], fresh["out"]["sugar_params"]
    jcache = fresh["tmp"] / "jax_cache"
    jcache.mkdir()
    jsugar = JaxGaussianParams(**{f.name: getattr(sugar, f.name).numpy()
                                  for f in dataclasses.fields(sugar)})
    np.savez(jcache / "sugar_params.npz", **{f.name: np.asarray(getattr(jsugar, f.name))
                                             for f in dataclasses.fields(jsugar)})
    np.savez(jcache / "shell.npz", verts=np.asarray(out["shell_verts"]),
             faces=np.asarray(out["shell_faces"]), poisson_res=np.asarray([POISSON], np.int64))
    jparams, jmeta = jax_checkpoint.load_frosting(
        os.path.join(fresh["cache"], "frosting_init.npz"))
    jax_checkpoint.save_frosting(str(jcache / "frosting_init.npz"), jparams, jmeta)
    from_jax, logs = _run(scene, cams, gt, rcfg, fresh["cfg"], str(jcache))
    assert logs == RESUMED
    _assert_groups_equal(from_jax["frosting_params"], out["frosting_params"])
