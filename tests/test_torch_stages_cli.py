"""The port's command line (frosting_tpu_torch.stages_cli) on the CPU: its
scene loading against the JAX package's, then train-gs -> train-sugar
(entropy, photo with the hard prune, sdf) -> render, with --device cpu,
on the sphere of tests/test_cli.py::make_colmap_scene written by the
port's scene.synthetic.write_colmap_scene. Then the commands that close
the pipeline, against the JAX package's: `metrics` on one saved
frosting.npz in both packages (metrics.json within 1e-5), `full-eval`'s
chain of commands (recorded, not run) and `convert`'s colmap command lines
(a fake colmap that records its argv), or its message without colmap."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from frosting_tpu import stages_cli as jax_cli
from frosting_tpu_torch import stages_cli
from frosting_tpu_torch.raster import RasterConfig, render
from frosting_tpu_torch.scene import gaussians as gauss_lib
from frosting_tpu_torch.scene import synthetic
from frosting_tpu_torch.utils import image as image_io


def _write_scene(d, n=400, n_cams=8, size=64):
    """make_colmap_scene's scene: Gaussians of scale 0.06 and opacity 0.9 on
    the unit sphere, coloured by position, seen by a ring of views at r 3.2;
    here the n Gaussians' centres are also the seed points."""
    rng = np.random.default_rng(0)
    dd = rng.normal(size=(n, 3))
    means = torch.from_numpy((dd / np.linalg.norm(dd, axis=1, keepdims=True)).astype(np.float32))
    sh = torch.zeros((n, 16, 3))
    sh[:, 0] = (means + 1.5) / 3.0
    quats = torch.zeros((n, 4))
    quats[:, 0] = 1.0
    model = (means, torch.full((n, 3), 0.06), quats, torch.full((n,), 0.9), sh)
    cams = synthetic.camera_ring(n_cams=n_cams, radius=3.2, device="cpu")
    cfg = RasterConfig(width=size, height=size, chunk=32, max_instances=8192)
    synthetic.write_colmap_scene(d, model, cams, cfg)
    return d


def _common(scene_dir, out):
    return ["-s", scene_dir, "-o", out, "--max-instances", "8192", "--chunk", "32"]


def test_load_scene_then_train_gs_train_sugar_render_on_the_cpu(tmp_path):
    """_load_scene equal to the JAX package's; then the three commands in
    a row, each artifact loading back (render of a frosting model:
    tests/test_torch_frosting_trainer.py)."""
    scene_dir = _write_scene(str(tmp_path / "scene"))
    argv = ["render", *_common(scene_dir, str(tmp_path)), "--eval"]
    scene, cams, gt, rcfg = stages_cli._load_scene(
        stages_cli.build_parser().parse_args(argv + ["--device", "cpu"]))
    jscene, jcams, jgt, jrcfg = jax_cli._load_scene(jax_cli.build_parser().parse_args(argv))
    assert gt.dtype == jgt.dtype and gt.shape == jgt.shape == (7, 3, 64, 64)
    np.testing.assert_array_equal(gt, jgt)
    assert (rcfg.width, rcfg.height, rcfg.chunk, rcfg.max_instances) == (
        jrcfg.width, jrcfg.height, jrcfg.chunk, jrcfg.max_instances)
    for cam, jcam in zip(cams, jcams):
        for f in dataclasses.fields(cam):
            np.testing.assert_allclose(getattr(cam, f.name).numpy(),
                                       np.asarray(getattr(jcam, f.name)), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(scene.points, jscene.points)
    assert scene.spatial_extent == jscene.spatial_extent
    assert [c.image_name for c in scene.test_cameras] == [c.image_name for c in jscene.test_cameras]

    out = str(tmp_path / "out")
    common = [*_common(scene_dir, out), "--device", "cpu"]
    hist = stages_cli.main(["train-gs", *common, "--iterations", "5", "--capacity", "2048"])
    assert [h["iter"] for h in hist] == [5] and np.isfinite(hist[0]["loss"])
    gs_path = os.path.join(out, "gs.ply")
    params = gauss_lib.load_ply(gs_path, device="cpu")
    assert params.capacity == 400  # the scene's seed points

    # give half the Gaussians opacity 0.9, half 0.1: the prune at 9000 keeps
    # the first half
    params.opacities_raw = torch.where(
        torch.arange(400) < 200, torch.logit(torch.tensor(0.9)), torch.logit(torch.tensor(0.1)))
    gauss_lib.save_ply(params, gs_path)
    hist = stages_cli.main(["train-sugar", *common, "-r", "dn_consistency",
                            "--start-iteration", "8999", "--iterations", "9001",
                            "--capacity", "2048"])
    assert [(h["iter"], h["phase"]) for h in hist] == [(9000, "photo"), (9001, "sdf")]
    assert all(np.isfinite(h["loss"]) and h["n_active"] == 200 for h in hist)
    sugar = gauss_lib.load_ply(os.path.join(out, "sugar.ply"), device="cpu")
    assert sugar.capacity == 200 and torch.isfinite(sugar.means3d).all()

    stages_cli.main(["render", *common])
    names = sorted(os.listdir(os.path.join(out, "renders")))
    assert names == [f"train_{i:05d}.png" for i in range(8)]
    scene, cams, _gt, rcfg = stages_cli._load_scene(
        stages_cli.build_parser().parse_args(["render", *common]))
    model = gauss_lib.activate(stages_cli.load_live_gaussians(gs_path, device="cpu"))
    with torch.inference_mode():
        img = np.clip(render(*model, cams[3], rcfg).image.numpy(), 0, 1)
    got, mode = image_io.read_image(os.path.join(out, "renders", "train_00003.png"))
    assert mode == "RGB"
    np.testing.assert_array_equal(got, (img.transpose(1, 2, 0) * 255).astype(np.uint8))


def _write_frosting(path, n=3000, seed=0):
    """A frosting.npz (JAX's keys) around the scene's unit sphere: n
    Gaussians in sorted random cells, coloured by position."""
    rng = np.random.default_rng(seed)
    verts, faces = synthetic.uv_sphere(12, 24)
    cell = np.sort(rng.integers(0, len(faces), n)).astype(np.int32)
    centre = verts[faces[cell]].mean(axis=1)
    sh_dc = ((centre + 1.5) / 3.0 - 0.5) / 0.28209479177387814
    np.savez(
        path,
        shell_verts=verts, inner_dist=np.full(len(verts), -0.04, np.float32),
        outer_dist=np.full(len(verts), 0.04, np.float32),
        bary_logits=rng.normal(0, 1, (n, 6)).astype(np.float32),
        scales_log=np.full((n, 3), np.log(0.05), np.float32),
        quats_raw=rng.normal(size=(n, 4)).astype(np.float32),
        opacities_raw=np.full(n, 2.0, np.float32),
        sh_dc=sh_dc[:, None].astype(np.float32), sh_rest=np.zeros((n, 15, 3), np.float32),
        meta_faces=faces, meta_cell_idx=cell,
        meta_cell_bounds=np.searchsorted(cell, np.arange(len(faces) + 1)).astype(np.int32))


def test_metrics_command_matches_jax(tmp_path, monkeypatch):
    """metrics on a saved frosting.npz, rendered on the held-out view, in
    both packages: metrics.json within 1e-5 (the render's parity)."""
    monkeypatch.delenv("FROSTING_TPU_LPIPS_WEIGHTS", raising=False)
    scene_dir = _write_scene(str(tmp_path / "scene"))
    outs = {}
    for name in ("port", "jax"):
        out = tmp_path / name
        out.mkdir()
        _write_frosting(out / "frosting.npz")
        argv = ["metrics", *_common(scene_dir, str(out)), "--eval"]
        if name == "port":
            res = stages_cli.main(argv + ["--device", "cpu"])
        else:
            jax_cli.main(argv)
        with open(out / "metrics.json") as fh:
            outs[name] = json.load(fh)
    assert outs["port"] == res and res["n_views"] == 1 and res["lpips"] is None
    assert outs["port"].keys() == outs["jax"].keys()
    for k in ("psnr", "ssim"):
        assert abs(outs["port"][k] - outs["jax"][k]) <= 1e-5, (k, outs)
    assert 10.0 < res["psnr"] < 60.0


FULL_EVAL_FLAGS = {
    "defaults": [],
    "every-flag": ["--eval", "--white-bg", "--resolution-scale", "2", "--iterations", "300",
                   "--capacity", "4096", "-r", "sdf", "--low-poly", "--fg-split",
                   "--gaussians", "5000", "--use-background", "--occlusion-culling"],
}


@pytest.mark.parametrize("case", FULL_EVAL_FLAGS)
def test_full_eval_runs_the_jax_chain_of_commands(case, monkeypatch):
    """full-eval calls the same commands with the same argv as JAX's, each
    also given the port's --device."""
    calls = {"port": [], "jax": []}
    monkeypatch.setattr(stages_cli, "main", lambda argv: calls["port"].append(list(argv)))
    monkeypatch.setattr(jax_cli, "main", lambda argv: calls["jax"].append(list(argv)))
    argv = ["full-eval", "-s", "SCENE", "-o", "OUT", *FULL_EVAL_FLAGS[case]]
    args = stages_cli.build_parser().parse_args(argv + ["--device", "cpu"])
    args.fn(args)
    jargs = jax_cli.build_parser().parse_args(argv)
    jargs.fn(jargs)
    assert [c[0] for c in calls["jax"]] == [
        "train-gs", "train-sugar", "extract-shell", "train-frosting", "metrics"]
    assert len(calls["port"]) == len(calls["jax"])
    for got, want in zip(calls["port"], calls["jax"]):
        i = got.index("--device")
        assert got[i + 1] == "cpu" and got[:i] + got[i + 2:] == want
        stages_cli.build_parser().parse_args(got)  # every argv parses


def test_convert_runs_the_jax_colmap_commands(tmp_path, monkeypatch):
    """Without colmap on PATH both exit with the same message; with a fake
    colmap that records its argv, both run the same three command lines."""
    raw = tmp_path / "raw"
    (raw / "input").mkdir(parents=True)
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    exits = []
    for mod in (stages_cli, jax_cli):
        with pytest.raises(SystemExit) as e:
            mod.main(["convert", "-s", str(raw)])
        exits.append(e.value.code)
    assert exits[0] == exits[1] and "colmap" in exits[0]

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    fake = bin_dir / "colmap"
    fake.write_text('#!/bin/sh\necho "$@" >> "$COLMAP_LOG"\n')
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bin_dir}:/usr/bin:/bin")
    logs = []
    for name, mod in (("port", stages_cli), ("jax", jax_cli)):
        monkeypatch.setenv("COLMAP_LOG", str(tmp_path / f"{name}.log"))
        mod.main(["convert", "-s", str(raw)])
        logs.append((tmp_path / f"{name}.log").read_text().splitlines())
    assert logs[0] == logs[1] and [line.split()[0] for line in logs[0]] == [
        "feature_extractor", "exhaustive_matcher", "mapper"]
    assert (raw / "distorted").is_dir()
