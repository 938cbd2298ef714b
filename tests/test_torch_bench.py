"""The port's measurement entry points (frosting_tpu_torch/bench/) on the
CPU: their scene is bench.py's, their fwd+bwd step takes the gradient
bench.py takes, they refuse to measure without a card, and bench_1080p
writes no file.

The opacity gradient of a bench step is held against ``jax.grad`` of the
same loss through the JAX package's render (pure-JAX backend,
``bwd_sort_bf16=False``), normalised by its largest magnitude, at atol 5e-4
(tests/test_torch_render_grad.py's tolerance).
"""

import ast
import dataclasses
import hashlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frosting_tpu.cameras import look_at_camera as jax_look_at
from frosting_tpu.raster import render as jax_render
from frosting_tpu_torch.bench import __main__ as bench_main
from frosting_tpu_torch.bench import bench_1080p, perf_scan_variants, perf_vpu_dtype
from frosting_tpu_torch.bench.common import bench_scene, opacity_grad
from frosting_tpu_torch.cameras import look_at_camera
from tests.test_torch_render import configs

ROOT = Path(__file__).resolve().parents[1]


def _scene_draws(script, n):
    """Run the statements of `script`'s main() from its rng to its last
    draw (`sh[:, 0] = ...`), with n set to n: the script's own draws."""
    tree = ast.parse((ROOT / script).read_text())
    main = next(f for f in tree.body if isinstance(f, ast.FunctionDef) and f.name == "main")
    body = main.body
    start = next(i for i, st in enumerate(body) if ast.unparse(st).startswith("rng = "))
    end = next(i for i, st in enumerate(body) if ast.unparse(st).startswith("sh[:, 0] = "))
    stmts = [st for st in body[start:end + 1]
             if not (isinstance(st, ast.Assign) and ast.unparse(st.targets[0]) == "n")]
    scope = {"np": np, "n": n}
    exec(compile(ast.Module(stmts, []), script, "exec"), scope)
    return [scope[k] for k in ("means", "scales", "quats", "opac", "sh")]


@pytest.mark.parametrize("script,args", [
    ("bench.py", (0, -0.7, 0.7, 0.008, 0.04)),
    ("scripts/bench_1080p.py", (0, -0.9, 0.9, 0.003, 0.015)),
])
def test_bench_scene_is_the_scripts_scene(script, args):
    n = 1000
    ref = _scene_draws(script, n)
    got = bench_scene(n, *args)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


def test_bench_step_opacity_gradient_matches_jax():
    """One fwd+bwd iteration at 64x48 @ 500 (iteration 3, salt 0.017), the
    JAX side perturbed as bench.py's loop body does."""
    arrays = bench_scene(500, 0, -0.7, 0.7, 0.008, 0.04)
    jcfg, tcfg = configs(64, 48, chunk=128, max_instances=1 << 14)
    jcfg = dataclasses.replace(jcfg, bwd_sort_bf16=False)
    i, salt = 3, 0.017
    jcam = jax_look_at(eye=[0.0, 0.0, -3.0], target=[0.0, 0.0, 0.0])
    tcam = look_at_camera(eye=[0.0, 0.0, -3.0], target=[0.0, 0.0, 0.0], device="cpu")
    target = np.zeros((3, 48, 64), np.float32)

    gs = tuple(torch.from_numpy(a) for a in arrays)
    got = opacity_grad(gs, tcam, tcfg, torch.from_numpy(target), i, salt).numpy()

    means, scales, quats, opac, sh = (jnp.asarray(a) for a in arrays)
    it = jnp.float32(i)

    def loss(means, opac):
        out = jax_render(means, scales, quats, opac, sh, jcam, jcfg)
        return jnp.mean(jnp.abs(out.image - target))

    @jax.jit
    def grad_opac(means, opac):
        opac_i = jnp.clip(opac + 0.001 * it + salt, 0, 1)
        means_i = means + 1e-5 * it + salt * 1e-3
        return jax.grad(loss, argnums=1)(means_i, opac_i)

    ref = np.asarray(grad_opac(means, opac))
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(got / scale, ref / scale, atol=5e-4)


def test_entry_points_refuse_to_run_without_a_card(capsys):
    assert not torch.cuda.is_available()
    for mod in (bench_main, bench_1080p, perf_vpu_dtype, perf_scan_variants):
        assert mod.main() != 0
        assert "no CUDA device" in capsys.readouterr().err


def test_module_entry_point_exits_nonzero_without_a_card():
    run = subprocess.run([sys.executable, "-m", "frosting_tpu_torch.bench"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert run.returncode != 0
    assert "no CUDA device" in run.stderr and not run.stdout


def test_bench_record_has_bench_py_keys():
    rec = bench_main.run("cpu", n=300, width=64, height=48, iters=2, repeats=1)
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "extra"}
    assert {"fwd_only_mpix_s", "fwd_only_fps", "instances", "max_instances",
            "device"} <= set(rec["extra"])
    assert rec["extra"]["device"] == "cpu" and rec["unit"] == "Mpix/s"
    assert rec["value"] > 0 and rec["vs_baseline"] == rec["value"] / 25.0


def test_bench_1080p_writes_no_file(tmp_path, monkeypatch):
    record = ROOT / "BENCH_1080P.json"
    before = hashlib.sha256(record.read_bytes()).hexdigest()
    monkeypatch.chdir(tmp_path)
    lines = []
    rec = bench_1080p.run("cpu", n=400, width=64, height=48, iters=1,
                          log=lambda *a: lines.append(a))
    assert lines and lines[0][0] == "instances"
    assert {"metric", "value", "unit", "instances", "ms_per_iter", "fwd_only_mpix_s",
            "fwd_only_fps"} <= set(rec)
    assert list(tmp_path.iterdir()) == []
    assert hashlib.sha256(record.read_bytes()).hexdigest() == before
