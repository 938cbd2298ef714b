"""Stage 3 (frosting_tpu_torch.extract.shell) against the JAX package's on
the CPU: the density and its gradient, the depth render and a camera's
level points, the whole extract_shell for each method, and the
extract-shell command on a scene on disk.

The whole extraction is compared statistically (vertex count, symmetric
Chamfer distance, median radius), not vertex by vertex: the port's inputs
to the QEM decimator differ from JAX's in the last float32 bits (another
summation order in the density, the FFT), and QEM may then order its
collapses differently, which moves vertices by up to a cell while the
surface stays where it is. The JAX reference of each method is computed
once per module."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from frosting_tpu.extract import shell as jax_shell
from frosting_tpu.models import fields as jax_fields
from frosting_tpu.ops import mesh_raster as jax_mesh_raster
from frosting_tpu.raster import RasterConfig as JaxRasterConfig
from frosting_tpu.scene import synthetic as jax_synthetic
from frosting_tpu_torch import stages_cli
from frosting_tpu_torch.extract import shell
from frosting_tpu_torch.models import fields
from frosting_tpu_torch.raster import RasterConfig
from frosting_tpu_torch.scene import gaussians as gauss_lib
from frosting_tpu_torch.scene import synthetic
from tests.test_torch_mesh import JAX_RASTERIZE_JIT

W, H, N_CAMS = 64, 48, 3
POISSON_RES = 40


def _sphere(n=2000, seed=2, scale=0.06):
    """Gaussians of one scale and opacity 0.9 on the unit sphere."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    return (d.astype(np.float32), np.full((n, 3), scale, np.float32), quats,
            np.full((n,), 0.9, np.float32))


def _cfg(method, **kw):
    return dict(surface_level=0.3, poisson_resolution=POISSON_RES, target_vertices=3000,
                knn_k=8, method=method, marching_resolution=40, **kw)


def _both(arrays):
    return (tuple(jnp.asarray(a) for a in arrays),
            tuple(torch.from_numpy(a) for a in arrays))


def _rcfgs():
    return (JaxRasterConfig(width=W, height=H, chunk=32, max_instances=16384, backend="jax"),
            RasterConfig(width=W, height=H, chunk=32, max_instances=16384))


def _cams():
    return (jax_synthetic.camera_ring(n_cams=N_CAMS, radius=3.5),
            synthetic.camera_ring(n_cams=N_CAMS, radius=3.5, device="cpu"))


# visibility culling in the surface run; the other two keep the largest
# component (the JAX mesh rasterizer compiles anew for every face count)
CONFIGS = {
    "surface": _cfg("surface"),
    "centers": _cfg("centers", visibility_threshold=None),
    "marching": _cfg("marching", visibility_threshold=None),
}


@pytest.fixture(scope="module")
def jax_reference():
    """{method: (verts, faces, aux)} of the JAX extract_shell, computed on
    first use (its mesh rasterizer jitted: tests/test_torch_mesh.py)."""
    cache = {}

    def get(method):
        if method not in cache:
            (jg, _tg), (jrcfg, _r), (jcams, _c) = _both(_sphere()), _rcfgs(), _cams()
            # its visibility culling reads only pix_to_face: the jitted rasterizer
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jax_mesh_raster, "rasterize_mesh", JAX_RASTERIZE_JIT)
                cache[method] = jax_shell.extract_shell(
                    *jg, jcams, jrcfg, jax_shell.ShellConfig(**CONFIGS[method]))
        return cache[method]

    return get


def _random_gaussians(n=1500, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    scales = np.exp(rng.uniform(np.log(0.03), np.log(0.15), (n, 3))).astype(np.float32)
    q = rng.normal(size=(n, 4))
    quats = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    opac = rng.uniform(0.1, 1.0, n).astype(np.float32)
    return means, scales, quats, opac


def test_density_and_gradient_match_jax_value_and_grad():
    """density_and_grad on given neighbour sets against jax.value_and_grad of
    field_values' density (beta "average", density factor 1), to 1e-5 of the
    largest magnitude; and eval_density_blocks, whose radius-bounded KNN
    the JAX sweep's exact one (<= 16384 refs) must agree with."""
    g = _random_gaussians()
    rng = np.random.default_rng(1)
    pts = (g[0][rng.integers(0, len(g[0]), 2000)]
           + rng.normal(0, 0.05, (2000, 3))).astype(np.float32)
    pts[:100] = rng.uniform(-3, 3, (100, 3))  # some far from every Gaussian
    jg, tg = _both(g)
    knn_idx = np.array(jax_shell.knn_lib.knn_query(jnp.asarray(pts), jg[0], k=8)[0])

    def density_at(p, idx):
        return jax_fields.field_values(p[None], idx[None], jg[0], jg[3], jg[1], jg[2],
                                       beta_mode="average", density_factor=1.0).density[0]

    import jax
    # jitted: one compile, not one per op of the eager vmap
    want_d, want_g = jax.jit(jax.vmap(jax.value_and_grad(density_at)))(
        jnp.asarray(pts), jnp.asarray(knn_idx))
    want_d, want_g = np.asarray(want_d), np.asarray(want_g)
    d, gr = fields.density_and_grad(torch.from_numpy(pts), torch.from_numpy(knn_idx),
                                    tg[0], tg[3], tg[1], tg[2])
    np.testing.assert_allclose(d.numpy(), want_d, rtol=0, atol=1e-5 * np.abs(want_d).max())
    np.testing.assert_allclose(gr.numpy(), want_g, rtol=0, atol=1e-5 * np.abs(want_g).max())
    fv = fields.field_values(torch.from_numpy(pts), torch.from_numpy(knn_idx), tg[0], tg[3],
                             tg[1], tg[2], beta_mode="average")
    assert torch.equal(fv.density, d)

    want_d, want_g = jax_shell.eval_density_blocks(*jg, pts, k=8, block=512)
    d, gr = shell.eval_density_blocks(*tg, torch.from_numpy(pts), 8, block=512)
    np.testing.assert_allclose(d.numpy(), want_d, rtol=0, atol=1e-5 * np.abs(want_d).max())
    np.testing.assert_allclose(gr.numpy(), want_g, rtol=0, atol=1e-5 * np.abs(want_g).max())


@pytest.mark.parametrize("method", ["surface", "centers", "marching"])
def test_extract_shell_matches_jax(jax_reference, method):
    """Vertex count within 2%, symmetric Chamfer distance at most half a
    Poisson (or marching) cell, median radius within 1% of JAX's."""
    jv, jf, jaux = jax_reference(method)
    (_jg, tg), (_j, rcfg), (_c, cams) = _both(_sphere()), _rcfgs(), _cams()
    v, f, aux = shell.extract_shell(*tg, cams, rcfg, shell.ShellConfig(**CONFIGS[method]))
    assert v.dtype == np.float64 and f.dtype == np.int64 and len(jv) > 500
    assert abs(len(v) - len(jv)) <= 0.02 * len(jv)
    chamfer = (cKDTree(jv).query(v)[0].mean() + cKDTree(v).query(jv)[0].mean()) / 2
    cell = 2.6 / (POISSON_RES - 1)  # the cloud's span (~2) padded by 15% a side
    assert chamfer <= cell / 2, chamfer
    r, jr = np.median(np.linalg.norm(v, axis=1)), np.median(np.linalg.norm(jv, axis=1))
    assert abs(r - jr) <= 0.01 * jr
    assert set(aux["timings_ms"]) >= {"QEM decimation", "query KNN", "density + gradient"}
    if method != "marching":
        np.testing.assert_allclose(aux["surface_points"], jaux["surface_points"],
                                   rtol=1e-5, atol=1e-5)


def test_depth_render_and_level_points_match_jax():
    """render_depth and level_points_from_camera for one camera: maps and
    points to 1e-5; valid (covered, above the level) equal on all but a
    few pixels on the level. (After the surface extraction, whose JAX
    compile of level_points_from_camera it reuses.)"""
    (jg, tg), (jrcfg, rcfg), (jcams, cams) = _both(_sphere()), _rcfgs(), _cams()
    cfg = shell.ShellConfig(**CONFIGS["surface"])
    jcfg = jax_shell.ShellConfig(**CONFIGS["surface"])
    sh = np.zeros((len(jg[0]), 1, 3), np.float32)
    want = jax_shell.render_depth(*jg, jnp.asarray(sh), jcams[1], jrcfg)
    got = shell.render_depth(*tg, torch.from_numpy(sh), cams[1], rcfg)
    acc = np.asarray(want[2])
    for a, b in zip(got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy()[acc > 0.5], b[acc > 0.5], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), acc, rtol=0, atol=1e-5)

    want = [np.asarray(x) for x in jax_shell.level_points_from_camera(
        *jg, jcams[1], jrcfg, jcfg)]
    got = [x.numpy() for x in shell.level_points_from_camera(*tg, cams[1], rcfg, cfg)]
    valid = want[3] & got[3]
    assert valid.sum() > 500 and (want[3] != got[3]).sum() <= 3
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_allclose(a[valid], b[valid], rtol=1e-5, atol=1e-5)


def test_extract_shell_command_on_the_cpu(tmp_path):
    """extract-shell --device cpu over a scene on disk writes shell.ply and,
    with --both-poly, shell_lowpoly.ply, which load back; without --device
    cpu, on a machine with no CUDA device, the command raises."""
    means, scales, quats, opac = _sphere(n=1200)
    sh = np.zeros((len(means), 16, 3), np.float32)
    model = tuple(torch.from_numpy(a) for a in (means, scales, quats, opac, sh))
    cams = synthetic.camera_ring(n_cams=N_CAMS, radius=3.5, device="cpu")
    scene = str(tmp_path / "scene")
    synthetic.write_colmap_scene(scene, model, cams, _rcfgs()[1])
    out = tmp_path / "out"
    out.mkdir()
    raw = {"means3d": means, "sh_dc": sh[:, :1], "sh_rest": sh[:, 1:],
           "scales_log": np.log(scales), "quats_raw": quats,
           "opacities_raw": np.log(opac / (1 - opac)), "mask": np.ones(len(means), np.float32)}
    gauss_lib.save_ply(gauss_lib.params_from_numpy(raw, device="cpu"), str(out / "sugar.ply"))
    argv = ["extract-shell", "-s", scene, "-o", str(out), "--max-instances", "16384",
            "--chunk", "32", "--poisson-resolution", "32", "--both-poly"]
    res = stages_cli.main(argv + ["--device", "cpu"])
    v, f = stages_cli.load_mesh(os.path.join(out, "shell.ply"))
    lv, lf = stages_cli.load_mesh(os.path.join(out, "shell_lowpoly.ply"))
    assert (len(v), len(lv)) == (res["verts"], res["verts_low"]) and len(f) > 500
    assert np.isfinite(v).all() and f.max() < len(v) and lf.max() < len(lv)
    assert 0.9 < np.median(np.linalg.norm(v, axis=1)) < 1.2
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            stages_cli.main(argv)
