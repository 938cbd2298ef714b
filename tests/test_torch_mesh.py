"""The port's mesh ops (frosting_tpu_torch.ops.mesh) and z-buffer mesh
rasterizer (ops.mesh_raster) against the JAX package's, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frosting_tpu.cameras import look_at_camera as jax_look_at
from frosting_tpu.ops import mesh as jax_mesh
from frosting_tpu.ops import mesh_raster as jax_raster
from frosting_tpu.raster import RasterConfig as JaxRasterConfig
from frosting_tpu_torch.cameras import look_at_camera
from frosting_tpu_torch.ops import mesh as mesh_ops
from frosting_tpu_torch.ops import mesh_raster
from frosting_tpu_torch.raster import RasterConfig
from tests.test_mesh import icosphere


def _mesh(subdiv=2, seed=0):
    v, f = icosphere(subdiv)
    rng = np.random.default_rng(seed)
    return (v * rng.uniform(0.9, 1.1, (len(v), 1))).astype(np.float32), f


@pytest.mark.parametrize("name", ["face_normals", "face_areas", "vertex_normals"])
def test_mesh_tensor_ops_match_jax(name):
    v, f = _mesh()
    want = np.asarray(getattr(jax_mesh, name)(jnp.asarray(v), jnp.asarray(f)))
    got = getattr(mesh_ops, name)(torch.from_numpy(v), torch.from_numpy(f)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_mesh_losses_topology_and_interpolation_match_jax():
    v, f = _mesh()
    edges = mesh_ops.edges_from_faces(f)
    pairs = mesh_ops.adjacent_face_pairs(f)
    np.testing.assert_array_equal(edges, jax_mesh.edges_from_faces(f))
    np.testing.assert_array_equal(pairs, jax_mesh.adjacent_face_pairs(f))
    vt, ft = torch.from_numpy(v), torch.from_numpy(f)
    np.testing.assert_allclose(
        float(mesh_ops.laplacian_smoothing_loss(vt, torch.from_numpy(edges))),
        float(jax_mesh.laplacian_smoothing_loss(jnp.asarray(v), jnp.asarray(edges))),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        float(mesh_ops.normal_consistency_loss(vt, ft, torch.from_numpy(pairs))),
        float(jax_mesh.normal_consistency_loss(jnp.asarray(v), jnp.asarray(f),
                                               jnp.asarray(pairs))),
        rtol=1e-6, atol=1e-6)
    rng = np.random.default_rng(1)
    vals = rng.normal(size=(len(v), 4)).astype(np.float32)
    fidx = rng.integers(0, len(f), (7, 5))
    bary = rng.dirichlet(np.ones(3), (7, 5)).astype(np.float32)
    want = jax_mesh.barycentric_interpolate(jnp.asarray(vals), jnp.asarray(f),
                                            jnp.asarray(fidx), jnp.asarray(bary))
    got = mesh_ops.barycentric_interpolate(torch.from_numpy(vals), ft,
                                           torch.from_numpy(fidx), torch.from_numpy(bary))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def _rasterize_both(v, f, w, h, eye):
    jcfg = JaxRasterConfig(width=w, height=h, chunk=32, max_instances=1 << 14, backend="jax")
    jfr = jax_raster.rasterize_mesh(jnp.asarray(v), jnp.asarray(f),
                                    jax_look_at(eye=eye, target=[0, 0, 0]), jcfg)
    cfg = RasterConfig(width=w, height=h, chunk=32, max_instances=1 << 14)
    fr = mesh_raster.rasterize_mesh(torch.from_numpy(v), torch.from_numpy(f),
                                    look_at_camera(eye=eye, target=[0, 0, 0], device="cpu"), cfg)
    return jfr, fr


def test_rasterize_mesh_matches_jax_at_an_odd_size():
    """72x40 (partial tiles on both axes): pix_to_face equal on all but
    <= 0.1% of the pixels, zbuf and bary to 1e-5 where the faces agree."""
    v, f = _mesh(3)
    jfr, fr = _rasterize_both(v, f, 72, 40, [0.3, -0.2, -2.5])
    jpf, pf = np.asarray(jfr.pix_to_face), fr.pix_to_face.numpy()
    assert pf.shape == (40, 72) and fr.zbuf.shape == (40, 72) and fr.bary.shape == (40, 72, 3)
    assert (jpf != pf).mean() <= 1e-3
    both = (jpf == pf) & (pf >= 0)
    assert both.mean() > 0.3
    np.testing.assert_allclose(fr.zbuf.numpy()[both], np.asarray(jfr.zbuf)[both],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fr.bary.numpy()[both], np.asarray(jfr.bary)[both],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.isinf(fr.zbuf.numpy()), pf < 0)


@pytest.mark.parametrize("order", ["a-first", "b-first"])
def test_rasterize_mesh_ties_go_to_the_lower_face_id(order):
    """Two coincident faces (equal depth at every pixel): the lower face id
    wins everywhere, whichever triangle it is, as in JAX."""
    tri = np.array([[-0.8, -0.6, 0.0], [0.9, -0.5, 0.0], [0.1, 0.8, 0.0]], np.float32)
    v = np.concatenate([tri, tri])
    f = np.array([[0, 1, 2], [3, 4, 5]] if order == "a-first" else [[3, 4, 5], [0, 1, 2]])
    jfr, fr = _rasterize_both(v, f, 72, 40, [0.0, 0.0, -2.0])
    pf = fr.pix_to_face.numpy()
    assert (pf == 0).sum() > 100 and not (pf == 1).any()
    np.testing.assert_array_equal(pf, np.asarray(jfr.pix_to_face))
