"""The port's mesh ops (frosting_tpu_torch.ops.mesh) and z-buffer mesh
rasterizer (ops.mesh_raster) against the JAX package's, on the CPU."""

import jax
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

# JAX's mesh rasterizer jitted: one compile per configuration in place of
# the eager run's per-op compiles (~5x faster on the CPU). Its pix_to_face
# is the eager run's; its zbuf and barycentrics may differ in the last bits
# (XLA fuses the jitted arithmetic), so the tests that compare those with
# the port call the eager function, and those that read only which faces a
# camera sees (visibility culling) may call this.
JAX_RASTERIZE_JIT = jax.jit(jax_raster.rasterize_mesh, static_argnames=("cfg", "near"))


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
        float(mesh_ops.normal_consistency_loss(
            vt, ft, mesh_ops.pair_incidence(torch.from_numpy(pairs), len(f)))),
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


def _rasterize_both(v, f, w, h, eye, jax_fn=jax_raster.rasterize_mesh):
    jcfg = JaxRasterConfig(width=w, height=h, chunk=32, max_instances=1 << 14, backend="jax")
    jfr = jax_fn(jnp.asarray(v), jnp.asarray(f), jax_look_at(eye=eye, target=[0, 0, 0]), jcfg)
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
    wins everywhere, whichever triangle it is, as in JAX (jitted: only
    pix_to_face is compared)."""
    tri = np.array([[-0.8, -0.6, 0.0], [0.9, -0.5, 0.0], [0.1, 0.8, 0.0]], np.float32)
    v = np.concatenate([tri, tri])
    f = np.array([[0, 1, 2], [3, 4, 5]] if order == "a-first" else [[3, 4, 5], [0, 1, 2]])
    jfr, fr = _rasterize_both(v, f, 72, 40, [0.0, 0.0, -2.0], jax_fn=JAX_RASTERIZE_JIT)
    pf = fr.pix_to_face.numpy()
    assert (pf == 0).sum() > 100 and not (pf == 1).any()
    np.testing.assert_array_equal(pf, np.asarray(jfr.pix_to_face))


def _one_rounding_per_row(got, want, terms):
    """|got - want| within one float32 rounding of each sum: the two add the
    same rows in other orders. terms: per element, the sum of the
    magnitudes of the rows added into it (a bound of every partial sum)."""
    eps = float(np.finfo(np.float32).eps)
    return np.abs(got - want) <= eps * terms + 1e-30


def test_gather_rows_backward_sums_in_a_fixed_order():
    """segment.gather_rows: the forward is x[index]; its backward equals
    autograd's backward of the plain gather within one rounding per summed
    row, and equals the float64 sum as closely; a second call is bitwise
    the same. face_corners with a vertex incidence, normal_consistency_loss
    with a PairIncidence and the frosting's cell corners (a learned shell's
    gather) give the plain gathers' gradients the same way."""
    from frosting_tpu_torch.models import frosting as frosting_lib
    from frosting_tpu_torch.ops import segment

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(50, 4)).astype(np.float32))
    index = torch.from_numpy(rng.integers(0, 50, 700))
    g = torch.from_numpy(rng.normal(size=(700, 4)).astype(np.float32))
    order, offsets = segment.sort_by_index(index, 50)

    def grads(fixed):
        xl = x.clone().requires_grad_(True)
        y = segment.gather_rows(xl, index, order, offsets) if fixed else xl[index]
        assert torch.equal(y.detach(), x[index])
        return torch.autograd.grad(y, xl, g)[0].numpy()

    got, plain = grads(True), grads(False)
    assert np.array_equal(got, grads(True))
    terms = np.zeros((50, 4))
    np.add.at(terms, index.numpy(), np.abs(g.numpy()).astype(np.float64))
    exact = np.zeros((50, 4))
    np.add.at(exact, index.numpy(), g.numpy().astype(np.float64))
    assert _one_rounding_per_row(got, plain, 2 * terms).all()
    assert _one_rounding_per_row(got, exact, terms).all()

    v, f = _mesh()
    vt, ft = torch.from_numpy(v), torch.from_numpy(f)
    inc = mesh_ops.vertex_incidence(ft, len(v))
    pairs = torch.from_numpy(mesh_ops.adjacent_face_pairs(f))
    pinc = mesh_ops.pair_incidence(pairs, len(f))
    gc = torch.from_numpy(rng.normal(size=(len(f), 3, 3)).astype(np.float32))
    def plain_normal_consistency(t):
        fn = mesh_ops.face_normals(t, ft)
        return torch.mean(1.0 - torch.sum(fn[pairs[:, 0]] * fn[pairs[:, 1]], dim=-1))

    for fn in (lambda t, fixed: mesh_ops.face_corners(t, ft, inc if fixed else None) * gc,
               lambda t, fixed: mesh_ops.normal_consistency_loss(t, ft, pinc, inc) if fixed
               else plain_normal_consistency(t)):
        out = []
        for fixed in (True, False):
            t = vt.clone().requires_grad_(True)
            out.append(torch.autograd.grad(fn(t, fixed).sum(), t)[0].numpy())
        scale = np.abs(out[1]).max()
        assert np.abs(out[0] - out[1]).max() <= 1e-6 * scale
    params = frosting_lib.params_from_numpy({
        "shell_verts": v, "inner_dist": -rng.uniform(0.02, 0.05, len(v)),
        "outer_dist": rng.uniform(0.02, 0.05, len(v)), "bary_logits": np.zeros((1, 6)),
        "scales_log": np.zeros((1, 3)), "quats_raw": np.zeros((1, 4)),
        "opacities_raw": np.zeros(1), "sh_dc": np.zeros((1, 1, 3)), "sh_rest": np.zeros((1, 0, 3)),
        "bg": None}, device="cpu")
    gk = torch.from_numpy(rng.normal(size=(len(f), 6, 3)).astype(np.float32))
    out = []
    for fixed in (True, False):
        d = params.outer_dist.clone().requires_grad_(True)
        p = frosting_lib.FrostingParams(**{**params.__dict__, "outer_dist": d})
        corners = frosting_lib.cell_corners(p, ft, inc if fixed else None)
        out.append(torch.autograd.grad((corners * gk).sum(), d)[0].numpy())
    assert np.abs(out[0] - out[1]).max() <= 1e-6 * np.abs(out[1]).max()
