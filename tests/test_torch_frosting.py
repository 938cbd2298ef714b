"""The Frosting model (frosting_tpu_torch.models.frosting, stage 4) and the
fixed-order vertex normals against the JAX package's, on the CPU.

The shell is built in numpy (an icosphere of 642 vertices), never by
extraction; 2000 source Gaussians lie around it. Each JAX reference is
computed once per module. Where the port's draws matter (init), it is
handed JAX's own ``jax.random`` draws.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frosting_tpu.models import frosting as jax_frosting
from frosting_tpu.ops import mesh as jax_mesh
from frosting_tpu.ops import quat as jax_quat
from frosting_tpu.scene.gaussians import GaussianParams as JaxGaussianParams
from frosting_tpu_torch.models import frosting
from frosting_tpu_torch.ops import mesh as mesh_ops
from frosting_tpu_torch.ops import quat as quat_ops
from frosting_tpu_torch.scene.gaussians import params_from_numpy as gaussians_from_numpy
from tests.test_mesh import icosphere

torch.set_num_threads(1)
EXTENT = 3.5
N_FROSTING = 3000
K = 8


def _shell(seed=0, jitter=0.02):
    v, f = icosphere(3)
    rng = np.random.default_rng(seed)
    v = v * rng.uniform(1.0 - jitter, 1.0 + jitter, (len(v), 1))
    return v.astype(np.float32), f.astype(np.int32)


def _source(n=2000, n_far=100, seed=1):
    """Raw 3DGS params: n Gaussians around the unit sphere, coloured by
    position, then n_far outside the shell's bounding box (the background)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    means = np.concatenate([d * rng.uniform(0.97, 1.03, (n, 1)),
                            rng.uniform(2.0, 4.0, (n_far, 3))]).astype(np.float32)
    m = len(means)
    q = rng.normal(size=(m, 4))
    sh = rng.normal(0.0, 0.1, (m, 16, 3))
    sh[:, 0] = (means + 1.5) / 3.0
    return {
        "means3d": means,
        "sh_dc": sh[:, :1].astype(np.float32),
        "sh_rest": sh[:, 1:].astype(np.float32),
        "scales_log": np.log(rng.uniform(0.02, 0.06, (m, 3))).astype(np.float32),
        "quats_raw": (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32),
        "opacities_raw": rng.uniform(0.0, 3.0, m).astype(np.float32),
        "mask": np.ones(m, np.float32),
    }


def _activated(raw):
    """(means, scales, quats, opacities) as numpy, activated."""
    return (raw["means3d"], np.exp(raw["scales_log"]), raw["quats_raw"],
            (1.0 / (1.0 + np.exp(-raw["opacities_raw"]))).astype(np.float32))


def _normals(v, f):
    return np.asarray(jax_mesh.vertex_normals(jnp.asarray(v), jnp.asarray(f)))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_quat_apply_and_conjugate_match_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(50, 7, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    v = rng.normal(size=(50, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(quat_ops.conjugate(_t(q)).numpy(),
                               np.asarray(jax_quat.conjugate(jnp.asarray(q))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(quat_ops.apply(_t(q), _t(v)).numpy(),
                               np.asarray(jax_quat.apply(jnp.asarray(q), jnp.asarray(v))),
                               rtol=1e-6, atol=1e-6)


def test_vertex_normals_sum_in_a_fixed_order():
    """Two calls bitwise equal; 1e-6 against JAX; the incidence lists each
    vertex's faces corner by corner in face order, as JAX's scatters add."""
    v, f = _shell()
    a = mesh_ops.vertex_normals(_t(v), _t(f))
    b = mesh_ops.vertex_normals(_t(v), _t(f), incidence=mesh_ops.vertex_incidence(_t(f), len(v)))
    assert torch.equal(a, b)
    np.testing.assert_allclose(a.numpy(), _normals(v, f), rtol=1e-6, atol=1e-6)
    inc = mesh_ops.vertex_incidence(_t(f), len(v))
    corner_major = np.concatenate([f[:, 0], f[:, 1], f[:, 2]])
    order = np.argsort(corner_major, kind="stable") % len(f)
    np.testing.assert_array_equal(inc.face.numpy(), order)
    np.testing.assert_array_equal(inc.offsets.numpy(),
                                  np.searchsorted(np.sort(corner_major), np.arange(len(v) + 1)))


def _blend_params(seed, n=500):
    v, f = _shell()
    rng = np.random.default_rng(seed)
    d = {
        "shell_verts": v,
        "inner_dist": -np.abs(rng.normal(0.05, 0.01, len(v))).astype(np.float32),
        "outer_dist": np.abs(rng.normal(0.1, 0.02, len(v))).astype(np.float32),
        "bary_logits": rng.normal(0, 1, (n, 6)).astype(np.float32),
        "scales_log": np.zeros((n, 3), np.float32),
        "quats_raw": np.tile(np.float32([1, 0, 0, 0]), (n, 1)),
        "opacities_raw": np.zeros(n, np.float32),
        "sh_dc": np.zeros((n, 1, 3), np.float32),
        "sh_rest": np.zeros((n, 15, 3), np.float32),
    }
    cell_idx = np.sort(rng.integers(0, len(f), n)).astype(np.int32)
    return d, f, cell_idx, rng.normal(size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("sorted_cells", [True, False], ids=["cell_bounds", "unsorted"])
def test_gaussian_centers_and_gradients_match_jax(sorted_cells):
    """Value and the gradients of sum(centers * salt) in the bary logits and
    the shell against jax.grad: with cell_bounds (JAX's prefix differences,
    the port's segment sum), and for an unsorted cell_idx without them
    (JAX's gather, the port's sum in cell order). Tolerance as the JAX
    package's own check of its two paths (tests/test_frosting.py:368)."""
    d, f, cell_idx, salt = _blend_params(seed=3)
    bounds = np.searchsorted(cell_idx, np.arange(len(f) + 1)).astype(np.int32)
    if not sorted_cells:
        perm = np.random.default_rng(4).permutation(len(cell_idx))
        cell_idx, salt, bounds = cell_idx[perm], salt[perm], None
        d["bary_logits"] = d["bary_logits"][perm]
    jp = jax_frosting.FrostingParams(**{k: jnp.asarray(a) for k, a in d.items()})

    def jloss(p):
        m = jax_frosting.gaussian_centers(
            p, jnp.asarray(f), jnp.asarray(cell_idx), None if bounds is None else jnp.asarray(bounds))
        return jnp.sum(m * jnp.asarray(salt))

    want, jgrad = jax.value_and_grad(jloss)(jp)
    p = frosting.params_from_numpy(d, device="cpu")
    names = ("bary_logits", "shell_verts", "inner_dist", "outer_dist")
    for name in names:
        getattr(p, name).requires_grad_(True)
    meta = frosting.make_meta(f, cell_idx, bounds, device="cpu")
    m = frosting.gaussian_centers(p, meta.faces, meta.cell_idx, meta.cell_bounds, meta.incidence)
    loss = torch.sum(m * _t(salt))
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    grads = torch.autograd.grad(loss, [getattr(p, n) for n in names])
    for name, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(jgrad, name)),
                                   rtol=2e-4, atol=2e-5, err_msg=name)


def test_corner_blend_backward_equals_the_gather_and_is_reproducible():
    """CornerBlend's gradients equal autograd's through the plain gather
    (corners[cell_idx] and a weighted sum) to 1e-6, and two calls are
    bitwise equal."""
    d, f, cell_idx, salt = _blend_params(seed=5, n=2000)
    p = frosting.params_from_numpy(d, device="cpu")
    meta = frosting.make_meta(f, cell_idx, np.searchsorted(cell_idx, np.arange(len(f) + 1)),
                              device="cpu")
    corners = frosting.cell_corners(p, meta.faces)

    def grads(plain):
        w = torch.softmax(p.bary_logits, -1).requires_grad_(True)
        c = corners.clone().requires_grad_(True)
        if plain:
            m = torch.sum(w[..., None] * c[meta.cell_idx], dim=1)
        else:
            m = frosting.CornerBlend.apply(w, c, meta.cell_idx, meta.cell_bounds)
        return torch.autograd.grad(torch.sum(m * _t(salt)), [w, c])

    first, second, plain = grads(False), grads(False), grads(True)
    for a, b, c in zip(first, second, plain):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def level_inputs():
    v, f = _shell()
    raw = _source()
    means, scales, quats, opac = _activated(raw)
    normals = _normals(v, f)
    rng = np.random.default_rng(6)
    ranges = rng.uniform(0.05, 0.15, len(v)).astype(np.float32)
    cfg = dict(knn_k=K)
    want = jax_frosting.level_dists_along_normals(
        jnp.asarray(v), jnp.asarray(normals), jnp.asarray(means), jnp.asarray(scales),
        jnp.asarray(quats), jnp.asarray(opac), jax_frosting.FrostingConfig(**cfg),
        jnp.asarray(ranges))
    return v, f, normals, (means, scales, quats, opac), ranges, cfg, [np.asarray(w) for w in want]


def test_level_samples_are_jax_linspace():
    for s in (2, 5, 7, 11, 21, 33, 64):
        np.testing.assert_array_equal(frosting.level_samples(s),
                                      np.asarray(jnp.linspace(-1.0, 1.0, s)))


def test_level_dists_along_normals_match_jax(level_inputs):
    v, f, normals, g, ranges, cfg, (want_in, want_out) = level_inputs
    inner, outer = frosting.level_dists_along_normals(
        _t(v), _t(normals), *(_t(a) for a in (g[0], g[1], g[2], g[3])),
        frosting.FrostingConfig(**cfg), _t(ranges))
    assert (want_in < 0).mean() > 0.9 and (want_out > 0).mean() > 0.9
    np.testing.assert_allclose(inner.numpy(), want_in, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(outer.numpy(), want_out, rtol=1e-5, atol=1e-5)


def _sheets(v, normals, seed, lo=0.02, hi=0.12):
    rng = np.random.default_rng(seed)
    inner = v - rng.uniform(lo, hi, (len(v), 1)).astype(np.float32) * normals
    outer = v + rng.uniform(lo, hi, (len(v), 1)).astype(np.float32) * normals
    return inner.astype(np.float32), outer.astype(np.float32)


def test_is_inside_cells_matches_jax():
    """Points around the shell, inside and outside the cells: equal."""
    v, f = _shell()
    normals = _normals(v, f)
    inner, outer = _sheets(v, normals, seed=7)
    rng = np.random.default_rng(8)
    pts = (v[rng.integers(0, len(v), 4000)] * rng.uniform(0.85, 1.15, (4000, 1))
           + rng.normal(0, 0.02, (4000, 3))).astype(np.float32)
    exclude = rng.integers(0, len(f), 4000).astype(np.int32)
    for ex in (None, exclude):
        want = np.asarray(jax_frosting.is_inside_cells(
            jnp.asarray(pts), jnp.asarray(inner), jnp.asarray(outer), jnp.asarray(f), EXTENT,
            k=K, exclude_cells=None if ex is None else jnp.asarray(ex)))
        got = frosting.is_inside_cells(
            _t(pts), _t(inner), _t(outer), _t(f), EXTENT, k=K,
            exclude_cells=None if ex is None else _t(ex).long()).numpy()
        assert 0.2 < want.mean() < 0.8
        np.testing.assert_array_equal(got, want)


def test_avoid_self_intersections_matches_jax():
    """A bumpy shell and targets that make the sheets cross other cells
    (inner ones past the centre): the frozen offsets equal JAX's on all but
    0.5% of the vertices (a sheet point on another cell's plane may meet
    the strict threshold in one package's rounding and not the other's),
    to 1e-6."""
    v, f = _shell(jitter=0.1)
    normals = _normals(v, f)
    rng = np.random.default_rng(9)
    inner_t = -rng.uniform(0.2, 1.5, len(v)).astype(np.float32)
    outer_t = rng.uniform(0.0, 0.4, len(v)).astype(np.float32)
    want = [np.asarray(w) for w in jax_frosting.avoid_self_intersections(
        jnp.asarray(v), jnp.asarray(normals), jnp.asarray(f), jnp.asarray(inner_t),
        jnp.asarray(outer_t), EXTENT, n_iters=20, k=K)]
    got = [g.numpy() for g in frosting.avoid_self_intersections(
        _t(v), _t(normals), _t(f), _t(inner_t), _t(outer_t), EXTENT, n_iters=20, k=K)]
    for w, g, t in zip(want, got, (inner_t, outer_t)):
        assert (np.abs(w) < 0.99 * np.abs(t)).mean() > 0.2  # these froze on the way
        same = np.isclose(g, w, rtol=1e-6, atol=1e-6)
        assert same.mean() >= 0.995, same.mean()


@pytest.fixture(scope="module")
def inits():
    """JAX's init_frosting and the port's on the same inputs, with JAX's own
    draws handed to the port; background Gaussians on."""
    v, f = _shell()
    raw = _source()
    means, scales, quats, opac = _activated(raw)
    key = jax.random.key(0)
    jgauss = JaxGaussianParams(**{k: jnp.asarray(a) for k, a in raw.items()})
    kw = dict(n_gaussians=N_FROSTING, knn_k=K)
    jp, jm = jax_frosting.init_frosting(
        key, v, f, jnp.asarray(means), jnp.asarray(scales), jnp.asarray(quats),
        jnp.asarray(opac), jgauss, jax_frosting.FrostingConfig(**kw), EXTENT,
        use_background=True)
    k1, k2, _k3 = jax.random.split(key, 3)
    u_cell = np.asarray(jax.random.uniform(k1, (N_FROSTING,)))
    u_bary = np.asarray(jax.random.uniform(k2, (N_FROSTING, 6)))
    p, m = frosting.init_frosting(
        v, f, *(_t(a) for a in (means, scales, quats, opac)),
        gaussians_from_numpy(raw, device="cpu"), frosting.FrostingConfig(**kw), EXTENT,
        use_background=True, u_cell=_t(u_cell), u_bary=_t(u_bary))
    return jp, jm, p, m


def test_init_frosting_matches_jax(inits):
    """cell_idx equal on all but 0.1% of the Gaussians (the two cumsums of
    the cell volumes round differently, which can move a draw on a cell
    boundary to the next cell); cell_bounds are cell_idx's run bounds; the
    offsets, bary logits, scales and SH to 1e-5 where the cells agree. The
    scales are compared where JAX's self-KNN (approximate: Morton windows)
    found the exact 3 nearest neighbours, as the port's does: at least 99%
    of the Gaussians."""
    from frosting_tpu.ops import knn as jax_knn

    jp, jm, p, m = inits
    jci, ci = np.asarray(jm.cell_idx), m.cell_idx.numpy()
    same = jci == ci
    assert same.mean() >= 0.999, same.mean()
    assert (np.diff(ci) >= 0).all()
    np.testing.assert_array_equal(m.cell_bounds.numpy(),
                                  np.searchsorted(ci, np.arange(len(m.faces) + 1)))
    for name in ("inner_dist", "outer_dist"):
        np.testing.assert_allclose(getattr(p, name).numpy(), np.asarray(getattr(jp, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    assert float(p.outer_dist.mean()) > 0 > float(p.inner_dist.mean())
    for name in ("bary_logits", "sh_dc", "sh_rest", "quats_raw", "opacities_raw"):
        np.testing.assert_allclose(getattr(p, name).numpy()[same],
                                   np.asarray(getattr(jp, name))[same],
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    pts = np.asarray(jax_frosting.gaussian_centers(jp, jm.faces, jm.cell_idx))
    approx = np.asarray(jax_knn.mean_knn_sqdist(jnp.asarray(pts), k=3))
    d2 = np.sum((pts[:, None] - pts[None]) ** 2, -1)
    np.fill_diagonal(d2, np.inf)
    exact = np.sort(d2, axis=1)[:, :3].mean(1)
    found = np.isclose(approx, exact, rtol=1e-5) & same
    assert found.mean() >= 0.99, found.mean()
    np.testing.assert_allclose(p.scales_log.numpy()[found], np.asarray(jp.scales_log)[found],
                               rtol=1e-5, atol=1e-5)
    assert jp.bg is not None and p.bg is not None
    np.testing.assert_array_equal(p.bg.mask.numpy(), np.asarray(jp.bg.mask))
    assert p.bg.mask.sum() >= 100  # the far points, and sphere points past the box


def test_activate_frosting_with_background_matches_jax(inits):
    """JAX's initialised model carried into the port (params_from_numpy,
    meta_from_numpy) activates to JAX's arrays, background Gaussians
    included, to 1e-6."""
    jp, jm, _p, _m = inits
    d = {f.name: np.asarray(getattr(jp, f.name)) for f in dataclasses.fields(jp) if f.name != "bg"}
    d["bg"] = {f.name: np.asarray(getattr(jp.bg, f.name)) for f in dataclasses.fields(jp.bg)}
    p = frosting.params_from_numpy(d, device="cpu")
    meta = frosting.meta_from_numpy(
        {k: np.asarray(getattr(jm, k)) for k in ("faces", "cell_idx", "cell_bounds")},
        device="cpu")
    want = jax_frosting.activate_frosting(jp, jm)
    with torch.no_grad():
        got = frosting.activate_frosting(p, meta)
    assert got[0].shape[0] == N_FROSTING + jp.bg.capacity
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 5000, 2_100_000])
def test_fixed_order_cumsum(n):
    """ops/segment.cumsum, the allocation's CDF, equals torch.cumsum in
    float64 to round-off, at sizes around its block."""
    from frosting_tpu_torch.ops import segment

    x = torch.from_numpy(np.random.default_rng(n).uniform(0, 1, n))
    got = segment.cumsum(x)
    assert got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), torch.cumsum(x, 0).numpy(), rtol=1e-12)
