"""The port's extraction building blocks against the JAX package's, on the
CPU: marching tetrahedra, the FFT Poisson solve, every mesh-cleaning
function, the QEM decimator (bitwise against frosting_tpu.native), the
auto Poisson resolution, and the exact query KNN (ops.knn.knn_query)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from frosting_tpu import native as jax_native
from frosting_tpu.extract import marching as jax_marching
from frosting_tpu.extract import meshclean as jax_meshclean
from frosting_tpu.extract import poisson as jax_poisson
from frosting_tpu.extract.shell import auto_poisson_resolution as jax_auto_res
from frosting_tpu.ops import knn as jax_knn
from frosting_tpu_torch import _build
from frosting_tpu_torch.extract import marching, meshclean, poisson
from frosting_tpu_torch.extract.shell import auto_poisson_resolution
from frosting_tpu_torch.ops import knn
from tests.test_mesh import icosphere
from tests.test_torch_mesh import JAX_RASTERIZE_JIT


def _noisy_sphere_grid(n=33, seed=0):
    rng = np.random.default_rng(seed)
    lin = np.linspace(-1.3, 1.3, n)
    g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1)
    field = 1.0 - np.linalg.norm(g, axis=-1) + 0.05 * rng.normal(size=(n, n, n))
    return field.astype(np.float32), (-1.3,) * 3, (2.6 / (n - 1),) * 3


@pytest.mark.parametrize("slab_cubes", [32_000_000, 3 * 32 * 32], ids=["whole", "slabbed"])
def test_marching_tets_matches_numpy(slab_cubes):
    """Same grid: faces equal, verts to 1e-12 (float64 positions); the
    slabbed case welds across slabs as the numpy version does."""
    grid, origin, spacing = _noisy_sphere_grid()
    want_v, want_f = jax_marching.marching_tets(grid, 0.0, origin=origin, spacing=spacing,
                                                max_slab_cubes=slab_cubes)
    v, f = marching.marching_tets(torch.from_numpy(grid), 0.0, origin=origin,
                                  spacing=spacing, max_slab_cubes=slab_cubes)
    assert len(want_f) > 1000
    assert v.dtype == torch.float64 and f.dtype == torch.int64
    np.testing.assert_array_equal(f.numpy(), want_f)
    np.testing.assert_allclose(v.numpy(), want_v, rtol=0, atol=1e-12)


def _oriented_cloud(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (d * 0.8 + 0.01 * rng.normal(size=d.shape)).astype(np.float32)
    return pts, d.astype(np.float32)


def test_poisson_matches_jax():
    """Same points: chi to rtol 1e-4 (of its largest magnitude), iso to
    1e-5; the whole reconstruction's mesh then equals JAX's, verts to 1e-6
    (marching's float32 interpolation of a chi that differs in the last
    bits)."""
    pts, nrm = _oriented_cloud()
    n = 40
    p01, lo, hi_p = poisson.normalise(torch.from_numpy(pts))
    jlo = pts.min(0) - 0.15 * (pts.max(0) - pts.min(0)).max()
    np.testing.assert_array_equal(lo.numpy(), jlo)
    want_chi, want_iso = jax_poisson._poisson_grid(jnp.asarray(p01.numpy()),
                                                   jnp.asarray(nrm), n)
    chi, iso = poisson.poisson_grid(p01, torch.from_numpy(nrm), n)
    want_chi = np.asarray(want_chi)
    np.testing.assert_allclose(chi.numpy(), want_chi, rtol=0,
                               atol=1e-4 * np.abs(want_chi).max())
    np.testing.assert_allclose(float(iso), float(want_iso), rtol=0, atol=1e-5)
    # the splat sums in a fixed order: a second call is bitwise equal
    assert torch.equal(poisson.poisson_grid(p01, torch.from_numpy(nrm), n)[0], chi)

    want_v, want_f = jax_poisson.poisson_reconstruct(pts, nrm, resolution=n)
    v, f = poisson.poisson_reconstruct(torch.from_numpy(pts), torch.from_numpy(nrm),
                                       resolution=n)
    np.testing.assert_array_equal(f.numpy(), want_f)
    np.testing.assert_allclose(v.numpy(), want_v, rtol=0, atol=1e-6)


def _mesh_with_islands():
    v, f = icosphere(2)
    far = v[:30] * 3.0
    verts = np.concatenate([v, far]).astype(np.float64)
    faces = np.concatenate([f, np.arange(len(v), len(v) + 30).reshape(10, 3)]).astype(np.int64)
    return verts, faces, v


def test_meshclean_functions_equal_jax():
    """Every host-side cleaning function, on the same inputs, equals the
    JAX package's exactly."""
    rng = np.random.default_rng(0)
    verts, faces, support = _mesh_with_islands()
    pts = np.concatenate([support, rng.uniform(-4, 4, (20, 3))]).astype(np.float32)
    extra = rng.normal(size=(len(pts), 3))
    got = meshclean.remove_statistical_outliers(pts, k=8, extra=[extra])
    want = jax_meshclean.remove_statistical_outliers(pts, k=8, extra=[extra])
    for a, b in zip(got[:2] + tuple(got[2]), want[:2] + tuple(want[2])):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(meshclean.remove_unsupported_vertices(verts, faces, support, 0.1),
                    jax_meshclean.remove_unsupported_vertices(verts, faces, support, 0.1)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(meshclean.project_on_points(verts, support, 0.7),
                                  jax_meshclean.project_on_points(verts, support, 0.7))
    for a, b in zip(meshclean.decimate_vertex_clustering(verts, faces, 80),
                    jax_meshclean.decimate_vertex_clustering(verts, faces, 80)):
        np.testing.assert_array_equal(a, b)
    parts = [(verts, faces), None, (support, faces[:50])]
    for a, b in zip(meshclean.merge_meshes(parts), jax_meshclean.merge_meshes(parts)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(meshclean.face_components(faces, len(verts)),
                                  jax_meshclean.face_components(faces, len(verts)))
    mask = rng.uniform(size=len(faces)) > 0.3
    for a, b in zip(meshclean.keep_faces(verts, faces, mask),
                    jax_meshclean.keep_faces(verts, faces, mask)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(meshclean.largest_component(verts, faces),
                    jax_meshclean.largest_component(verts, faces)):
        np.testing.assert_array_equal(a, b)


def test_nearest_distances_equal_ckdtree_inside_a_closed_surface():
    """The exact query KNN's nearest-support distances (float64) equal
    cKDTree's bit for bit, for points on, inside (near the centre, where
    the search radius has to grow) and outside a sphere of support points;
    with `enough`, the points past the radius that sufficed are inf."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(3)
    d = rng.normal(size=(4000, 3))
    support = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    e = rng.normal(size=(3000, 3))
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    pts = np.concatenate([e * rng.uniform(0.97, 1.03, (3000, 1)),
                          rng.normal(0, 0.05, (200, 3)), e[:100] * 3.0])
    want = cKDTree(support).query(pts, k=1)[0]
    np.testing.assert_array_equal(meshclean.nearest_distances(pts, support), want)
    some = meshclean.nearest_distances(pts, support, enough=3000)
    near = np.isfinite(some)
    assert near.sum() >= 3000 and not near[3000:3200].any()
    np.testing.assert_array_equal(some[near], want[near])


@pytest.mark.parametrize("threshold", [0.001, 0.5], ids=["keep-visible", "cull-most"])
def test_visibility_cull_components_equals_jax(threshold, monkeypatch):
    """The sphere and a second one beside it: components seen by the
    cameras; the port's per-label bincount keeps what JAX's loop keeps.
    (JAX's mesh rasterizer runs jitted, one compile in place of its eager
    ops' many: the same pix_to_face.)"""
    from frosting_tpu.ops import mesh_raster as jax_mesh_raster
    from frosting_tpu.raster import RasterConfig as JaxRasterConfig

    monkeypatch.setattr(jax_mesh_raster, "rasterize_mesh", JAX_RASTERIZE_JIT)
    from frosting_tpu.scene import synthetic as jax_synthetic
    from frosting_tpu_torch.raster import RasterConfig
    from frosting_tpu_torch.scene import synthetic

    v, f = icosphere(2)
    verts = np.concatenate([v, v * 0.3 + [2.5, 0.0, 0.0]]).astype(np.float64)
    faces = np.concatenate([f, f + len(v)]).astype(np.int64)
    jcfg = JaxRasterConfig(width=48, height=32, chunk=32, max_instances=1 << 14, backend="jax")
    cfg = RasterConfig(width=48, height=32, chunk=32, max_instances=1 << 14)
    want = jax_meshclean.visibility_cull_components(
        verts, faces, jax_synthetic.camera_ring(n_cams=2, radius=3.5), jcfg, threshold)
    got = meshclean.visibility_cull_components(
        verts, faces, synthetic.camera_ring(n_cams=2, radius=3.5, device="cpu"), cfg, threshold)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_qem_decimation_is_bitwise_the_jax_packages():
    """The port's copy of qem.cpp, built by _build.py, against
    frosting_tpu.native.qem_decimate: the same vertices and faces, bit for
    bit; decimate returns a mesh within budget unchanged."""
    v, f = icosphere(3)
    v = v.astype(np.float64) * np.random.default_rng(0).uniform(0.95, 1.05, (len(v), 1))
    want = jax_native.qem_decimate(v, f, 200)
    assert want is not None
    got = meshclean.decimate(v, f, 200)
    assert len(got[0]) <= 210 and got[1].dtype == np.int64
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    same = meshclean.decimate(v, f, len(v))
    assert same[0] is v and same[1] is f


def test_qem_fails_loudly(tmp_path, monkeypatch):
    """No fallback to vertex clustering: a source that does not compile,
    or no compiler at all, raises; so does a decimation the library
    refuses (a target under 4 vertices)."""
    v, f = icosphere(2)
    with pytest.raises(RuntimeError, match="qem_decimate failed"):
        meshclean.decimate(v, f, 3)
    (tmp_path / "qem.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="build failed: qem.cpp"):
        meshclean.decimate(v, f, 100)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        meshclean.decimate(v, f, 100)


def test_auto_poisson_resolution_equals_jax():
    rng = np.random.default_rng(0)
    d = rng.normal(size=(20_000, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for pts in (d[:3], d[:500], d, d * 0.01):
        for cap in (256, 1024):
            assert auto_poisson_resolution(pts, cap) == jax_auto_res(pts, cap)


def _brute(queries, refs, k):
    d = refs[None] - queries[:, None]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    return idx, np.take_along_axis(d2, idx, 1)


def test_knn_query_is_exact_against_jax_up_to_16384_refs():
    """JAX's knn_query is exact (brute force) up to 16384 references: the
    port's indices equal its where the k-th distances do not tie, and the
    distances to rtol 1e-6 (the JAX side expands the square)."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(12_000, 3))
    refs = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    queries = (refs[rng.integers(0, len(refs), 3000)]
               * rng.uniform(0.97, 1.03, (3000, 1))).astype(np.float32)
    want_idx, want_d2 = (np.asarray(a) for a in jax_knn.knn_query(
        jnp.asarray(queries), jnp.asarray(refs), k=8))
    idx, d2 = knn.knn_query(torch.from_numpy(queries), torch.from_numpy(refs), k=8)
    np.testing.assert_allclose(d2.numpy(), want_d2, rtol=1e-5, atol=1e-7)
    _ref_idx, ref_d2 = _brute(queries, refs, 9)
    distinct = np.all(np.diff(ref_d2, axis=1) > 1e-6 * ref_d2[:, 1:], axis=1)
    assert distinct.mean() > 0.9
    np.testing.assert_array_equal(idx.numpy()[distinct], want_idx[distinct])


def test_knn_query_is_exact_far_outside_the_refs_and_within_a_radius():
    """Queries inside, beside and far outside the references' box, against
    a float32 brute force: every result exact; with `radius`, exactly the
    neighbours within it, the rest filler (index 0, inf); one index serves
    several query blocks."""
    rng = np.random.default_rng(1)
    refs = np.concatenate([rng.normal(0, 0.05, (1500, 3)),
                           rng.uniform(-1, 1, (500, 3))]).astype(np.float32)
    queries = np.concatenate([
        rng.uniform(-1, 1, (300, 3)),  # inside the box
        rng.uniform(-3, 3, (300, 3)),  # beside it
        rng.normal(0, 1, (200, 3)) * 40 + 100,  # far outside
    ]).astype(np.float32)
    index = knn.knn_prepare(torch.from_numpy(refs), k=16)
    ref_idx, ref_d2 = _brute(queries, refs, 17)
    distinct = np.all(np.diff(ref_d2, axis=1) > 0, axis=1)
    assert distinct.mean() > 0.8
    for rows in (slice(0, 400), slice(400, None)):
        idx, d2 = knn.knn_query_indexed(index, torch.from_numpy(queries[rows]), 16)
        np.testing.assert_allclose(d2.numpy(), ref_d2[rows, :16], rtol=1e-6)
        ok = distinct[rows]
        np.testing.assert_array_equal(idx.numpy()[ok], ref_idx[rows, :16][ok])
    radius = 0.4
    idx, d2 = knn.knn_query_indexed(index, torch.from_numpy(queries), 16, radius=radius)
    inside = ref_d2[:, :16] <= radius * radius
    assert inside.any() and (~inside).any()
    np.testing.assert_allclose(d2.numpy()[inside], ref_d2[:, :16][inside], rtol=1e-6)
    assert np.isinf(d2.numpy()[~inside]).all() and (idx.numpy()[~inside] == 0).all()
