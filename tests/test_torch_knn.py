"""The port's exact KNN (frosting_tpu_torch.ops.knn) against a numpy brute
force, and the JAX package's approximate knn against it (recall)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frosting_tpu.ops import knn as jax_knn
from frosting_tpu_torch.ops import knn


def _brute_force(points, k, valid=None):
    """(idx, sqdist) of every live row by numpy, float32 explicit
    differences summed as the port sums them; dead rows left as filler."""
    n = len(points)
    live = np.arange(n) if valid is None else np.nonzero(valid)[0]
    idx = np.zeros((n, k), np.int64)
    d2 = np.full((n, k), np.inf, np.float32)
    for i in live:
        d = points[live] - points[i]
        dd = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        dd[live == i] = np.inf
        order = np.argsort(dd, kind="stable")[:k]
        idx[i, :len(order)], d2[i, :len(order)] = live[order], dd[order]
    return idx, d2


def _cloud(kind, rng, n=2000):
    if kind == "uniform":
        return rng.uniform(-1, 1, (n, 3))
    if kind == "surface":
        d = rng.normal(size=(n, 3))
        return d / np.linalg.norm(d, axis=1, keepdims=True)
    # a dense object in a wide sparse background, and exact duplicates
    pts = np.concatenate([rng.normal(0, 0.01, (n - n // 6, 3)), rng.uniform(-50, 50, (n // 6, 3))])
    pts[:3] = pts[3:6]
    return pts


@pytest.mark.parametrize("with_dead", [False, True], ids=["all-live", "dead-slots"])
@pytest.mark.parametrize("kind", ["uniform", "surface", "clustered"])
def test_knn_is_exact(kind, with_dead):
    """Distances equal the brute force's (rtol 1e-6; the same float32
    operations); indices equal where the k-th distances do not tie; dead
    slots are never neighbours."""
    rng = np.random.default_rng(len(kind))
    pts = _cloud(kind, rng, n=1000).astype(np.float32)
    valid = rng.uniform(size=len(pts)) > 0.3 if with_dead else None
    if with_dead:
        pts[~valid] = 1e6  # parked arena slots
    idx, d2 = knn.knn(torch.from_numpy(pts), 16,
                      None if valid is None else torch.from_numpy(valid))
    ref_idx, ref_d2 = _brute_force(pts, 17, valid)  # one past k, for ties
    live = np.arange(len(pts)) if valid is None else np.nonzero(valid)[0]
    idx, d2 = idx.numpy()[live], d2.numpy()[live]
    np.testing.assert_allclose(d2, ref_d2[live, :16], rtol=1e-6)
    distinct = np.all(np.diff(ref_d2[live], axis=1) > 0, axis=1)
    np.testing.assert_array_equal(idx[distinct], ref_idx[live, :16][distinct])
    assert distinct.mean() > 0.8  # duplicated points tie in the rows that hold them
    assert not np.any(idx == live[:, None])
    if with_dead:
        assert valid[idx].all()


def test_knn_pads_past_the_live_count_and_falls_back_to_brute_force(monkeypatch):
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1, 1, (12, 3)).astype(np.float32)
    valid = np.arange(12) < 6
    idx, d2 = knn.knn(torch.from_numpy(pts), 8, torch.from_numpy(valid))
    assert np.isinf(d2[:6, 5:].numpy()).all() and np.isfinite(d2[:6, :5].numpy()).all()
    assert valid[idx[:6, :5].numpy()].all()

    # with no grid level every query goes to the brute-force pass
    pts = _cloud("clustered", rng, n=600).astype(np.float32)
    want = knn.knn(torch.from_numpy(pts), 16)
    monkeypatch.setattr(knn, "GRID_LEVELS", 0)
    got = knn.knn(torch.from_numpy(pts), 16)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())


def test_mean_knn_sqdist():
    pts = np.random.default_rng(2).uniform(-1, 1, (500, 3)).astype(np.float32)
    _, ref = _brute_force(pts, 3)
    got = knn.mean_knn_sqdist(torch.from_numpy(pts), k=3).numpy()
    np.testing.assert_allclose(got, ref.mean(axis=1), rtol=1e-6)


def test_jax_knn_recall_against_the_exact_knn():
    """The JAX knn (Morton windows + NN-descent) finds >= 95% of the exact
    neighbours of a 2k-point cloud with dead slots."""
    rng = np.random.default_rng(3)
    pts = _cloud("surface", rng).astype(np.float32)
    valid = rng.uniform(size=len(pts)) > 0.1
    exact, _ = knn.knn(torch.from_numpy(pts), 16, torch.from_numpy(valid))
    approx, _ = jax_knn.knn(jnp.asarray(pts), k=16, valid=jnp.asarray(valid))
    live = np.nonzero(valid)[0]
    exact, approx = exact.numpy()[live], np.asarray(approx)[live]
    hits = sum(len(set(a) & set(e)) for a, e in zip(approx, exact))
    assert hits / exact.size >= 0.95
