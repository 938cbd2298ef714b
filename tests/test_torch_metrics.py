"""The port's metrics (frosting_tpu_torch.metrics) against the JAX
package's (frosting_tpu.metrics) on the CPU: evaluate_views' PSNR and SSIM
on the same images within 1e-6, LPIPS with the same VGG16-shaped weights
drawn from a seed (the recipe of tests/test_metrics.py) at 3x64x64 within
rtol 2e-4 (the JAX test's tolerance against its torch reference),
get_lpips without and with FROSTING_TPU_LPIPS_WEIGHTS, and write_metrics'
file byte for byte. The `stages_cli metrics` command:
tests/test_torch_stages_cli.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frosting_tpu import metrics as jax_metrics
from frosting_tpu_torch import metrics
from frosting_tpu_torch.scene.synthetic import write_lpips_weights


@pytest.fixture(autouse=True)
def _no_weights(monkeypatch):
    monkeypatch.delenv("FROSTING_TPU_LPIPS_WEIGHTS", raising=False)


def _views(n=3, size=64, seed=0):
    """n renders and their ground truths [n, 3, size, size] in [0, 1]; the
    renders run past [0, 1], which evaluate_views clips."""
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0.0, 1.0, (n, 3, size, size)).astype(np.float32)
    img = (gt + rng.normal(0.0, 0.1, gt.shape)).astype(np.float32)
    return img, gt


def test_evaluate_views_matches_jax():
    img, gt = _views()
    got = metrics.evaluate_views(lambda i: torch.from_numpy(img[i]), range(3), gt)
    want = jax_metrics.evaluate_views(lambda i: jnp.asarray(img[i]), range(3), gt)
    assert got.keys() == want.keys()
    assert got["n_views"] == want["n_views"] == 3 and got["lpips"] is want["lpips"] is None
    for k in ("psnr", "ssim"):
        assert abs(got[k] - want[k]) <= 1e-6, (k, got[k], want[k])


def test_lpips_matches_jax(tmp_path):
    path = write_lpips_weights(tmp_path / "lpips.npz")
    img, gt = _views(n=1)
    got = float(metrics.LPIPS(path, device="cpu")(torch.from_numpy(img[0]),
                                                   torch.from_numpy(gt[0])))
    jax_lpips = jax_metrics.LPIPS(path)
    # jitted: one compile of the whole network, not one per layer
    want = float(jax.jit(lambda a, b: jax_lpips(a, b))(jnp.asarray(img[0]), jnp.asarray(gt[0])))
    assert got > 0
    np.testing.assert_allclose(got, want, rtol=2e-4)


def test_get_lpips_reads_the_variable(tmp_path, monkeypatch):
    assert metrics.get_lpips("cpu") is None
    monkeypatch.setenv("FROSTING_TPU_LPIPS_WEIGHTS", str(tmp_path / "missing.npz"))
    assert metrics.get_lpips("cpu") is None
    path = write_lpips_weights(tmp_path / "lpips.npz", seed=1)
    monkeypatch.setenv("FROSTING_TPU_LPIPS_WEIGHTS", path)
    lpips = metrics.get_lpips("cpu")
    assert isinstance(lpips, metrics.LPIPS)
    img, gt = _views(n=2, size=32)
    res = metrics.evaluate_views(lambda i: torch.from_numpy(img[i]), range(2), gt, lpips)
    want = np.mean([float(lpips(torch.from_numpy(np.clip(img[i], 0, 1)),
                                torch.from_numpy(gt[i]))) for i in range(2)])
    assert res["lpips"] == pytest.approx(want, rel=1e-6)


def test_write_metrics_matches_jax(tmp_path):
    res = {"psnr": 27.355785369873047, "ssim": 0.9671761989593506, "lpips": None, "n_views": 1}
    metrics.write_metrics(str(tmp_path / "a" / "metrics.json"), res)
    jax_metrics.write_metrics(str(tmp_path / "b" / "metrics.json"), res)
    assert (tmp_path / "a" / "metrics.json").read_bytes() == (
        tmp_path / "b" / "metrics.json").read_bytes()
