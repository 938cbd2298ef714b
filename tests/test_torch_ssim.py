"""The port's photometric losses (frosting_tpu_torch.ops.ssim) against the
JAX reference's on the same images, on the CPU. Tolerance atol 1e-5: both
sum the same 11x11 window terms in float32, in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from frosting_tpu.ops import ssim as jax_ssim
from frosting_tpu_torch.ops import ssim as port_ssim

ATOL = 1e-5


def _images(seed, shape=(3, 40, 56)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    # a blurred, noisy copy: SSIM well away from 0 and 1
    b = np.clip(0.7 * a + 0.3 * np.roll(a, 3, axis=2)
                + rng.normal(scale=0.05, size=shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize(
    "name", ["ssim", "dssim", "l1_loss", "l2_loss", "psnr", "photometric_loss"]
)
def test_loss_matches_jax(name):
    a, b = _images(0)
    want = float(getattr(jax_ssim, name)(jnp.asarray(a), jnp.asarray(b)))
    got = float(getattr(port_ssim, name)(torch.from_numpy(a), torch.from_numpy(b)))
    # psnr is in dB: 1e-5 relative to its ~15 dB
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL if name == "psnr" else 0)


def test_ssim_gradient_matches_jax():
    a, b = _images(1, shape=(3, 33, 47))
    want = np.asarray(jax.grad(jax_ssim.ssim)(jnp.asarray(a), jnp.asarray(b)))
    x = torch.from_numpy(a).requires_grad_(True)
    port_ssim.ssim(x, torch.from_numpy(b)).backward()
    np.testing.assert_allclose(x.grad.numpy(), want, atol=ATOL)


def test_identical_images():
    a, _ = _images(2)
    t = torch.from_numpy(a)
    assert abs(float(port_ssim.ssim(t, t)) - 1.0) < 1e-6
    assert float(port_ssim.psnr(t, t)) == pytest.approx(120.0)
