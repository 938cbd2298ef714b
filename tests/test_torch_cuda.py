"""The CUDA forward blend kernel on the card against its plain PyTorch
version. Marked `gpu`: every test skips without a CUDA device. This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from frosting_tpu_torch.cameras import look_at_camera
from frosting_tpu_torch.raster import RasterConfig, render
from frosting_tpu_torch.raster import blend_cuda
from frosting_tpu_torch.raster.binning import bin_gaussians
from frosting_tpu_torch.raster.blend_torch import blend_forward_torch
from frosting_tpu_torch.raster.preprocess import pack_fields, preprocess
from frosting_tpu_torch.scene.synthetic import gaussian_blob_scene

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(cuda, width, height, n):
    gs = gaussian_blob_scene(n=n, seed=1, device=cuda)
    cam = look_at_camera(eye=[0.3, -2.6, 1.0], target=[0, 0, 0], up=(0, 0, 1),
                         device=cuda)
    cfg = RasterConfig(width=width, height=height, max_instances=1 << 22)
    proj = preprocess(*gs, cam, cfg)
    binned = bin_gaussians(proj.rect, proj.depths, proj.valid, cfg)
    return pack_fields(proj), binned, cfg


@pytest.mark.parametrize("size", [(256, 256), (333, 197)], ids=["256", "333x197"])
def test_kernel_matches_plain_version(cuda, size):
    fields, binned, cfg = _inputs(cuda, *size, n=20_000)
    before = blend_cuda.blend_forward.launches
    out = blend_cuda.blend_forward(fields, binned, cfg)
    torch.cuda.synchronize()
    assert blend_cuda.blend_forward.launches == before + 1
    ref = blend_forward_torch(fields, binned, cfg)
    err = (out - ref).abs()
    # stop-threshold flips: at most 0.1% of pixels, each at most 1e-2
    off = err > 1e-5 + 1e-5 * ref.abs()
    assert off.float().mean().item() <= 1e-3
    assert err.max().item() <= 1e-2
    assert torch.isfinite(out).all()


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    fields, binned, cfg = _inputs(cuda, 64, 64, n=500)
    with pytest.raises(TypeError):
        blend_cuda.blend_forward(fields.double(), binned, cfg)
    with pytest.raises(ValueError):
        blend_cuda.blend_forward(fields[:, :8], binned, cfg)
    with pytest.raises(ValueError):
        blend_cuda.blend_forward(
            fields, binned._replace(inst_gauss=binned.inst_gauss.cpu()), cfg
        )


def test_render_refuses_gradients_on_cuda(cuda):
    gs = [t.clone().requires_grad_(i == 0) for i, t in
          enumerate(gaussian_blob_scene(n=100, seed=2, device=cuda))]
    cam = look_at_camera(eye=[0, -3, 0.5], target=[0, 0, 0], up=(0, 0, 1), device=cuda)
    cfg = RasterConfig(width=64, height=64)
    with pytest.raises(NotImplementedError):
        render(*gs, cam, cfg)
    with torch.no_grad():
        img = render(*gs, cam, cfg).image
    assert np.isfinite(img.cpu().numpy()).all()
