"""The CUDA blend kernels on the card against their plain PyTorch versions,
the render's gradients through them, and one train step. Marked `gpu`: every
test skips without a CUDA device. This file imports no JAX, so it also runs
on a machine without it:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from frosting_tpu_torch.cameras import look_at_camera
from frosting_tpu_torch.raster import RasterConfig
from frosting_tpu_torch.raster import blend_cuda
from frosting_tpu_torch.raster.binning import bin_gaussians
from frosting_tpu_torch.raster.blend_torch import (
    blend_backward_torch,
    blend_forward_torch,
)
from frosting_tpu_torch.raster.preprocess import pack_fields, preprocess
from frosting_tpu_torch.raster.render import BlendFunction
from frosting_tpu_torch.scene import synthetic
from frosting_tpu_torch.scene.synthetic import (
    adversarial_blend_inputs,
    gaussian_blob_scene,
)
from frosting_tpu_torch.train import gs_trainer

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


def _assert_rows_match(rows, ref):
    """B2's rows against the plain version's, each column normalised by its
    largest magnitude: the kernel sums each instance's pixels in another
    order, and a pixel on the stop threshold may stop one Gaussian apart,
    which moves one pixel's term of one or two instances (18 values) by any
    amount. So at most 1e-5 of the values, or 18 where that is more, may be
    past atol/rtol 1e-5 (chip_smoke.py BWD_OFF_SHARE, BWD_OFF_MIN)."""
    assert rows.shape == ref.shape
    assert torch.isfinite(rows).all()
    scale = ref.abs().amax(dim=0).clamp_min(1e-30)
    err = (rows - ref).abs() / scale
    off = int((err > 1e-5 + 1e-5 * ref.abs() / scale).sum())
    assert off <= max(1e-5 * err.numel(), 18), off


def _cotangent(out, seed=0):
    gen = torch.Generator(device=out.device).manual_seed(seed)
    return torch.randn(out.shape, generator=gen, device=out.device)


@pytest.mark.parametrize("size", [(256, 256), (333, 197)], ids=["256", "333x197"])
def test_backward_kernel_matches_plain_version(cuda, size):
    fields, binned, cfg = _inputs(cuda, *size, n=20_000)
    out = blend_cuda.blend_forward(fields, binned, cfg)
    g = _cotangent(out)
    before = blend_cuda.blend_backward.launches
    rows = blend_cuda.blend_backward(fields, binned, cfg, out, g)
    torch.cuda.synchronize()
    assert blend_cuda.blend_backward.launches == before + 1
    ref = blend_backward_torch(fields, binned, cfg, out, g)
    assert rows.shape == (binned.inst_gauss.shape[0], 9)
    _assert_rows_match(rows, ref)


def test_backward_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    fields, binned, cfg = _inputs(cuda, 64, 64, n=500)
    out = blend_cuda.blend_forward(fields, binned, cfg)
    g = _cotangent(out)
    with pytest.raises(TypeError):
        blend_cuda.blend_backward(fields, binned, cfg, out, g.double())
    with pytest.raises(ValueError):
        blend_cuda.blend_backward(fields, binned, cfg, out[:, :32], g)
    with pytest.raises(ValueError):
        blend_cuda.blend_backward(fields, binned, cfg, out, g.cpu())
    with pytest.raises(ValueError):
        blend_cuda.blend_backward(
            fields, binned, cfg, out, g.transpose(1, 2).contiguous().transpose(1, 2)
        )


def _hard_inputs(cuda, kind):
    if kind == "adversarial":
        return adversarial_blend_inputs(seed=0, device=cuda)
    if kind == "deep":
        # 60k low-opacity Gaussians seen from inside the cloud: runs of
        # thousands of instances per tile, few pixels stop early
        gs = list(gaussian_blob_scene(n=60_000, seed=3, device=cuda))
        gs[3] = gs[3] * 0.05
        cam = look_at_camera(eye=[0.2, -1.2, 0.3], target=[0, 0, 0], up=(0, 0, 1),
                             device=cuda)
        cfg = RasterConfig(width=160, height=96, max_instances=1 << 22)
    else:  # an odd size: partial tiles on both edges
        gs = gaussian_blob_scene(n=8_000, seed=4, device=cuda)
        cam = look_at_camera(eye=[0.3, -2.6, 1.0], target=[0, 0, 0], up=(0, 0, 1),
                             device=cuda)
        cfg = RasterConfig(width=97, height=61, max_instances=1 << 22)
    proj = preprocess(*gs, cam, cfg)
    binned = bin_gaussians(proj.rect, proj.depths, proj.valid, cfg)
    return pack_fields(proj), binned, cfg


@pytest.mark.parametrize("kind", ["adversarial", "deep", "odd"])
def test_kernels_match_plain_versions_on_hard_inputs(cuda, kind):
    """Footprint boxes past the tile, degenerate conics, needles whose det
    cancels in float32, opacities at the cutoff, runs of over 10k
    instances, partial tiles: B1 and B2 against
    their plain versions, and B2 bitwise equal to itself."""
    fields, binned, cfg = _hard_inputs(cuda, kind)
    if kind != "odd":
        lens = binned.tile_ranges[:, 1] - binned.tile_ranges[:, 0]
        assert int(lens.max()) > 1000
    out = blend_cuda.blend_forward(fields, binned, cfg)
    torch.cuda.synchronize()
    ref = blend_forward_torch(fields, binned, cfg)
    err = (out - ref).abs()
    assert (err > 1e-5 + 1e-5 * ref.abs()).float().mean().item() <= 1e-3
    assert err.max().item() <= 1e-2 and torch.isfinite(out).all()
    g = _cotangent(out)
    rows = blend_cuda.blend_backward(fields, binned, cfg, out, g)
    again = blend_cuda.blend_backward(fields, binned, cfg, out, g)
    torch.cuda.synchronize()
    assert torch.equal(rows, again)
    _assert_rows_match(rows, blend_backward_torch(fields, binned, cfg, out, g))


def test_render_gradients_match_the_plain_versions(cuda):
    gs = gaussian_blob_scene(n=5_000, seed=2, device=cuda)
    cam = look_at_camera(eye=[0, -3, 0.5], target=[0, 0, 0], up=(0, 0, 1), device=cuda)
    cfg = RasterConfig(width=200, height=150, max_instances=1 << 20)
    target = torch.rand((3, 150, 200), generator=torch.Generator(device=cuda).manual_seed(1),
                        device=cuda)
    bg = torch.tensor([0.1, 0.2, 0.3], device=cuda)

    def grads(blend_fns):
        leaves = [t.clone().requires_grad_(True) for t in gs]
        proj = preprocess(*leaves, cam, cfg)
        out, _, _ = BlendFunction.apply(
            pack_fields(proj), proj.rect, proj.depths, proj.valid, cfg, *blend_fns
        )
        image = out[:3] + out[3][None] * bg[:, None, None]
        loss = torch.mean((image - target) ** 2) + 0.1 * torch.mean(out[3])
        return torch.autograd.grad(loss, leaves)

    got = grads((blend_cuda.blend_forward, blend_cuda.blend_backward))
    ref = grads((blend_forward_torch, blend_backward_torch))
    for a, b in zip(got, ref):
        scale = b.abs().max() + 1e-8
        assert ((a - b).abs() / scale).max().item() <= 5e-4


def test_one_train_step_on_the_card(cuda):
    rcfg = RasterConfig(width=128, height=96, max_instances=1 << 18)
    gt = gaussian_blob_scene(n=2_000, seed=0, device=cuda)
    cams = synthetic.camera_ring(n_cams=2, radius=3.0, device=cuda)
    gt_imgs = synthetic.render_gt_images(gt, cams, rcfg, np.zeros(3, np.float32))
    pts, cols = synthetic.degraded_init(gt, keep=0.5, jitter=0.03)
    cfg = gs_trainer.GSTrainConfig(capacity=2048)
    state, opt = gs_trainer.init_state(pts, cols, 3.3, cfg, device=cuda)
    before = state.params.means3d.clone()
    launches = blend_cuda.blend_backward.launches
    state, m = gs_trainer.train_step(
        state, cams[0], torch.from_numpy(gt_imgs[0]).to(cuda), opt, rcfg, cfg, 0
    )
    assert blend_cuda.blend_backward.launches == launches + 1
    assert np.isfinite(float(m["loss"])) and not bool(m["overflow"])
    assert not torch.equal(state.params.means3d, before)
    assert int(state.opt_state.count["means3d"]) == 1
