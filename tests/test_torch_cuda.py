"""The CUDA kernels on the card against their plain PyTorch versions: the
blend kernels, the render's gradients through them (bitwise reproducible
over two calls) and one train step; the probes P1-P4 of the bench
entry points. Marked `gpu`: every test skips without a CUDA device. This
file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from frosting_tpu_torch.bench import perf_scan_variants as ps
from frosting_tpu_torch.bench import perf_vpu_dtype as pv
from frosting_tpu_torch.bench.common import bench_scene, graph_ms
from frosting_tpu_torch.cameras import look_at_camera
from frosting_tpu_torch.raster import RasterConfig
from frosting_tpu_torch.raster import blend_cuda
from frosting_tpu_torch.raster.binning import bin_gaussians
from frosting_tpu_torch.raster.blend_torch import (
    blend_backward_torch,
    blend_forward_torch,
)
from frosting_tpu_torch.raster.preprocess import pack_fields, preprocess
from frosting_tpu_torch.raster.render import BlendFunction, render
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


def test_render_gradients_are_bitwise_reproducible(cuda):
    """tests/test_determinism.py's property of the JAX package on the card:
    two calls give bitwise-equal gradients of all five inputs. bench.py's
    scene at 512x512 puts each Gaussian in several tiles, so a sum of its
    instance rows with float atomics (index_add_) varies between calls."""
    gs = [torch.from_numpy(a).to(cuda) for a in bench_scene(100_000, 0, -0.7, 0.7, 0.008, 0.04)]
    cam = look_at_camera(eye=[0.0, 0.0, -3.0], target=[0, 0, 0], device=cuda)
    cfg = RasterConfig(width=512, height=512, max_instances=1 << 21)
    target = torch.rand((3, 512, 512), generator=torch.Generator(device=cuda).manual_seed(1),
                        device=cuda)

    def grads():
        leaves = [t.clone().requires_grad_(True) for t in gs]
        out = render(*leaves, cam, cfg)
        loss = torch.mean((out.image - target) ** 2) + 0.1 * torch.mean(out.t_final)
        return torch.autograd.grad(loss, leaves)

    for a, b in zip(grads(), grads()):
        assert torch.equal(a, b)


def _bf16_ulp(v):
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126))) - 7)


@pytest.mark.parametrize("shape", [pv.SHAPE, (3, 334)], ids=["tpu-shape", "odd"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("probe", ["chain_fma", "chain_exp"])
def test_chain_kernels_match_plain_versions(cuda, probe, dtype, shape):
    """P1: rtol 1e-6 in float32, 1 ulp in bf16 (0.25 y is exact, so each
    step rounds once on both sides); P2: rtol 1e-5 in float32, 1e-2 in bf16
    (other exp implementations)."""
    x = pv.probe_input(pv.DTYPES[dtype], cuda, shape=shape)
    fn, plain = getattr(pv, probe), getattr(pv, probe + "_torch")
    before = fn.launches
    got = fn(x)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = plain(x).float()
    err = (got.float() - ref).abs()
    if probe == "chain_fma":
        tol = 1e-6 * ref.abs() if dtype == "f32" else _bf16_ulp(ref)
    else:
        tol = (1e-5 if dtype == "f32" else 1e-2) * ref.abs()
    assert torch.isfinite(got).all() and bool((err <= tol).all())


@pytest.mark.parametrize("lo", [0.9, ps.NONZERO_LO], ids=["tpu-input", "nonzero"])
@pytest.mark.parametrize("variant", list(ps.VARIANTS))
def test_scan_kernels_match_plain_versions(cuda, variant, lo):
    """P3 and P4 against their plain versions, which multiply in the same
    order: rtol 2e-5, values under 1e-30 held by atol 1e-30 alone; in fact
    bitwise equal."""
    for seed in (0, 1):
        x = ps.probe_input(seed, lo=lo, device=cuda)
        acc = ps.scan_reps(x, variant)
        incl, prod = ps.scan_once(x, variant)
        torch.cuda.synchronize()
        for got, ref in ((acc, ps.scan_reps_torch(x)),
                         (incl, ps.scan_once_torch(x)[0]),
                         (prod, ps.scan_once_torch(x)[1])):
            assert torch.isfinite(got).all()
            assert bool(((got - ref).abs() <= 1e-30 + 2e-5 * ref.abs()).all())
            assert torch.equal(got, ref)


def test_scan_kernels_take_any_row_count(cuda):
    x = ps.probe_input(2, lo=ps.NONZERO_LO, device=cuda)[:7].contiguous()
    assert torch.equal(ps.scan_reps(x), ps.scan_reps_torch(x))
    incl, prod = ps.scan_once(x, "scan_roll+prod_roll")
    ref_i, ref_p = ps.scan_once_torch(x)
    assert torch.equal(incl, ref_i) and torch.equal(prod, ref_p)


def test_probe_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = pv.probe_input(torch.float32, cuda, shape=(4, 8))
    with pytest.raises(TypeError):
        pv.chain_fma(x.double())
    with pytest.raises(ValueError):
        pv.chain_fma(x, out=torch.empty((4, 9), device=cuda))
    with pytest.raises(ValueError):
        pv.chain_exp(x.to(torch.bfloat16).reshape(-1)[1:])
    s = ps.probe_input(0, device=cuda)
    with pytest.raises(ValueError):
        ps.scan_reps(s[:, :64].contiguous())
    with pytest.raises(ValueError):
        ps.scan_once(s, "scan_shift+prod_tree")
    with pytest.raises(ValueError):
        ps.scan_reps(s, out=torch.empty((512, 1)))


def test_probe_launches_replay_in_a_cuda_graph(cuda):
    x = pv.probe_input(torch.float32, cuda)
    out = torch.empty_like(x)
    ms = graph_ms(lambda: pv.chain_fma(x, out), iters=10, repeats=2)
    assert 0 < ms < 10
    assert torch.equal(out, pv.chain_fma_torch(x))
    floor = graph_ms(lambda: ps.empty_launch(cuda), iters=10, repeats=2)
    assert 0 < floor < ms
