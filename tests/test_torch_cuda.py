"""The CUDA kernels on the card against their plain PyTorch versions: the
blend kernels, the render's gradients through them (bitwise reproducible
over two calls) and one train step; the probes P1-P4 of the bench
entry points; the stage-2 path: the exact KNN against its CPU result, B2
on a depth render's inputs and one SuGaR step; the stage-3 path: the mesh
rasterizer, the query KNN, marching tetrahedra, the Poisson solve (its
indicator bitwise equal over two runs) and a small extract_shell, each on
the card against the CPU. Marked `gpu`: every test skips without a CUDA device. This
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
from frosting_tpu_torch.extract import marching, poisson
from frosting_tpu_torch.extract import shell as shell_lib
from frosting_tpu_torch.models import sugar as sugar_lib
from frosting_tpu_torch.ops import knn as knn_lib
from frosting_tpu_torch.ops import mesh_raster
from frosting_tpu_torch.raster import RasterConfig
from frosting_tpu_torch.raster import blend_cuda
from frosting_tpu_torch.raster.binning import bin_gaussians
from frosting_tpu_torch.raster.blend_torch import (
    blend_backward_torch,
    blend_forward_torch,
)
from frosting_tpu_torch.raster.preprocess import pack_fields, preprocess
from frosting_tpu_torch.raster.render import BlendFunction, render
from frosting_tpu_torch.scene import gaussians as gauss_lib
from frosting_tpu_torch.scene import synthetic
from frosting_tpu_torch.scene.synthetic import (
    adversarial_blend_inputs,
    gaussian_blob_scene,
)
from frosting_tpu_torch.train import gs_trainer, sugar_trainer
from frosting_tpu_torch.train import optimizer as opt_lib

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


@pytest.mark.parametrize("rows", [1, 7, 129, 513])
def test_scan_kernels_take_rows_off_the_grid(cuda, rows):
    """Row counts that fill neither P3's blocks of one row nor P4's warps of
    32 / ONCE_LANES rows evenly, every variant, bitwise."""
    x = np.random.default_rng(rows).uniform(ps.NONZERO_LO, 1.0, (rows, ps.K))
    x = torch.from_numpy(x.astype(np.float32)).to(cuda)
    ref_acc = ps.scan_reps_torch(x)
    ref_incl, ref_prod = ps.scan_once_torch(x)
    for variant in ps.VARIANTS:
        acc = ps.scan_reps(x, variant, out=torch.full((rows, 1), np.nan, device=cuda))
        incl, prod = ps.scan_once(x, variant, incl=torch.full_like(x, np.nan),
                                  prod=torch.full((rows, 1), np.nan, device=cuda))
        torch.cuda.synchronize()
        assert torch.equal(acc, ref_acc), variant
        assert torch.equal(incl, ref_incl) and torch.equal(prod, ref_prod), variant


def test_scan_rounds_kernel_is_bitwise_reproducible(cuda):
    """Two launches of P3 give the same bits, in every variant: the 30
    rounds run in parallel, but their products are added in round order."""
    x = ps.probe_input(3, lo=ps.NONZERO_LO, device=cuda)
    for variant in ps.VARIANTS:
        first = ps.scan_reps(x, variant)
        second = ps.scan_reps(x, variant)
        torch.cuda.synchronize()
        assert torch.equal(first, second), variant


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


def test_knn_on_the_card_equals_the_cpu(cuda):
    """The same float32 operations on both devices: equal distances, equal
    indices where the k-th and (k+1)-th distances do not tie."""
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.normal(0, 0.02, (15_000, 3)),
                          rng.uniform(-2, 2, (5_000, 3))]).astype(np.float32)
    valid = rng.uniform(size=len(pts)) > 0.1
    cpu = knn_lib.knn(torch.from_numpy(pts), 16, torch.from_numpy(valid))
    gpu = knn_lib.knn(torch.from_numpy(pts).to(cuda), 16, torch.from_numpy(valid).to(cuda))
    live = torch.from_numpy(np.nonzero(valid)[0])
    d_cpu, d_gpu = cpu[1][live], gpu[1].cpu()[live]
    assert torch.equal(d_cpu, d_gpu)
    distinct = (d_cpu[:, 1:] != d_cpu[:, :-1]).all(1)
    assert torch.equal(cpu[0][live][distinct], gpu[0].cpu()[live][distinct])
    assert bool(torch.from_numpy(valid)[gpu[0].cpu()[live]].all())


def _sugar_setup(cuda, n=3_000, size=(160, 120)):
    rcfg = RasterConfig(width=size[0], height=size[1], max_instances=1 << 20)
    arrays = bench_scene(n, 3, -0.7, 0.7, 0.01, 0.05)
    means, scales, quats, opac, sh = arrays
    params = gauss_lib.params_from_numpy({
        "means3d": means, "sh_dc": sh[:, :1], "sh_rest": sh[:, 1:],
        "scales_log": np.log(scales), "quats_raw": quats,
        "opacities_raw": np.log(opac / (1 - opac)), "mask": np.ones(n, np.float32),
    }, device=cuda)
    cam = look_at_camera(eye=[0.3, -2.6, 1.0], target=[0, 0, 0], up=(0, 0, 1), device=cuda)
    return params, cam, rcfg


def test_backward_kernel_on_a_depth_render(cuda):
    """B2 on a dn_consistency depth render's inputs (colours 2-4, a
    transmittance cotangent through depth / acc at every covered pixel):
    against the plain version in float64 it is at most twice as far off
    as the plain float32 version (chip_smoke.py compare_backward_float64:
    the suffix trick's float32 rounding grows with the colours), and it
    holds chip_smoke.py's limits against the plain float32 version."""
    params, cam, rcfg = _sugar_setup(cuda)
    means, scales, quats, opac, _sh = (t.detach() for t in gauss_lib.activate(params))
    depth_colors, normals = sugar_lib.depth_normal_colors(means, scales, quats, cam)
    no_sh = torch.zeros_like(means[:, None])
    proj = preprocess(means, scales, quats, opac, no_sh, cam, rcfg, colors_precomp=depth_colors)
    fields = pack_fields(proj)
    binned = bin_gaussians(proj.rect, proj.depths, proj.valid, rcfg)
    out = blend_cuda.blend_forward(fields, binned, rcfg).requires_grad_(True)
    normal_img = render(means, scales, quats, opac, no_sh, cam, rcfg, colors_precomp=normals).image
    acc = 1.0 - out[3]
    loss = sugar_lib.dn_consistency_loss(
        out[0] / acc.clamp_min(1e-6), normal_img / acc.clamp_min(1e-6)[None], acc, cam, rcfg)
    (g,) = torch.autograd.grad(loss, out)
    out = out.detach()
    assert int((g[3] != 0).sum()) > 0
    rows = blend_cuda.blend_backward(fields, binned, rcfg, out, g)
    plain = blend_backward_torch(fields, binned, rcfg, out, g)
    f64 = fields.double()
    ref = blend_backward_torch(f64, binned, rcfg, blend_forward_torch(f64, binned, rcfg), g.double())
    scale = ref.abs().amax(0).clamp_min(1e-30)

    def off(x):
        err = (x.double() - ref).abs() / scale
        return int((err > 1e-5 + 1e-5 * ref.abs() / scale).sum()), err.max().item()

    (k_off, k_max), (p_off, p_max) = off(rows), off(plain)
    assert k_off <= max(2 * p_off, 1e-5 * rows.numel(), 18), (k_off, p_off)
    assert k_max <= 2 * max(p_max, 1e-5), (k_max, p_max)
    # and against the plain float32 walk, chip_smoke.py's limits
    pscale = plain.abs().amax(0).clamp_min(1e-30)
    err = (rows - plain).abs() / pscale
    o_off = int((err > 1e-5 + 1e-5 * plain.abs() / pscale).sum())
    assert o_off <= 4.2e-4 * rows.numel() and err.max().item() <= 2.8e-4, (o_off, err.max())


def test_one_sugar_step_on_the_card(cuda):
    """A dn_consistency step in the sdf phase (B1 and B2 on the colour,
    depth and normal renders), with the same draws on the card and on the
    CPU: the same loss to 1e-4, and the same updated parameters under the
    rule of tests/test_torch_sugar_step.py (a first Adam step is lr *
    sign(g), so an element whose gradient is round-off may move +-lr
    apart: all but 1% of each group agree to 1e-5 + 1e-4 relative, none by
    more than two learning rates)."""
    params, cam, rcfg = _sugar_setup(cuda)
    cfg = sugar_trainer.SugarTrainConfig(method="dn_consistency", n_sdf_samples=4096)
    gt = torch.rand((3, rcfg.height, rcfg.width), generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    draws = (torch.rand(4096, generator=gen), torch.randn((4096, 3), generator=gen))
    results = []
    for dev in ("cpu", cuda):
        p = gauss_lib.GaussianParams(**{
            k: v.detach().to(dev, copy=True) for k, v in vars(params).items()})
        opt = opt_lib.make_gs_optimizer(3.0)
        state = opt.init(p)
        knn_idx = sugar_trainer.compute_knn(p, cfg.knn_k)
        launches = blend_cuda.blend_backward.launches
        m = sugar_trainer.train_step(
            p, state, cam.to(dev), gt.to(dev), knn_idx, opt, rcfg, cfg, 3, "sdf",
            draws=tuple(t.to(dev) for t in draws))
        if dev != "cpu":
            assert blend_cuda.blend_backward.launches == launches + 3
        results.append((float(m["loss"]), p))
    (l_cpu, p_cpu), (l_gpu, p_gpu) = results
    assert np.isfinite(l_gpu) and abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    lrs = {"means3d": 1.6e-4 * 3.0, "sh_dc": 2.5e-3, "sh_rest": 2.5e-3 / 20,
           "opacities_raw": 0.05, "scales_log": 5e-3, "quats_raw": 1e-3}
    for g in opt_lib.GROUPS:
        got, want = getattr(p_gpu, g).cpu(), getattr(p_cpu, g)
        err = (got - want).abs()
        off = err > 1e-5 + 1e-4 * want.abs()
        assert off.float().mean().item() <= 0.01, (g, int(off.sum()))
        assert err.max().item() <= 2 * lrs[g] + 1e-6, (g, err.max().item())


def _sphere_mesh(n=4000, seed=0):
    """A closed mesh near the unit sphere: marching tetrahedra of a noisy
    radial field (on the CPU)."""
    rng = np.random.default_rng(seed)
    lin = np.linspace(-1.3, 1.3, 41)
    g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), -1)
    field = (1.0 - np.linalg.norm(g, axis=-1) + 0.02 * rng.normal(size=g.shape[:3]))
    return torch.from_numpy(field.astype(np.float32)), (-1.3,) * 3, (2.6 / 40,) * 3


def test_marching_and_mesh_raster_on_the_card_equal_the_cpu(cuda):
    """marching_tets: faces equal and verts to 1e-12; rasterize_mesh of that
    mesh at an odd size: pix_to_face equal on all but 0.1% of the pixels,
    zbuf and bary to 1e-5 where the faces agree."""
    grid, origin, spacing = _sphere_mesh()
    v_cpu, f_cpu = marching.marching_tets(grid, 0.0, origin, spacing, max_slab_cubes=40_000)
    v_gpu, f_gpu = marching.marching_tets(grid.to(cuda), 0.0, origin, spacing,
                                          max_slab_cubes=40_000)
    assert torch.equal(f_gpu.cpu(), f_cpu)
    assert (v_gpu.cpu() - v_cpu).abs().max().item() <= 1e-12
    cfg = RasterConfig(width=333, height=197, max_instances=1 << 20)
    frags = []
    for dev in ("cpu", cuda):
        cam = look_at_camera(eye=[0.4, -2.2, 1.0], target=[0, 0, 0], up=(0, 0, 1), device=dev)
        frags.append(mesh_raster.rasterize_mesh(v_cpu.float().to(dev), f_cpu.to(dev), cam, cfg))
    (c, g) = frags
    pf_c, pf_g = c.pix_to_face, g.pix_to_face.cpu()
    assert (pf_c != pf_g).float().mean().item() <= 1e-3
    both = (pf_c == pf_g) & (pf_c >= 0)
    assert both.float().mean().item() > 0.2
    assert (c.zbuf[both] - g.zbuf.cpu()[both]).abs().max().item() <= 1e-5
    assert (c.bary[both] - g.bary.cpu()[both]).abs().max().item() <= 1e-5


def test_poisson_on_the_card_is_bitwise_reproducible(cuda):
    """Two solves on the card give a bitwise-equal indicator (the splat sums
    in a fixed order); it agrees with the CPU's to 1e-4 of its largest
    magnitude, the iso level to 1e-5."""
    rng = np.random.default_rng(0)
    d = rng.normal(size=(200_000, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = torch.from_numpy((d * 0.8 + 0.005 * rng.normal(size=d.shape)).astype(np.float32))
    p01, _lo, _hi = poisson.normalise(pts)
    nrm = torch.from_numpy(d.astype(np.float32))
    chi_c, iso_c = poisson.poisson_grid(p01, nrm, 128)
    chi_a, iso_a = poisson.poisson_grid(p01.to(cuda), nrm.to(cuda), 128)
    chi_b, iso_b = poisson.poisson_grid(p01.to(cuda), nrm.to(cuda), 128)
    assert torch.equal(chi_a, chi_b) and torch.equal(iso_a, iso_b)
    assert (chi_a.cpu() - chi_c).abs().max().item() <= 1e-4 * chi_c.abs().max().item()
    assert abs(float(iso_a) - float(iso_c)) <= 1e-5


def test_query_knn_on_the_card_equals_the_cpu(cuda):
    rng = np.random.default_rng(2)
    refs = torch.from_numpy(rng.normal(0, 0.3, (30_000, 3)).astype(np.float32))
    q = torch.from_numpy(rng.uniform(-3, 3, (20_000, 3)).astype(np.float32))
    for radius in (None, 0.2):
        cpu = knn_lib.knn_query(q, refs, 16, radius=radius)
        gpu = knn_lib.knn_query(q.to(cuda), refs.to(cuda), 16, radius=radius)
        assert torch.equal(gpu[1].cpu(), cpu[1])
        distinct = (cpu[1][:, 1:] != cpu[1][:, :-1]).all(1)
        assert torch.equal(gpu[0].cpu()[distinct], cpu[0][distinct])


@pytest.mark.parametrize("method", ["surface", "centers", "marching"])
def test_small_extract_shell_on_the_card(cuda, method):
    """extract_shell of a 20k-Gaussian sphere from 3 views at 256x192 on the
    card against the CPU: vertex count within 2%, symmetric Chamfer
    distance within half a Poisson cell, median radius within 1%; B1
    launched once per view by the surface method."""
    from scipy.spatial import cKDTree

    rng = np.random.default_rng(0)
    n = 20_000
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    arrays = (d.astype(np.float32), np.full((n, 3), 0.02, np.float32), quats,
              np.full((n,), 0.9, np.float32))
    rcfg = RasterConfig(width=256, height=192, max_instances=1 << 22)
    cfg = shell_lib.ShellConfig(method=method, poisson_resolution=128, target_vertices=20_000,
                                marching_resolution=96)
    meshes = []
    for dev in ("cpu", cuda):
        cams = synthetic.camera_ring(n_cams=3, radius=3.5, device=dev)
        launches = blend_cuda.blend_forward.launches
        v, f, _aux = shell_lib.extract_shell(
            *(torch.from_numpy(a).to(dev) for a in arrays), cams, rcfg, cfg)
        if dev != "cpu" and method == "surface":
            assert blend_cuda.blend_forward.launches == launches + 3
        meshes.append(v)
    (v_c, v_g) = meshes
    assert np.isfinite(v_g).all() and len(v_c) > 1000
    assert abs(len(v_g) - len(v_c)) <= 0.02 * len(v_c)
    chamfer = (cKDTree(v_c).query(v_g)[0].mean() + cKDTree(v_g).query(v_c)[0].mean()) / 2
    assert chamfer <= 0.5 * 2.6 / 127, chamfer
    r_c, r_g = (np.median(np.linalg.norm(v, axis=1)) for v in meshes)
    assert abs(r_g - r_c) <= 0.01 * r_c
