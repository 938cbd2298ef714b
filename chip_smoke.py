"""Smoke test of the PyTorch/CUDA port on one GPU.

Run from the root of the repository on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero):
  1. device: require CUDA, print `nvidia-smi` name and power limit;
  2. build: compile the blend kernels (B1, B2) and the probes (P1-P4) from
     csrc/ with nvcc, one process per source, all at once;
  3. kernels vs plain: hold the CUDA forward blend (B1) and backward blend
     (B2) against their plain PyTorch versions on the same inputs (bench.py's
     512x512 @ 100k scene, an odd 1000x600 @ 20k size with partial edge
     tiles, an adversarial scene of footprints past the tile, degenerate
     conics, needles whose float32 det cancels, opacities at the cutoff and
     a run of 12k instances), the port's render on a small scene against
     the per-pixel oracle, and the render's gradients through B1 + B2 +
     the fixed-order reduction against the same loss's gradients through
     the plain versions; two calls of those gradients must be bitwise
     equal. Every B2 check launches it twice and requires bitwise-equal
     rows;
  4. serving path at full width: scripts/bench_1080p.py's scene (1M
     Gaussians, SH degree 3, seed 0) written as gs.ply, loaded back onto the
     card and served by the port's viewer at 1920x1080: three GET /render
     and one GET /state. B1 and B2 are also held against their plain
     versions at this shape;
  5. training path at full width: that scene, rendered from 4 orbit views,
     is the ground truth; gs_trainer.train runs 40 iterations at 1920x1080
     from its jittered means (create_from_pcd, capacity 2^21), with two
     densify steps, and evaluate's PSNR must rise; the four views, re-binned
     with the final state, must not overflow;
  6. timing: B1, B2 and their plain versions at 1080p @ 1M with CUDA events,
     their bounds from this run's data, a train step broken into its parts,
     B1 and B2 held against their plain versions and timed on the step's
     own blend inputs, the per-Gaussian reduction against index_add_ (time,
     and how many values two calls of each disagree in), render gradients
     of the trained state on the step's view twice (bitwise equal), and one
     densify step;
  7. bench path: the probes P1-P4 against their plain versions (the TPU
     scripts' shapes, and for the scans also an input whose products do
     not underflow), then the port's measurement entry points at full size,
     in process: perf_vpu_dtype and perf_scan_variants (graph-replay times
     and rates, the empty-launch floor, P4's variants cross-checked),
     bench's 512x512 @ 100k and bench_1080p's 1920x1080 @ 1M (their JSON
     lines); then the probes' plain and library times and bounds, and the
     device's busy share over the bench loops (torch.profiler).
The three main paths (4, 5 and 7) reset the kernels' launch counts just
before and read them just after. The line before the last is the JSON
kernels record; the last line is {"ok": true, "device": {...}}.
"""

import dataclasses
import json
import os
import statistics
import struct
import sys
import tempfile
import time
import urllib.request
import zlib

import numpy as np
import torch

from frosting_tpu_torch import _build
from frosting_tpu_torch.bench import __main__ as bench_main
from frosting_tpu_torch.bench import bench_1080p, perf_scan_variants, perf_vpu_dtype
from frosting_tpu_torch.bench import common as bench_common
from frosting_tpu_torch.bench.common import (
    BF16X2_FLOP_S,
    FP32_FLOP_S,
    HBM_BYTES_S,
    SFU_OPS_S,
    autotuned_config,
    bench_scene,
    cuda_ms,
    graph_ms,
    smi,
    timed,
)
from frosting_tpu_torch.cameras import look_at_camera
from frosting_tpu_torch.raster import RasterConfig, render
from frosting_tpu_torch.raster import blend_cuda
from frosting_tpu_torch.raster.binning import bin_gaussians
from frosting_tpu_torch.raster.blend_torch import (
    blend_backward_torch,
    blend_forward_torch,
    blend_work_torch,
)
from frosting_tpu_torch.raster.preprocess import pack_fields, preprocess
from frosting_tpu_torch.raster.reference import render_naive
from frosting_tpu_torch.raster.render import (
    BlendFunction,
    autotune_max_instances,
    count_instances,
    sum_rows_by_gaussian,
)
from frosting_tpu_torch.ops.ssim import l1_loss, ssim
from frosting_tpu_torch.scene import gaussians as gauss_lib
from frosting_tpu_torch.scene import synthetic
from frosting_tpu_torch.scene.synthetic import adversarial_blend_inputs
from frosting_tpu_torch.train import gs_trainer
from frosting_tpu_torch.train import optimizer as opt_lib
from frosting_tpu_torch.utils import viewer

# The card's peak rates are in frosting_tpu_torch/bench/common.py.
# Per evaluated (instance, pixel) pair the forward blend needs at least dx,
# dy, the quadratic form (9 flops) and op * exp: 12 FP32 flops and one exp.
# The backward adds about 30 flops (T, u, dalpha, the nine terms) and one
# reciprocal 1 / (1 - alpha) on the SFU.
FLOPS_PER_PAIR, SFU_PER_PAIR = 12, 1
FLOPS_PER_PAIR_BWD, SFU_PER_PAIR_BWD = 42, 2
# Kernel vs plain tolerance: atol/rtol 1e-5; at most 0.1% of values may
# differ by a stop-threshold flip (T * (1 - alpha) on the 1e-4 stop, where
# the two sum in another order). A forward flip moves a pixel by at most
# alpha * T <= 1e-2. A backward value is a sum over the tile's pixels, so it
# is compared normalised by its column's largest magnitude; a flip there
# moves one pixel's term of one or two instances (18 values), which has no
# small bound, so far fewer may be off: 1e-5 of the values, or 18 where
# that is more (the runs show at most 3.3e-7).
ATOL = RTOL = 1e-5
FLIP_SHARE, FLIP_BOUND = 1e-3, 1e-2
BWD_OFF_SHARE, BWD_OFF_MIN = 1e-5, 18
# Render gradients, kernels vs plain, normalised by the largest magnitude:
# the render-vs-oracle gradient tolerance of tests/test_raster.py.
GRAD_ATOL = 5e-4
GRAD_NAMES = ("means3d", "scales", "quats", "opacities", "sh")
MAIN_W, MAIN_H, MAIN_N = 1920, 1080, 1_000_000
ORBITS = ((0.0, 0.3), (2.1, 0.2), (4.2, 0.45))  # (azimuth, elevation)
ORBIT_R = 3.5
# Training: 4 views on the same orbit, 40 iterations (SH degree up every 10,
# densify at 20 and 30, size prune at 30, opacity reset past the run).
TRAIN_ORBITS = ((0.5, 0.25), (2.0, 0.4), (3.6, 0.15), (5.1, 0.35))
TRAIN_ITERS = 40
TRAIN_CAPACITY = 1 << 21
TRAIN_JITTER = 0.003  # world units; the scene's scales are 0.003-0.015
# 3DGS sets it to 1.1 x the cameras' largest distance from their centre
TRAIN_EXTENT = 1.1 * ORBIT_R
DEV = "cuda"


def log(*a):
    print(*a, flush=True)


def raw_params(arrays):
    """bench_scene's arrays as the raw (pre-activation) parameters of
    scene/gaussians.py, numpy arrays by group."""
    means, scales, quats, opac, sh = arrays
    return {
        "means3d": means,
        "sh_dc": sh[:, :1],
        "sh_rest": sh[:, 1:],
        "scales_log": np.log(scales),
        "quats_raw": quats,
        "opacities_raw": np.log(opac / (1.0 - opac)),
        "mask": np.ones(len(means), np.float32),
    }


def serving_views(model):
    """The serving orbit's cameras and a 1920x1080 config whose
    max_instances fits their largest instance count."""
    cams = [viewer._orbit_camera(az, el, ORBIT_R, device=DEV) for az, el in ORBITS]
    probe = RasterConfig(width=MAIN_W, height=MAIN_H, max_instances=1 << 24)
    counts = [count_instances(*model, c, probe) for c in cams]
    cap = autotune_max_instances(max(counts), 128, safety=1.25)
    log(f"instances per view {counts}, max_instances {cap}")
    return cams, RasterConfig(width=MAIN_W, height=MAIN_H, chunk=128, max_instances=cap)


def on_card(arrays):
    return tuple(torch.from_numpy(a).to(DEV) for a in arrays)


def blend_inputs(gs, cam, cfg):
    proj = preprocess(*gs, cam, cfg)
    return pack_fields(proj), bin_gaussians(proj.rect, proj.depths, proj.valid, cfg)


def compare(label, fields, binned, cfg):
    """Kernel vs plain version on the same inputs; returns max abs error."""
    before = blend_cuda.blend_forward.launches
    out = blend_cuda.blend_forward(fields, binned, cfg)
    torch.cuda.synchronize()
    if blend_cuda.blend_forward.launches != before + 1:
        raise AssertionError(f"{label}: the kernel's launch count did not rise")
    ref = blend_forward_torch(fields, binned, cfg)
    err = (out - ref).abs()
    off = (err > ATOL + RTOL * ref.abs()).float().mean().item()
    max_err = err.max().item()
    log(f"{label}: instances {int(binned.num_instances)} max_abs_err {max_err:.3e} "
        f"share_off_tol {off:.2e}")
    if not torch.isfinite(out).all():
        raise AssertionError(f"{label}: kernel output not finite")
    if off > FLIP_SHARE or max_err > FLIP_BOUND:
        raise AssertionError(f"{label}: kernel disagrees with the plain version")
    return max_err


def compare_backward(label, fields, binned, cfg, plain_chunk=None, g=None):
    """B2 vs its plain version on the same inputs (B1's output and the
    cotangent g, by default a seeded one with colour and T parts); two
    launches must give bitwise-equal rows. Returns max abs error."""
    out = blend_cuda.blend_forward(fields, binned, cfg)
    if g is None:
        gen = torch.Generator(device=DEV).manual_seed(0)
        g = torch.randn(out.shape, generator=gen, device=DEV)
    before = blend_cuda.blend_backward.launches
    rows = blend_cuda.blend_backward(fields, binned, cfg, out, g)
    again = blend_cuda.blend_backward(fields, binned, cfg, out, g)
    torch.cuda.synchronize()
    if blend_cuda.blend_backward.launches != before + 2:
        raise AssertionError(f"{label}: the backward kernel's count did not rise")
    if not torch.equal(rows, again):
        raise AssertionError(f"{label}: two backward launches differ")
    del again
    plain_cfg = dataclasses.replace(cfg, chunk=plain_chunk or cfg.chunk)
    ref = blend_backward_torch(fields, binned, plain_cfg, out, g)
    if not torch.isfinite(rows).all():
        raise AssertionError(f"{label}: backward kernel output not finite")
    scale = ref.abs().amax(dim=0).clamp_min(1e-30)  # per gradient column
    err = (rows - ref).abs()
    off = int((err / scale > ATOL + RTOL * ref.abs() / scale).sum())
    max_err = err.max().item()
    log(f"{label} backward: rows {rows.shape[0]} max_abs_err {max_err:.3e} "
        f"max_normalised_err {(err / scale).max().item():.3e} "
        f"off_tol {off} of {err.numel()}; two launches bitwise equal")
    if off > max(BWD_OFF_SHARE * err.numel(), BWD_OFF_MIN):
        raise AssertionError(f"{label}: backward kernel disagrees with the plain version")
    return max_err


def render_grads(gs, cam, cfg, loss_of, bg=None):
    """Gradients of loss_of(image, t_final) of the port's render in its
    five inputs (B1 + B2 + the fixed-order reduction, then autograd)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in gs]
    out = render(*leaves, cam, cfg, bg=bg)
    return torch.autograd.grad(loss_of(out.image, out.t_final), leaves)


def reproducible_grads(label, gs, cam, cfg, loss_of, bg=None):
    """render_grads twice: every gradient must be bitwise equal over the two
    calls (tests/test_determinism.py's property of the JAX package).
    Returns the first call's gradients."""
    first = render_grads(gs, cam, cfg, loss_of, bg)
    second = render_grads(gs, cam, cfg, loss_of, bg)
    for name, a, b in zip(GRAD_NAMES, first, second):
        if not torch.equal(a, b):
            n_diff = int((a != b).sum())
            raise AssertionError(
                f"{label}: two calls give render gradients of {name} that differ "
                f"in {n_diff} of {a.numel()} values")
    log(f"{label}: render gradients of {', '.join(GRAD_NAMES)} bitwise equal "
        "over two calls")
    return first


def phase_render_gradients(gs, cam, cfg):
    """The render's gradients on the card (B1 + B2 + the fixed-order
    reduction), bitwise equal over two calls, against the same loss's
    gradients through the plain blend versions."""
    gen = torch.Generator(device=DEV).manual_seed(1)
    target = torch.rand((3, cfg.height, cfg.width), generator=gen, device=DEV)
    bg = torch.tensor([0.1, 0.2, 0.3], device=DEV)

    def loss_of(image, t_final):
        return torch.mean((image - target) ** 2) + 0.1 * torch.mean(t_final)

    got = reproducible_grads("512x512 @ 100k", gs, cam, cfg, loss_of, bg)

    leaves = [t.clone().requires_grad_(True) for t in gs]
    proj = preprocess(*leaves, cam, cfg)
    out4, _, _ = BlendFunction.apply(
        pack_fields(proj), proj.rect, proj.depths, proj.valid, cfg,
        blend_forward_torch, blend_backward_torch,
    )
    image = out4[:3] + out4[3][None] * bg[:, None, None]
    ref = torch.autograd.grad(loss_of(image, out4[3]), leaves)
    for name, a, b in zip(GRAD_NAMES, got, ref):
        scale = b.abs().max().item()
        err = (a - b).abs().max().item() / max(scale, 1e-30)
        log(f"render gradient {name}: max normalised err {err:.3e} (max |grad| {scale:.3e})")
        if not (scale > 0 and err <= GRAD_ATOL and torch.isfinite(a).all()):
            raise AssertionError(f"render gradient of {name} disagrees with the plain versions")


def decode_png(data):
    """8-bit RGB PNG with filter 0 rows (the port's encoder) -> [H, W, 3]."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = ihdr[:2]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    return rows[:, 1:].reshape(h, w, 3)


def get(base, path):
    with urllib.request.urlopen(base + path, timeout=300) as r:
        return r.status, r.read()


def phase_small_reference():
    """The port's render on the card against the per-pixel oracle."""
    arrays = bench_scene(300, 7, -0.8, 0.8, 0.02, 0.12)
    gs = on_card(arrays)
    cam = look_at_camera(eye=[0.2, -0.3, -2.8], target=[0, 0, 0], device=DEV)
    cfg = RasterConfig(width=96, height=80, max_instances=1 << 16)
    bg = torch.tensor([0.1, 0.2, 0.3], device=DEV)
    with torch.inference_mode():
        out = render(*gs, cam, cfg, bg=bg)
        img_n, t_n = render_naive(preprocess(*gs, cam, cfg), bg, cfg)
    err = max((out.image - img_n).abs().max().item(),
              (out.t_final - t_n).abs().max().item())
    log(f"small reference 96x80 @ 300: max_abs_err vs oracle {err:.3e}")
    if err > FLIP_BOUND or not torch.isfinite(out.image).all():
        raise AssertionError("render disagrees with the per-pixel oracle")


class Timer:
    """CUDA events recorded between the parts of one run; ms per part."""

    def __init__(self):
        self.marks = []

    def mark(self, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev))

    def parts(self):
        self.marks[-1][1].synchronize()
        return {
            name: a.elapsed_time(b)
            for (_, a), (name, b) in zip(self.marks, self.marks[1:])
        }


def step_breakdown(state, opt, cam, gt, rcfg, tcfg, reps):
    """A train step at full SH degree, cut where the trainer's render and
    loss pass from one part to the next (the same calls as
    gs_trainer.train_step), with CUDA events between the parts. Returns the
    median ms of each part over reps runs, after one warm-up run, and the
    last run's blend inputs (fields, binned, out, g_out)."""
    bg = torch.zeros(3, device=DEV)
    runs = []
    for _ in range(reps + 1):
        p = state.params
        leaves = {g: getattr(p, g).detach().requires_grad_(True) for g in opt_lib.GROUPS}
        probe = torch.zeros((p.capacity, 2), device=DEV, requires_grad=True)
        t = Timer()
        t.mark("start")
        model = gauss_lib.activate(dataclasses.replace(p, **leaves))
        proj = preprocess(*model, cam, rcfg)
        proj = proj._replace(means2d=proj.means2d + probe)
        fields = pack_fields(proj)
        t.mark("preprocess")
        binned = bin_gaussians(proj.rect, proj.depths, proj.valid, rcfg)
        t.mark("binning")
        out = blend_cuda.blend_forward(fields.detach(), binned, rcfg)
        t.mark("blend_forward (B1)")
        out_leaf = out.requires_grad_(True)
        image = out_leaf[:3] + out_leaf[3][None] * bg[:, None, None]
        loss = (1.0 - tcfg.lambda_dssim) * l1_loss(image, gt) + (
            tcfg.lambda_dssim * (1.0 - ssim(image, gt)))
        (g_out,) = torch.autograd.grad(loss, out_leaf)
        t.mark("loss + SSIM, forward and backward")
        rows = blend_cuda.blend_backward(fields.detach(), binned, rcfg, out.detach(),
                                         g_out.contiguous())
        t.mark("blend_backward (B2)")
        dfields = sum_rows_by_gaussian(rows, binned.inst_gauss, fields.shape[0])
        t.mark("reduction (sorted segment sum)")
        *grads, _ = torch.autograd.grad(
            fields, [leaves[g] for g in opt_lib.GROUPS] + [probe], dfields)
        t.mark("preprocess backward")
        opt.step(p, dict(zip(opt_lib.GROUPS, grads)), state.opt_state,
                 torch.isfinite(loss.detach()))
        t.mark("Adam")
        runs.append(t.parts())
    runs = runs[1:]
    parts = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    return parts, (fields.detach(), binned, out.detach(), g_out.contiguous())


def phase_training(model, rcfg):
    """The training main path: gs_trainer.train at full width. Returns
    (state, cameras, ground truth, train config, launches per kernel)."""
    cams = [viewer._orbit_camera(az, el, ORBIT_R, device=DEV) for az, el in TRAIN_ORBITS]
    with torch.inference_mode():
        gt_imgs = np.stack([
            render(*model, c, rcfg).image.cpu().numpy() for c in cams
        ])
    pts, cols = synthetic.degraded_init(model, keep=1.0, jitter=TRAIN_JITTER, seed=1)
    tcfg = gs_trainer.GSTrainConfig(
        iterations=TRAIN_ITERS,
        capacity=TRAIN_CAPACITY,
        sh_increase_interval=10,
        densify_from=20,
        densify_until=31,
        densification_interval=10,
        size_threshold_from=25,
        # the reference's 20 px is for ~1000 px wide training images; scaled
        # to 1920 px, so that the isotropic init's own radii (~20 px near the
        # cameras) are not pruned wholesale
        max_screen_size=40.0,
        opacity_reset_interval=10 * TRAIN_ITERS,
        log_every=10,
    )
    t0 = time.time()
    init, _ = gs_trainer.init_state(pts, cols, TRAIN_EXTENT, tcfg, device=DEV)
    log(f"train init: {len(pts)} points, create_from_pcd (host KNN) "
        f"{time.time() - t0:.1f} s")
    before = gs_trainer.evaluate(init, cams, gt_imgs, rcfg, tcfg)
    del init
    torch.cuda.empty_cache()

    lines = []

    def log_train(line):
        lines.append(line)
        log("  " + line)

    blend_cuda.blend_forward.launches = 0
    blend_cuda.blend_backward.launches = 0
    t0 = time.time()
    state, history = gs_trainer.train(
        cams, gt_imgs, pts, cols, TRAIN_EXTENT, rcfg, tcfg, seed=0,
        log_fn=log_train, device=DEV,
    )
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {
        "blend_forward": blend_cuda.blend_forward.launches,
        "blend_backward": blend_cuda.blend_backward.launches,
    }
    after = gs_trainer.evaluate(state, cams, gt_imgs, rcfg, tcfg)
    log(f"training: {TRAIN_ITERS} iterations at {MAIN_W}x{MAIN_H} from {len(pts)} "
        f"points in {wall:.1f} s (init included); it/s per log interval "
        f"{[round(h['iters_per_s'], 2) for h in history]}; launches {launches}")
    log(f"evaluate on the {len(cams)} views: before {before}, after {after}")
    densified = [x for x in lines if " densify " in x]
    if len(densified) < 2:
        raise AssertionError("the densify steps did not run")
    for name, n in launches.items():
        if n < TRAIN_ITERS:
            raise AssertionError(f"training launched {name} {n} times")
    if not all(np.isfinite(h["loss"]) for h in history):
        raise AssertionError("a logged loss is not finite")
    if any(h["overflow"] for h in history):
        raise AssertionError("instance overflow during training")
    # a log step's flag is its own step's: re-bin every view with the final
    # state, so that no view's overflow goes unseen
    with torch.inference_mode():
        final = gauss_lib.activate(state.params)
        for c in cams:
            proj = preprocess(*final, c, rcfg)
            if bool(bin_gaussians(proj.rect, proj.depths, proj.valid, rcfg).overflow):
                raise AssertionError("a training view overflows with the final state")
        del final, proj
    if not after["psnr"] > before["psnr"]:
        raise AssertionError("training did not raise PSNR")
    return state, cams, gt_imgs, tcfg, launches


def work(fields, binned, cfg):
    """This run's data: instances, pre-stop pairs (every pair up to each
    pixel's stop) and live pairs (at or above the 1/255 cutoff, up to and
    including the stop), and the bytes each kernel must move."""
    n_inst = int(binned.inst_gauss.numel())
    image_bytes = 4 * cfg.height * cfg.width * 4
    in_bytes = n_inst * 9 * 4 + n_inst * 4 + binned.tile_ranges.numel() * 4
    return {
        "instances": n_inst,
        "pairs": int(blend_work_torch(fields, binned, cfg)),
        "live": int(blend_work_torch(fields, binned, cfg, live=True)),
        # B1 reads each instance's fields once per tile and writes [4, H, W];
        # B2 also reads out and g_out and writes the [M, 9] rows
        "bytes_fwd": in_bytes + image_bytes,
        "bytes_bwd": in_bytes + 2 * image_bytes + n_inst * 9 * 4,
    }


def bounds(w):
    """{"live": ..., "prestop": ...} bounds of B1 and B2 for the work w, each
    (ms, "bytes" or "operations", bytes ms, operations ms)."""

    def one(bytes_moved, pairs, flops, sfu):
        b = bytes_moved / HBM_BYTES_S * 1e3
        o = max(pairs * flops / FP32_FLOP_S, pairs * sfu / SFU_OPS_S) * 1e3
        return max(b, o), ("bytes" if b > o else "operations"), b, o

    return tuple(
        {k: one(w[by], w[n], flops, sfu) for k, n in (("live", "live"), ("prestop", "pairs"))}
        for by, flops, sfu in (("bytes_fwd", FLOPS_PER_PAIR, SFU_PER_PAIR),
                               ("bytes_bwd", FLOPS_PER_PAIR_BWD, SFU_PER_PAIR_BWD))
    )


def fmt_bound(b):
    return " / ".join(
        f"{k} {v[0]:.4f} ms ({v[1]}; bytes {v[2]:.4f}, operations {v[3]:.4f})"
        for k, v in b.items())


def phase_reduction(fields, binned, cfg, out, g_out):
    """The per-Gaussian sum of B2's rows on the step's inputs: the port's
    fixed-order reduction against the index_add_ it replaced (times, how
    many values two calls of each disagree in, and their difference)."""
    rows = blend_cuda.blend_backward(fields, binned, cfg, out, g_out)
    n = fields.shape[0]

    def index_add():
        return torch.zeros((n, rows.shape[1]), device=DEV).index_add_(
            0, binned.inst_gauss.long(), rows)

    def fixed():
        return sum_rows_by_gaussian(rows, binned.inst_gauss, n)

    result = {}
    for name, fn in (("index_add_", index_add), ("sorted segment sum", fixed)):
        a, b = fn(), fn()
        result[name] = {"ms": cuda_ms(fn, 10),
                        "values_differing_over_two_calls": int((a != b).sum())}
    a, b = index_add(), fixed()
    diff = ((a - b).abs().amax(0) / b.abs().amax(0).clamp_min(1e-30)).max().item()
    log(f"reduction of {rows.shape[0]} rows into {n}: " + "; ".join(
        f"{k} {v['ms']:.4f} ms, {v['values_differing_over_two_calls']} of "
        f"{a.numel()} values differ over two calls" for k, v in result.items())
        + f"; max normalised difference between the two {diff:.3e}")
    if result["sorted segment sum"]["values_differing_over_two_calls"]:
        raise AssertionError("the fixed-order reduction is not reproducible")
    if diff > GRAD_ATOL:
        raise AssertionError("the fixed-order reduction disagrees with index_add_")
    return result


def scan_reps_library(x):
    """P3 through PyTorch's own scan and product (timed as library_ms)."""
    acc = torch.zeros((x.shape[0], 1), device=x.device)
    y = x
    for _ in range(perf_scan_variants.REPS):
        acc = acc + torch.prod(torch.cumprod(y, 1), 1, keepdim=True)
        y = y * 0.999 + 1e-4
    return acc


def scan_once_library(x):
    """P4 through torch.cumprod followed by torch.prod."""
    incl = torch.cumprod(x, 1)
    return incl, torch.prod(incl, 1, keepdim=True)


def bf16_ulp(v):
    """The spacing of bf16 values at |v| (v in float32)."""
    e = torch.floor(torch.log2(v.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def hold_probes():
    """P1-P4 against their plain versions on the TPU scripts' inputs, and
    the scans also on an input whose products stay near 0.1. Tolerances:
    the FMA chain rtol 1e-6 in float32 and 1 ulp in bf16 (0.25 y is exact,
    so both round each step once); the exp chain rtol 1e-5 in float32 and
    1e-2 in bf16 (other exp implementations; the chain contracts errors);
    the scans rtol 2e-5, values under 1e-30 held by atol 1e-30 alone (the
    order of a product decides its denormals; the kernels multiply in the
    plain versions' order, so equality is expected). Returns max abs error
    per probe and dtype / input."""
    errs = {}
    pv = perf_vpu_dtype
    for probe, fn, plain in (("chain_fma", pv.chain_fma, pv.chain_fma_torch),
                             ("chain_exp", pv.chain_exp, pv.chain_exp_torch)):
        for nm, dt in pv.DTYPES.items():
            x = pv.probe_input(dt, DEV)
            got, ref = fn(x).float(), plain(x).float()
            err = (got - ref).abs()
            if probe == "chain_fma":
                tol = 1e-6 * ref.abs() if nm == "f32" else bf16_ulp(ref)
            else:
                tol = (1e-5 if nm == "f32" else 1e-2) * ref.abs()
            errs[f"{probe}_{nm}"] = err.max().item()
            log(f"{probe}_{nm} [1024, 512]: max_abs_err {errs[f'{probe}_{nm}']:.3e}, "
                f"bitwise equal {torch.equal(got, ref)}, values in "
                f"[{ref.min().item():.6g}, {ref.max().item():.6g}]")
            if not (torch.isfinite(got).all() and (err <= tol).all()):
                raise AssertionError(f"{probe}_{nm} disagrees with its plain version")

    ps = perf_scan_variants

    def held(label, got, ref, lib):
        err = (got - ref).abs()
        lib_rel = ((lib - ref).abs() / ref.abs().clamp_min(1e-30))[ref.abs() > 1e-30]
        log(f"  {label}: max_abs_err {err.max().item():.3e}, bitwise equal "
            f"{torch.equal(got, ref)}; values in [{ref.min().item():.3e}, "
            f"{ref.max().item():.3e}]; torch.cumprod/prod differ by rel "
            f"{lib_rel.max().item() if lib_rel.numel() else 0.0:.3e}")
        if not (torch.isfinite(got).all() and (err <= 1e-30 + 2e-5 * ref.abs()).all()):
            raise AssertionError(f"{label} disagrees with its plain version")
        return err.max().item()

    for tag, lo in (("tpu", 0.9), ("nonzero", ps.NONZERO_LO)):
        # P3 on seed 0 (the TPU script's timing input), P4 on seed 1 (its
        # cross-check input)
        x = ps.probe_input(0, lo=lo, device=DEV)
        ref, lib = ps.scan_reps_torch(x), scan_reps_library(x)
        log(f"scan_reps, input uniform in [{lo}, 1) seed 0:")
        reps = {v: ps.scan_reps(x, v) for v in ps.VARIANTS}
        errs[f"scan_reps_{tag}"] = max(held(v, o, ref, lib) for v, o in reps.items())
        x = ps.probe_input(1, lo=lo, device=DEV)
        (ref_i, ref_p), (lib_i, lib_p) = ps.scan_once_torch(x), scan_once_library(x)
        log(f"scan_once, input uniform in [{lo}, 1) seed 1:")
        once = {v: ps.scan_once(x, v) for v in ps.VARIANTS}
        errs[f"scan_once_{tag}"] = max(
            max(held(v + " incl", i, ref_i, lib_i), held(v + " prod", p, ref_p, lib_p))
            for v, (i, p) in once.items())
        for outs in (list(reps.values()), [torch.cat(o, 1) for o in once.values()]):
            if not all(torch.equal(o, outs[0]) for o in outs):
                raise AssertionError("the scan variants are not bitwise equal")
    return errs


PROBE_COUNTERS = {
    "blend_forward": blend_cuda.blend_forward,
    "blend_backward": blend_cuda.blend_backward,
    "chain_fma": perf_vpu_dtype.chain_fma,
    "chain_exp": perf_vpu_dtype.chain_exp,
    "scan_reps": perf_scan_variants.scan_reps,
    "scan_once": perf_scan_variants.scan_once,
}


def phase_bench():
    """The bench main path: the port's four measurement entry points, in
    process, at their full sizes, with every kernel's launch count reset
    just before and read just after (a CUDA graph's replays re-run the
    launches captured from its wrapper calls and are not counted). Returns
    (launches, the probes' times in ms)."""
    for fn in PROBE_COUNTERS.values():
        fn.launches = 0
    times = perf_vpu_dtype.run(DEV, log=log)
    times.update(perf_scan_variants.run(DEV, log=log))
    log(json.dumps(bench_main.run(DEV)))
    log(json.dumps(bench_1080p.run(DEV, log=log)))
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in PROBE_COUNTERS.items()}
    log(f"bench path launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the bench path did not launch {name}")
    return launches, times


def device_profile(label, fn):
    """Where one call of fn spends the card's time: torch.profiler's kernel
    time (the sum of every kernel's device time) over the wall time of an
    unprofiled call (CUDA events), and the five kernels that take most.
    Returns the busy share, or None where the profiler saw no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    wall_ms = timed(fn, DEV)[0]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        log(f"{label}: the profiler saw no device time; busy share not measured")
        return None
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    log(f"{label}: wall {wall_ms:.3f} ms (unprofiled), kernels {busy_ms:.3f} ms, "
        f"device busy {busy_ms / wall_ms:.1%}, idle {1 - busy_ms / wall_ms:.1%}; "
        f"{sum(e.count for e in kernels)} kernel launches; largest: " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}" for e in top))
    return busy_ms / wall_ms


def bench_profiles():
    """Device busy share of 10 fwd+bwd and 10 fwd-only iterations of the
    bench's 512x512 @ 100k loops, and of 2 of each of bench_1080p's."""
    shares = {}
    for label, module, iters in (("512x512 @ 100k", bench_main, 10),
                                 ("1920x1080 @ 1M", bench_1080p, 2)):
        gs, cam, cfg, _ = module.setup(DEV)
        target = torch.zeros((3, cfg.height, cfg.width), device=DEV)
        shares[label] = {
            "fwd+bwd": device_profile(
                f"{label} fwd+bwd x{iters}",
                lambda: bench_common.fwd_bwd_loop(gs, cam, cfg, target, iters, 0.017)),
            "fwd": device_profile(
                f"{label} fwd-only x{iters}",
                lambda: bench_common.fwd_loop(gs, cam, cfg, iters, 0.013)),
        }
    return shares


def bound(bytes_moved, *ops_rates):
    """(ms, "bytes" or "operations"): the larger of bytes over the HBM rate
    and each (operations, rate) pair's time."""
    b = bytes_moved / HBM_BYTES_S * 1e3
    o = max(n / r for n, r in ops_rates) * 1e3
    return max(b, o), ("bytes" if b > o else "operations")


def probe_timings(errs, times, launches):
    """The probes' kernel records: kernel times from the bench path's graph
    replays (P4's timed here), plain and library times by graph replay,
    and bounds from the probes' shapes."""
    pv, ps = perf_vpu_dtype, perf_scan_variants
    recs = []
    for name, line, fn_plain, ops in (
        ("chain_fma", 64, pv.chain_fma_torch,
         lambda n, rate: ((pv.fma_flops(n), rate),)),
        ("chain_exp", 89, pv.chain_exp_torch,
         lambda n, rate: ((pv.exp_count(n), SFU_OPS_S), (pv.exp_count(n), rate))),
    ):
        rec = {"name": name, "route": "cuda",
               "source": "frosting_tpu_torch/csrc/perf_vpu_dtype.cu",
               "replaces": f"scripts/perf_vpu_dtype.py:{line}",
               "launches": launches[name]}
        tpu_name = "chain_fma" if name == "chain_fma" else "chain_exp40"
        for nm, dt in pv.DTYPES.items():
            x = pv.probe_input(dt, DEV)
            key = "" if nm == "f32" else "_bf16"
            b_ms, b_by = bound(2 * x.numel() * x.element_size(),
                               *ops(x.numel(), FP32_FLOP_S if nm == "f32" else BF16X2_FLOP_S))
            rec.update({
                f"max_abs_err{key}": errs[f"{name}_{nm}"],
                f"ms{key}": times[f"{tpu_name}_{nm}"],
                f"plain_ms{key}": graph_ms(lambda: fn_plain(x), 10, 3),
                f"bound_ms{key}": b_ms, f"bound_by{key}": b_by,
            })
        rec["library_ms"] = None
        rec["library_note"] = (f"no one PyTorch call computes the "
                               f"{pv.FMA_REPS if name == 'chain_fma' else pv.EXP_REPS}-step chain")
        recs.append(rec)

    x = ps.probe_input(0, device=DEV)
    rows = x.shape[0]
    b_ms, b_by = bound(x.numel() * 4 + rows * 4, (ps.reps_flops(rows), FP32_FLOP_S))
    recs.append({
        "name": "scan_reps", "route": "cuda",
        "source": "frosting_tpu_torch/csrc/perf_scan_variants.cu",
        "replaces": "scripts/perf_scan_variants.py:76",
        "launches": launches["scan_reps"],
        "max_abs_err": max(errs["scan_reps_tpu"], errs["scan_reps_nonzero"]),
        "ms": times["scan_concat+prod_concat"],
        "ms_variants": {v: times[v] for v in ps.VARIANTS},
        "plain_ms": graph_ms(lambda: ps.scan_reps_torch(x), 10, 3),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": graph_ms(lambda: scan_reps_library(x), 10, 3),
        "library_note": "30 rounds of torch.cumprod, torch.prod and the update",
        "launch_floor_ms": times["empty_launch"],
    })
    x = ps.probe_input(1, device=DEV)
    incl, prod = torch.empty_like(x), torch.empty((rows, 1), device=DEV)
    once_ms = {v: graph_ms(lambda: ps.scan_once(x, v, incl, prod)) for v in ps.VARIANTS}
    b_ms, b_by = bound(2 * x.numel() * 4 + rows * 4, (ps.once_flops(rows), FP32_FLOP_S))
    recs.append({
        "name": "scan_once", "route": "cuda",
        "source": "frosting_tpu_torch/csrc/perf_scan_variants.cu",
        "replaces": "scripts/perf_scan_variants.py:116",
        "launches": launches["scan_once"],
        "max_abs_err": max(errs["scan_once_tpu"], errs["scan_once_nonzero"]),
        "ms": once_ms["scan_concat+prod_concat"],
        "ms_variants": once_ms,
        "plain_ms": graph_ms(lambda: ps.scan_once_torch(x), 10, 3),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": graph_ms(lambda: scan_once_library(x)),
        "library_note": "torch.cumprod followed by torch.prod",
        "launch_floor_ms": times["empty_launch"],
    })
    for r in recs:
        log(f"{r['name']}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in r.items() if isinstance(v, float)))
    return recs


def main():
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the plain versions' colour sums are batched matmuls: keep them FP32
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi()
    log("device:", card, "|", torch.cuda.get_device_name(0),
        "| torch", torch.__version__, "cuda", torch.version.cuda)

    # 2. build
    t0 = time.time()
    logs = _build.build_all(
        blend_cuda.KERNELS + perf_vpu_dtype.KERNELS + perf_scan_variants.KERNELS)
    log(f"build: {time.time() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")

    # 3. kernels vs plain versions
    max_err = {"blend_forward": 0.0, "blend_backward": 0.0}

    def check(label, fields, binned, cfg, plain_chunk=None):
        max_err["blend_forward"] = max(
            max_err["blend_forward"], compare(label, fields, binned, cfg))
        max_err["blend_backward"] = max(
            max_err["blend_backward"],
            compare_backward(label, fields, binned, cfg, plain_chunk))

    with torch.inference_mode():
        phase_small_reference()
    gs = on_card(bench_scene(100_000, 0, -0.7, 0.7, 0.008, 0.04))
    cam = look_at_camera(eye=[0.0, 0.0, -3.0], target=[0, 0, 0], device=DEV)
    with torch.inference_mode():
        cfg512, _ = autotuned_config(gs, cam, 1 << 21, width=512, height=512)
        fields, binned = blend_inputs(gs, cam, cfg512)
        check("512x512 @ 100k", fields, binned, cfg512)
        ms512 = cuda_ms(lambda: blend_cuda.blend_forward(fields, binned, cfg512), 10)
        plain512 = cuda_ms(lambda: blend_forward_torch(fields, binned, cfg512), 3)
        log(f"512x512 @ 100k: kernel {ms512:.4f} ms, plain {plain512:.3f} ms")
    phase_render_gradients(gs, cam, cfg512)
    with torch.inference_mode():
        gs = on_card(bench_scene(20_000, 1, -0.7, 0.7, 0.008, 0.04))
        cfg_odd = RasterConfig(width=1000, height=600, max_instances=1 << 21)
        fields, binned = blend_inputs(gs, cam, cfg_odd)
        check("1000x600 @ 20k", fields, binned, cfg_odd)
        del gs, fields, binned
        fields, binned, cfg_adv = adversarial_blend_inputs(seed=0, device=DEV)
        check("adversarial 100x70, needles, a run of 12k", fields, binned, cfg_adv)
        del fields, binned

    # 4. serving path: gs.ply -> load_ply -> viewer at 1920x1080
    raw = raw_params(bench_scene(MAIN_N, 0, -0.9, 0.9, 0.003, 0.015))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gs.ply")
        t0 = time.time()
        gauss_lib.save_ply(gauss_lib.params_from_numpy(raw, device="cpu"), path)
        params = gauss_lib.load_ply(path, device=DEV)
        log(f"gs.ply: {os.path.getsize(path) / 1e6:.1f} MB written and "
            f"loaded in {time.time() - t0:.1f} s")
    with torch.inference_mode():
        model = gauss_lib.activate(params)
        cams, cfg = serving_views(model)
        fields, binned = blend_inputs(model, cams[0], cfg)
        # the plain backward's [tiles, pixels, chunk] temporaries at 1080p
        # take ~1 GB each at chunk 128: walk it 64 at a time
        check("1920x1080 @ 1M", fields, binned, cfg, plain_chunk=64)
        del fields, binned
        torch.cuda.empty_cache()

    blend_cuda.blend_forward.launches = 0
    blend_cuda.blend_backward.launches = 0
    server = viewer.start(lambda: model, cfg, port=0, host="127.0.0.1", device=DEV)
    try:
        base = "http://127.0.0.1:%d" % server.server_address[1]
        request_ms = []
        for az, el in ORBITS:
            t0 = time.perf_counter()
            status, body = get(base, f"/render?az={az}&el={el}&r={ORBIT_R}")
            request_ms.append((time.perf_counter() - t0) * 1e3)
            if status != 200:
                raise AssertionError(f"/render status {status}")
            w, h = struct.unpack(">II", body[16:24])
            if (w, h) != (MAIN_W, MAIN_H):
                raise AssertionError(f"PNG is {w}x{h}")
            img = decode_png(body)
            if img.std() < 1.0:
                raise AssertionError("rendered image is constant")
        status, body = get(base, "/state")
        state = json.loads(body)
        if status != 200 or state != {"n_gaussians": MAIN_N}:
            raise AssertionError(f"/state: {status} {state}")
    finally:
        server.shutdown()
        server.server_close()
    serve_launches = blend_cuda.blend_forward.launches
    serve_counts = {"blend_forward": serve_launches,
                    "blend_backward": blend_cuda.blend_backward.launches}
    log(f"viewer: 3 renders at {MAIN_W}x{MAIN_H} @ 1M, ms per request "
        f"{[round(t, 1) for t in request_ms]}, forward kernel launches "
        f"{serve_launches}, backward {blend_cuda.blend_backward.launches}")
    if serve_launches < len(ORBITS):
        raise AssertionError("the serving path did not go through the kernel")

    # 5. training path at full width (max_instances far above the ground
    # truth's count: binning sizes its buffers to the views' real counts)
    rcfg = RasterConfig(width=MAIN_W, height=MAIN_H, chunk=128, max_instances=1 << 24)
    state, tcams, gt_imgs, tcfg, launches = phase_training(model, rcfg)

    # 6. timing at 1080p @ 1M
    with torch.inference_mode():
        for c in cams:
            proj = preprocess(*model, c, cfg)
            if bool(bin_gaussians(proj.rect, proj.depths, proj.valid, cfg).overflow):
                raise AssertionError("instance overflow on the serving path")
        fields, binned = blend_inputs(model, cams[0], cfg)
        ms = cuda_ms(lambda: blend_cuda.blend_forward(fields, binned, cfg), 10)
        plain_ms = cuda_ms(lambda: blend_forward_torch(fields, binned, cfg), 3)
        render_ms = cuda_ms(lambda: render(*model, cams[0], cfg), 10)
        # where a render and a request spend their time
        pre_ms = cuda_ms(lambda: preprocess(*model, cams[0], cfg), 10)
        proj = preprocess(*model, cams[0], cfg)
        bin_ms = cuda_ms(
            lambda: bin_gaussians(proj.rect, proj.depths, proj.valid, cfg), 10
        )
        # each kernel's wrapper sorts the tiles before it launches
        order_ms = cuda_ms(lambda: blend_cuda.heaviest_first(binned.tile_ranges), 10)
        t0 = time.perf_counter()
        viewer.render_png(model, cams[0], cfg)
        png_ms = (time.perf_counter() - t0) * 1e3
        log(f"breakdown: preprocess {pre_ms:.3f} ms, binning {bin_ms:.3f} ms, "
            f"tile order (inside each of B1 and B2) {order_ms:.4f} ms, render "
            f"{render_ms:.3f} ms (device); render + PNG {png_ms:.1f} ms (host)")
        out = blend_cuda.blend_forward(fields, binned, cfg)
        g = torch.randn(out.shape, generator=torch.Generator(device=DEV).manual_seed(0),
                        device=DEV)
        ms_b = cuda_ms(lambda: blend_cuda.blend_backward(fields, binned, cfg, out, g), 10)
        plain_cfg = dataclasses.replace(cfg, chunk=64)
        plain_ms_b = cuda_ms(
            lambda: blend_backward_torch(fields, binned, plain_cfg, out, g), 3)
        serve = work(fields, binned, cfg)
        del fields, binned, out, g, proj
        torch.cuda.empty_cache()
    b_f, b_b = bounds(serve)
    log(f"{MAIN_W}x{MAIN_H} @ 1M: {serve['instances']} instances, {serve['pairs']} "
        f"pre-stop (instance, pixel) pairs, {serve['live']} live; B1 {ms:.4f} ms, "
        f"plain {plain_ms:.3f} ms, bound {fmt_bound(b_f)}; B2 {ms_b:.4f} ms, "
        f"plain {plain_ms_b:.3f} ms, bound {fmt_bound(b_b)}; whole render "
        f"{render_ms:.3f} ms")

    opt = opt_lib.make_gs_optimizer(TRAIN_EXTENT)
    gt0 = torch.from_numpy(gt_imgs[0]).to(DEV)
    parts, (f_s, b_s, o_s, g_s) = step_breakdown(
        state, opt, tcams[0], gt0, rcfg, tcfg, reps=5)
    step_ms = cuda_ms(lambda: gs_trainer.train_step(
        state, tcams[0], gt0, opt, rcfg, tcfg, tcfg.sh_degree), 5)
    log(f"train step at {MAIN_W}x{MAIN_H}, {int(state.params.num_active())} live "
        f"Gaussians of {TRAIN_CAPACITY}, {int(b_s.num_instances)} instances: "
        f"{step_ms:.3f} ms (CUDA events, median of 5), {1e3 / step_ms:.2f} it/s; "
        f"parts (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
        + f"; sum {sum(parts.values()):.3f}")
    reproducible_grads("the train step's view, trained state",
                       gauss_lib.activate(state.params), tcams[0], rcfg,
                       lambda image, t_final: l1_loss(image, gt0))
    with torch.inference_mode():
        # the step's own blend inputs: the low-opacity, deep-run case
        label = "the train step's blend inputs"
        max_err["blend_forward"] = max(
            max_err["blend_forward"], compare(label, f_s, b_s, rcfg))
        max_err["blend_backward"] = max(
            max_err["blend_backward"],
            compare_backward(label, f_s, b_s, rcfg, plain_chunk=64, g=g_s))
        # the same launches back to back, without the step's host gaps
        ms_fs = cuda_ms(lambda: blend_cuda.blend_forward(f_s, b_s, rcfg), 10)
        ms_bs = cuda_ms(lambda: blend_cuda.blend_backward(f_s, b_s, rcfg, o_s, g_s), 10)
        plain_ms_fs = cuda_ms(lambda: blend_forward_torch(f_s, b_s, rcfg), 1)
        plain_ms_bs = cuda_ms(lambda: blend_backward_torch(
            f_s, b_s, dataclasses.replace(rcfg, chunk=64), o_s, g_s), 1)
        step = work(f_s, b_s, rcfg)
        reduction = phase_reduction(f_s, b_s, rcfg, o_s, g_s)
    s_f, s_b = bounds(step)
    log(f"the step's blend inputs alone: {step['instances']} instances, "
        f"{step['pairs']} pre-stop pairs, {step['live']} live; B1 {ms_fs:.4f} ms, "
        f"plain {plain_ms_fs:.3f} ms, bound {fmt_bound(s_f)}; B2 {ms_bs:.4f} ms, "
        f"plain {plain_ms_bs:.3f} ms, bound {fmt_bound(s_b)}")
    del f_s, b_s, o_s, g_s
    t = Timer()
    t.mark("start")
    gs_trainer.densify_step(state, torch.Generator(device=DEV).manual_seed(0),
                            TRAIN_EXTENT, tcfg, use_size_prune=True)
    t.mark("densify")
    log(f"densify step: {t.parts()['densify']:.3f} ms")
    del state, opt
    torch.cuda.empty_cache()

    # 7. the bench path: the probes held, then the entry points in process
    probe_err = hold_probes()
    bench_launches, bench_times = phase_bench()
    probe_records = probe_timings(probe_err, bench_times, bench_launches)
    bench_profiles()

    def record(name, line, b, sb, times, plain):
        return {
            "name": name,
            "route": "cuda",
            "source": f"frosting_tpu_torch/csrc/{name}.cu",
            "replaces": f"frosting_tpu/raster/blend_pallas.py:{line}",
            # the training path's count; each main path's beside it
            "launches": launches[name],
            "launches_by_path": {
                "serving": serve_counts[name],
                "training": launches[name],
                "bench": bench_launches[name],
            },
            "max_abs_err": max_err[name],
            # the serving view; *_step: the train step's own blend inputs
            "ms": times[0],
            "plain_ms": plain[0],
            # the least time for the live pairs (bound_live_ms); the bound
            # over every pre-stop pair beside it
            "bound_ms": b["live"][0],
            "bound_by": b["live"][1],
            # no PyTorch call computes either blend or any part of it
            "library_ms": None,
            "bound_live_ms": b["live"][0],
            "bound_prestop_ms": b["prestop"][0],
            "pairs": serve["pairs"],
            "live_pairs": serve["live"],
            "ms_step": times[1],
            "plain_ms_step": plain[1],
            "bound_live_ms_step": sb["live"][0],
            "bound_prestop_ms_step": sb["prestop"][0],
            "pairs_step": step["pairs"],
            "live_pairs_step": step["live"],
        }

    records = [
        record("blend_forward", 207, b_f, s_f, (ms, ms_fs), (plain_ms, plain_ms_fs)),
        record("blend_backward", 411, b_b, s_b, (ms_b, ms_bs), (plain_ms_b, plain_ms_bs)),
    ] + probe_records
    records[1]["reduction"] = reduction
    log(card)
    log(json.dumps({"kernels": records}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
