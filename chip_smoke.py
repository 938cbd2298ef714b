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
     lines); then the probes' plain and library times and bounds (for the
     scans also each variant's time above the empty-launch floor and the
     bound of its shuffles and shared-memory accesses), and the device's
     busy share over the bench loops (torch.profiler).
  8. stages path at full width: a COLMAP scene on disk (8 PNG views at
     1920x1080 of the 1M scene, rendered with B1; PINHOLE poses; the 1M
     means as points3D.bin) goes through the port's command line in
     process: stages_cli train-gs (30 iterations), render (one PNG decoded
     back and held equal to the render it came from) and train-sugar for
     each of density, sdf and dn_consistency from the 1M model's gs.ply,
     iterations 8990-9010 (entropy, photo with the hard prune at 9000,
     sdf); finite losses, PSNR held within a margin, 55-80% of the
     Gaussians left by the prune, sugar.ply loads back. Then the decode of
     a 1080p PNG, the scene load, compute_knn at 1M and a SuGaR step per
     phase and method part by part are timed, and B1 and B2 are held
     against their plain versions on a dn_consistency depth render's
     inputs, with the transmittance cotangent that depth / acc gives.
     Stage 3 on the same scene (phase_extract): 1M Gaussians on the unit
     sphere as sugar.ply, stages_cli extract-shell --both-poly at the
     defaults (B1 once per view; both meshes within their vertex budgets,
     finite, median radius in a band; the parts' times and peak device
     memory logged), a second run at --low-poly (its own process) whose
     shell.ply equals the first's shell_lowpoly.ply byte for byte, and
     --method centers / marching within their bands.
The four main paths (4, 5, 7 and 8) reset the kernels' launch counts just
before and read them just after; stage 3's extract-shell is read on its
own. The line before the last is the JSON
kernels record; the last line is {"ok": true, "device": {...}}.
"""

import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import urllib.request

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
    PIPE_OPS_S,
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
from frosting_tpu_torch import stages_cli
from frosting_tpu_torch.models import sugar as sugar_lib
from frosting_tpu_torch.ops.ssim import l1_loss, ssim
from frosting_tpu_torch.scene import gaussians as gauss_lib
from frosting_tpu_torch.scene import synthetic
from frosting_tpu_torch.scene.synthetic import adversarial_blend_inputs
from frosting_tpu_torch.train import gs_trainer, sugar_trainer
from frosting_tpu_torch.train import optimizer as opt_lib
from frosting_tpu_torch.utils import image as image_io
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
DEPTH_ERR_FACTOR = 2  # see compare_backward_float64
# On the depth render's inputs the kernel and the plain float32 walk may
# differ past the tolerance above in at most this share of the values, by
# at most this normalised error: twice the largest of three readings on
# the H100 (6,964 of 3.3e7 values, 1.36e-4; PERF.md).
DEPTH_VS_PLAIN_OFF_SHARE, DEPTH_VS_PLAIN_MAX_NORM = 4.2e-4, 2.8e-4
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
# Stages path: 8 views around the orbit at r 3.5, every command with a
# max_instances far above a view's ~3.7-4.2M instances (binning sizes its
# buffers to the real count), so that no render overflows.
STAGE_ORBITS = tuple((2 * math.pi * i / 8, 0.15 + 0.15 * (i % 3)) for i in range(8))
STAGE_MAX_INSTANCES = 1 << 24
STAGE_GS_ITERS = 30
SUGAR_FROM, SUGAR_TO = 8990, 9010  # entropy to 8999, photo + prune at 9000, sdf
SUGAR_METHODS = ("density", "sdf", "dn_consistency")
# PSNR of a log step's own view: the first log step (9000) comes right
# after the prune and the last (9010) after ten sdf steps, on another view
SUGAR_PSNR_MARGIN = 3.0  # dB
PRUNE_KEEP = (0.55, 0.80)  # opacities U(0.3, 0.95): ~69% are >= 0.5
# Stage 3: a known answer, MAIN_N Gaussians of scale 0.01 and opacity 0.9
# whose means lie on the unit sphere, as sugar.ply; extract-shell at its
# defaults (surface method, level 0.3, 21 samples, k 16, auto Poisson
# resolution up to 1024, targets 1M and 200k, visibility culling 0.001).
# The level-0.3 crossings lie ~2.7 scales (0.027) outside the sphere of
# means and are then snapped onto those points, so both meshes' median
# vertex radius lies in SHELL_RADIUS. QEM stops at its target, and after it
# only the vertices of faces it collapsed or of culled components go, so a
# mesh keeps at least SHELL_KEEP of its target.
SHELL_SCALE, SHELL_OPACITY = 0.01, 0.9
SHELL_TARGETS = (1_000_000, 200_000)
SHELL_RADIUS = (0.97, 1.05)
SHELL_KEEP = 0.9
# The ablation methods on the same model. centers: Poisson on the means
# themselves (radius 1), the mesh then snapped onto them, at 512^3 (at the
# auto 1024^3 the host QEM of its ~8M-vertex mesh takes ~4.5 min on the
# card's machine); marching at 256^3 over the cameras' box (+/- 3.85,
# cells of 0.030) takes the density's level set 2.7 scales outside the
# sphere: radius ~1.027 (1.0276 measured before culling).
CENTERS_POISSON = 512
CENTERS_RADIUS = (0.97, 1.05)
MARCHING_RADIUS = (0.99, 1.06)
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


def backward_twice(label, fields, binned, cfg, out, g):
    """B2's rows on the inputs; two launches must be bitwise equal."""
    before = blend_cuda.blend_backward.launches
    rows = blend_cuda.blend_backward(fields, binned, cfg, out, g)
    again = blend_cuda.blend_backward(fields, binned, cfg, out, g)
    torch.cuda.synchronize()
    if blend_cuda.blend_backward.launches != before + 2:
        raise AssertionError(f"{label}: the backward kernel's count did not rise")
    if not torch.equal(rows, again):
        raise AssertionError(f"{label}: two backward launches differ")
    if not torch.isfinite(rows).all():
        raise AssertionError(f"{label}: backward kernel output not finite")
    return rows


def backward_off(rows, ref):
    """(values off the tolerance, max normalised error, max abs error) of
    gradient rows against ref, each column normalised by ref's largest
    magnitude in it."""
    scale = ref.abs().amax(dim=0).clamp_min(1e-30)
    err = (rows.to(ref.dtype) - ref).abs()
    off = int((err / scale > ATOL + RTOL * ref.abs() / scale).sum())
    return off, (err / scale).max().item(), err.max().item()


def compare_backward(label, fields, binned, cfg, plain_chunk=None, g=None):
    """B2 vs its plain version on the same inputs (B1's output and the
    cotangent g, by default a seeded one with colour and T parts); two
    launches must give bitwise-equal rows. Returns max abs error."""
    out = blend_cuda.blend_forward(fields, binned, cfg)
    if g is None:
        gen = torch.Generator(device=DEV).manual_seed(0)
        g = torch.randn(out.shape, generator=gen, device=DEV)
    rows = backward_twice(label, fields, binned, cfg, out, g)
    plain_cfg = dataclasses.replace(cfg, chunk=plain_chunk or cfg.chunk)
    ref = blend_backward_torch(fields, binned, plain_cfg, out, g)
    off, max_norm, max_err = backward_off(rows, ref)
    log(f"{label} backward: rows {rows.shape[0]} max_abs_err {max_err:.3e} "
        f"max_normalised_err {max_norm:.3e} "
        f"off_tol {off} of {rows.numel()}; two launches bitwise equal")
    if off > max(BWD_OFF_SHARE * rows.numel(), BWD_OFF_MIN):
        raise AssertionError(f"{label}: backward kernel disagrees with the plain version")
    return max_err


def compare_backward_float64(label, fields, binned, cfg, g, plain_chunk=64):
    """B2 on inputs whose colours leave [0, 1] (a depth render's: ~2.5-4.5),
    held with the plain float32 version against the plain version in
    float64. The suffix trick's dalpha = u T - gS / (1 - alpha) subtracts
    colour-sized sums, so the rounding of any float32 walk grows with |c|
    while the gradients, which follow colour differences, do not: neither
    float32 version holds the tolerance above against the other here. The
    kernel's values off that tolerance against float64 may be at most
    DEPTH_ERR_FACTOR times the plain float32 version's (or the count
    allowed above), and so may its largest normalised error; against the
    plain float32 version, DEPTH_VS_PLAIN_OFF_SHARE of the values may be
    off, by at most DEPTH_VS_PLAIN_MAX_NORM. Returns the kernel's max abs
    error against float64."""
    out = blend_cuda.blend_forward(fields, binned, cfg)
    rows = backward_twice(label, fields, binned, cfg, out, g)
    plain_cfg = dataclasses.replace(cfg, chunk=plain_chunk)
    plain = blend_backward_torch(fields, binned, plain_cfg, out, g)
    f64 = fields.double()
    ref = blend_backward_torch(f64, binned, plain_cfg,
                               blend_forward_torch(f64, binned, plain_cfg), g.double())
    k_off, k_norm, k_err = backward_off(rows, ref)
    p_off, p_norm, _ = backward_off(plain, ref)
    o_off, o_norm, _ = backward_off(rows, plain)
    log(f"{label} backward against float64: rows {rows.shape[0]}; kernel off_tol "
        f"{k_off}, max_normalised_err {k_norm:.3e}, max_abs_err {k_err:.3e}; plain float32 "
        f"off_tol {p_off}, max_normalised_err {p_norm:.3e}; kernel vs plain float32 "
        f"off_tol {o_off}, max_normalised_err {o_norm:.3e}; of {rows.numel()} values; "
        "two launches bitwise equal")
    allowed = max(DEPTH_ERR_FACTOR * p_off, BWD_OFF_SHARE * rows.numel(), BWD_OFF_MIN)
    if k_off > allowed or k_norm > DEPTH_ERR_FACTOR * max(p_norm, ATOL):
        raise AssertionError(f"{label}: backward kernel less accurate than the plain version")
    if o_off > DEPTH_VS_PLAIN_OFF_SHARE * rows.numel() or o_norm > DEPTH_VS_PLAIN_MAX_NORM:
        raise AssertionError(f"{label}: backward kernel disagrees with the plain version")
    return k_err, {"values": rows.numel(), "kernel_off_tol": k_off,
                   "kernel_max_normalised_err": k_norm, "plain_f32_off_tol": p_off,
                   "plain_f32_max_normalised_err": p_norm,
                   "kernel_vs_plain_f32_off_tol": o_off,
                   "kernel_vs_plain_f32_max_normalised_err": o_norm}


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

    floor = times["empty_launch"]

    def scan_layout(ms, lanes, table, rounds):
        """The variants' times above the empty-launch floor, and the bound
        of the layout's shuffles and shared-memory accesses."""
        return {
            "ms_above_floor": ms["scan_concat+prod_concat"] - floor,
            "ms_above_floor_variants": {v: t - floor for v, t in ms.items()},
            "lanes_per_row": lanes,
            "pipe_bound_ms_variants": {
                v: rows * rounds * ps.pipe_ops(lanes, *f, table) / PIPE_OPS_S * 1e3
                for v, f in ps.VARIANTS.items()},
        }

    x = ps.probe_input(0, device=DEV)
    rows = x.shape[0]
    b_ms, b_by = bound(x.numel() * 4 + rows * 4, (ps.reps_flops(rows), FP32_FLOP_S))
    reps_ms = {v: times[v] for v in ps.VARIANTS}
    recs.append({
        "name": "scan_reps", "route": "cuda",
        "source": "frosting_tpu_torch/csrc/perf_scan_variants.cu",
        "replaces": "scripts/perf_scan_variants.py:76",
        "launches": launches["scan_reps"],
        "max_abs_err": max(errs["scan_reps_tpu"], errs["scan_reps_nonzero"]),
        "ms": times["scan_concat+prod_concat"],
        "ms_variants": reps_ms,
        "plain_ms": graph_ms(lambda: ps.scan_reps_torch(x), 10, 3),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": graph_ms(lambda: scan_reps_library(x), 10, 3),
        "library_note": "30 rounds of torch.cumprod, torch.prod and the update",
        "launch_floor_ms": floor,
        **scan_layout(reps_ms, ps.REPS_LANES, True, ps.REPS),
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
        "launch_floor_ms": floor,
        **scan_layout(once_ms, ps.ONCE_LANES, False, 1),
    })
    for r in recs:
        log(f"{r['name']}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in r.items() if isinstance(v, float)))
    return recs


def host_ms(fn, reps):
    """Median host-clock ms of fn over reps calls (each ends in a sync)."""
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def phase_stages(raw, model):
    """The stages main path: a COLMAP scene of the 1M model written to disk
    and driven through stages_cli in process (train-gs, render, train-sugar
    for each method), then its timings and the depth-render check of B1
    and B2, then stage 3 (phase_extract). Returns (launches per kernel of
    the stage 1-2 commands, of the first extract-shell, timings)."""
    cams = [viewer._orbit_camera(az, el, ORBIT_R, device=DEV) for az, el in STAGE_ORBITS]
    rcfg = RasterConfig(width=MAIN_W, height=MAIN_H, chunk=128,
                        max_instances=STAGE_MAX_INSTANCES)
    timings = {}
    with tempfile.TemporaryDirectory() as tmp:
        scene_dir, out = os.path.join(tmp, "scene"), os.path.join(tmp, "out")
        t0 = time.time()
        paths = synthetic.write_colmap_scene(scene_dir, model, cams, rcfg)
        log(f"stages: COLMAP scene of {len(cams)} PNG views at {MAIN_W}x{MAIN_H} and "
            f"{MAIN_N} points written in {time.time() - t0:.1f} s")
        timings["png_decode_1080p_ms"] = host_ms(lambda: image_io.read_image(paths[0]), 5)
        common = ["-s", scene_dir, "-o", out, "--max-instances", str(STAGE_MAX_INSTANCES),
                  "--device", DEV]
        args = stages_cli.build_parser().parse_args(["render", *common])
        t0 = time.perf_counter()
        scene, scams, gt, srcfg = stages_cli._load_scene(args)
        timings["scene_load_ms"] = (time.perf_counter() - t0) * 1e3
        with torch.inference_mode():
            want = np.clip(render(*model, cams[0], rcfg).image.cpu().numpy(), 0, 1)
        want = (want * 255).astype(np.uint8).astype(np.float32) / 255.0
        if not (np.array_equal(gt[0], want) and len(scams) == len(cams)
                and len(scene.points) == MAIN_N):
            raise AssertionError("the loaded scene differs from the one written")
        log(f"stages: 1080p PNG decode {timings['png_decode_1080p_ms']:.1f} ms "
            f"(median of 5); load_colmap_scene + _load_scene of {len(scams)} views "
            f"{timings['scene_load_ms']:.0f} ms; GT view 0 equals the written render")
        del gt

        blend_cuda.blend_forward.launches = 0
        blend_cuda.blend_backward.launches = 0
        t0 = time.perf_counter()
        hist = stages_cli.main(["train-gs", *common, "--iterations", str(STAGE_GS_ITERS),
                                "--capacity", str(TRAIN_CAPACITY)])
        timings["train_gs_s"] = time.perf_counter() - t0
        if not all(np.isfinite(h["loss"]) and not h["overflow"] for h in hist):
            raise AssertionError(f"train-gs: a non-finite loss or an overflow: {hist}")
        t0 = time.perf_counter()
        stages_cli.main(["render", *common])
        torch.cuda.synchronize()
        timings["render_command_s"] = time.perf_counter() - t0
        # train-gs's model, checked against the render command's PNG once
        # the commands' launches are read
        live = gauss_lib.activate(stages_cli.load_live_gaussians(
            os.path.join(out, "gs.ply"), device=DEV))
        log(f"stages: train-gs {timings['train_gs_s']:.1f} s ({STAGE_GS_ITERS} iterations, "
            f"scene load and create_from_pcd included), render command "
            f"{timings['render_command_s']:.1f} s for {len(scams)} views")

        gauss_lib.save_ply(gauss_lib.params_from_numpy(raw, device="cpu"),
                           os.path.join(out, "gs.ply"))
        for method in SUGAR_METHODS:
            t0 = time.perf_counter()
            hist = stages_cli.main([
                "train-sugar", *common, "-r", method, "--start-iteration", str(SUGAR_FROM),
                "--iterations", str(SUGAR_TO), "--capacity", str(TRAIN_CAPACITY)])
            timings[f"train_sugar_{method}_s"] = time.perf_counter() - t0
            first, last = hist[0], hist[-1]
            log(f"stages: train-sugar -r {method}: {timings[f'train_sugar_{method}_s']:.1f} s; "
                + "; ".join(f"it {h['iter']} [{h['phase']}] loss {h['loss']:.4f} psnr "
                            f"{h['psnr']:.2f} n {h['n_active']}" for h in hist)
                + f"; PSNR margin {SUGAR_PSNR_MARGIN} dB")
            if not all(np.isfinite(h["loss"]) and not h["overflow"] for h in hist):
                raise AssertionError(f"train-sugar {method}: a non-finite loss or an overflow")
            if not last["psnr"] >= first["psnr"] - SUGAR_PSNR_MARGIN:
                raise AssertionError(f"train-sugar {method}: PSNR fell past the margin")
            keep = first["n_active"] / MAIN_N
            if not (first["iter"] == 9000 and PRUNE_KEEP[0] <= keep <= PRUNE_KEEP[1]):
                raise AssertionError(f"train-sugar {method}: the prune kept {keep:.3f}")
            back = gauss_lib.load_ply(os.path.join(out, "sugar.ply"), device="cpu")
            if back.capacity != last["n_active"] or not torch.isfinite(back.means3d).all():
                raise AssertionError(f"train-sugar {method}: sugar.ply does not load back")
        torch.cuda.synchronize()
        launches = {"blend_forward": blend_cuda.blend_forward.launches,
                    "blend_backward": blend_cuda.blend_backward.launches}
        log(f"stages path launches {launches}")
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"the stages path did not launch {name}")

        with torch.inference_mode():
            img = np.clip(render(*live, scams[0], srcfg).image.cpu().numpy(), 0, 1)
        got, mode = image_io.read_image(os.path.join(out, "renders", "train_00000.png"))
        if not (mode == "RGB" and np.array_equal(got, (img.transpose(1, 2, 0) * 255).astype(np.uint8))):
            raise AssertionError("render: the PNG differs from the render it came from")
        timings["render_view_ms"] = host_ms(lambda: viewer.render_png(live, scams[0], srcfg), 3)
        del live
        log(f"stages: render + PNG of one view {timings['render_view_ms']:.1f} ms (host "
            "clock, median of 3); renders/train_00000.png decodes to the render")
        gt0 = torch.from_numpy(np.asarray(scene.train_cameras[0].image(), np.float32))
        timings.update(stages_timings(os.path.join(out, "gs.ply"), scene, gt0.to(DEV)))
        del scene, gt0
        torch.cuda.empty_cache()
        extract_launches, timings["extract_shell"] = phase_extract(
            scene_dir, out, common, len(scams))
    return launches, extract_launches, timings


def sphere_raw(n, seed=0):
    """Raw parameters of n Gaussians of scale SHELL_SCALE and opacity
    SHELL_OPACITY whose means lie on the unit sphere (seeded numpy)."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    quats = np.zeros((n, 4), np.float32)
    quats[:, 0] = 1.0
    sh = np.zeros((n, 16, 3), np.float32)
    return raw_params((d.astype(np.float32), np.full((n, 3), SHELL_SCALE, np.float32), quats,
                       np.full((n,), SHELL_OPACITY, np.float32), sh))


def median_radius(path):
    v, f = stages_cli.load_mesh(path)
    if not (np.isfinite(v).all() and len(f) and f.min() >= 0 and f.max() < len(v)):
        raise AssertionError(f"{path}: non-finite vertices or bad faces")
    return len(v), len(f), float(np.median(np.linalg.norm(v, axis=1)))


def phase_extract(scene_dir, out, common, n_views):
    """Stage 3 on the stages path's scene: the known-answer sphere as
    sugar.ply, then extract-shell --both-poly at full width in process (B1
    launched once per view, its parts' times, peak device memory, both
    meshes' counts and radii). A second run of the command, at --low-poly
    in a process of its own, must write a shell.ply equal byte for byte to
    the first run's shell_lowpoly.ply (the same Poisson mesh decimated to
    the same budget); it starts first, and the first run starts once the
    second has finished its device work and entered its ~5 min of host
    QEM, so that the two share no device time. Then --method centers at
    Poisson 512^3 and --method marching at 256^3. Returns (launches of the
    first command, results)."""
    gauss_lib.save_ply(gauss_lib.params_from_numpy(sphere_raw(MAIN_N), device="cpu"),
                       os.path.join(out, "sugar.ply"))
    out_b = out + "_again"
    os.makedirs(out_b)
    shutil.copy(os.path.join(out, "sugar.ply"), out_b)
    shell_ply = os.path.join(out, "shell.ply")
    low_ply = os.path.join(out, "shell_lowpoly.ply")
    results = {}

    def run(label, extra):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = stages_cli.main(["extract-shell", *common, *extra])
        torch.cuda.synchronize()
        res["command_s"] = time.perf_counter() - t0
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        results[label] = res
        log(f"extract-shell {' '.join(extra)}: {res['command_s']:.1f} s, peak device memory "
            f"{res['peak_gib']:.2f} GiB, Poisson {res['poisson_resolutions']}; parts (ms): "
            + ", ".join(f"{k} {v:.1f}" for k, v in res["timings_ms"].items()))
        return res

    common_b = [out_b if a == out else a for a in common]
    again = subprocess.Popen(
        [sys.executable, "-m", "frosting_tpu_torch.stages_cli", "extract-shell", *common_b,
         "--low-poly"],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        t0 = time.perf_counter()
        for line in again.stdout:
            log(f"  [second run] {line.rstrip()}")
            if line.startswith("[shell/all] poisson res"):
                break
        else:
            raise AssertionError(f"the second extract-shell ended early ({again.wait()})")
        log(f"second run's device work done in {time.perf_counter() - t0:.1f} s")
        blend_cuda.blend_forward.launches = 0
        blend_cuda.blend_backward.launches = 0
        run("surface", ["--both-poly"])
        torch.cuda.synchronize()
        launches = {"blend_forward": blend_cuda.blend_forward.launches,
                    "blend_backward": blend_cuda.blend_backward.launches}
        log(f"extract-shell launches {launches}")
        if launches != {"blend_forward": n_views, "blend_backward": 0}:
            raise AssertionError(f"extract-shell should launch B1 once per view: {launches}")
        for line in again.stdout:
            log(f"  [second run] {line.rstrip()}")
        if again.wait() != 0:
            raise AssertionError(f"the second extract-shell failed ({again.returncode})")
        results["again_low_poly"] = {"command_s": time.perf_counter() - t0}
    finally:
        if again.poll() is None:
            again.kill()
            again.wait()
    for path, target in zip((shell_ply, low_ply), SHELL_TARGETS):
        nv, nf, r = median_radius(path)
        log(f"{os.path.basename(path)}: {nv} vertices, {nf} faces, median radius {r:.5f} "
            f"(band {SHELL_RADIUS}, {SHELL_KEEP * target:.0f} to {target} vertices)")
        if not (SHELL_KEEP * target <= nv <= target and SHELL_RADIUS[0] <= r <= SHELL_RADIUS[1]):
            raise AssertionError(f"{path}: {nv} vertices, median radius {r}")
        results["surface"][os.path.basename(path)] = {"verts": nv, "faces": nf, "median_r": r}
    with open(low_ply, "rb") as f, open(os.path.join(out_b, "shell.ply"), "rb") as g:
        same = f.read() == g.read()
    log(f"second run (--low-poly): shell.ply {'equals' if same else 'DIFFERS from'} the first "
        "run's shell_lowpoly.ply byte for byte")
    if not same:
        raise AssertionError("two extractions of the same model differ")
    for method, band, extra in (
            ("centers", CENTERS_RADIUS, ["--poisson-resolution", str(CENTERS_POISSON)]),
            ("marching", MARCHING_RADIUS, ["--marching-resolution", "256"])):
        run(method, ["--method", method, *extra])
        nv, nf, r = median_radius(shell_ply)
        log(f"--method {method}: {nv} vertices, {nf} faces, median radius {r:.5f} "
            f"(band {band})")
        if not (0 < nv <= SHELL_TARGETS[0] and band[0] <= r <= band[1]):
            raise AssertionError(f"--method {method}: {nv} vertices, median radius {r}")
        results[method]["shell.ply"] = {"verts": nv, "faces": nf, "median_r": r}
    return launches, results


def stages_timings(gs_path, scene, gt0):
    """compute_knn at 1M and one SuGaR step per phase and method, part by
    part (CUDA events, median of 5 after a warm-up), on the 1M model and
    view 0; then B1 and B2 on a dn_consistency depth render's inputs."""
    cam = scene.train_cameras[0].camera
    rcfg = RasterConfig(width=MAIN_W, height=MAIN_H, chunk=128,
                        max_instances=STAGE_MAX_INSTANCES)
    params = gauss_lib.load_ply(gs_path, capacity=TRAIN_CAPACITY, device=DEV)
    knn_runs = [timed(lambda: sugar_trainer.compute_knn(params), DEV)[0] for _ in range(3)]
    knn_idx = sugar_trainer.compute_knn(params)
    log(f"compute_knn at {MAIN_N} live of {TRAIN_CAPACITY}, k 16: "
        f"{', '.join(f'{t:.1f}' for t in knn_runs)} ms (CUDA events, three calls)")
    opt = opt_lib.make_gs_optimizer(scene.spatial_extent)
    opt_state = opt.init(params)
    gen = torch.Generator(device=DEV).manual_seed(0)
    steps = {}
    for method in SUGAR_METHODS:
        cfg = sugar_trainer.SugarTrainConfig(method=method, spatial_extent=scene.spatial_extent)
        for phase in (("photo", "entropy", "sdf") if method == "density" else ("sdf",)):
            runs = []
            for _ in range(6):
                t = Timer()
                t.mark("start")
                sugar_trainer.train_step(params, opt_state, cam, gt0, knn_idx, opt, rcfg, cfg,
                                         3, phase, generator=gen, mark=t.mark)
                runs.append(t.parts())
            runs = runs[1:]
            parts = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
            parts["step"] = statistics.median(sum(r.values()) for r in runs)
            label = f"{method}/{phase}" if phase == "sdf" else phase
            steps[label] = parts
            log(f"SuGaR step {label} at {MAIN_W}x{MAIN_H}: " + ", ".join(
                f"{k} {v:.3f}" for k, v in parts.items()) + " ms (median of 5)")
    hold = hold_depth_render(params, cam, rcfg)
    return {"knn_ms": knn_runs, "sugar_step_ms": steps, **hold}


def hold_depth_render(params, cam, rcfg):
    """B1 and B2 against their plain versions on the blend inputs of the
    depth render of a dn_consistency step (colours are depths of ~3-4), B2
    with the cotangent the loss gives it: through depth / acc and acc = 1 -
    t_final, every covered pixel's transmittance row is nonzero."""
    means, scales, quats, opac, _sh = (t.detach() for t in gauss_lib.activate(params))
    depth_colors, normals = sugar_lib.depth_normal_colors(means, scales, quats, cam)
    no_sh = torch.zeros_like(means[:, None])
    proj = preprocess(means, scales, quats, opac, no_sh, cam, rcfg,
                      colors_precomp=depth_colors)
    fields = pack_fields(proj)
    binned = bin_gaussians(proj.rect, proj.depths, proj.valid, rcfg)
    out_d = blend_cuda.blend_forward(fields, binned, rcfg).requires_grad_(True)
    with torch.no_grad():
        normal_img = render(means, scales, quats, opac, no_sh, cam, rcfg,
                            colors_precomp=normals).image
    acc = 1.0 - out_d[3]
    depth_map = out_d[0] / torch.clamp(acc, min=1e-6)
    normal_map = normal_img / torch.clamp(acc, min=1e-6)[None]
    loss = sugar_lib.dn_consistency_loss(depth_map, normal_map, acc, cam, rcfg)
    (g_out,) = torch.autograd.grad(loss, out_d)
    out_d = out_d.detach()
    label = "a dn_consistency depth render's inputs"
    nz = int((g_out[3] != 0).sum())
    colours = fields[binned.inst_gauss.long(), 6]
    log(f"{label}: instance colours in [{float(colours.min()):.3f}, "
        f"{float(colours.max()):.3f}], {nz} pixels with a nonzero transmittance cotangent")
    if nz == 0:
        raise AssertionError("the depth render gave B2 no transmittance cotangent")
    with torch.inference_mode():
        err_f = compare(label, fields, binned, rcfg)
        err_b, held = compare_backward_float64(label, fields, binned, rcfg, g_out.contiguous())
    return {"depth_render_max_abs_err": {"blend_forward": err_f, "blend_backward": err_b},
            "depth_render_b2_against_float64": held}


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
            img, mode = image_io.decode_png(body)
            if (mode, img.shape) != ("RGB", (MAIN_H, MAIN_W, 3)):
                raise AssertionError(f"the PNG is {mode} {img.shape}")
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

    # 8. the stages path: a scene on disk through stages_cli
    stage_launches, extract_launches, stage_times = phase_stages(raw, model)
    log(json.dumps({"stages": stage_times}))
    for name, err in stage_times["depth_render_max_abs_err"].items():
        max_err[name] = max(max_err[name], err)

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
                "stages": stage_launches[name],
                "extract_shell": extract_launches[name],
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
    records[1]["depth_render"] = stage_times["depth_render_b2_against_float64"]
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
