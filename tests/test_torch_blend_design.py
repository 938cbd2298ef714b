"""The two design arguments of the CUDA blend kernels, on the CPU through the
plain functions beside them in frosting_tpu_torch/raster/blend_torch.py:

  * the footprint box (instance_boxes_torch): every pair at or above the
    1/255 cutoff lies inside its instance's box, so a walk that skips the
    pairs outside it unevaluated gives exactly the plain results (a pair
    below the cutoff touches neither T nor any sum);
  * the backward's split-TF32 moment product (moment_rows_tf32) gives the
    direct FP32 sums of blend_backward_torch within the kernel tolerance.

The plain versions themselves match JAX (tests/test_torch_blend.py,
tests/test_torch_render_grad.py); these tests hold the kernels' shortcuts
against them.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from frosting_tpu_torch.cameras import look_at_camera
from frosting_tpu_torch.raster import RasterConfig
from frosting_tpu_torch.raster.binning import bin_gaussians
from frosting_tpu_torch.raster.blend_torch import (
    _direct_sums,
    _rows,
    _tile_pixels,
    _walk,
    blend_work_torch,
    instance_boxes_torch,
    moment_rows_tf32,
)
from frosting_tpu_torch.raster.config import ALPHA_CUTOFF
from frosting_tpu_torch.raster.preprocess import pack_fields, preprocess
from frosting_tpu_torch.scene.synthetic import adversarial_blend_inputs
from tests.test_torch_render import EYE, make_scene, torch_arrays

# A pixel grid around the instance, wide enough for the largest boxes drawn.
GRID = torch.meshgrid(torch.arange(-96.0, 160.0), torch.arange(-96.0, 160.0),
                      indexing="ij")


def _raw(field, px, py):
    """op * exp(power) as the plain walk computes it; 0 where power > 0."""
    mx, my, ca, cb, cc, op = field[:6]
    dx, dy = mx - px, my - py
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    return torch.where(power > 0.0, 0.0, op * torch.exp(power))


_f32 = dict(width=32, allow_nan=False, allow_infinity=False)


@settings(max_examples=150, deadline=None)
@given(
    mean=st.tuples(st.floats(-40.0, 100.0, **_f32), st.floats(-40.0, 100.0, **_f32)),
    conic=st.tuples(st.floats(-0.5, 4.0, **_f32), st.floats(-3.0, 3.0, **_f32),
                    st.floats(-0.5, 4.0, **_f32)),
    degenerate=st.sampled_from(["none", "det0", "a0", "thin", "needle"]),
    op=st.one_of(st.floats(float(np.float32(0.99 / 255)), float(np.float32(1.2 / 255)),
                           **_f32),
                 st.floats(0.0, 1.0, **_f32)),
    needle=st.tuples(st.floats(0.0, 2 * np.pi), st.floats(100.0, 3000.0),
                     st.floats(-60.0, 60.0)),
)
def test_every_pair_above_the_cutoff_lies_inside_its_box(mean, conic, degenerate, op,
                                                         needle):
    a, b, c = conic
    if degenerate == "det0":  # a singular conic: b^2 = a c
        b = float(np.sqrt(abs(a * c)))
    elif degenerate == "a0":
        a = 0.0
    elif degenerate == "thin":  # a near-singular, very anisotropic ellipse
        a, c = 3.3, 3.3
        b = 3.3 * (1 - 1e-5)
    elif degenerate == "needle" and op > 1.0 / 255:
        # sigma sl along u and preprocess's 0.3 px^2 across: det cancels in
        # float32. The mean lies back along u, off the grid, from a tip of
        # the alpha = 1/255 ellipse near the grid's centre, where the box ends
        phi, sl, inset = needle
        u = np.array([np.cos(phi), np.sin(phi)])
        a, b, c = np.linalg.inv(sl**2 * np.outer(u, u) + 0.3 * np.eye(2))[[0, 0, 1], [0, 1, 1]]
        rho = np.sqrt(2 * np.log(255 * op) / (a * u[0] ** 2 + 2 * b * u[0] * u[1] + c * u[1] ** 2))
        mean = (32.0 + inset - rho) * u[0], (32.0 + inset - rho) * u[1]
    field = torch.tensor([*mean, a, b, c, op, 0.0, 0.0, 0.0], dtype=torch.float32)
    x0, y0, x1, y1 = instance_boxes_torch(field[None])[0].tolist()
    ys, xs = GRID
    hit = _raw(field, xs, ys) >= ALPHA_CUTOFF
    inside = (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)
    assert not (hit & ~inside).any(), (x0, y0, x1, y1)


def test_boxes_of_degenerate_instances_are_the_whole_plane():
    fields = torch.tensor([
        [5.0, 5.0, 1.0, 0.0, 1.0, 1.0 / 255, 0, 0, 0],  # L = 0
        [5.0, 5.0, 1.0, 0.0, 1.0, 0.001, 0, 0, 0],  # L < 0
        [5.0, 5.0, 1.0, 1.0, 1.0, 0.5, 0, 0, 0],  # det = 0
        [5.0, 5.0, -1.0, 0.0, -1.0, 0.5, 0, 0, 0],  # not positive definite
        [5.0, 5.0, 1e-38, 0.0, 1e-38, 0.5, 0, 0, 0],  # box not finite
        [5.0, 5.0, 0.5, 0.0, 0.5, 0.5, 0, 0, 0],  # an ordinary one
    ])
    boxes = instance_boxes_torch(fields)
    assert torch.isinf(boxes[:5]).all()
    r = float(np.sqrt(2 * np.log(255 * 0.5) / 0.5))
    pad = 1.0 + r / 64
    torch.testing.assert_close(
        boxes[5], torch.tensor([5 - r - pad, 5 - r - pad, 5 + r + pad, 5 + r + pad]))


def _blend_inputs(width, height, n, seed, chunk=32):
    gs = torch_arrays(make_scene(n=n, seed=seed, opaque_wall=True))
    cam = look_at_camera(eye=EYE, target=[0.0, 0.0, 0.0], device="cpu")
    cfg = RasterConfig(width=width, height=height, chunk=chunk, max_instances=1 << 16)
    proj = preprocess(*gs, cam, cfg)
    return pack_fields(proj), bin_gaussians(proj.rect, proj.depths, proj.valid, cfg), cfg


@pytest.mark.parametrize("size", [(64, 64), (96, 80), "adversarial"],
                         ids=["64x64", "96x80", "adversarial"])
def test_no_pair_of_the_walk_above_the_cutoff_lies_outside_its_box(size):
    """Every (instance, pixel) pair of the plain walk, stopped or not, whose
    raw value reaches the cutoff lies inside the instance's box: the pairs
    the kernels skip are pairs the walk skips too."""
    if size == "adversarial":  # 100x70, degenerate conics, needles, a run of 300
        fields, binned, cfg = adversarial_blend_inputs(seed=1, device="cpu", deep=300)
    else:
        fields, binned, cfg = _blend_inputs(*size, n=300, seed=11)
        # widen some Gaussians past the tile and push some to the cutoff, so
        # that boxes both cover whole tiles and cut most of a tile's pairs
        fields = fields.clone()
        fields[0:40, 2:5] *= 0.02
        fields[40:80, 5] = 1.01 / 255
    boxes = instance_boxes_torch(fields[:-1])
    assert torch.isfinite(boxes).all(1).float().mean() > 0.5
    x, y = _tile_pixels(cfg, "cpu")
    px, py = x[..., None].float(), y[..., None].float()  # [T, P, 1]
    hits = 0
    for c in _walk(fields, binned, cfg):
        hit = (c.power <= 0.0) & (c.raw >= ALPHA_CUTOFF) & c.in_run[:, None, :]
        b = instance_boxes_torch(c.f.reshape(-1, 9)).reshape(*c.f.shape[:2], 4)
        b = b[:, None]  # [T', 1, K, 4]
        tx, ty = px[c.tiles], py[c.tiles]
        outside = ((tx < b[..., 0]) | (ty < b[..., 1])
                   | (tx > b[..., 2]) | (ty > b[..., 3]))
        assert not (hit & outside).any()
        hits += int(hit.sum())
    # the boxes leave pairs out: some were evaluated that need not be
    pairs = int(blend_work_torch(fields, binned, cfg))
    live = int(blend_work_torch(fields, binned, cfg, live=True))
    assert 0 < live <= hits and live < pairs


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_split_tf32_moments_match_the_direct_sums(seed):
    """One 32x16 tile of a 1920x1080 image, 64 instances whose means lie up
    to 100 px outside it, random dpower (both signs), weights and colour
    cotangents. Normalised by each column's largest magnitude, every row
    value holds 1e-5 + 1e-5 relative (the kernel's tolerance)."""
    rng = np.random.default_rng(seed)
    tile_w, tile_h, k = 32, 16, 64
    x0 = int(rng.integers(0, 1920 // tile_w)) * tile_w
    y0 = int(rng.integers(0, 1080 // tile_h)) * tile_h
    cx, cy = x0 + tile_w / 2, y0 + tile_h / 2
    sub = np.arange(tile_w * tile_h)
    px = (x0 + sub % tile_w).astype(np.float32)
    py = (y0 + sub // tile_w).astype(np.float32)
    f = np.zeros((k, 9), np.float32)
    f[:, 0] = cx + rng.uniform(-tile_w / 2 - 100, tile_w / 2 + 100, k)
    f[:, 1] = cy + rng.uniform(-tile_h / 2 - 100, tile_h / 2 + 100, k)
    f[:, 2] = rng.uniform(0.001, 2.0, k)
    f[:, 3] = rng.uniform(-0.5, 0.5, k) * f[:, 2]
    f[:, 4] = rng.uniform(0.001, 2.0, k)
    f[:, 5] = rng.uniform(0.01, 1.0, k)
    # dpower spans magnitudes, as a Gaussian's falloff gives
    dp = rng.normal(size=(px.size, k)) * np.exp(rng.uniform(-12, 0, (px.size, k)))
    w = rng.uniform(0, 1, (px.size, k)) * (rng.uniform(size=(px.size, k)) < 0.7)
    g = rng.normal(size=(px.size, 3))
    f, dp, w, g, px, py = (torch.from_numpy(np.asarray(a, np.float32))
                           for a in (f, dp, w, g, px, py))
    dx = f[None, :, 0] - px[:, None]
    dy = f[None, :, 1] - py[:, None]
    want = _rows(f, _direct_sums(dp, dx, dy), w.T @ g)
    got = moment_rows_tf32(f, dp, w, g, px - cx, py - cy, cx, cy)
    scale = want.abs().amax(dim=0)
    err = (got - want).abs() / scale
    assert (err <= 1e-5 + 1e-5 * want.abs() / scale).all(), err.amax(dim=0)
