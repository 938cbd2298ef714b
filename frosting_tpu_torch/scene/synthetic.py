"""Procedural synthetic scenes for tests and benchmarks.

Counterpart of ``frosting_tpu/scene/synthetic.py``: the arrays come from
numpy with the same seeds, so both packages get identical scenes.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch

from frosting_tpu_torch.cameras import Camera, look_at_camera
from frosting_tpu_torch.ops import sh as sh_ops
from frosting_tpu_torch.raster import RasterConfig, render


def gaussian_blob_scene(
    n: int = 5000, seed: int = 0, device="cuda"
) -> Tuple[torch.Tensor, ...]:
    """A colourful blob cloud: activated (means, scales, quats, opacities,
    sh)."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(0, 2 * np.pi, n)
    r = 0.6 + 0.25 * np.sin(3 * t) + rng.normal(scale=0.05, size=n)
    z = 0.4 * np.cos(2 * t) + rng.normal(scale=0.08, size=n)
    means = np.stack([r * np.cos(t), r * np.sin(t), z], axis=1)
    scales = np.exp(rng.uniform(np.log(0.01), np.log(0.05), (n, 3)))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.4, 0.95, n)
    sh = np.zeros((n, 16, 3), np.float32)
    sh[:, 0] = (means + 1.2) * 0.8 + rng.normal(scale=0.05, size=(n, 3))
    sh[:, 1:4] = rng.normal(scale=0.08, size=(n, 3, 3))
    return tuple(
        torch.as_tensor(np.asarray(a, np.float32), device=device)
        for a in (means, scales, quats, opac, sh)
    )


def camera_ring(
    n_cams: int = 24,
    radius: float = 3.0,
    height: float = 0.8,
    fov_deg: float = 50.0,
    device="cuda",
) -> List[Camera]:
    cams = []
    for i in range(n_cams):
        a = 2 * math.pi * i / n_cams
        eye = [radius * math.cos(a), radius * math.sin(a), height]
        cams.append(
            look_at_camera(
                eye=eye, target=[0.0, 0.0, 0.0], up=(0, 0, 1),
                fov_x=math.radians(fov_deg), device=device,
            )
        )
    return cams


def render_gt_images(
    gt_gaussians, cameras: List[Camera], cfg: RasterConfig, bg
) -> np.ndarray:
    """Ground-truth views [n_cams, 3, H, W] as numpy."""
    dev = gt_gaussians[0].device
    bg = torch.as_tensor(np.asarray(bg, np.float32), device=dev)
    with torch.inference_mode():
        return np.stack(
            [
                render(*gt_gaussians, c, cfg, bg=bg).image.cpu().numpy()
                for c in cameras
            ]
        )


def degraded_init(
    gt_gaussians, keep: float = 0.3, jitter: float = 0.05, seed: int = 1
) -> Tuple[np.ndarray, np.ndarray]:
    """Subsample and jitter the ground-truth cloud as a training starting
    point (in place of a COLMAP seed cloud): (points [n, 3], colours [n, 3])
    as float32 numpy."""
    means, _scales, _quats, _opac, sh = (
        torch.as_tensor(a).detach().cpu() for a in gt_gaussians
    )
    rng = np.random.default_rng(seed)
    n = means.shape[0]
    idx = rng.choice(n, int(n * keep), replace=False)
    pts = means.numpy()[idx] + rng.normal(scale=jitter, size=(len(idx), 3))
    cols = torch.clamp(sh_ops.sh_to_rgb(sh[torch.from_numpy(idx), 0]), 0.0, 1.0)
    return pts.astype(np.float32), cols.numpy().astype(np.float32)


def adversarial_blend_inputs(seed: int = 0, device="cuda", deep: int = 12_000):
    """Blend inputs built to stress the blend kernels' shortcuts, without
    preprocess: (fields [N + 1, 9], Binned, RasterConfig) for a 100x70
    image (4x5 tiles of 32x16, partial at the edges).

    The Gaussians mix small footprints, large anisotropic ones whose boxes
    exceed the tile, conics that are singular or not positive definite,
    and opacities just above 1/255. Tile 0's run holds ``deep`` instances
    of low opacity (a deep walk); every other tile holds 300, each run in
    Gaussian index order (the depth order). In front of every run stand 8
    needles: footprints thousands of pixels long and 0.55 px wide
    (preprocess's 0.3 px^2 dilation), at a slant that makes det = a c - b^2
    cancel in float32, with their means far off screen and the tips of
    their alpha = 1/255 ellipses inside the image, where a box from the
    rounded det would end."""
    from frosting_tpu_torch.raster.binning import Binned

    cfg = RasterConfig(width=100, height=70, max_instances=1 << 20)
    rng = np.random.default_rng(seed)
    n, needles = deep + 300, 8
    kind = rng.choice(4, n, p=[0.4, 0.3, 0.1, 0.2])
    # the last row is pack_fields' all-zero sentinel
    f = np.zeros((n + needles + 1, 9))
    f[:n, 0] = rng.uniform(-40, cfg.width + 40, n)
    f[:n, 1] = rng.uniform(-40, cfg.height + 40, n)
    # conic = inverse of a rotated covariance with sigmas (s1, s2)
    s1 = np.where(kind == 1, rng.uniform(20, 80, n), rng.uniform(0.7, 4, n))
    s2 = np.where(kind == 1, rng.uniform(0.5, 3, n), s1 * rng.uniform(0.5, 1, n))
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    cov = np.stack([c * c * s1**2 + s * s * s2**2, c * s * (s1**2 - s2**2),
                    s * s * s1**2 + c * c * s2**2], 1)
    det = cov[:, 0] * cov[:, 2] - cov[:, 1] ** 2
    f[:n, 2], f[:n, 3], f[:n, 4] = cov[:, 2] / det, -cov[:, 1] / det, cov[:, 0] / det
    bad = kind == 2  # singular (b^2 = a c) or indefinite conics
    f[:n, 3] = np.where(bad, np.sqrt(f[:n, 2] * f[:n, 4]) * rng.choice([1.0, 1.5], n),
                        f[:n, 3])
    f[:n, 5] = np.where(kind == 3, (1 + rng.uniform(0, 0.05, n)) / 255,
                        rng.uniform(0.05, 0.99, n))
    f[:deep, 5] = np.minimum(f[:deep, 5], rng.uniform(1.01 / 255, 0.03, deep))
    f[:n, 6:9] = rng.uniform(0, 1, (n, 3))
    runs = [np.arange(deep)] + [
        np.sort(rng.choice(np.arange(deep, n), 300, replace=False))
        for _ in range(cfg.n_tiles - 1)
    ]
    # needles: covariance sl^2 u u^T + 0.3 I, u at 20-70 degrees to an axis;
    # the mean lies back along u from a tip within 40 px of the image centre
    phi = rng.uniform(np.radians(20), np.radians(70), needles) + (
        np.pi / 2 * rng.integers(0, 4, needles))
    u = np.stack([np.cos(phi), np.sin(phi)], 1)
    sl = rng.uniform(600, 1500, needles)
    cov = sl[:, None, None] ** 2 * u[:, :, None] * u[:, None, :] + 0.3 * np.eye(2)
    conic = np.linalg.inv(cov)
    op = rng.uniform(0.3, 0.99, needles)
    # the alpha = 1/255 ellipse reaches rho along u: rho^2 u^T C u / 2 = L
    rho = np.sqrt(2 * np.log(255 * op) / np.einsum("ni,nij,nj->n", u, conic, u))
    tip = np.array([cfg.width / 2, cfg.height / 2]) + rng.uniform(-40, 40, (needles, 1)) * u
    rows = slice(n, n + needles)
    f[rows, 0:2] = tip - rho[:, None] * u
    f[rows, 2], f[rows, 3], f[rows, 4] = conic[:, 0, 0], conic[:, 0, 1], conic[:, 1, 1]
    f[rows, 5] = op
    f[rows, 6:9] = rng.uniform(0, 1, (needles, 3))
    runs = [np.concatenate([np.arange(n, n + needles), r]) for r in runs]
    lens = np.array([len(r) for r in runs])
    ends = np.cumsum(lens)
    ranges = np.stack([ends - lens, ends], 1)
    binned = Binned(
        inst_gauss=torch.as_tensor(np.concatenate(runs), dtype=torch.int32, device=device),
        tile_ranges=torch.as_tensor(ranges, dtype=torch.int32, device=device),
        num_instances=torch.tensor(int(ends[-1]), device=device),
        overflow=torch.tensor(False, device=device),
    )
    return torch.as_tensor(f, dtype=torch.float32, device=device), binned, cfg
