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
