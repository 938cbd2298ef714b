"""Naive per-pixel compositing oracle for tests (O(N * H * W), tiny scenes).

Counterpart of ``frosting_tpu/raster/reference.py``: the renderer's
semantics (tile-rect inclusion, alpha clamp and cutoff, stop test of
renderCUDA forward.cu:310-351) as a sequential walk over depth-sorted
Gaussians, sharing no code with the binned path.
"""

from __future__ import annotations

import torch

from frosting_tpu_torch.raster.config import (
    ALPHA_CLAMP,
    ALPHA_CUTOFF,
    TRANSMITTANCE_EPS,
    RasterConfig,
)
from frosting_tpu_torch.raster.preprocess import Projected


def render_naive(proj: Projected, bg: torch.Tensor, cfg: RasterConfig):
    """Returns (image [3, H, W], t_final [H, W])."""
    dev = proj.means2d.device
    h, w = cfg.height, cfg.width
    ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    tile_x = (torch.arange(w, device=dev) // cfg.tile_w)[None, :]
    tile_y = (torch.arange(h, device=dev) // cfg.tile_h)[:, None]

    depth_key = torch.where(
        proj.valid, proj.depths, torch.full_like(proj.depths, float("inf"))
    )
    order = torch.sort(depth_key, stable=True).indices

    t_all = torch.ones((h, w), device=dev)
    t_mask = torch.ones((h, w), device=dev)
    color = torch.zeros((3, h, w), device=dev)
    for g in order.tolist():
        mx, my = proj.means2d[g, 0], proj.means2d[g, 1]
        ca, cb, cc = proj.conics[g, 0], proj.conics[g, 1], proj.conics[g, 2]
        op = proj.opacities[g] if bool(proj.valid[g]) else proj.opacities.new_zeros(())
        tx0, ty0, tx1, ty1 = (int(v) for v in proj.rect[g])
        in_rect = (tile_x >= tx0) & (tile_x < tx1) & (tile_y >= ty0) & (tile_y < ty1)
        dx = mx - xs
        dy = my - ys
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        raw = op * torch.exp(power)
        alpha = torch.clamp(raw, max=ALPHA_CLAMP)
        alpha = torch.where(
            (power > 0.0) | (raw < ALPHA_CUTOFF) | ~in_rect, 0.0, alpha
        )
        m = t_all * (1.0 - alpha) >= TRANSMITTANCE_EPS
        wgt = torch.where(m, alpha * t_all, 0.0)
        color = color + wgt[None] * proj.colors[g][:, None, None]
        t_all = t_all * (1.0 - alpha)
        t_mask = t_mask * torch.where(m, 1.0 - alpha, 1.0)
    img = color + t_mask[None] * bg.to(dev)[:, None, None]
    return img, t_mask
