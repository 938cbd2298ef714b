"""Per-Gaussian preprocessing: projection, EWA covariance, SH colour, tile
rect (preprocessCUDA, cuda_rasterizer/forward.cu:154-259).

Counterpart of ``frosting_tpu/raster/preprocess.py``. Plain tensor code,
differentiable by autograd; the integer outputs (radii, rect) carry no
gradient.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from frosting_tpu_torch.cameras import Camera, ndc_to_pix
from frosting_tpu_torch.ops import cov as cov_ops
from frosting_tpu_torch.ops import sh as sh_ops
from frosting_tpu_torch.raster.config import ALPHA_CUTOFF, RasterConfig


class Projected(NamedTuple):
    means2d: torch.Tensor  # [N, 2] pixel coords
    conics: torch.Tensor  # [N, 3] inverse 2D covariance (a, b, c)
    colors: torch.Tensor  # [N, 3] clamped RGB
    opacities: torch.Tensor  # [N] activated opacity
    depths: torch.Tensor  # [N] view-space z
    radii: torch.Tensor  # [N] int32 3-sigma pixel radius (0 => culled)
    rect: torch.Tensor  # [N, 4] int32 (tx0, ty0, tx1, ty1) tile bbox
    valid: torch.Tensor  # [N] bool


def _tile_index(v: torch.Tensor, tile: int, limit: int, plus: int = 0):
    """`clip(v // tile + plus, 0, limit)` as int32, with float floor
    division as in the JAX reference."""
    q = torch.div(v, tile, rounding_mode="floor") + plus
    return torch.clamp(q, 0, limit).to(torch.int32)


def preprocess(
    means3d: torch.Tensor,  # [N, 3]
    scales: torch.Tensor,  # [N, 3] activated (positive)
    quats: torch.Tensor,  # [N, 4] unit wxyz
    opacities: torch.Tensor,  # [N] activated (0..1)
    sh: torch.Tensor,  # [N, K, 3] SH coefficients
    camera: Camera,
    cfg: RasterConfig,
    active_sh_degree: int | None = None,
    colors_precomp: torch.Tensor | None = None,
    cov3d_precomp: torch.Tensor | None = None,
    scale_modifier: float = 1.0,
    pixel_offset=(0, 0),
) -> Projected:
    """``pixel_offset`` (ox, oy): the projection is always in the full
    image's pixel frame (``cfg.projection_width`` / ``projection_height``);
    the means are then shifted into the frame of the rendered sub-rectangle
    whose top-left pixel is (ox, oy), and the tile rect is taken against
    ``cfg``'s grid there."""
    deg = cfg.sh_degree if active_sh_degree is None else active_sh_degree
    camera = camera.to(means3d.device)
    f32 = torch.float32

    homog = torch.cat([means3d, torch.ones_like(means3d[..., :1])], dim=-1)
    p_view = cov_ops.matvec_rows(homog, camera.world_view[:, :3])
    depth = p_view[..., 2]
    in_front = depth > cfg.near

    p_hom = cov_ops.matvec_rows(homog, camera.full_proj)
    p_w = 1.0 / (p_hom[..., 3] + 1e-7)
    ndc = p_hom[..., :2] * p_w[..., None]
    mean_x = ndc_to_pix(ndc[..., 0], cfg.projection_width) - pixel_offset[0]
    mean_y = ndc_to_pix(ndc[..., 1], cfg.projection_height) - pixel_offset[1]
    means2d = torch.stack([mean_x, mean_y], dim=-1)

    if cov3d_precomp is None:
        cov6 = cov_ops.cov3d_from_scale_quat(scales * scale_modifier, quats)
    else:
        cov6 = cov3d_precomp
    focal_x, focal_y = camera.focals(cfg.projection_width, cfg.projection_height)
    cov2d = cov_ops.ewa_project(
        means3d, cov6, camera.world_view, focal_x, focal_y,
        camera.tan_fov_x, camera.tan_fov_y,
    )
    conic, radius_f, det = cov_ops.conic_and_radius(cov2d)

    if colors_precomp is None:
        dirs = means3d - camera.cam_center
        norm = torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True))
        dirs = dirs / torch.clamp(norm, min=1e-12)
        colors = torch.clamp(sh_ops.eval_sh(deg, sh, dirs) + 0.5, min=0.0)
    else:
        colors = colors_precomp

    # Tile rect (getRect, auxiliary.h:46-55) from the per-axis 3-sigma
    # extents, shrunk to the ellipse {q <= 2 ln(255 opac)} outside which
    # alpha < 1/255 and the blend adds nothing (+1e-2 slack in q: the log
    # here and the exp in the blend round differently).
    rx, ry = cov_ops.axis_extents(cov2d)
    t_cut = torch.sqrt(
        torch.clamp(
            2.0 * torch.log(255.0 * torch.clamp(opacities, min=1e-12)) + 1e-2,
            0.0,
            9.0,
        )
    ) * (1.0 / 3.0)
    keep = in_front & (det > 0.0)
    rx = torch.where(keep, rx * t_cut, torch.zeros_like(rx))
    ry = torch.where(keep, ry * t_cut, torch.zeros_like(ry))
    # Pixel samples sit at integer coordinates: the covered pixel range is
    # [ceil(mean - r), floor(mean + r)], so the exclusive tile end is
    # floor(mean + r) // tile + 1.
    tx0 = _tile_index(torch.ceil(mean_x - rx), cfg.tile_w, cfg.tiles_x)
    ty0 = _tile_index(torch.ceil(mean_y - ry), cfg.tile_h, cfg.tiles_y)
    tx1 = _tile_index(torch.floor(mean_x + rx), cfg.tile_w, cfg.tiles_x, 1)
    ty1 = _tile_index(torch.floor(mean_y + ry), cfg.tile_h, cfg.tiles_y, 1)
    # empty coverage can give tx1 < tx0: clamp so widths are never negative
    tx1 = torch.maximum(tx1, tx0)
    ty1 = torch.maximum(ty1, ty0)
    area = (tx1 - tx0) * (ty1 - ty0)
    # opac < 1/255 => alpha is zero at every pixel: cull outright
    valid = in_front & (det > 0.0) & (area > 0) & (opacities >= ALPHA_CUTOFF)
    rect = torch.stack([tx0, ty0, tx1, ty1], dim=-1)
    radii = torch.where(valid, radius_f, torch.zeros_like(radius_f)).to(torch.int32)

    return Projected(
        means2d=means2d.to(f32),
        conics=conic.to(f32),
        colors=colors.to(f32),
        opacities=opacities.to(f32),
        depths=depth.to(f32),
        radii=radii,
        rect=rect,
        valid=valid,
    )


def rect_for_grid(means2d: torch.Tensor, radii: torch.Tensor, cfg: RasterConfig):
    """(rect [N, 4] int32, valid [N] bool) of already-projected Gaussians
    against cfg's tile grid, from the isotropic radius (used when a
    projection is re-targeted to a sub-rectangle)."""
    r = radii.to(torch.float32)
    mean_x, mean_y = means2d[..., 0], means2d[..., 1]
    tx0 = _tile_index(torch.ceil(mean_x - r), cfg.tile_w, cfg.tiles_x)
    ty0 = _tile_index(torch.ceil(mean_y - r), cfg.tile_h, cfg.tiles_y)
    tx1 = _tile_index(torch.floor(mean_x + r), cfg.tile_w, cfg.tiles_x, 1)
    ty1 = _tile_index(torch.floor(mean_y + r), cfg.tile_h, cfg.tiles_y, 1)
    tx1 = torch.maximum(tx1, tx0)
    ty1 = torch.maximum(ty1, ty0)
    area = (tx1 - tx0) * (ty1 - ty0)
    valid = (radii > 0) & (area > 0)
    return torch.stack([tx0, ty0, tx1, ty1], dim=-1), valid


def shift_projected(
    proj: Projected,
    pixel_offset,
    strip_cfg: RasterConfig,
    tile_aligned: bool | None = None,
) -> Projected:
    """Re-target a full-image projection to a sub-rectangle (a strip) whose
    top-left pixel is pixel_offset = (ox, oy) of ints: the 2D means move into
    its pixel frame and the tile rect is taken against strip_cfg's grid.
    Where the offset is a whole number of tiles (``tile_aligned``; found
    from the ints where None), the full image's anisotropic rect is shifted
    exactly, so a strip covers the same instances as the full render's rows
    of tiles; otherwise the rect is re-derived from the isotropic radius
    (``rect_for_grid``)."""
    ox, oy = int(pixel_offset[0]), int(pixel_offset[1])
    if tile_aligned is None:
        tile_aligned = ox % strip_cfg.tile_w == 0 and oy % strip_cfg.tile_h == 0
    means2d = proj.means2d - torch.tensor(
        [ox, oy], dtype=torch.float32, device=proj.means2d.device)
    if tile_aligned:
        tox, toy = ox // strip_cfg.tile_w, oy // strip_cfg.tile_h
        tx0 = torch.clamp(proj.rect[:, 0] - tox, 0, strip_cfg.tiles_x)
        ty0 = torch.clamp(proj.rect[:, 1] - toy, 0, strip_cfg.tiles_y)
        tx1 = torch.clamp(proj.rect[:, 2] - tox, 0, strip_cfg.tiles_x)
        ty1 = torch.clamp(proj.rect[:, 3] - toy, 0, strip_cfg.tiles_y)
        rect = torch.stack([tx0, ty0, tx1, ty1], dim=-1)
        valid = proj.valid & ((tx1 - tx0) * (ty1 - ty0) > 0)
    else:
        rect, valid = rect_for_grid(means2d, proj.radii, strip_cfg)
    return proj._replace(means2d=means2d, rect=rect, valid=valid)


def pack_fields(proj: Projected) -> torch.Tensor:
    """Per-Gaussian blend inputs packed as [N + 1, INSTANCE_WIDTH] float32
    rows (the layout in config.py), opacity zeroed for invalid Gaussians.
    The trailing all-zero row is a sentinel that contributes nothing."""
    opac = torch.where(proj.valid, proj.opacities, torch.zeros_like(proj.opacities))
    rows = torch.cat(
        [proj.means2d, proj.conics, opac[:, None], proj.colors], dim=1
    )
    return torch.cat([rows, torch.zeros_like(rows[:1])], dim=0).contiguous()
