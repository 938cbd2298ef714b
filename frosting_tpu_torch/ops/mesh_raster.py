"""Z-buffer triangle rasterization with pix_to_face + barycentrics.

Counterpart of ``frosting_tpu/ops/mesh_raster.py`` (the PyTorch3D
MeshRasterizer / nvdiffrast stand-in of extraction's visibility culling and
the later stages' occlusion culling and texture baking). Triangles are
binned to pixel tiles by the Gaussian rasterizer's ``bin_gaussians`` (a
face's tile rect, depth keys all zero, so each tile's run stays in face
order), then every (instance, tile pixel) pair is evaluated, a bounded
number of pairs at a time, and the nearest face of each pixel is taken by
one ``scatter_reduce(amin)`` over a packed int64 key: the float32 bits of
the pixel's depth (positive, so they order as the values do) above the
face id. The winner's barycentrics are recomputed at its pixel with the
same arithmetic. Ties in depth go to the lowest face id, as in JAX, whose
``argmin`` within a chunk and strict ``<`` across chunks walk each tile's
run in face order. Barycentrics are screen-space linear (the reference's
perspective_correct=False). Plain PyTorch: the JAX version is no Pallas
kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from frosting_tpu_torch.cameras import Camera, ndc_to_pix
from frosting_tpu_torch.ops.cov import matvec_rows
from frosting_tpu_torch.raster.binning import bin_gaussians
from frosting_tpu_torch.raster.config import RasterConfig

# (instance, pixel) pairs evaluated at once: bounds the working set (a few
# [pairs] float32 / int64 arrays) whatever the face count.
CHUNK_PAIRS = 1 << 24
_NO_HIT = torch.iinfo(torch.int64).max


class Fragments(NamedTuple):
    """Per-pixel rasterization result (PyTorch3D Fragments analogue)."""

    pix_to_face: torch.Tensor  # [H, W] int64, -1 for background
    zbuf: torch.Tensor  # [H, W] f32, +inf for background
    bary: torch.Tensor  # [H, W, 3] f32


def project_verts(verts: torch.Tensor, camera: Camera, cfg: RasterConfig):
    """-> (xy [V, 2] pixel coords, z_view [V])."""
    ones = torch.ones_like(verts[:, :1])
    homog = torch.cat([verts, ones], dim=-1)
    p_view = matvec_rows(homog, camera.world_view[:, :3])
    p_hom = matvec_rows(homog, camera.full_proj)
    w = p_hom[:, 3]
    ndc = p_hom[:, :2] / (w[:, None] + 1e-9)
    x = ndc_to_pix(ndc[:, 0], cfg.projection_width)
    y = ndc_to_pix(ndc[:, 1], cfg.projection_height)
    return torch.stack([x, y], dim=-1), p_view[:, 2]


def _face_rects(xy, z, faces, cfg: RasterConfig, near: float):
    """Conservative tile rect per face + validity."""
    tri = xy[faces]  # [F, 3, 2]
    zf = z[faces]  # [F, 3]
    mn = torch.amin(tri, dim=1)
    mx = torch.amax(tri, dim=1)

    def tile(v, size, count, plus):
        return torch.clamp(torch.floor(v / size) + plus, 0, count).to(torch.int32)

    tx0 = tile(mn[:, 0], cfg.tile_w, cfg.tiles_x, 0)
    ty0 = tile(mn[:, 1], cfg.tile_h, cfg.tiles_y, 0)
    tx1 = tile(mx[:, 0], cfg.tile_w, cfg.tiles_x, 1)
    ty1 = tile(mx[:, 1], cfg.tile_h, cfg.tiles_y, 1)
    valid = torch.all(zf > near, dim=1)  # conservative near-cull
    valid &= (tx1 - tx0) * (ty1 - ty0) > 0
    return torch.stack([tx0, ty0, tx1, ty1], dim=-1), valid


def _barycentrics(tri_xy, tri_z, px, py):
    """(b0, b1, b2, inside, zpix) of triangles tri_xy [..., 3, 2] with
    depths tri_z [..., 3] at pixels (px, py), broadcast; the arithmetic of
    the JAX ``_chunk_zmin``."""
    ax, ay = tri_xy[..., 0, 0], tri_xy[..., 0, 1]
    bx, by = tri_xy[..., 1, 0], tri_xy[..., 1, 1]
    cx, cy = tri_xy[..., 2, 0], tri_xy[..., 2, 1]
    # signed edge functions at pixel centers
    w0 = (bx - px) * (cy - py) - (cx - px) * (by - py)
    w1 = (cx - px) * (ay - py) - (ax - px) * (cy - py)
    w2 = (ax - px) * (by - py) - (bx - px) * (ay - py)
    area = (bx - ax) * (cy - ay) - (cx - ax) * (by - ay)
    area_safe = torch.where(torch.abs(area) < 1e-12, 1.0, area)
    b0 = w0 / area_safe
    b1 = w1 / area_safe
    b2 = w2 / area_safe
    inside = (b0 >= 0.0) & (b1 >= 0.0) & (b2 >= 0.0) & (torch.abs(area) > 1e-12)
    zpix = b0 * tri_z[..., 0] + b1 * tri_z[..., 1] + b2 * tri_z[..., 2]
    return b0, b1, b2, inside, zpix


@torch.no_grad()
def rasterize_mesh(
    verts: torch.Tensor,
    faces: torch.Tensor,
    camera: Camera,
    cfg: RasterConfig,
    near: float = 0.01,
) -> Fragments:
    """Rasterize a triangle mesh to Fragments. cfg supplies image/tile
    geometry and the instance capacity (faces x tiles)."""
    dev = verts.device
    faces = faces.long()
    xy, z = project_verts(verts, camera, cfg)
    rect, valid = _face_rects(xy, z, faces, cfg, near)
    binned = bin_gaussians(
        rect, torch.zeros(faces.shape[0], device=dev), valid, cfg)
    inst_face = binned.inst_gauss.long()
    runs = (binned.tile_ranges[:, 1] - binned.tile_ranges[:, 0]).long()
    inst_tile = torch.repeat_interleave(
        torch.arange(cfg.n_tiles, device=dev), runs, output_size=len(inst_face))
    tri_xy, tri_z = xy[faces], z[faces]

    p = cfg.tile_pixels
    lane = torch.arange(p, device=dev)
    lx, ly = lane % cfg.tile_w, lane // cfg.tile_w
    best = torch.full((cfg.n_tiles * p,), _NO_HIT, dtype=torch.int64, device=dev)
    per = max(1, CHUNK_PAIRS // p)
    for s in range(0, len(inst_face), per):
        f, t = inst_face[s:s + per], inst_tile[s:s + per]
        px = ((t % cfg.tiles_x) * cfg.tile_w)[:, None] + lx[None]
        py = ((t // cfg.tiles_x) * cfg.tile_h)[:, None] + ly[None]
        _b0, _b1, _b2, inside, zpix = _barycentrics(
            tri_xy[f][:, None], tri_z[f][:, None], px.float(), py.float())
        key = (zpix.view(torch.int32).long() << 32) | f[:, None]
        key = torch.where(inside & (zpix > 0.0), key, _NO_HIT)
        best.scatter_reduce_(0, (t[:, None] * p + lane[None]).reshape(-1),
                             key.reshape(-1), "amin")

    hit = best != _NO_HIT
    face = torch.where(hit, best & 0xFFFFFFFF, 0)
    pix = torch.arange(cfg.n_tiles * p, device=dev)
    t = pix // p
    px = ((t % cfg.tiles_x) * cfg.tile_w + lx[pix % p]).float()
    py = ((t // cfg.tiles_x) * cfg.tile_h + ly[pix % p]).float()
    b0, b1, b2, _inside, _z = _barycentrics(tri_xy[face], tri_z[face], px, py)
    zbuf = torch.where(hit, (best >> 32).to(torch.int32).view(torch.float32),
                       float("inf"))
    bary = torch.where(hit[:, None], torch.stack([b0, b1, b2], dim=-1), 0.0)

    def untile(x, c):
        x = x.reshape(cfg.tiles_y, cfg.tiles_x, cfg.tile_h, cfg.tile_w, c)
        x = x.permute(0, 2, 1, 3, 4).reshape(
            cfg.tiles_y * cfg.tile_h, cfg.tiles_x * cfg.tile_w, c)
        return x[: cfg.height, : cfg.width]

    return Fragments(
        pix_to_face=untile(torch.where(hit, face, -1), 1)[..., 0],
        zbuf=untile(zbuf, 1)[..., 0],
        bary=untile(bary, 3),
    )
