"""Plain PyTorch forward blend: front-to-back alpha compositing of each
tile's depth-ordered instance run.

Counterpart of the forward halves of ``frosting_tpu/raster/chunk_math.py``
(``_chunk_common``/``forward_chunk``) and ``blend_jax.py``, with the same
semantics:

  * alpha = min(0.99, op * exp(power)), zeroed where power > 0 or the raw
    value is below 1/255;
  * a pixel stops at the first Gaussian with T * (1 - alpha) < 1e-4, and
    that Gaussian does not contribute;
  * t_final is T after the last contributing Gaussian.

It runs on every tile at once and walks the tile runs ``cfg.chunk``
instances at a time, carrying two transmittances per pixel: ``t_all``, the
product over every alpha seen (it drives the stop test and, being
monotone, keeps a stopped pixel stopped), and ``t_mask``, the transmittance
after the last contributing Gaussian. This is the CPU path and the on-card
yardstick of the CUDA kernel (blend_cuda.py).
"""

from __future__ import annotations

import torch

from frosting_tpu_torch.raster.binning import Binned
from frosting_tpu_torch.raster.config import (
    ALPHA_CLAMP,
    ALPHA_CUTOFF,
    TRANSMITTANCE_EPS,
    RasterConfig,
)


def _walk(fields: torch.Tensor, binned: Binned, cfg: RasterConfig):
    """Yield, chunk by chunk, (in_run, f, alpha, t_before, m, incl, t_all)
    for every tile: in_run [T, K] marks slots inside the tile's run, f
    [T, K, 9] holds their fields, alpha/t_before/m/incl are [T, P, K] per
    (pixel, instance) terms (m: the instance contributes) and t_all
    [T, P, 1] is the carried transmittance before the chunk."""
    dev = fields.device
    n_tiles, p, k = cfg.n_tiles, cfg.tile_pixels, cfg.chunk
    sentinel = fields.shape[0] - 1  # the all-zero row of pack_fields
    starts = binned.tile_ranges[:, 0].long()
    lens = binned.tile_ranges[:, 1].long() - starts
    inst_gauss = binned.inst_gauss.long()
    sub = torch.arange(p, device=dev)
    tile = torch.arange(n_tiles, device=dev)
    # pixel centres at integer coordinates, [T, P, 1]
    px = ((tile % cfg.tiles_x)[:, None] * cfg.tile_w + sub % cfg.tile_w)
    py = ((tile // cfg.tiles_x)[:, None] * cfg.tile_h + sub // cfg.tile_w)
    px = px.to(fields.dtype)[..., None]
    py = py.to(fields.dtype)[..., None]
    t_all = torch.ones((n_tiles, p, 1), dtype=fields.dtype, device=dev)
    slot = torch.arange(k, device=dev)
    max_len = int(lens.max()) if n_tiles else 0
    for c0 in range(0, max_len, k):
        in_run = (c0 + slot)[None, :] < lens[:, None]  # [T, K]
        idx = torch.where(in_run, starts[:, None] + c0 + slot, 0)
        gid = torch.where(in_run, inst_gauss[idx], sentinel)
        f = fields[gid]  # [T, K, W]
        mx, my = f[:, None, :, 0], f[:, None, :, 1]  # [T, 1, K]
        ca, cb, cc = f[:, None, :, 2], f[:, None, :, 3], f[:, None, :, 4]
        op = f[:, None, :, 5]
        dx = mx - px  # [T, P, K]
        dy = my - py
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        raw = op * torch.exp(power)
        alpha = torch.clamp(raw, max=ALPHA_CLAMP)
        alpha = torch.where((power > 0.0) | (raw < ALPHA_CUTOFF), 0.0, alpha)
        one_minus = 1.0 - alpha
        incl = torch.cumprod(one_minus, dim=2)
        excl = torch.cat([torch.ones_like(incl[..., :1]), incl[..., :-1]], 2)
        t_before = t_all * excl
        m = (t_before * one_minus >= TRANSMITTANCE_EPS) & in_run[:, None, :]
        yield in_run, f, alpha, t_before, m, incl, t_all
        t_all = t_all * incl[..., -1:]


def blend_forward_torch(
    fields: torch.Tensor,  # [N + 1, 9] pack_fields output
    binned: Binned,
    cfg: RasterConfig,
) -> torch.Tensor:
    """Returns [4, H, W]: rows 0..2 colour, row 3 t_final."""
    n_tiles, p = cfg.n_tiles, cfg.tile_pixels
    color = fields.new_zeros((n_tiles, p, 3))
    t_mask = fields.new_ones((n_tiles, p, 1))
    for _in_run, f, alpha, t_before, m, incl, t_all in _walk(fields, binned, cfg):
        w = torch.where(m, alpha * t_before, 0.0)  # [T, P, K]
        color = color + torch.bmm(w, f[..., 6:9])
        # transmittance after each contributing Gaussian; it only falls
        # along the walk, so the minimum is the last one
        v = torch.where(m, t_all * incl, 1.0)
        t_mask = torch.minimum(t_mask, torch.amin(v, dim=2, keepdim=True))
    out = torch.cat([color, t_mask], dim=2)  # [T, P, 4]
    out = out.reshape(cfg.tiles_y, cfg.tiles_x, cfg.tile_h, cfg.tile_w, 4)
    out = out.permute(4, 0, 2, 1, 3).reshape(
        4, cfg.tiles_y * cfg.tile_h, cfg.tiles_x * cfg.tile_w
    )
    return out[:, : cfg.height, : cfg.width].contiguous()


def blend_work_torch(
    fields: torch.Tensor, binned: Binned, cfg: RasterConfig
) -> torch.Tensor:
    """Number of (instance, pixel) evaluations a front-to-back walk that
    stops each pixel at its stop Gaussian needs, summed over the pixels
    inside the image: the work the blend's data requires (for a roofline
    bound), with no early stop of whole tiles assumed."""
    n_tiles, p = cfg.n_tiles, cfg.tile_pixels
    work = torch.zeros((n_tiles, p), dtype=torch.int64, device=fields.device)
    stopped = torch.zeros((n_tiles, p), dtype=torch.bool, device=fields.device)
    for in_run, _f, _a, _tb, m, _incl, _ta in _walk(fields, binned, cfg):
        # m is true on a prefix of each pixel's run and false from its stop
        work += m.sum(dim=2)
        stopped |= (~m & in_run[:, None, :]).any(dim=2)
    work += stopped.long()
    sub = torch.arange(p, device=fields.device)
    tile = torch.arange(n_tiles, device=fields.device)
    x = (tile % cfg.tiles_x)[:, None] * cfg.tile_w + sub % cfg.tile_w
    y = (tile // cfg.tiles_x)[:, None] * cfg.tile_h + sub // cfg.tile_w
    inside = (x < cfg.width) & (y < cfg.height)
    return torch.sum(work * inside)
