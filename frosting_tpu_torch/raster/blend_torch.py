"""Plain PyTorch blend: front-to-back alpha compositing of each tile's
depth-ordered instance run, and its backward.

Counterpart of ``frosting_tpu/raster/chunk_math.py`` (``_chunk_common``,
``forward_chunk``, ``backward_chunk``) and ``blend_jax.py``, with the same
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
after the last contributing Gaussian. The backward re-walks the runs in
forward order with JAX's suffix trick (see ``blend_backward_torch``). These
are the CPU path and the on-card yardsticks of the CUDA kernels
(blend_cuda.py).

Beside them live the plain forms of the kernels' two design arguments:
``instance_boxes_torch``, the pixel box outside which a pair is below the
cutoff (the kernels skip such pairs unevaluated), and ``moment_rows_tf32``,
the backward's per-instance sums as split-TF32 moment products
(csrc/blend_common.cuh).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from frosting_tpu_torch.raster.binning import Binned
from frosting_tpu_torch.raster.config import (
    ALPHA_CLAMP,
    ALPHA_CUTOFF,
    INSTANCE_WIDTH,
    TRANSMITTANCE_EPS,
    RasterConfig,
)


# The footprint box's padding beyond the alpha = 1/255 ellipse, in pixels:
# BOX_PAD plus BOX_PAD_REL of the ellipse's half-extent
# (csrc/blend_common.cuh kBoxPad, kBoxPadRel).
BOX_PAD = 1.0
BOX_PAD_REL = 1.0 / 64.0
# A conic whose det = a c - b^2 is at most BOX_MIN_DET_REL * a c gets the
# whole plane: above it, det's float32 rounding (about 2^-23 a c) moves r by
# under 1e-3 of itself, well inside BOX_PAD_REL (kBoxMinDetRel).
BOX_MIN_DET_REL = 1e-4


def instance_boxes_torch(fields: torch.Tensor) -> torch.Tensor:
    """[N, 9] fields -> [N, 4] (x0, y0, x1, y1): the pixel box outside which
    op * exp(power) < 1/255, so that a pair there never touches T or any
    sum. With L = ln(255 op), det = a c - b^2, the ellipse power >= -L
    reaches rx = sqrt(2 L c / det) and ry = sqrt(2 L a / det) from the mean;
    the box adds BOX_PAD + BOX_PAD_REL * r on each side against rounding.
    L <= 0, a conic that is not positive definite or too ill-conditioned
    for det's rounding (det <= BOX_MIN_DET_REL * a c: long, thin
    footprints) or a box that is not finite gives the whole plane (-inf,
    -inf, inf, inf)."""
    mx, my, ca, cb, cc, op = fields[:, :6].unbind(1)
    big = torch.log(255.0 * op)
    ac = ca * cc
    det = ac - cb * cb
    rx = torch.sqrt(2.0 * big * cc / det)
    ry = torch.sqrt(2.0 * big * ca / det)
    px = BOX_PAD + BOX_PAD_REL * rx
    py = BOX_PAD + BOX_PAD_REL * ry
    box = torch.stack([mx - rx - px, my - ry - py, mx + rx + px, my + ry + py], 1)
    ok = ((big > 0.0) & (ca > 0.0) & (det > 0.0) & (det > BOX_MIN_DET_REL * ac)
          & torch.isfinite(box).all(1))
    whole = torch.tensor([-1.0, -1.0, 1.0, 1.0], dtype=fields.dtype,
                         device=fields.device) * float("inf")
    return torch.where(ok[:, None], box, whole)


class _Chunk(NamedTuple):
    """One step of the walk over every tile's run: [T, K] per slot, [T, P, K]
    per (pixel, instance) pair, [T, P, 1] per pixel."""

    in_run: torch.Tensor  # [T, K] slot lies inside the tile's run
    idx: torch.Tensor  # [T, K] index into inst_gauss of the slot (0 outside)
    f: torch.Tensor  # [T, K, 9] the slots' fields (sentinel row outside)
    dx: torch.Tensor  # [T, P, K] mean2d.x - pixel x
    dy: torch.Tensor  # [T, P, K]
    power: torch.Tensor  # [T, P, K]
    raw: torch.Tensor  # [T, P, K] op * exp(power), before the clamp
    alpha: torch.Tensor  # [T, P, K]
    t_before: torch.Tensor  # [T, P, K] transmittance before the pair
    m: torch.Tensor  # [T, P, K] the instance contributes to the pixel
    incl: torch.Tensor  # [T, P, K] inclusive cumprod of 1 - alpha
    t_all: torch.Tensor  # [T, P, 1] carried transmittance before the chunk


def _tile_pixels(cfg: RasterConfig, dev):
    """Pixel centres (x, y) at integer coordinates, each [T, P]."""
    sub = torch.arange(cfg.tile_pixels, device=dev)
    tile = torch.arange(cfg.n_tiles, device=dev)
    x = (tile % cfg.tiles_x)[:, None] * cfg.tile_w + sub % cfg.tile_w
    y = (tile // cfg.tiles_x)[:, None] * cfg.tile_h + sub // cfg.tile_w
    return x, y


def _walk(fields: torch.Tensor, binned: Binned, cfg: RasterConfig):
    """Yield a _Chunk for every ``cfg.chunk`` instances of the tile runs."""
    dev = fields.device
    n_tiles, p, k = cfg.n_tiles, cfg.tile_pixels, cfg.chunk
    sentinel = fields.shape[0] - 1  # the all-zero row of pack_fields
    starts = binned.tile_ranges[:, 0].long()
    lens = binned.tile_ranges[:, 1].long() - starts
    inst_gauss = binned.inst_gauss.long()
    x, y = _tile_pixels(cfg, dev)
    px = x.to(fields.dtype)[..., None]  # [T, P, 1]
    py = y.to(fields.dtype)[..., None]
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
        yield _Chunk(in_run, idx, f, dx, dy, power, raw, alpha, t_before, m,
                     incl, t_all)
        t_all = t_all * incl[..., -1:]


def _to_tiles(img: torch.Tensor, cfg: RasterConfig) -> torch.Tensor:
    """[C, H, W] -> [T, P, C], zero past the image edge."""
    c = img.shape[0]
    pad = img.new_zeros((c, cfg.tiles_y * cfg.tile_h, cfg.tiles_x * cfg.tile_w))
    pad[:, : cfg.height, : cfg.width] = img
    t = pad.reshape(c, cfg.tiles_y, cfg.tile_h, cfg.tiles_x, cfg.tile_w)
    return t.permute(1, 3, 2, 4, 0).reshape(cfg.n_tiles, cfg.tile_pixels, c)


def blend_forward_torch(
    fields: torch.Tensor,  # [N + 1, 9] pack_fields output
    binned: Binned,
    cfg: RasterConfig,
) -> torch.Tensor:
    """Returns [4, H, W]: rows 0..2 colour, row 3 t_final."""
    n_tiles, p = cfg.n_tiles, cfg.tile_pixels
    color = fields.new_zeros((n_tiles, p, 3))
    t_mask = fields.new_ones((n_tiles, p, 1))
    for c in _walk(fields, binned, cfg):
        w = torch.where(c.m, c.alpha * c.t_before, 0.0)  # [T, P, K]
        color = color + torch.bmm(w, c.f[..., 6:9])
        # transmittance after each contributing Gaussian; it only falls
        # along the walk, so the minimum is the last one
        v = torch.where(c.m, c.t_all * c.incl, 1.0)
        t_mask = torch.minimum(t_mask, torch.amin(v, dim=2, keepdim=True))
    out = torch.cat([color, t_mask], dim=2)  # [T, P, 4]
    out = out.reshape(cfg.tiles_y, cfg.tiles_x, cfg.tile_h, cfg.tile_w, 4)
    out = out.permute(4, 0, 2, 1, 3).reshape(
        4, cfg.tiles_y * cfg.tile_h, cfg.tiles_x * cfg.tile_w
    )
    return out[:, : cfg.height, : cfg.width].contiguous()


def blend_backward_torch(
    fields: torch.Tensor,  # [N + 1, 9] pack_fields output
    binned: Binned,
    cfg: RasterConfig,
    out: torch.Tensor,  # [4, H, W] the forward's result, before background
    g_out: torch.Tensor,  # [4, H, W] the loss's cotangent on out
) -> torch.Tensor:
    """Per-instance gradient rows [M, 9], aligned with ``binned.inst_gauss``:
    (dmean2d x, y, dconic a, b, c, dopacity, dcolor r, g, b).

    A forward-order re-walk (``chunk_math.backward_chunk``). With u = g . c
    for the instance's colour c, w = alpha * T its weight and gS the part of
    g . C_total that the instances behind it paint,
      dalpha = u * T - gS / (1 - alpha) - g_T * T_final / (1 - alpha),
    where gS = g . C_total - (g . C_prefix + u * w), the prefix taken
    inclusively. dpower = dalpha * alpha where the pair contributes, is live
    and unclamped. The spatial terms are sums over the tile's pixels of
    dpower against dx, dy and their products; dopacity = sum dpower / op
    (dalpha * exp(power) where alpha = op * exp(power)). Pixels past the
    image edge carry zero cotangent; instances past every pixel's stop get
    zero rows."""
    rows_out = fields.new_zeros((binned.inst_gauss.shape[0], INSTANCE_WIDTH))
    fwd = _to_tiles(out, cfg)  # [T, P, 4]
    g = _to_tiles(g_out, cfg)
    g_color, g_tmask = g[..., :3], g[..., 3:4]
    gc_total = torch.sum(g_color * fwd[..., :3], dim=2, keepdim=True)
    g_tfinal = g_tmask * fwd[..., 3:4]  # [T, P, 1]
    gc_pre = torch.zeros_like(gc_total)
    for c in _walk(fields, binned, cfg):
        col = c.f[:, None, :, 6:9]  # [T, 1, K, 3]
        u = (g_color[..., 0:1] * col[..., 0] + g_color[..., 1:2] * col[..., 1]
             + g_color[..., 2:3] * col[..., 2])  # [T, P, K]
        w = torch.where(c.m, c.alpha * c.t_before, 0.0)
        cum = torch.cumsum(u * w, dim=2)
        g_suffix = gc_total - (gc_pre + cum)
        inv = 1.0 / (1.0 - c.alpha)
        dalpha = torch.where(
            c.m, u * c.t_before - g_suffix * inv - g_tfinal * inv, 0.0
        )
        live = (c.power <= 0.0) & (c.raw >= ALPHA_CUTOFF) & (c.raw < ALPHA_CLAMP)
        dp = torch.where(live, dalpha * c.alpha, 0.0)
        rows = _rows(c.f, _direct_sums(dp, c.dx, c.dy),
                     torch.bmm(w.transpose(1, 2), g_color))  # [T, K, 9]
        rows_out[c.idx[c.in_run]] = rows[c.in_run]
        gc_pre = gc_pre + cum[..., -1:]
    return rows_out


def _direct_sums(dp, dx, dy):
    """The six spatial sums over the pixels (dim -2) of dp against dx, dy
    and their products: (s0, sx, sy, sxx, syy, sxy), each [..., K]."""
    return tuple(t.sum(dim=-2) for t in (
        dp, dp * dx, dp * dy, dp * dx * dx, dp * dy * dy, dp * dx * dy))


def _rows(f, sums, dcol):
    """Gradient rows [..., K, 9] from an instance's fields f [..., K, 9],
    its six spatial sums and its colour sums dcol [..., K, 3]."""
    s0, sx, sy, sxx, syy, sxy = sums
    ca, cb, cc, op = f[..., 2], f[..., 3], f[..., 4], f[..., 5]
    return torch.cat([
        torch.stack([
            -(ca * sx + cb * sy),
            -(cc * sy + cb * sx),
            -0.5 * sxx,
            -sxy,
            -0.5 * syy,
            s0 / torch.where(op == 0.0, 1.0, op),
        ], dim=-1),
        dcol,
    ], dim=-1)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits), as the backward
    kernel rounds its tensor-core operands: add half of the dropped range,
    then clear the low 13 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_tf32(x):
    hi = round_tf32(x)
    return hi, round_tf32(x - hi)


def moment_rows_tf32(
    f: torch.Tensor,  # [K, 9] the instances' fields
    dp: torch.Tensor,  # [P, K] dpower of each (pixel, instance) pair
    w: torch.Tensor,  # [P, K] alpha * T
    g_color: torch.Tensor,  # [P, 3] the pixels' colour cotangent
    xo: torch.Tensor,  # [P] pixel x - cx, integers in [-tile_w/2, tile_w/2)
    yo: torch.Tensor,  # [P] pixel y - cy
    cx: float,
    cy: float,
) -> torch.Tensor:
    """The backward kernel's per-instance rows [K, 9] as it computes them:
    the moments of dpower against the tile-centred basis (1, x, y, x^2,
    y^2, xy) and the colour sums g^T w, as TF32 products with FP32 sums
    (chunk_math.py's moment product). The basis values are integers of at
    most 9 significant bits, exact in TF32, so dpower is split into two
    TF32 parts (two passes); g^T w splits both sides (hi hi + hi lo + lo
    hi, three passes). The moments become the sums against dx = mx - x by
    expanding the squares around the tile-centred mean (mx - cx)."""
    basis = torch.stack([torch.ones_like(xo), xo, yo, xo * xo, yo * yo, xo * yo])
    dp_hi, dp_lo = _split_tf32(dp)
    mom = basis @ dp_hi + basis @ dp_lo  # [6, K]
    g_hi, g_lo = _split_tf32(g_color)
    w_hi, w_lo = _split_tf32(w)
    dcol = (w_hi.T @ g_hi + w_lo.T @ g_hi) + w_hi.T @ g_lo  # [K, 3]
    m0, m_x, m_y, m_xx, m_yy, m_xy = mom
    mxc = f[:, 0] - cx
    myc = f[:, 1] - cy
    sums = (
        m0,
        mxc * m0 - m_x,
        myc * m0 - m_y,
        mxc * mxc * m0 - 2.0 * mxc * m_x + m_xx,
        myc * myc * m0 - 2.0 * myc * m_y + m_yy,
        mxc * myc * m0 - mxc * m_y - myc * m_x + m_xy,
    )
    return _rows(f, sums, dcol)


def blend_work_torch(
    fields: torch.Tensor, binned: Binned, cfg: RasterConfig, live: bool = False
) -> torch.Tensor:
    """Number of (instance, pixel) evaluations a front-to-back walk that
    stops each pixel at its stop Gaussian needs, summed over the pixels
    inside the image: the work the blend's data requires (for a roofline
    bound), with no early stop of whole tiles assumed. With ``live``, only
    the pairs at or above the 1/255 cutoff count (the contributing pairs
    and each pixel's stop pair): the least work of a walk that skips the
    rest unevaluated, as the kernels' footprint boxes do."""
    n_tiles, p = cfg.n_tiles, cfg.tile_pixels
    work = torch.zeros((n_tiles, p), dtype=torch.int64, device=fields.device)
    stopped = torch.zeros((n_tiles, p), dtype=torch.bool, device=fields.device)
    for c in _walk(fields, binned, cfg):
        # m is true on a prefix of each pixel's run and false from its stop
        work += (c.m & (c.alpha > 0.0) if live else c.m).sum(dim=2)
        stopped |= (~c.m & c.in_run[:, None, :]).any(dim=2)
    work += stopped.long()
    x, y = _tile_pixels(cfg, fields.device)
    inside = (x < cfg.width) & (y < cfg.height)
    return torch.sum(work * inside)
