"""Primitive instance exchange over the tile axis.

Counterpart of ``frosting_tpu/parallel/exchange.py``: in place of
all-gathering every rank's projected Gaussians (memory per rank then grows
with the whole cloud), each rank sends each projected Gaussian only to the
strips whose rows its tile rect overlaps, through one ``all_to_all`` with a
fixed capacity ``cap_pair`` per pair of ranks, and an overflow flag that is
the maximum over the axis, as the rasterizer's instance capacity has.

Gradients go back through the same exchange (``collectives.all_to_all``'s
backward is the reverse exchange) and through the compaction gather, whose
backward sums each Gaussian's rows in a fixed order (``segment.gather_rows``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from frosting_tpu_torch.ops import segment
from frosting_tpu_torch.parallel import collectives
from frosting_tpu_torch.raster import RasterConfig
from frosting_tpu_torch.raster.preprocess import Projected

# The payload, float32 columns:
# 0:2 means2d | 2:5 conics | 5:8 colours | 8 opacity | 9 depth | 10 radius |
# 11:15 the full image's tile rect (carried exactly, so that the receiver
# keeps the sender's anisotropic inclusion set; small ints are exact in f32)
WIDTH = 15


def _pack(proj: Projected) -> torch.Tensor:
    return torch.cat([
        proj.means2d,
        proj.conics,
        proj.colors,
        proj.opacities[:, None],
        proj.depths[:, None],
        proj.radii.to(torch.float32)[:, None],
        proj.rect.to(torch.float32),
    ], dim=1)


def _unpack(rows: torch.Tensor, valid: torch.Tensor) -> Projected:
    radii = torch.where(valid, rows[:, 10], 0.0).to(torch.int32)
    rect = torch.where(valid[:, None], rows[:, 11:15], 0.0).to(torch.int32)
    return Projected(
        means2d=rows[:, 0:2],
        conics=rows[:, 2:5],
        colors=rows[:, 5:8],
        opacities=torch.where(valid, rows[:, 8], 0.0),
        depths=rows[:, 9],
        radii=radii,
        rect=rect,
        valid=valid,
    )


def exchange_projected(
    proj_local: Projected,
    mesh: collectives.Mesh,
    axis: str,
    n_tile: int,
    strip_h: int,
    cap_pair: int,
    full_cfg: RasterConfig,
) -> Tuple[Projected, torch.Tensor]:
    """Route each locally projected Gaussian to the strips its tile rect
    overlaps. Returns (the candidates, n_tile * cap_pair of them in the
    FULL image's pixel frame, in source-rank order; the overflow flag, the
    maximum over the axis). Call shift_projected afterwards to move them
    into the strip's frame."""
    rows = _pack(proj_local)
    n_local = rows.shape[0]
    dev = rows.device
    valid = proj_local.valid
    ty0, ty1 = proj_local.rect[:, 1], proj_local.rect[:, 3]
    tiles_per_strip = strip_h // full_cfg.tile_h
    ids = torch.arange(n_local, device=dev)
    slots = torch.arange(cap_pair, device=dev)

    index, slot_valid, counts = [], [], []
    for t in range(n_tile):
        s0, s1 = t * tiles_per_strip, (t + 1) * tiles_per_strip
        want = valid & (ty1 > s0) & (ty0 < s1)
        pos = torch.cumsum(want.to(torch.int64), 0) - 1
        count = want.sum()
        # the j-th wanted Gaussian takes slot j; past cap_pair it is dropped
        dst = torch.where(want & (pos < cap_pair), pos, cap_pair)
        idx = torch.zeros((cap_pair + 1,), dtype=torch.int64, device=dev)
        idx[dst] = ids
        index.append(idx[:cap_pair])
        slot_valid.append(slots < torch.clamp(count, max=cap_pair))
        counts.append(count)
    index = torch.cat(index)
    overflow = torch.stack(counts).max() > cap_pair
    send_rows = segment.gather_rows(rows, index, *segment.sort_by_index(index, n_local))
    send_valid = torch.cat(slot_valid).to(torch.int32)

    # entry s of the result is what the rank at tile position s sent here
    recv_rows = collectives.all_to_all(send_rows, mesh, axis)
    recv_valid = collectives.all_to_all(send_valid, mesh, axis) > 0
    cand = _unpack(recv_rows, recv_valid)
    return cand, collectives.pmax(overflow, mesh, axis)
