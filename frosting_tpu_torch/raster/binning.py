"""Tile binning: expand each Gaussian into one instance per tile its rect
covers, then order the instances by tile and, within a tile, front to back.

Counterpart of ``frosting_tpu/raster/binning.py`` in the form a GPU runs
well (the CUDA reference's duplicateWithKeys + radix sort + identifyTile
Ranges, rasterizer_impl.cu:70-138): per-Gaussian counts, an exclusive
cumsum, expansion with ``repeat_interleave`` and one stable sort. The TPU's
diff-scatter decodes, chunk-padded layout and matmul histogram have no
counterpart here.

Ordering matches the JAX reference exactly: Gaussians are sorted stably by
depth (invalid ones keyed +inf), instances are emitted in that depth-major
order, and a stable sort on the tile id keeps it within each tile, so ties
keep Gaussian index order. Past ``max_instances`` the farthest instances are
dropped and ``overflow`` is set.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from frosting_tpu_torch.raster.config import RasterConfig


class Binned(NamedTuple):
    inst_gauss: torch.Tensor  # [M] int32 Gaussian id of each sorted instance
    tile_ranges: torch.Tensor  # [n_tiles, 2] int32 [start, end) into inst_gauss
    num_instances: torch.Tensor  # [] int64 instance count before truncation
    overflow: torch.Tensor  # [] bool, num_instances > max_instances


def bin_gaussians(
    rect: torch.Tensor,  # [N, 4] int32 tile bbox (tx0, ty0, tx1, ty1)
    depths: torch.Tensor,  # [N] f32
    valid: torch.Tensor,  # [N] bool
    cfg: RasterConfig,
) -> Binned:
    dev = rect.device
    i64 = torch.int64
    n = rect.shape[0]
    rect = rect.to(i64)
    w = rect[:, 2] - rect[:, 0]
    counts = torch.where(valid, w * (rect[:, 3] - rect[:, 1]), 0)
    base = rect[:, 1] * cfg.tiles_x + rect[:, 0]

    dkey = torch.where(valid, depths, torch.full_like(depths, float("inf")))
    order = torch.sort(dkey, stable=True).indices
    counts_s = counts[order]
    cum = torch.cumsum(counts_s, 0)
    total = cum[-1] if n else torch.zeros((), dtype=i64, device=dev)
    # The one host sync of the render: the instance buffer is sized to the
    # kept count (at most max_instances).
    m = min(int(total), cfg.max_instances)

    # Truncation at capacity keeps the nearest instances: clip the
    # cumulative counts and take the per-Gaussian differences.
    cum_kept = torch.clamp(cum, max=m)
    kept = torch.diff(cum_kept, prepend=cum_kept.new_zeros(1))
    seg = torch.repeat_interleave(
        torch.arange(n, device=dev), kept, output_size=m
    )  # depth rank of the Gaussian owning each instance
    rank = torch.arange(m, device=dev) - (cum - counts_s)[seg]
    w_s = w[order][seg]
    row = torch.div(rank, w_s, rounding_mode="floor")
    tile = base[order][seg] + row * cfg.tiles_x + (rank - row * w_s)

    tile_sorted, perm = torch.sort(tile, stable=True)
    inst_gauss = order[seg][perm]

    ends = torch.cumsum(torch.bincount(tile_sorted, minlength=cfg.n_tiles), 0)
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    tile_ranges = torch.stack([starts, ends], dim=1)
    return Binned(
        inst_gauss=inst_gauss.to(torch.int32),
        tile_ranges=tile_ranges.to(torch.int32).contiguous(),
        num_instances=total,
        overflow=total > cfg.max_instances,
    )
