"""Sums of rows grouped by an index, in a fixed order.

``index_add_`` and the backward of an indexing gather sum with float
atomics on the GPU, whose order, and so the last bits of the result, change
from run to run. Here the rows are ordered by their index with a stable
sort, and each index's run is summed sequentially in that order by
``segment_reduce`` over offsets found by ``searchsorted`` (no host sync), so
the sums are bitwise reproducible on the card. The order depends only on
the index: build it once (``sort_by_index``) where the index is fixed, as a
mesh's faces or a frosting's cell assignment are. ``gather_rows`` is an
indexing gather whose backward sums so, and ``cumsum`` a cumulative sum in
a fixed order, for the same reason.
"""

from __future__ import annotations

from typing import Tuple

import torch


def sort_by_index(index: torch.Tensor, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order [M], offsets [n + 1]): a stable sort of index [M] (values in
    [0, n)), and the bounds of each value's run in that order."""
    ids, order = torch.sort(index, stable=True)
    bounds = torch.arange(n + 1, device=ids.device, dtype=ids.dtype)
    return order, torch.searchsorted(ids, bounds)


def segment_sum(rows: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """[len(offsets) - 1, ...]: the sum of rows[offsets[i]:offsets[i + 1]],
    each run summed in row order; 0 for an empty run."""
    return torch.segment_reduce(
        rows, "sum", offsets=offsets.long(), axis=0, unsafe=True, initial=0.0)


def sum_by_index(rows: torch.Tensor, index: torch.Tensor, n: int) -> torch.Tensor:
    """[n, ...]: the rows of each index value summed, in row order."""
    order, offsets = sort_by_index(index, n)
    return segment_sum(rows[order], offsets)


class GatherRows(torch.autograd.Function):
    """x[index] for a 1-D index, differentiable in x: the backward sums the
    incoming rows into x's rows in the fixed order of (order, offsets) =
    ``sort_by_index(index, len(x))``, where autograd's backward of the
    gather would scatter-add them with float atomics."""

    @staticmethod
    def forward(ctx, x, index, order, offsets):
        ctx.save_for_backward(order, offsets)
        return x[index]

    @staticmethod
    def backward(ctx, g):
        order, offsets = ctx.saved_tensors
        return segment_sum(g[order], offsets), None, None, None


def gather_rows(x: torch.Tensor, index: torch.Tensor, order: torch.Tensor,
                offsets: torch.Tensor) -> torch.Tensor:
    """x[index] ([M, ...] for index [M]) whose gradient reaches x as fixed-
    order segment sums; (order, offsets) = sort_by_index(index, len(x)),
    built once where the index is fixed."""
    return GatherRows.apply(x, index, order, offsets)


def cumsum(x: torch.Tensor, block: int = 1024) -> torch.Tensor:
    """Inclusive cumulative sum of a 1-D x in a fixed order: each block of
    `block` values is scanned along its row (a [rows, block] scan, which
    PyTorch runs row by row), then every block's total is carried into the
    next by the same scan of the totals. On the card ``torch.cumsum`` of a
    1-D tensor is one decoupled look-back scan, whose float sums associate
    differently from run to run."""
    n = x.shape[0]
    rows = max(2, -(-n // block))  # two rows at least: one row is a 1-D scan
    inner = torch.cumsum(
        torch.nn.functional.pad(x, (0, rows * block - n)).reshape(rows, block), dim=1)
    if n > block:
        carry = cumsum(inner[:, -1], block)
        inner = inner + torch.cat([carry.new_zeros(1), carry[:-1]])[:, None]
    return inner.reshape(-1)[:n]
