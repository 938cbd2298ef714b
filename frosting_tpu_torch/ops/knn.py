"""Exact K-nearest neighbours of a point cloud, on the device of the points.

Counterpart of ``frosting_tpu/ops/knn.py::knn`` and ``mean_knn_sqdist``.
The JAX ``knn`` is approximate (Morton windows + NN-descent, recall ~0.99,
KNN_RECALL.json); this one is exact, with the same contract: neighbour 0 is
the nearest other point, and rows flagged dead by ``valid`` never appear as
neighbours (their own rows are filler: index 0, sqdist inf).

Method: a uniform grid with cells of about ``k`` points (as the typical
point sees them). Each query takes
the points of the 27 cells around its own, as one ragged candidate list
(built without padding to the fullest cell: the lists of a block of
queries are expanded to that block's longest one), and keeps the k nearest
by squared distance, summed from explicit coordinate differences in
float32, as the JAX version sums them. A query whose k-th distance does not
lie inside its 27-cell box (or that found fewer than k candidates) is
searched again on a coarser grid: one whose cells are as wide as its k-th
distance so far (which makes the search exact), or twice as wide where it
found fewer than k; after GRID_LEVELS grids, by brute force over every
live point. Plain PyTorch: the JAX reference is
plain JAX, not a TPU kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# Entries of the [queries, candidates] matrices per block: bounds the
# working set (a few int64 / float32 arrays of this size) at any N.
BLOCK_ENTRIES = 1 << 24
GRID_LEVELS = 12
# 27-cell offsets
_OFFSETS = torch.tensor(
    [(x, y, z) for z in (-1, 0, 1) for y in (-1, 0, 1) for x in (-1, 0, 1)],
    dtype=torch.int64,
)


def _sqdist(points: torch.Tensor, q: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """[B, C] squared distances of points[cand] to the queries q [B]."""
    d = points[cand] - points[q][:, None, :]
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def _top_k(d2, cand, k):
    """The k nearest columns of d2 (ascending), padded with inf past C."""
    if d2.shape[1] < k:
        pad = k - d2.shape[1]
        d2 = torch.nn.functional.pad(d2, (0, pad), value=float("inf"))
        cand = torch.nn.functional.pad(cand, (0, pad), value=0)
    top, j = torch.topk(d2, k, dim=1, largest=False, sorted=True)
    return torch.gather(cand, 1, j), top


def _grid_pass(points, live, queries, k, cell):
    """One grid level over the live points for the given query indices.
    Returns (idx [Q, k], d2 [Q, k], exact [Q] bool, candidates [Q])."""
    dev = points.device
    p = points[live]
    lo = p.amin(0)
    dims = ((p.amax(0) - lo) / cell).floor().to(torch.int64) + 1

    def cell_of(x):
        c = ((x - lo) / cell).floor().to(torch.int64)
        return torch.minimum(torch.clamp(c, min=0), dims - 1)

    def key(c):
        return (c[..., 2] * dims[1] + c[..., 1]) * dims[0] + c[..., 0]

    pkey = key(cell_of(p))
    skey, order = torch.sort(pkey)
    sorted_ids = live[order]

    qc = cell_of(points[queries])  # [Q, 3]
    nc = qc[:, None, :] + _OFFSETS.to(dev)[None]  # [Q, 27, 3]
    inside = ((nc >= 0) & (nc < dims)).all(-1)
    nkey = torch.where(inside, key(nc), -1)
    starts = torch.searchsorted(skey, nkey)
    counts = torch.where(inside, torch.searchsorted(skey, nkey, right=True) - starts, 0)
    ends = torch.cumsum(counts, 1)  # [Q, 27] inclusive offsets
    total = ends[:, -1]

    # distance from each query to the faces of its 27-cell box; a face at
    # the grid's edge has no live point beyond it
    qp = points[queries]
    box_lo = lo + (qc - 1).to(qp.dtype) * cell
    box_hi = lo + (qc + 2).to(qp.dtype) * cell
    face = torch.cat([
        torch.where(qc - 1 >= 0, qp - box_lo, float("inf")),
        torch.where(qc + 2 <= dims - 1, box_hi - qp, float("inf")),
    ], dim=1).amin(1)

    idx = torch.zeros((len(queries), k), dtype=torch.int64, device=dev)
    d2 = torch.full((len(queries), k), float("inf"), device=dev)
    # blocks of queries with similar candidate counts: sort by count
    by_total = torch.argsort(total, descending=True)
    totals = total[by_total].cpu().numpy()
    start = 0
    while start < len(totals):
        c = max(int(totals[start]), 1)
        b = max(1, BLOCK_ENTRIES // c)
        rows = by_total[start:start + b]
        start += b
        col = torch.arange(c, device=dev)
        e = ends[rows]
        seg = torch.searchsorted(e, col.expand(len(rows), c).contiguous(), right=True)
        ok = seg < 27
        seg = seg.clamp(max=26)
        first = torch.gather(e - counts[rows], 1, seg)
        pos = torch.gather(starts[rows], 1, seg) + col[None] - first
        cand = sorted_ids[pos.clamp(0, len(sorted_ids) - 1)]
        q = queries[rows]
        dd = _sqdist(points, q, cand)
        dd = torch.where(ok & (cand != q[:, None]), dd, float("inf"))
        idx[rows], d2[rows] = _top_k(dd, cand, k)
    # exact where the k-th neighbour lies inside the box, with a margin for
    # the rounding of cell coordinates near a face
    exact = d2[:, -1] <= (face * (1.0 - 1e-4)) ** 2
    return idx, d2, exact, total


def _initial_cell(p: torch.Tensor, k: int) -> float:
    """A cell size at which the typical point shares its cell with about k
    others: cells of k points if the cloud filled its bounding box, then
    rescaled by the median over the points of their cell's count until
    that is within a factor 2 of k (a dense object inside a wide, sparse
    background sets the size by the object, where most points are)."""
    lo = p.amin(0)
    extent = (p.amax(0) - lo).clamp_min(1e-12)
    cell = float((torch.prod(extent) * k / len(p)) ** (1.0 / 3.0))
    floor = float(extent.max()) / (1 << 20)
    for _ in range(8):
        cell = max(cell, floor)
        c = ((p - lo) / cell).floor().to(torch.int64)
        dims = c.amax(0) + 1
        key = (c[:, 2] * dims[1] + c[:, 1]) * dims[0] + c[:, 0]
        _, inverse, counts = torch.unique(key, return_inverse=True, return_counts=True)
        ratio = k / float(counts[inverse].median())
        if 0.5 <= ratio <= 2.0:
            break
        cell *= min(max(ratio ** (1.0 / 3.0), 1.0 / 64.0), 4.0)
    return max(cell, floor)


def _brute_force(points, live, queries, k):
    n_live = len(live)
    b = max(1, BLOCK_ENTRIES // max(n_live, 1))
    idx, d2 = [], []
    for i in range(0, len(queries), b):
        q = queries[i:i + b]
        cand = live[None].expand(len(q), n_live)
        dd = _sqdist(points, q, cand)
        dd = torch.where(cand != q[:, None], dd, float("inf"))
        ii, di = _top_k(dd, cand, k)
        idx.append(ii)
        d2.append(di)
    return torch.cat(idx), torch.cat(d2)


@torch.no_grad()
def knn(
    points: torch.Tensor,  # [N, 3] float32
    k: int = 16,
    valid: Optional[torch.Tensor] = None,  # [N] bool; False rows are dead
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact self-KNN: (idx [N, k] int64, sqdist [N, k] float32), ascending,
    self excluded. With fewer than k other live points, the missing
    entries carry sqdist inf."""
    n = points.shape[0]
    dev = points.device
    live = (
        torch.arange(n, device=dev)
        if valid is None
        else torch.nonzero(valid, as_tuple=True)[0]
    )
    idx = torch.zeros((n, k), dtype=torch.int64, device=dev)
    d2 = torch.full((n, k), float("inf"), device=dev)
    if len(live) == 0:
        return idx, d2
    cell = _initial_cell(points[live], k)
    todo = live
    # the cell size each waiting query needs next: at least its k-th
    # distance so far (the 27-cell box then holds the whole ball, so the
    # search is exact), or, where it found n < k candidates, a box about
    # 2k / n times the volume
    need = torch.zeros(len(todo), device=dev)
    for _ in range(GRID_LEVELS):
        now = need <= cell
        q = todo[now]
        ii, dd, exact, found = _grid_pass(points, live, q, k, cell)
        idx[q[exact]], d2[q[exact]] = ii[exact], dd[exact]
        kth = dd[~exact, -1].sqrt() * (1.0 + 1e-3)
        grow = (2.0 * k / found[~exact].clamp_min(1)).to(kth.dtype) ** (1.0 / 3.0)
        failed = now.nonzero(as_tuple=True)[0][~exact]
        need[failed] = torch.where(torch.isfinite(kth), kth, cell * grow.clamp_min(2.0))
        keep = ~now
        keep[failed] = True
        todo, need = todo[keep], need[keep]
        if len(todo) == 0:
            break
        cell = max(2.0 * cell, float(need.min()))
    if len(todo):
        idx[todo], d2[todo] = _brute_force(points, live, todo, k)
    return idx, d2


def mean_knn_sqdist(points: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Mean squared distance to the k nearest neighbours (simple-knn
    distCUDA2's quantity)."""
    _, d2 = knn(points, k=k)
    d2 = torch.where(torch.isfinite(d2), d2, 0.0)
    return torch.mean(d2, dim=1)

