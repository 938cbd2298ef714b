"""Exact K-nearest neighbours of a point cloud, on the device of the points.

Counterpart of ``frosting_tpu/ops/knn.py``: ``knn`` and ``mean_knn_sqdist``
(self-KNN), and ``knn_prepare`` / ``knn_query_indexed`` / ``knn_query``
(query points against a fixed reference cloud, ``KnnIndex``).
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

from typing import NamedTuple, Optional, Tuple

import torch

# Entries of the [queries, candidates] matrices per block: bounds the
# working set (a few int64 / float32 arrays of this size) at any N.
BLOCK_ENTRIES = 1 << 24
GRID_LEVELS = 12
# Relative margin on a box face's distance, for the rounding of cell
# coordinates near a face; and on a k-th distance taken as the next cell.
FACE_MARGIN = 1e-4
NEED_MARGIN = 1e-3
# 27-cell offsets
_OFFSETS = torch.tensor(
    [(x, y, z) for z in (-1, 0, 1) for y in (-1, 0, 1) for x in (-1, 0, 1)],
    dtype=torch.int64,
)


def _sqdist(points: torch.Tensor, qp: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """[B, C] squared distances of points[cand] to the query points qp [B, 3]."""
    d = points[cand] - qp[:, None, :]
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def _top_k(d2, cand, k):
    """The k nearest columns of d2 (ascending), padded with inf past C."""
    if d2.shape[1] < k:
        pad = k - d2.shape[1]
        d2 = torch.nn.functional.pad(d2, (0, pad), value=float("inf"))
        cand = torch.nn.functional.pad(cand, (0, pad), value=0)
    top, j = torch.topk(d2, k, dim=1, largest=False, sorted=True)
    return torch.gather(cand, 1, j), top


class _Grid(NamedTuple):
    """A uniform grid of cell size `cell` over the live points: their ids
    sorted by cell key, and the sorted keys."""

    lo: torch.Tensor  # [3] the live points' lower corner
    dims: torch.Tensor  # [3] int64 cells per axis
    cell: float
    skey: torch.Tensor  # [L] sorted cell keys
    ids: torch.Tensor  # [L] point ids in key order

    def cell_of(self, x):
        """Cell coordinates of x, clamped to the grid: a point outside it
        takes the nearest edge cell."""
        c = ((x - self.lo) / self.cell).floor().to(torch.int64)
        return torch.minimum(torch.clamp(c, min=0), self.dims - 1)

    def key(self, c):
        return (c[..., 2] * self.dims[1] + c[..., 1]) * self.dims[0] + c[..., 0]


def _build_grid(points, live, cell) -> _Grid:
    p = points[live]
    lo = p.amin(0)
    dims = ((p.amax(0) - lo) / cell).floor().to(torch.int64) + 1
    grid = _Grid(lo, dims, cell, None, None)
    skey, order = torch.sort(grid.key(grid.cell_of(p)))
    return grid._replace(skey=skey, ids=live[order])


def _grid_pass(grid: _Grid, points, qp, k, self_ids=None):
    """The k nearest of the grid's points among the 27 cells around each
    query point qp [Q, 3] (self_ids [Q]: each query's own row, left out).
    Returns (idx [Q, k], d2 [Q, k], face [Q], candidates [Q]): face is the
    distance from the query to the nearest face of its 27-cell box beyond
    which a point may lie, so the result is exact where d2[:, -1] <= face^2.
    A query outside the grid searches around the nearest edge cell: its
    box's faces at the grid's edge have no point beyond them, and its
    distance to the other faces is measured from the query itself."""
    dev = points.device
    qc = grid.cell_of(qp)  # [Q, 3]
    nc = qc[:, None, :] + _OFFSETS.to(dev)[None]  # [Q, 27, 3]
    inside = ((nc >= 0) & (nc < grid.dims)).all(-1)
    nkey = torch.where(inside, grid.key(nc), -1)
    starts = torch.searchsorted(grid.skey, nkey)
    counts = torch.where(
        inside, torch.searchsorted(grid.skey, nkey, right=True) - starts, 0)
    ends = torch.cumsum(counts, 1)  # [Q, 27] inclusive offsets
    total = ends[:, -1]

    # distance from each query to the faces of its 27-cell box; a face at
    # the grid's edge has no point beyond it
    box_lo = grid.lo + (qc - 1).to(qp.dtype) * grid.cell
    box_hi = grid.lo + (qc + 2).to(qp.dtype) * grid.cell
    face = torch.cat([
        torch.where(qc - 1 >= 0, qp - box_lo, float("inf")),
        torch.where(qc + 2 <= grid.dims - 1, box_hi - qp, float("inf")),
    ], dim=1).amin(1)

    idx = torch.zeros((len(qp), k), dtype=torch.int64, device=dev)
    d2 = torch.full((len(qp), k), float("inf"), dtype=points.dtype, device=dev)
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
        cand = grid.ids[pos.clamp(0, len(grid.ids) - 1)]
        dd = _sqdist(points, qp[rows], cand)
        if self_ids is not None:
            ok &= cand != self_ids[rows][:, None]
        dd = torch.where(ok, dd, float("inf"))
        idx[rows], d2[rows] = _top_k(dd, cand, k)
    return idx, d2, face, total


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


def _brute_force(points, live, qp, k, self_ids=None):
    """The k nearest live points of each query point qp [Q, 3], over every
    live point (self_ids [Q]: each query's own row, left out)."""
    n_live = len(live)
    b = max(1, BLOCK_ENTRIES // max(n_live, 1))
    idx, d2 = [], []
    for i in range(0, len(qp), b):
        q = qp[i:i + b]
        cand = live[None].expand(len(q), n_live)
        dd = _sqdist(points, q, cand)
        if self_ids is not None:
            dd = torch.where(cand != self_ids[i:i + b, None], dd, float("inf"))
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
    d2 = torch.full((n, k), float("inf"), dtype=points.dtype, device=dev)
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
        ii, dd, face, found = _grid_pass(
            _build_grid(points, live, cell), points, points[q], k, q)
        # exact where the k-th neighbour lies inside the box, with a margin
        # for the rounding of cell coordinates near a face
        exact = dd[:, -1] <= (face * (1.0 - FACE_MARGIN)) ** 2
        idx[q[exact]], d2[q[exact]] = ii[exact], dd[exact]
        kth = dd[~exact, -1].sqrt() * (1.0 + NEED_MARGIN)
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
        idx[todo], d2[todo] = _brute_force(points, live, points[todo], k, todo)
    return idx, d2


class KnnIndex:
    """The reference cloud of ``knn_query_indexed``: its live points and its
    grids, one per cell size of a fixed ladder cell0 * 2^level (cell0: about
    k points a cell, ``_initial_cell``), each built (one sort of the live
    points) the first time a query needs it and reused by every later
    query block. Counterpart of the JAX ``knn_prepare``'s index, which
    hoists the Morton sorts out of the query blocks in the same way."""

    def __init__(self, refs: torch.Tensor, k: int, valid: Optional[torch.Tensor] = None):
        dev = refs.device
        self.refs = refs
        self.live = (
            torch.arange(refs.shape[0], device=dev)
            if valid is None
            else torch.nonzero(valid, as_tuple=True)[0]
        )
        self.cell0 = _initial_cell(refs[self.live], k) if len(self.live) else 1.0
        if len(self.live):
            self.lo, self.hi = refs[self.live].amin(0), refs[self.live].amax(0)
        self._grids = {}

    def grid(self, level: int) -> _Grid:
        if level not in self._grids:
            self._grids[level] = _build_grid(
                self.refs, self.live, self.cell0 * 2.0 ** level)
        return self._grids[level]


def knn_prepare(refs: torch.Tensor, k: int = 16,
                valid: Optional[torch.Tensor] = None) -> KnnIndex:
    """The search index over a fixed reference cloud [N, 3], for queries of
    k neighbours; rows flagged False in ``valid`` are never neighbours."""
    return KnnIndex(refs, k, valid)


@torch.no_grad()
def knn_query_indexed(
    index: KnnIndex,
    queries: torch.Tensor,  # [M, 3] float32, anywhere
    k: int = 16,
    radius: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact KNN of query points against the index's references: (idx
    [M, k] int64, sqdist [M, k] in the references' dtype), ascending. Missing entries (fewer
    than k references, or with ``radius``, fewer than k within it) are
    filler: index 0, sqdist inf.

    ``radius``: leave out every reference farther than it. The search is
    then exact inside the radius and stops there: a query point far from
    every reference (a sample in empty space) costs one pass, where the
    unbounded search would widen its box until it held the k nearest.

    Each query takes the grid of the ladder's finest cell, as the self-KNN
    does; where that is not exact it moves to the grid whose cells are as
    wide as its k-th distance so far (or ``radius``, if smaller), or about
    2k / n times the volume where it found n < k candidates; after
    GRID_LEVELS grids, brute force over every live reference. A query
    outside the references' bounding box searches around the nearest edge
    cell; the exactness test holds for it (``_grid_pass``), and with
    ``radius`` a query farther than it from the box is filler at once."""
    m = queries.shape[0]
    dev = queries.device
    idx = torch.zeros((m, k), dtype=torch.int64, device=dev)
    d2 = torch.full((m, k), float("inf"), dtype=index.refs.dtype, device=dev)
    if m == 0 or len(index.live) == 0:
        return idx, d2
    todo = torch.arange(m, device=dev)
    if radius is not None:
        out = torch.clamp(index.lo - queries, min=0) + torch.clamp(queries - index.hi, min=0)
        todo = todo[(out * out).sum(1) <= radius * radius]
    need = torch.zeros(len(todo), dtype=index.refs.dtype, device=dev)
    for level in range(GRID_LEVELS):
        if len(todo) == 0:
            break
        cell = index.cell0 * 2.0 ** level
        now = need <= cell
        if not bool(now.any()):
            continue
        q = todo[now]
        ii, dd, face, found = _grid_pass(index.grid(level), index.refs, queries[q], k)
        margin = face * (1.0 - FACE_MARGIN)
        exact = dd[:, -1] <= margin ** 2
        if radius is not None:
            exact |= margin >= radius
        idx[q[exact]], d2[q[exact]] = ii[exact], dd[exact]
        kth = dd[~exact, -1].sqrt() * (1.0 + NEED_MARGIN)
        grow = (2.0 * k / found[~exact].clamp_min(1)).to(kth.dtype) ** (1.0 / 3.0)
        nxt = torch.where(torch.isfinite(kth), kth, cell * grow.clamp_min(2.0))
        if radius is not None:
            nxt = nxt.clamp(max=radius * (1.0 + NEED_MARGIN))
        failed = now.nonzero(as_tuple=True)[0][~exact]
        need[failed] = torch.maximum(nxt, torch.full_like(nxt, 2.0 * cell))
        keep = ~now
        keep[failed] = True
        todo, need = todo[keep], need[keep]
    if len(todo):
        idx[todo], d2[todo] = _brute_force(index.refs, index.live, queries[todo], k)
    if radius is not None:
        far = d2 > radius * radius
        idx[far], d2[far] = 0, float("inf")
    return idx, d2


def knn_query(
    queries: torch.Tensor,  # [M, 3]
    refs: torch.Tensor,  # [N, 3]
    k: int = 16,
    radius: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact KNN of queries against a reference cloud (pytorch3d
    knn_points(queries, refs)): ``knn_query_indexed`` over a one-shot
    ``knn_prepare``. Counterpart of the JAX ``knn_query``, which is exact
    (brute force) up to 16384 references and approximate (Morton windows)
    past them; build the index yourself when many query blocks share the
    references."""
    return knn_query_indexed(knn_prepare(refs, k), queries, k, radius)


def mean_knn_sqdist(points: torch.Tensor, k: int = 3) -> torch.Tensor:
    """Mean squared distance to the k nearest neighbours (simple-knn
    distCUDA2's quantity)."""
    _, d2 = knn(points, k=k)
    d2 = torch.where(torch.isfinite(d2), d2, 0.0)
    return torch.mean(d2, dim=1)

