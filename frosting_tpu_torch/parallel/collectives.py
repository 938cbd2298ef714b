"""The mesh of ranks and the collectives of the sharded steps.

Counterpart of the ``jax.sharding.Mesh`` and the ``jax.lax`` collectives
that ``frosting_tpu/parallel/`` calls inside ``shard_map``. A ``Mesh`` is an
[n_data, n_tile] grid of ``torch.distributed`` ranks with one process group
per row (axis ``"tile"``: the strips of one camera) and one per column
(axis ``"data"``: the cameras of one strip), and one over the whole grid
(axis ``WORLD``, JAX's ``("data", "tile")``). Every rank of the default
group creates every group, in the same order, so a mesh is built by all
ranks together.

The autograd Functions give each collective the gradient that JAX's
transpose gives it:

  * ``all_gather`` (tiled, dim 0): the backward sums the cotangents over the
    group and keeps this rank's slice (JAX's ``psum_scatter``);
  * ``psum``: an all-reduce, whose backward is an all-reduce;
  * ``pmax``: an all-reduce of the maximum, without gradient;
  * ``ppermute``: a ring shift by ``shift`` group positions, whose backward
    is the reverse shift;
  * ``all_to_all`` (tiled, dim 0): block j goes to group position j; the
    backward is the same exchange of the cotangents;
  * ``broadcast`` (no gradient): one rank's tensors, of any shapes and
    dtypes, on every rank of the group.

Every collective is a call of ``torch.distributed`` on the mesh's groups
(all_gather, all_reduce, all_to_all_single, batched isend / irecv), with
the backend the caller chose. Where that backend is gloo and the tensors
live on a CUDA device, each collective copies its input to host memory,
runs there and copies the result back: gloo's CUDA support differs between
collectives and PyTorch versions, so the copy is made explicitly for that
backend, every time, and its bytes are counted (``Mesh.stats``).
"""

from __future__ import annotations

import collections
import datetime
from typing import Dict, Union

import numpy as np
import torch
import torch.distributed as dist

WORLD = ("data", "tile")
Axis = Union[str, tuple]


class Mesh:
    """An [n_data, n_tile] grid of ranks (``ranks[d, t]`` is the rank at
    data index d and tile index t) and its process groups, on ``device``.
    ``dist`` must be initialised; every rank of the default group must
    build the same meshes in the same order (a rank outside the grid takes
    part in making the groups and may not call a collective on them)."""

    def __init__(self, ranks, device="cuda"):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        if self.ranks.ndim != 2:
            raise ValueError("ranks must be an [n_data, n_tile] grid")
        n_data, n_tile = self.ranks.shape
        self.shape = {"data": n_data, "tile": n_tile}
        self.size = n_data * n_tile
        self.device = torch.device(device)
        self.backend = dist.get_backend()
        # gloo runs every collective on host copies of CUDA tensors
        self.host_staged = self.backend == "gloo" and self.device.type == "cuda"
        # bytes this rank gave to each collective (its input's size), and
        # the bytes copied between the device and host memory for gloo
        self.stats: Dict[str, int] = collections.Counter()
        rows = [dist.new_group([int(r) for r in row]) for row in self.ranks]
        cols = [dist.new_group([int(r) for r in col]) for col in self.ranks.T]
        whole = dist.new_group(sorted(int(r) for r in self.ranks.ravel()))
        me = dist.get_rank()
        where = np.argwhere(self.ranks == me)
        self.data_index, self.tile_index = (int(v) for v in where[0]) if len(where) else (-1, -1)
        d, t = self.data_index, self.tile_index
        self._groups = {"tile": rows[d], "data": cols[t], WORLD: whole} if d >= 0 else {}
        self._members = {
            "tile": [int(r) for r in self.ranks[d]] if d >= 0 else [],
            "data": [int(r) for r in self.ranks[:, t]] if d >= 0 else [],
            WORLD: sorted(int(r) for r in self.ranks.ravel()),
        }

    def axis(self, axis: Axis):
        """(group, member ranks in group order, this rank's position)."""
        axis = WORLD if axis in (WORLD, ("tile", "data")) else axis
        if axis not in self._groups:
            raise ValueError(f"rank {dist.get_rank()} is not on this mesh's axis {axis}")
        members = self._members[axis]
        return self._groups[axis], members, members.index(dist.get_rank())

    def axis_size(self, axis: Axis) -> int:
        return len(self.axis(axis)[1])

    def axis_index(self, axis: str) -> int:
        return {"data": self.data_index, "tile": self.tile_index}[axis]

    @property
    def flat_index(self) -> int:
        """This rank's block of a primitive-sharded leaf: tile-major over
        the grid (``sharded_train.PRIM_SPEC``)."""
        return self.tile_index * self.shape["data"] + self.data_index

    def reset_stats(self):
        self.stats.clear()

    # --- the transport, staged through host memory for gloo on CUDA ---

    def _to_wire(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        if self.host_staged:
            self.stats["host_copy_bytes"] += x.numel() * x.element_size()
            return x.cpu()
        return x

    def _from_wire(self, x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        if self.host_staged:
            self.stats["host_copy_bytes"] += x.numel() * x.element_size()
            return x.to(like.device)
        return x

    def _count(self, name: str, x: torch.Tensor):
        self.stats[f"{name}_bytes"] += x.numel() * x.element_size()
        self.stats[f"{name}_calls"] += 1


def make_mesh(n_data: int, n_tile: int, device="cuda") -> Mesh:
    """The mesh of the first n_data * n_tile ranks, row-major: rank
    d * n_tile + t at (d, t)."""
    world = dist.get_world_size()
    if world < n_data * n_tile:
        raise ValueError(f"need {n_data * n_tile} devices, have {world}")
    return Mesh(np.arange(n_data * n_tile).reshape(n_data, n_tile), device)


def _gather(x: torch.Tensor, mesh: Mesh, axis: Axis) -> torch.Tensor:
    group, members, _ = mesh.axis(axis)
    mesh._count("all_gather", x)
    wire = mesh._to_wire(x)
    parts = [torch.empty_like(wire) for _ in members]
    dist.all_gather(parts, wire, group=group)
    return mesh._from_wire(torch.cat(parts), x)


def _reduce(x: torch.Tensor, mesh: Mesh, axis: Axis, op=dist.ReduceOp.SUM,
            name: str = "all_reduce") -> torch.Tensor:
    group, _, _ = mesh.axis(axis)
    mesh._count(name, x)
    wire = mesh._to_wire(x).clone()
    dist.all_reduce(wire, op=op, group=group)
    return mesh._from_wire(wire, x)


def _shift(x: torch.Tensor, mesh: Mesh, axis: Axis, shift: int) -> torch.Tensor:
    """The block at group position i goes to position (i + shift) % n."""
    group, members, i = mesh.axis(axis)
    n = len(members)
    if shift % n == 0:
        return x.clone()
    mesh._count("ppermute", x)
    wire = mesh._to_wire(x)
    out = torch.empty_like(wire)
    ops = [dist.P2POp(dist.isend, wire, members[(i + shift) % n], group),
           dist.P2POp(dist.irecv, out, members[(i - shift) % n], group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return mesh._from_wire(out, x)


def _exchange(x: torch.Tensor, mesh: Mesh, axis: Axis) -> torch.Tensor:
    group, members, _ = mesh.axis(axis)
    if x.shape[0] % len(members):
        raise ValueError(f"all_to_all: {x.shape[0]} rows do not split over {len(members)}")
    mesh._count("all_to_all", x)
    wire = mesh._to_wire(x)
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=group)
    return mesh._from_wire(out, x)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis, ctx.rows = mesh, axis, x.shape[0]
        return _gather(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        _, _, i = ctx.mesh.axis(ctx.axis)
        total = _reduce(g, ctx.mesh, ctx.axis, name="all_gather_grad")
        return total[i * ctx.rows:(i + 1) * ctx.rows], None, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.mesh, ctx.axis), None, None


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, shift):
        ctx.mesh, ctx.axis, ctx.shift = mesh, axis, shift
        return _shift(x, mesh, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.mesh, ctx.axis, -ctx.shift), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _exchange(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g.contiguous(), ctx.mesh, ctx.axis), None, None


def all_gather(x: torch.Tensor, mesh: Mesh, axis: Axis) -> torch.Tensor:
    """The group's blocks concatenated along dim 0, in group order
    (``jax.lax.all_gather(..., tiled=True)``)."""
    return _AllGather.apply(x, mesh, axis)


def psum(x: torch.Tensor, mesh: Mesh, axis: Axis) -> torch.Tensor:
    """The sum over the group, on every rank of it."""
    return _PSum.apply(x, mesh, axis)


def pmax(x: torch.Tensor, mesh: Mesh, axis: Axis) -> torch.Tensor:
    """The elementwise maximum over the group (no gradient); bool tensors
    come back as bool."""
    x = x.detach()
    if x.dtype == torch.bool:
        return _reduce(x.to(torch.int32), mesh, axis, dist.ReduceOp.MAX, "pmax") > 0
    return _reduce(x, mesh, axis, dist.ReduceOp.MAX, "pmax")


def ppermute(x: torch.Tensor, mesh: Mesh, axis: Axis, shift: int) -> torch.Tensor:
    """Ring shift: the result at group position i is the block of position
    (i - shift) % n."""
    return _PPermute.apply(x, mesh, axis, shift)


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: Axis) -> torch.Tensor:
    """x's n equal blocks along dim 0, block j sent to group position j;
    the result holds the block each position sent here, in group order
    (``jax.lax.all_to_all(..., split_axis=0, concat_axis=0, tiled=True)``)."""
    return _AllToAll.apply(x, mesh, axis)


def broadcast(tensors, mesh: Mesh, axis: Axis = WORLD, src: int = 0):
    """The tensors of the rank at group position ``src`` on every rank of
    the group, with their shapes and dtypes (``tensors`` is read on that
    rank only): one object broadcast of the layout, then one broadcast per
    dtype of the tensors packed flat. No gradient; bytes counted under
    ``broadcast``."""
    group, members, i = mesh.axis(axis)
    if len(members) == 1:
        return [t.detach().to(mesh.device) for t in tensors]
    layout = [[(tuple(t.shape), t.dtype) for t in tensors] if i == src else None]
    dist.broadcast_object_list(layout, src=members[src], group=group)
    out = [None] * len(layout[0])
    for dtype in dict.fromkeys(d for _, d in layout[0]):
        idx = [k for k, (_, d) in enumerate(layout[0]) if d == dtype]
        sizes = [int(np.prod(layout[0][k][0])) for k in idx]
        if i == src:
            flat = torch.cat([tensors[k].detach().reshape(-1) for k in idx]).to(mesh.device)
        else:
            flat = torch.empty(sum(sizes), dtype=dtype, device=mesh.device)
        mesh._count("broadcast", flat)
        wire = mesh._to_wire(flat)
        dist.broadcast(wire, src=members[src], group=group)
        flat = mesh._from_wire(wire, flat)
        for k, part in zip(idx, torch.split(flat, sizes)):
            out[k] = part.view(layout[0][k][0])
    return out


def init_process_group(backend: str, rank: int, world_size: int, address: str,
                       timeout_s: float = 300.0, device="cuda") -> None:
    """``torch.distributed.init_process_group`` with an explicit address
    (``tcp://host:port``) and a timeout of its own, so that a rank whose
    peers are gone fails within it. NCCL ranks bind their local CUDA
    device first."""
    if backend == "nccl":
        dev = torch.device(device)
        torch.cuda.set_device(dev if dev.index is not None else torch.cuda.current_device())
    dist.init_process_group(backend, init_method=address, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
