"""Multi-host runtime: process-group start-up and a host-aware mesh layout.

Counterpart of ``frosting_tpu/parallel/multihost.py``. The ("data", "tile")
axes of sharded_train.py keep their meaning everywhere; only the placement
of ranks changes across hosts:

  * "data" (cameras) is the outer axis: its one collective is the gradient
    all-reduce of each step, which tolerates the network between hosts;
  * "tile" (image strips) is the inner axis: every render all-gathers the
    projected Gaussians (or exchanges them, exchange.py) and the SSIM halos,
    so a tile row must stay inside one host (NVLink, not the network).

So ranks are ordered by (host, local rank) and each run of n_tile of them
is a tile row: whenever each host's rank count is a multiple of n_tile,
every tile row is on one host.
"""

from __future__ import annotations

import os
import socket
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from frosting_tpu_torch.parallel.collectives import Mesh, init_process_group

DEFAULT_TIMEOUT_S = 300.0


def initialize(backend: Optional[str] = None, device="cuda",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Start the default process group when the launcher's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``, as ``torchrun`` sets them) names a world of more than
    one process; do nothing and return False otherwise, so every command
    line can call it first. ``backend``: NCCL by default on a CUDA device,
    gloo on the CPU; the caller's choice otherwise. A CUDA rank binds
    ``local_device(device)``. The group has a timeout of its own (``timeout_s``),
    so a rank whose peers are gone fails within it. Returns True once the
    group is up (also where it already was)."""
    if dist.is_available() and dist.is_initialized():
        return True
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or "RANK" not in os.environ:
        return False
    rank = int(os.environ["RANK"])
    dev = local_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    address = f"tcp://{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    init_process_group(backend, rank, world, address, timeout_s, device=dev)
    return True


def start_world(backend: Optional[str] = None, device="cuda",
                timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """``initialize`` first; without a launcher, a world of one process on
    a free local port (NCCL on a CUDA device, gloo on the CPU, unless
    ``backend`` says otherwise)."""
    if initialize(backend, device, timeout_s):
        return
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_process_group(backend, 0, 1, f"tcp://127.0.0.1:{port}", timeout_s, device=dev)


def local_device(device="cuda") -> torch.device:
    """This rank's device: a CUDA device without an index becomes the card
    of LOCAL_RANK, modulo the cards there are (ranks that outnumber the
    cards share them in turn, which gloo allows and NCCL refuses)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % max(1, torch.cuda.device_count()))
    return dev


class RankInfo:
    """A rank's placement: its global rank (``id``) and its host
    (``process_index``: hosts numbered in order of first appearance)."""

    def __init__(self, id: int, process_index: int):
        self.id = id
        self.process_index = process_index

    def __repr__(self):
        return f"RankInfo(id={self.id}, process_index={self.process_index})"


def rank_infos() -> list:
    """Every rank's RankInfo, by an all-gather of the host names (every rank
    of the default group must call it)."""
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    hosts = {h: i for i, h in enumerate(dict.fromkeys(names))}
    return [RankInfo(r, hosts[h]) for r, h in enumerate(names)]


def arrange_devices(devices: Sequence, n_data: int, n_tile: int) -> np.ndarray:
    """The [n_data, n_tile] grid of devices (anything with ``id`` and
    ``process_index``: ranks here, ``jax.Device`` in the JAX package) in
    which every tile row lies in one process's (host's) set whenever each
    host's count allows it, so that only "data" crosses hosts. Pure over
    those attributes, so the policy is testable without a cluster."""
    if len(devices) < n_data * n_tile:
        raise ValueError(f"need {n_data * n_tile} devices, have {len(devices)}")
    devs = sorted(devices, key=lambda d: (getattr(d, "process_index", 0), d.id))
    devs = devs[: n_data * n_tile]
    # host-major order, rows of n_tile: whenever each host's count is a
    # multiple of n_tile, every tile row is one host's; otherwise the layout
    # is still correct, with the per-render collectives crossing hosts
    # (tile_rows_are_local says which)
    arr = np.empty((n_data * n_tile,), dtype=object)
    arr[:] = devs
    return arr.reshape(n_data, n_tile)


def make_hybrid_mesh(n_data: int, n_tile: int, devices=None, device="cuda") -> Mesh:
    """The ("data", "tile") mesh of the default group's ranks, placed by
    arrange_devices over their hosts (``devices``: their RankInfos, gathered
    by ``rank_infos`` where not given). One host is the degenerate case of
    the same policy. Every rank must call it."""
    devices = devices if devices is not None else rank_infos()
    grid = arrange_devices(devices, n_data, n_tile)
    mesh = Mesh(np.vectorize(lambda d: d.id, otypes=[np.int64])(grid), device)
    mesh.placement = grid
    return mesh


def tile_rows_are_local(mesh) -> bool:
    """True when every tile row of the mesh lies in one process's (host's)
    set: the placement that keeps the per-render collectives inside a host.
    ``mesh``: a Mesh from make_hybrid_mesh, or a grid of devices."""
    grid = np.asarray(getattr(mesh, "placement", mesh))
    for row in grid.reshape(-1, grid.shape[-1]):
        if len({getattr(d, "process_index", 0) for d in row}) > 1:
            return False
    return True
