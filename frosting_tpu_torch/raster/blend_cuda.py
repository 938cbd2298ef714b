"""The blend kernels: the hand-written CUDA kernels ``csrc/blend_forward.cu``
and ``csrc/blend_backward.cu`` (sharing ``csrc/blend_common.cuh``) for
tensors on the GPU, their plain PyTorch versions (blend_torch.py) for
tensors on the CPU.

The kernels replace ``frosting_tpu/raster/blend_pallas.py::
blend_forward_pallas`` and ``blend_backward_pallas``. Both are bound by FP32
and SFU (``exp``, reciprocal) throughput over the (instance, tile-pixel)
pairs they evaluate, not by bytes: each instance's 36 B is read once per
tile and reused by all of the tile's pixels; each warp skips the instances
whose footprint box misses its 8x4 pixel patch (see the sources' headers
for the designs). Blocks take tiles heaviest first (``heaviest_first``).
The kernels are built with nvcc at the first launch
(``frosting_tpu_torch/_build.py``).
"""

from __future__ import annotations

import ctypes

import torch

from frosting_tpu_torch import _build
from frosting_tpu_torch._build import check_tensor
from frosting_tpu_torch.raster.binning import Binned
from frosting_tpu_torch.raster.blend_torch import (
    blend_backward_torch,
    blend_forward_torch,
)
from frosting_tpu_torch.raster.config import INSTANCE_WIDTH, RasterConfig

KERNELS = ("blend_forward", "blend_backward")
MAX_THREADS_PER_BLOCK = 1024
# A warp covers an 8x4 pixel patch of its tile (csrc/blend_common.cuh).
PATCH_W, PATCH_H = 8, 4
# The backward's tile-centred basis (x, y, x^2, y^2, xy) is exact in TF32
# while |x|, |y| <= 32.
MAX_BACKWARD_TILE_SIDE = 64


def heaviest_first(tile_ranges: torch.Tensor) -> torch.Tensor:
    """[n_tiles] int32 tile ids sorted by run length, longest first
    (stable), on the device: blocks take tiles in this order, so that the
    heaviest runs start in the first wave and not the last. One argsort of
    n_tiles ints per launch; the backward's order is the forward's."""
    lens = tile_ranges[:, 1] - tile_ranges[:, 0]
    return torch.argsort(lens, descending=True, stable=True).to(torch.int32)


def blend_forward(
    fields: torch.Tensor,  # [N + 1, 9] float32, pack_fields output
    binned: Binned,
    cfg: RasterConfig,
) -> torch.Tensor:
    """Front-to-back blend of every tile's instance run -> [4, H, W]
    (rows 0..2 colour, row 3 t_final). CPU tensors take the plain PyTorch
    version; CUDA tensors launch the kernel on the current stream, without
    synchronising, or raise."""
    if fields.device.type == "cpu":
        return blend_forward_torch(fields, binned, cfg)
    _check_inputs(fields, binned, cfg)
    out = torch.empty((4, cfg.height, cfg.width), dtype=torch.float32,
                      device=fields.device)
    _launch("blend_forward", fields, binned.inst_gauss, binned.tile_ranges,
            heaviest_first(binned.tile_ranges), out, cfg=cfg)
    blend_forward.launches += 1
    return out


def blend_backward(
    fields: torch.Tensor,  # [N + 1, 9] float32, the forward's input
    binned: Binned,
    cfg: RasterConfig,
    out: torch.Tensor,  # [4, H, W] float32, the forward's result
    g_out: torch.Tensor,  # [4, H, W] float32, the cotangent on out
) -> torch.Tensor:
    """Per-instance gradient rows [M, 9], aligned with binned.inst_gauss
    (see blend_torch.blend_backward_torch). CPU tensors take the plain
    PyTorch version; CUDA tensors launch the kernel on the current stream,
    without synchronising, or raise."""
    if fields.device.type == "cpu":
        return blend_backward_torch(fields, binned, cfg, out, g_out)
    _check_inputs(fields, binned, cfg)
    if max(cfg.tile_w, cfg.tile_h) > MAX_BACKWARD_TILE_SIDE:
        raise ValueError(
            f"tile {cfg.tile_w}x{cfg.tile_h}: the backward kernel takes sides "
            f"up to {MAX_BACKWARD_TILE_SIDE}"
        )
    image = (4, cfg.height, cfg.width)
    check_tensor("out", out, torch.float32, image, fields.device)
    check_tensor("g_out", g_out, torch.float32, image, fields.device)
    # rows of instances past every pixel's stop are never written
    grads = torch.zeros((binned.inst_gauss.shape[0], INSTANCE_WIDTH),
                        dtype=torch.float32, device=fields.device)
    _launch("blend_backward", fields, binned.inst_gauss, binned.tile_ranges,
            heaviest_first(binned.tile_ranges), out, g_out, grads, cfg=cfg)
    blend_backward.launches += 1
    return grads


def _check_inputs(fields: torch.Tensor, binned: Binned, cfg: RasterConfig):
    if fields.device.type != "cuda":
        raise ValueError(f"no blend kernel for device {fields.device}")
    dev = fields.device
    check_tensor("fields", fields, torch.float32, (None, INSTANCE_WIDTH), dev)
    check_tensor("inst_gauss", binned.inst_gauss, torch.int32, (None,), dev)
    check_tensor("tile_ranges", binned.tile_ranges, torch.int32, (cfg.n_tiles, 2), dev)
    if fields.shape[0] < 1:
        raise ValueError("fields must hold at least the sentinel row")
    if cfg.tile_pixels > MAX_THREADS_PER_BLOCK:
        raise ValueError(
            f"tile {cfg.tile_w}x{cfg.tile_h} exceeds {MAX_THREADS_PER_BLOCK} "
            "threads per block"
        )
    if cfg.tile_w % PATCH_W or cfg.tile_h % PATCH_H:
        raise ValueError(
            f"tile {cfg.tile_w}x{cfg.tile_h} is not whole {PATCH_W}x{PATCH_H} "
            "warp patches"
        )


def _launch(name: str, *tensors, cfg: RasterConfig) -> None:
    """Launch csrc/<name>.cu on the tensors' current stream: device
    pointers, six ints (width, height, tiles_x, n_tiles, tile_w, tile_h);
    raise on a CUDA error."""
    _build.launch(
        name, f"{name}_launch",
        [ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * 6,
        [t.data_ptr() for t in tensors] + [
            cfg.width, cfg.height, cfg.tiles_x, cfg.n_tiles, cfg.tile_w,
            cfg.tile_h],
        tensors[0].device,
    )


# Kernel launches since the count was last reset (CPU calls are not counted).
blend_forward.launches = 0
blend_backward.launches = 0
