"""The forward blend: the hand-written CUDA kernel ``csrc/blend_forward.cu``
for tensors on the GPU, its plain PyTorch version for tensors on the CPU.

The kernel replaces ``frosting_tpu/raster/blend_pallas.py::
blend_forward_pallas``. It is bound by FP32 and SFU (``exp``) throughput over
the (instance, tile-pixel) pairs, not by bytes: each instance's 36 B is read
once per tile and reused by all of the tile's pixels (see the source's
header for the design). It is built with nvcc at the first launch
(``frosting_tpu_torch/_build.py``).
"""

from __future__ import annotations

import ctypes

import torch

from frosting_tpu_torch import _build
from frosting_tpu_torch.raster.binning import Binned
from frosting_tpu_torch.raster.blend_torch import blend_forward_torch
from frosting_tpu_torch.raster.config import INSTANCE_WIDTH, RasterConfig

KERNEL = "blend_forward"
MAX_THREADS_PER_BLOCK = 1024


def _library() -> ctypes.CDLL:
    lib = _build.load(KERNEL)
    fn = lib.blend_forward_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if len(shape) != t.dim() or any(
        s is not None and s != d for s, d in zip(shape, t.shape)
    ):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


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
    if fields.device.type != "cuda":
        raise ValueError(f"no blend kernel for device {fields.device}")
    dev = fields.device
    _check("fields", fields, torch.float32, (None, INSTANCE_WIDTH), dev)
    _check("inst_gauss", binned.inst_gauss, torch.int32, (None,), dev)
    _check("tile_ranges", binned.tile_ranges, torch.int32, (cfg.n_tiles, 2), dev)
    if fields.shape[0] < 1:
        raise ValueError("fields must hold at least the sentinel row")
    if cfg.tile_pixels > MAX_THREADS_PER_BLOCK:
        raise ValueError(
            f"tile {cfg.tile_w}x{cfg.tile_h} exceeds {MAX_THREADS_PER_BLOCK} "
            "threads per block"
        )
    lib = _library()
    out = torch.empty((4, cfg.height, cfg.width), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.blend_forward_launch(
            fields.data_ptr(),
            binned.inst_gauss.data_ptr(),
            binned.tile_ranges.data_ptr(),
            out.data_ptr(),
            cfg.width, cfg.height, cfg.tiles_x, cfg.n_tiles,
            cfg.tile_w, cfg.tile_h,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"blend_forward kernel launch failed: CUDA error {err}")
    blend_forward.launches += 1
    return out


# Kernel launches since the count was last reset (CPU calls are not counted).
blend_forward.launches = 0
