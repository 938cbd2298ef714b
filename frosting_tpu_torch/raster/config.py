"""Rasterizer configuration: the fields that shape the rendered result.

Counterpart of ``frosting_tpu/raster/config.py`` without its TPU-only knobs
(DMA superblocks, tiles per program, backend selection, interpret mode,
decode strategy, bf16 sort payloads).
"""

from __future__ import annotations

import dataclasses

# Packed per-Gaussian field layout, one float32 row of INSTANCE_WIDTH each:
#   0: mean2d.x   1: mean2d.y
#   2: conic.a    3: conic.b     4: conic.c
#   5: opacity
#   6: color.r    7: color.g     8: color.b
INSTANCE_WIDTH = 9

# Alpha-compositing constants, matching renderCUDA (forward.cu:310-351).
ALPHA_CLAMP = 0.99
ALPHA_CUTOFF = 1.0 / 255.0
TRANSMITTANCE_EPS = 1e-4


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Image size, tile grid and capacity for one render resolution."""

    width: int
    height: int
    # Full-image dimensions used for projection (NDC->pixel and focal
    # lengths); 0 = same as width/height.
    proj_width: int = 0
    proj_height: int = 0
    # Pixel tile: one CUDA block of tile_w * tile_h threads blends one tile.
    # The tile size decides which tiles a Gaussian's 3-sigma rect covers, so
    # it must match the JAX reference's 32x16 for parity.
    tile_w: int = 32
    tile_h: int = 16
    # Instances per step of the plain PyTorch blend's walk over a tile's run.
    chunk: int = 128
    # Capacity for (Gaussian, tile) instances. Past it the farthest
    # instances are dropped and `overflow` is set.
    max_instances: int = 1 << 20
    # Near-plane depth cull (auxiliary.h in_frustum).
    near: float = 0.2
    sh_degree: int = 3

    def __post_init__(self):
        for name in ("width", "height", "tile_w", "tile_h", "chunk",
                     "max_instances"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be positive")

    @property
    def projection_width(self) -> int:
        return self.proj_width or self.width

    @property
    def projection_height(self) -> int:
        return self.proj_height or self.height

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.tile_w)

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.tile_h)

    @property
    def n_tiles(self) -> int:
        return self.tiles_x * self.tiles_y

    @property
    def tile_pixels(self) -> int:
        return self.tile_w * self.tile_h
