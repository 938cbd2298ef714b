"""Tile-binned Gaussian rasterizer on PyTorch, forward pass.

  1. preprocess  - projection, EWA 2D covariance, SH->RGB, radii and tile
                   rects (preprocess.py);
  2. binning     - one instance per (Gaussian, covered tile), sorted by tile
                   and front to back, with per-tile ranges (binning.py);
  3. blend       - the CUDA kernel csrc/blend_forward.cu on the GPU, its
                   plain PyTorch version on the CPU (blend_cuda.py,
                   blend_torch.py).
"""

from frosting_tpu_torch.raster.config import RasterConfig
from frosting_tpu_torch.raster.render import render

__all__ = ["RasterConfig", "render"]
