"""Evaluation metrics over held-out views (the metrics.py:72-551 analogue).

Counterpart of ``frosting_tpu/metrics.py``. PSNR and SSIM come from the
port's ``ops/ssim.py``. LPIPS follows the reference's architecture (VGG16
features and learned linear heads, gaussian_splatting/lpipsPyTorch/
modules/*) as plain PyTorch convolutions on the images' device; its
pretrained weights cannot be downloaded here: point
FROSTING_TPU_LPIPS_WEIGHTS at an .npz export of the torchvision VGG16 +
LPIPS linear weights to enable it, otherwise ``evaluate_views`` reports
``lpips: None``. Nothing is fetched.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from frosting_tpu_torch.ops.ssim import psnr as psnr_fn
from frosting_tpu_torch.ops.ssim import ssim as ssim_fn


class LPIPS(torch.nn.Module):
    """VGG16-based LPIPS (lpipsPyTorch/modules/lpips.py structure). Weights
    are read from an npz with torchvision parameter names: ``features.N.
    weight`` / ``.bias`` for the convolutions and ``lin{k}.model.1.weight``
    for the heads. The convolutions run in float32, TF32 off."""

    # the five feature slices of VGG16's 30 layers; a slice after the first
    # starts at a max-pool, the other layers are 3x3 convs and ReLUs
    SLICES = [(0, 4), (4, 9), (9, 16), (16, 23), (23, 30)]
    # normalization constants (lpipsPyTorch/modules/networks.py)
    MEAN = np.array([-0.030, -0.088, -0.188], np.float32)
    STD = np.array([0.458, 0.448, 0.450], np.float32)

    def __init__(self, weights_path: str, device="cuda"):
        super().__init__()
        with np.load(weights_path) as z:
            self.conv_ids = [i for i in range(31) if f"features.{i}.weight" in z]
            for i in self.conv_ids:
                self.register_buffer(f"w{i}", torch.from_numpy(z[f"features.{i}.weight"]))
                self.register_buffer(f"b{i}", torch.from_numpy(z[f"features.{i}.bias"]))
            for k in range(5):
                self.register_buffer(f"lin{k}", torch.from_numpy(z[f"lin{k}.model.1.weight"])
                                     .reshape(1, -1, 1, 1))
        self.register_buffer("mean", torch.from_numpy(self.MEAN).reshape(1, 3, 1, 1))
        self.register_buffer("std", torch.from_numpy(self.STD).reshape(1, 3, 1, 1))
        self.to(device)

    def _vgg_features(self, x):
        pools = {start for start, _end in self.SLICES[1:]}
        ends = {end for _start, end in self.SLICES}
        feats, h = [], x
        for i in range(30):
            if i in self.conv_ids:
                h = F.conv2d(h, getattr(self, f"w{i}"), getattr(self, f"b{i}"), padding=1)
            elif i in pools:
                h = F.max_pool2d(h, 2)
            else:
                h = F.relu(h)
            if i + 1 in ends:
                feats.append(h)
        return feats

    @torch.no_grad()
    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a, b: [3, H, W] in [0, 1]. Returns the distance, a 0-d tensor."""
        def norm(x):
            return ((x * 2.0 - 1.0)[None] - self.mean) / self.std

        with torch.backends.cudnn.flags(allow_tf32=False):
            fa = self._vgg_features(norm(a))
            fb = self._vgg_features(norm(b))
        total = a.new_zeros(())
        for k, (f1, f2) in enumerate(zip(fa, fb)):
            n1 = f1 / torch.clamp(torch.linalg.vector_norm(f1, dim=1, keepdim=True), min=1e-10)
            n2 = f2 / torch.clamp(torch.linalg.vector_norm(f2, dim=1, keepdim=True), min=1e-10)
            total = total + torch.mean(torch.sum((n1 - n2) ** 2 * getattr(self, f"lin{k}"), dim=1))
        return total


def get_lpips(device="cuda") -> Optional[LPIPS]:
    """LPIPS from the npz named by FROSTING_TPU_LPIPS_WEIGHTS, or None."""
    path = os.environ.get("FROSTING_TPU_LPIPS_WEIGHTS")
    if path and os.path.exists(path):
        return LPIPS(path, device=device)
    return None


@torch.no_grad()
def evaluate_views(
    render_fn,  # camera -> [3, H, W] tensor
    cameras: List,
    gt_images: np.ndarray,  # [n, 3, H, W]
    lpips: Optional[LPIPS] = None,
) -> Dict[str, Optional[float]]:
    """PSNR / SSIM (/ LPIPS) means over views (metrics.py's evaluate loop);
    the ground truth goes to the render's device."""
    psnrs, ssims, lpipss = [], [], []
    for cam, gt in zip(cameras, gt_images):
        img = torch.clamp(render_fn(cam), 0.0, 1.0)
        gt = torch.as_tensor(np.asarray(gt, np.float32), device=img.device)
        psnrs.append(float(psnr_fn(img, gt)))
        ssims.append(float(ssim_fn(img, gt)))
        if lpips is not None:
            lpipss.append(float(lpips(img, gt)))
    return {
        "psnr": float(np.mean(psnrs)),
        "ssim": float(np.mean(ssims)),
        "lpips": float(np.mean(lpipss)) if lpipss else None,
        "n_views": len(psnrs),
    }


def write_metrics(path: str, results: Dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=2)
