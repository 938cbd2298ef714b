"""Photometric losses: L1, L2, windowed SSIM / D-SSIM, PSNR.

Counterpart of ``frosting_tpu/ops/ssim.py`` (reference loss_utils.py:17-63:
11x11 Gaussian window, sigma 1.5, per-channel depthwise convolution with
SAME zero padding, C1 = 0.01^2, C2 = 0.03^2), with the strip-sharded SSIM
of the multi-device steps (``ssim_strips``).

The JAX package runs the window at ``Precision.HIGHEST``. cuDNN runs float32
convolutions in TF32 by default (``torch.backends.cudnn.allow_tf32``), which
keeps about three decimal digits, so the blur runs under
``torch.backends.cudnn.flags(..., allow_tf32=False)``, forward and backward
(``_Blur``): full float32 on the card as on the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a - b))


def l2_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a - b) ** 2)


@functools.lru_cache(maxsize=8)
def _gaussian_window(window_size: int, sigma: float) -> np.ndarray:
    g = np.exp(
        -((np.arange(window_size) - window_size // 2) ** 2) / (2 * sigma**2)
    )
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def _conv_fp32(x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    """x [C, H, W] -> same: each channel convolved with window [k, k]."""
    c, k = x.shape[0], window.shape[0]
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        return F.conv2d(x[None], window.expand(c, 1, k, k).contiguous(), padding=k // 2,
                        groups=c)[0]


class _Blur(torch.autograd.Function):
    """Depthwise blur with a symmetric window and SAME zero padding. The
    operator is its own transpose, so the backward is the same blur."""

    @staticmethod
    def forward(ctx, x, window):
        ctx.save_for_backward(window)
        return _conv_fp32(x, window)

    @staticmethod
    def backward(ctx, g):
        (window,) = ctx.saved_tensors
        return _conv_fp32(g.contiguous(), window), None


def _ssim_map(img1, img2, window_size, sigma):
    c = img1.shape[0]
    window = torch.from_numpy(_gaussian_window(window_size, sigma)).to(img1.device)
    # the five blurred maps in one depthwise convolution
    stack = torch.cat([img1, img2, img1 * img1, img2 * img2, img1 * img2])
    blurred = _Blur.apply(stack, window)
    mu1, mu2, e11, e22, e12 = torch.split(blurred, c)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    sigma1_sq = e11 - mu1_sq
    sigma2_sq = e22 - mu2_sq
    sigma12 = e12 - mu12
    c1, c2 = 0.01**2, 0.03**2
    return ((2 * mu12 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )


def ssim(
    img1: torch.Tensor,  # [C, H, W] in [0, 1]
    img2: torch.Tensor,
    window_size: int = 11,
    sigma: float = 1.5,
) -> torch.Tensor:
    return torch.mean(_ssim_map(img1, img2, window_size, sigma))


def _exchange_row_halo(x: torch.Tensor, mesh, axis: str, h: int) -> torch.Tensor:
    """[C, H, W] strip -> [C, H + 2h, W] with h rows of halo from the strip
    neighbours along the mesh axis (zeros at the image's top and bottom, as
    the full image's SAME zero padding). Every rank takes part in both
    shifts, and in their backward, wherever its strip lies."""
    from frosting_tpu_torch.parallel import collectives

    n = mesh.axis_size(axis)
    idx = mesh.axis_index(axis)
    # our bottom halo is the next strip's top rows: every rank sends its
    # top block up by one, and its bottom block down by one
    from_next = collectives.ppermute(x[:, :h], mesh, axis, -1)
    from_prev = collectives.ppermute(x[:, -h:], mesh, axis, 1)
    first = torch.tensor(idx == 0, device=x.device)
    last = torch.tensor(idx == n - 1, device=x.device)
    from_prev = torch.where(first, 0.0, from_prev)
    from_next = torch.where(last, 0.0, from_next)
    return torch.cat([from_prev, x, from_next], dim=1)


def ssim_strips(
    img1: torch.Tensor,  # [C, strip_h, W] this rank's horizontal strip
    img2: torch.Tensor,
    mesh,
    axis: str = "tile",
    window_size: int = 11,
    sigma: float = 1.5,
) -> torch.Tensor:
    """This strip's share of the full image's SSIM: halo rows come from the
    neighbour strips (``parallel.collectives.ppermute``), so the windows
    cross the seams as in the full image, and the mean over the strips
    equals ``ssim`` of the whole image."""
    h = window_size // 2
    p1 = _exchange_row_halo(img1, mesh, axis, h)
    p2 = _exchange_row_halo(img2, mesh, axis, h)
    m = _ssim_map(p1, p2, window_size, sigma)
    return torch.mean(m[:, h:-h])


def dssim(img1, img2, **kw):
    return (1.0 - ssim(img1, img2, **kw)) / 2.0


def photometric_loss(pred, gt, dssim_factor: float = 0.2):
    """The reference training loss: (1 - f) * L1 + f * (1 - SSIM)."""
    return (1.0 - dssim_factor) * l1_loss(pred, gt) + dssim_factor * (
        1.0 - ssim(pred, gt)
    )


def psnr(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    mse = torch.mean((img1 - img2) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))
