"""Poisson surface reconstruction as an FFT solve, on the device.

Counterpart of ``frosting_tpu/extract/poisson.py`` (the stand-in for
Open3D's create_from_point_cloud_poisson): trilinear splatting of the
normals onto an n^3 grid, the divergence taken spectrally (the Fourier
symbol i sin k of the central difference), the inverse of the
central-difference Laplacian (eigenvalues 2 (cos k - 1) per axis), and the
iso level as the mean indicator at the input samples, as Kazhdan's SPSR
normalises it. The FFTs are ``torch.fft.rfftn`` / ``irfftn`` in complex64 on
the points' device at every resolution: the JAX package's routing of grids
from 512^3 up to the host CPU was for the TPU's FFT lowering, whose padded
temporaries did not fit one chip.

The splat is deterministic: each point's 8 corner contributions are
ordered by grid cell with one stable sort (corner-major, then point order,
as JAX's 8 scatter-adds take them) and each cell's run is summed by
``segment_reduce``, so two runs give a bitwise-equal indicator; an
``index_add_`` would sum with float atomics on the GPU.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from frosting_tpu_torch.extract.marching import marching_tets
from frosting_tpu_torch.utils.profiling import PartTimes

_CORNERS = tuple((dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1))


def _trilinear(pts01, n):
    """(base cell [P, 3] int64, fraction [P, 3]) of normalised coords."""
    x = torch.clamp(pts01 * (n - 1), 0.0, n - 1 - 1e-4)
    i0 = torch.floor(x).to(torch.int64)
    return i0, x - i0


def _corner_weight(f, dx, dy, dz):
    return ((f[:, 0] if dx else 1 - f[:, 0])
            * (f[:, 1] if dy else 1 - f[:, 1])
            * (f[:, 2] if dz else 1 - f[:, 2]))


def _splat(pts01, values, n):
    """[n, n, n, C] grid of the trilinear scatter-add of values [P, C],
    summed in a fixed order (see the module docstring)."""
    i0, f = _trilinear(pts01, n)
    cells, contrib = [], []
    for dx, dy, dz in _CORNERS:
        cells.append(((i0[:, 0] + dx) * n + (i0[:, 1] + dy)) * n + (i0[:, 2] + dz))
        contrib.append(values * _corner_weight(f, dx, dy, dz)[:, None])
    cells, order = torch.sort(torch.cat(cells), stable=True)
    contrib = torch.cat(contrib)[order]
    cells, counts = torch.unique_consecutive(cells, return_counts=True)
    sums = torch.segment_reduce(contrib, "sum", lengths=counts, axis=0, unsafe=True)
    grid = torch.zeros((n * n * n, values.shape[1]), dtype=values.dtype,
                       device=values.device)
    grid[cells] = sums
    return grid.reshape(n, n, n, -1)


def _trilinear_sample(grid, pts01, n):
    """Sample grid [n, n, n] at normalized coords [P, 3]."""
    i0, f = _trilinear(pts01, n)
    out = 0.0
    for dx, dy, dz in _CORNERS:
        out = out + _corner_weight(f, dx, dy, dz) * grid[
            i0[:, 0] + dx, i0[:, 1] + dy, i0[:, 2] + dz]
    return out


@torch.no_grad()
def poisson_grid(points01: torch.Tensor, normals: torch.Tensor, n: int,
                 parts: Optional[PartTimes] = None):
    """(chi [n, n, n] float32, iso) from points normalised to [0, 1]^3 and
    their outward normals (``frosting_tpu/extract/poisson.py::_poisson_grid``).
    One component's grid and spectrum live at a time beside the divergence's
    spectrum. `parts` times the splats and the FFT solve."""
    parts = parts or PartTimes(points01.device)
    dev = points01.device
    k = torch.fft.fftfreq(n, device=dev) * 2.0 * math.pi
    kr = torch.fft.rfftfreq(n, device=dev) * 2.0 * math.pi
    div_hat = None
    for c in range(3):
        with parts.device("Poisson splat"):
            comp = _splat(points01, -normals[:, c:c + 1], n)[..., 0]
        with parts.device("FFT solve"):
            kc = (kr if c == 2 else k).reshape([-1 if a == c else 1 for a in range(3)])
            term = torch.fft.rfftn(comp) * torch.complex(torch.zeros_like(kc), torch.sin(kc))
            del comp
            div_hat = term if div_hat is None else div_hat.add_(term)
            del term
    with parts.device("FFT solve"):
        # eigenvalues of the central-difference Laplacian: 2 (cos k - 1)
        # per axis, broadcast from 1-D factors
        lam = 2.0 * (torch.cos(k)[:, None, None] + torch.cos(k)[None, :, None]
                     + torch.cos(kr)[None, None, :] - 3.0)
        lam = torch.where(lam == 0.0, 1.0, lam)
        chi_hat = div_hat.div_(lam)
        del lam
        chi_hat[0, 0, 0] = 0.0
        chi = torch.fft.irfftn(chi_hat, s=(n, n, n)).to(torch.float32)
        del chi_hat, div_hat
        iso = torch.mean(_trilinear_sample(chi, points01, n))
    return chi, iso


def normalise(points: torch.Tensor, pad: float = 0.15):
    """(points01, lo, hi_p): the points in the cube [lo, hi_p] padded by
    `pad` of their widest extent on each side, mapped to [0, 1]^3."""
    lo = points.amin(0)
    hi = points.amax(0)
    span = (hi - lo).max()
    lo = lo - pad * span
    hi_p = lo + (span * (1 + 2 * pad))
    return (points - lo) / (hi_p - lo), lo, hi_p


@torch.no_grad()
def poisson_reconstruct(
    points: torch.Tensor,  # [P, 3] float32
    normals: torch.Tensor,  # [P, 3] outward unit normals
    resolution: int = 128,
    pad: float = 0.15,
    parts: Optional[PartTimes] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (verts [V, 3] float64, faces [F, 3] int64) of the reconstructed
    surface (outward-oriented), on the points' device. `parts` times the
    splats, the FFT solve and the marching."""
    parts = parts or PartTimes(points.device)
    points01, lo, hi_p = normalise(points, pad)
    chi, iso = poisson_grid(points01, normals, resolution, parts)
    del points01
    spacing = (hi_p - lo) / (resolution - 1)
    with parts.device("marching"):
        # chi is higher inside; marching_tets orients normals toward lower
        # values = outward. (Well-defined for level sets of chi - iso.)
        return marching_tets(chi, float(iso), origin=lo.double(), spacing=spacing.double())
