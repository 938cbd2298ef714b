"""Gaussian covariance math: 3D covariance from scale/rotation and the EWA
projection to a 2D screen-space covariance (computeCov3D / computeCov2D,
cuda_rasterizer/forward.cu:74-152).

Counterpart of ``frosting_tpu/ops/cov.py``. The small matrix products are
unrolled into elementwise ops in the same order as the reference, so they
stay exact float32 on the GPU (no TF32 matmul path is involved).
"""

from __future__ import annotations

import torch

from frosting_tpu_torch.ops import quat as quat_ops

# 0.3-pixel low-pass added to the 2D covariance diagonal (forward.cu:110-111).
COV2D_LOWPASS = 0.3
# Frustum clamp factor for the EWA Jacobian linearization point
# (forward.cu:82-87).
EWA_CLAMP = 1.3


def matvec_rows(p: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Row-vector product p @ M for [..., k] x [k, m], unrolled."""
    cols = [
        sum(p[..., i] * M[i, j] for i in range(p.shape[-1]))
        for j in range(M.shape[1])
    ]
    return torch.stack(cols, dim=-1)


def cov3d_from_scale_quat(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """[..., 3] activated scales + [..., 4] unit wxyz quats -> [..., 6]
    packed upper-triangular covariance (xx, xy, xz, yy, yz, zz) of
    R S S^T R^T."""
    R = quat_ops.to_matrix(quats)
    M = R * scales[..., None, :]  # R @ diag(s)

    def mm(i, j):
        return (
            M[..., i, 0] * M[..., j, 0]
            + M[..., i, 1] * M[..., j, 1]
            + M[..., i, 2] * M[..., j, 2]
        )

    return torch.stack(
        [mm(0, 0), mm(0, 1), mm(0, 2), mm(1, 1), mm(1, 2), mm(2, 2)], dim=-1
    )


def unpack_cov3d(cov6: torch.Tensor) -> torch.Tensor:
    """[..., 6] packed -> [..., 3, 3] symmetric."""
    xx, xy, xz, yy, yz, zz = (cov6[..., i] for i in range(6))
    return torch.stack([torch.stack([xx, xy, xz], dim=-1),
                        torch.stack([xy, yy, yz], dim=-1),
                        torch.stack([xz, yz, zz], dim=-1)], dim=-2)


def ewa_project(
    means3d: torch.Tensor,  # [..., 3] world positions
    cov6: torch.Tensor,  # [..., 6] packed world covariance
    world_view: torch.Tensor,  # [4, 4] row-vector convention
    focal_x,
    focal_y,
    tan_fov_x,
    tan_fov_y,
) -> torch.Tensor:
    """EWA splatting 2D covariance -> [..., 3] packed (xx, xy, yy),
    including the 0.3 px low-pass on the diagonal."""
    W = world_view[:3, :3]  # p_view = p @ W + wv[3, :3]
    t = matvec_rows(means3d, W) + world_view[3, :3]
    tz = t[..., 2]
    lim_x = EWA_CLAMP * tan_fov_x
    lim_y = EWA_CLAMP * tan_fov_y
    txtz = torch.clamp(t[..., 0] / tz, -lim_x, lim_x)
    tytz = torch.clamp(t[..., 1] / tz, -lim_y, lim_y)
    tx = txtz * tz
    ty = tytz * tz

    inv_z = 1.0 / tz
    inv_z2 = inv_z * inv_z
    j00 = focal_x * inv_z
    j02 = -focal_x * tx * inv_z2
    j11 = focal_y * inv_z
    j12 = -focal_y * ty * inv_z2

    # T = J @ Wc with Wc = W.T (camera rotation, column-vector convention)
    Wc = W.T
    t0 = j00[..., None] * Wc[0] + j02[..., None] * Wc[2]
    t1 = j11[..., None] * Wc[1] + j12[..., None] * Wc[2]

    xx, xy, xz, yy, yz, zz = (cov6[..., i] for i in range(6))

    def quad(a, b):
        return (
            a[..., 0] * b[..., 0] * xx
            + a[..., 1] * b[..., 1] * yy
            + a[..., 2] * b[..., 2] * zz
            + (a[..., 0] * b[..., 1] + a[..., 1] * b[..., 0]) * xy
            + (a[..., 0] * b[..., 2] + a[..., 2] * b[..., 0]) * xz
            + (a[..., 1] * b[..., 2] + a[..., 2] * b[..., 1]) * yz
        )

    cov_xx = quad(t0, t0) + COV2D_LOWPASS
    cov_yy = quad(t1, t1) + COV2D_LOWPASS
    cov_xy = quad(t0, t1)
    return torch.stack([cov_xx, cov_xy, cov_yy], dim=-1)


def conic_and_radius(cov2d: torch.Tensor):
    """Inverse 2D covariance and 3-sigma pixel radius (forward.cu:222-236).

    Returns (conic [..., 3] = (a, b, c), radius [...] float, det [...]).
    """
    cxx, cxy, cyy = cov2d[..., 0], cov2d[..., 1], cov2d[..., 2]
    det = cxx * cyy - cxy * cxy
    det_safe = torch.where(det == 0.0, torch.ones_like(det), det)
    inv = 1.0 / det_safe
    conic = torch.stack([cyy * inv, -cxy * inv, cxx * inv], dim=-1)
    mid = 0.5 * (cxx + cyy)
    sq = torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    lambda1 = mid + sq
    radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda1, min=1e-12)))
    return conic, radius, det


def axis_extents(cov2d: torch.Tensor):
    """Per-axis 3-sigma extents (+-3 sqrt(cov_xx), +-3 sqrt(cov_yy)) of the
    2D Gaussian: tighter than the isotropic 3 sigma_max box."""
    rx = 3.0 * torch.sqrt(torch.clamp(cov2d[..., 0], min=1e-12))
    ry = 3.0 * torch.sqrt(torch.clamp(cov2d[..., 2], min=1e-12))
    return rx, ry
