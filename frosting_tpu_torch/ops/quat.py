"""Quaternion algebra (wxyz convention) on torch tensors.

Counterpart of ``frosting_tpu/ops/quat.py`` (normalize, to_matrix,
conjugate, apply).
Convention: q = (w, x, y, z), the 3DGS rotation parameter layout.
"""

from __future__ import annotations

import torch


def normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    # sum of squares + clamped rsqrt keeps the gradient finite at q == 0
    sq = torch.sum(q * q, dim=-1, keepdim=True)
    return q * torch.rsqrt(torch.clamp(sq, min=eps * eps))


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (wxyz) -> rotation matrix [..., 3, 3].

    Matches computeCov3D's R (cuda_rasterizer/forward.cu:133-138).
    """
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1.0 - 2.0 * (y * y + z * z)
    r01 = 2.0 * (x * y - w * z)
    r02 = 2.0 * (x * z + w * y)
    r10 = 2.0 * (x * y + w * z)
    r11 = 1.0 - 2.0 * (x * x + z * z)
    r12 = 2.0 * (y * z - w * x)
    r20 = 2.0 * (x * z - w * y)
    r21 = 2.0 * (y * z + w * x)
    r22 = 1.0 - 2.0 * (x * x + y * y)
    row0 = torch.stack([r00, r01, r02], dim=-1)
    row1 = torch.stack([r10, r11, r12], dim=-1)
    row2 = torch.stack([r20, r21, r22], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v [..., 3] by unit quaternions q [..., 4]."""
    qvec = q[..., 1:]
    uv = torch.linalg.cross(qvec, v)
    uuv = torch.linalg.cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)
