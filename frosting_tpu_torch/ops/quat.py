"""Quaternion algebra (wxyz convention) on torch tensors.

Counterpart of ``frosting_tpu/ops/quat.py`` (normalize, to_matrix,
from_matrix, multiply, conjugate, apply).
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


def from_matrix(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4] (wxyz).

    JAX's branch-free Shepperd construction, step for step: all four
    candidates are built and the one keyed to the largest of the four
    diagonal combinations is taken (``argmax``, the first on a tie, as
    ``jnp.argmax``), so each quaternion's sign is the one JAX gives. The
    1e-6 floor keeps every candidate's gradient finite."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    qw2 = torch.clamp(1.0 + m00 + m11 + m22, min=1e-6)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=1e-6)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=1e-6)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=1e-6)

    def safe_div(a, b):
        return a / torch.clamp(b, min=1e-12)

    sw, sx, sy, sz = torch.sqrt(qw2), torch.sqrt(qx2), torch.sqrt(qy2), torch.sqrt(qz2)
    cw = torch.stack([sw, safe_div(m21 - m12, sw), safe_div(m02 - m20, sw),
                      safe_div(m10 - m01, sw)], dim=-1)
    cx = torch.stack([safe_div(m21 - m12, sx), sx, safe_div(m01 + m10, sx),
                      safe_div(m02 + m20, sx)], dim=-1)
    cy = torch.stack([safe_div(m02 - m20, sy), safe_div(m01 + m10, sy), sy,
                      safe_div(m12 + m21, sy)], dim=-1)
    cz = torch.stack([safe_div(m10 - m01, sz), safe_div(m02 + m20, sz),
                      safe_div(m12 + m21, sz), sz], dim=-1)
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    cands = torch.stack([cw, cx, cy, cz], dim=-2)  # [..., 4 candidates, 4]
    q = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 4)))
    return normalize(q[..., 0, :] * 0.5)


def multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a * b, both [..., 4] wxyz."""
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v [..., 3] by unit quaternions q [..., 4]."""
    qvec = q[..., 1:]
    uv = torch.linalg.cross(qvec, v)
    uuv = torch.linalg.cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)
