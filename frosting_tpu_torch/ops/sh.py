"""Real spherical-harmonics evaluation, degrees 0..4, on torch tensors.

Counterpart of ``frosting_tpu/ops/sh.py``. Coefficient layout is
[..., (deg+1)^2, C].
"""

from __future__ import annotations

import torch

C0 = 0.28209479177387814
C1 = 0.4886025119029199
C2 = (
    1.0925484305920792,
    -1.0925484305920792,
    0.31539156525252005,
    -1.0925484305920792,
    0.5462742152960396,
)
C3 = (
    -0.5900435899266435,
    2.890611442640554,
    -0.4570457994644658,
    0.3731763325901154,
    -0.4570457994644658,
    1.445305721320277,
    -0.5900435899266435,
)
C4 = (
    2.5033429417967046,
    -1.7701307697799304,
    0.9461746957575601,
    -0.6690465435572892,
    0.10578554691520431,
    -0.6690465435572892,
    0.47308734787878004,
    -1.7701307697799304,
    0.6258357354491761,
)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh_bases(degree: int, dirs: torch.Tensor) -> torch.Tensor:
    """Real SH basis values [..., (degree+1)^2] for unit directions [..., 3],
    in the reference's order and signs."""
    if not 0 <= degree <= 4:
        raise ValueError(f"degree must be in [0, 4], got {degree}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    out = [torch.full_like(x, C0)]
    if degree > 0:
        out += [-C1 * y, C1 * z, -C1 * x]
    if degree > 1:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            C2[0] * xy,
            C2[1] * yz,
            C2[2] * (2.0 * zz - xx - yy),
            C2[3] * xz,
            C2[4] * (xx - yy),
        ]
    if degree > 2:
        out += [
            C3[0] * y * (3.0 * xx - yy),
            C3[1] * xy * z,
            C3[2] * y * (4.0 * zz - xx - yy),
            C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            C3[4] * x * (4.0 * zz - xx - yy),
            C3[5] * z * (xx - yy),
            C3[6] * x * (xx - 3.0 * yy),
        ]
    if degree > 3:
        out += [
            C4[0] * xy * (xx - yy),
            C4[1] * yz * (3.0 * xx - yy),
            C4[2] * xy * (7.0 * zz - 1.0),
            C4[3] * yz * (7.0 * zz - 3.0),
            C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
            C4[5] * xz * (7.0 * zz - 3.0),
            C4[6] * (xx - yy) * (7.0 * zz - 1.0),
            C4[7] * xz * (xx - 3.0 * yy),
            C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
        ]
    return torch.stack(out, dim=-1)


def eval_sh(degree: int, sh: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """SH colours sum_k basis_k(dir) * sh[..., k, :]: sh [..., K, C] with
    K >= (degree+1)^2, dirs [..., 3] unit -> [..., C]. An elementwise
    weighted sum, not a matmul, so it stays exact f32 on the GPU."""
    basis = eval_sh_bases(degree, dirs)
    k = num_sh_coeffs(degree)
    return torch.sum(basis[..., :, None] * sh[..., :k, :], dim=-2)


def sh_to_rgb(sh_dc: torch.Tensor) -> torch.Tensor:
    """DC SH coefficient -> RGB (reference SH2RGB)."""
    return sh_dc * C0 + 0.5


def rgb_to_sh(rgb: torch.Tensor) -> torch.Tensor:
    """RGB -> DC SH coefficient (reference RGB2SH)."""
    return (rgb - 0.5) / C0
