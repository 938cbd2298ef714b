"""SuGaR surface-regularisation machinery: normals, entropy / SDF / normal
losses, depth and normal renders.

Counterpart of ``frosting_tpu/models/sugar.py`` (frosting_scene/
sugar_model.py, frosting_trainers/coarse_density.py): the "model" is
GaussianParams plus these loss functions of activated tensors.
``jax.lax.stop_gradient`` becomes ``.detach()``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from frosting_tpu_torch.models import fields
from frosting_tpu_torch.ops import quat as quat_ops
from frosting_tpu_torch.ops.cov import matvec_rows
from frosting_tpu_torch.raster import render


def smallest_axis(scales: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """Per-Gaussian normal = rotation column of the smallest scale
    (sugar_model.get_smallest_axis, sugar_model.py:977-999)."""
    R = quat_ops.to_matrix(quats)  # [N, 3, 3] columns are principal axes
    idx = torch.argmin(scales, dim=-1)  # [N]
    return torch.gather(R, 2, idx[:, None, None].expand(-1, 3, 1))[..., 0]


def fused_dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b, -1) over a last axis of 3, rounded as XLA's compiled
    reduction rounds it: fma(a2, b2, fma(a1, b1, a0 * b0)), each step
    rounded once to float32 (a float32 product is exact in float64).

    The sign of this sum weighs the neighbour normals in
    ``better_normal_loss``. Near isotropy it is a rounding: Adam's first
    steps move every quaternion component by the same +-lr, so normals of
    different Gaussians' axes are orthogonal to a few ulps, and a plain
    sum's sign differs from the JAX package's jitted step's in ~2% of the
    pairs."""
    a = a.to(torch.float64)
    b = b.to(torch.float64)
    r = (a[..., 0] * b[..., 0]).to(torch.float32)
    r = (a[..., 1] * b[..., 1] + r.to(torch.float64)).to(torch.float32)
    return (a[..., 2] * b[..., 2] + r.to(torch.float64)).to(torch.float32)


def entropy_loss(opacities: torch.Tensor, visible: torch.Tensor) -> torch.Tensor:
    """Binary entropy of visible opacities (coarse_density.py:542-555),
    probabilities clamped away from {0, 1} (see the JAX version; callers
    holding logits use entropy_loss_from_logits)."""
    o = torch.clamp(opacities, 1e-7, 1.0 - 1e-7)
    ent = -o * torch.log(o) - (1.0 - o) * torch.log(1.0 - o)
    w = visible.to(torch.float32)
    return torch.sum(ent * w) / torch.clamp(torch.sum(w), min=1.0)


def entropy_loss_from_logits(logits: torch.Tensor, visible: torch.Tensor) -> torch.Tensor:
    """Binary entropy of sigmoid(logits) in logit space: log(o) =
    -softplus(-x), log(1 - o) = -softplus(x), finite value and gradient at
    any saturation."""
    x = logits
    o = torch.sigmoid(x)
    sp = torch.nn.functional.softplus
    ent = o * sp(-x) + (1.0 - o) * sp(x)
    w = visible.to(torch.float32)
    return torch.sum(ent * w) / torch.clamp(torch.sum(w), min=1.0)


class SdfLossInputs(NamedTuple):
    samples: torch.Tensor  # [S, 3]
    gaussian_idx: torch.Tensor  # [S]
    knn_idx: torch.Tensor  # [S, K] neighbour sets of the owning Gaussians


def sample_sdf_points(
    means: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    knn_idx_all: torch.Tensor,  # [N, K]
    visible: torch.Tensor,  # [N] bool sampling mask
    n_samples: int,
    sampling_scale_factor: float = 1.5,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
    eps: Optional[torch.Tensor] = None,
) -> SdfLossInputs:
    """Points in visible Gaussians at 1.5x scale, uniform over Gaussians
    (coarse_density.py:155-156, 634-639). The draws as in
    fields.sample_points_in_gaussians."""
    weights = visible.to(torch.float32)
    samples, gidx = fields.sample_points_in_gaussians(
        n_samples, means, scales, quats, weights,
        scale_factor=sampling_scale_factor, generator=generator, u=u, eps=eps,
    )
    return SdfLossInputs(samples, gidx, knn_idx_all[gidx])


def sdf_estimation_density_loss(
    inp: SdfLossInputs,
    means: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    beta_mode: str = "average",
) -> torch.Tensor:
    """Density-mode SDF estimation loss (coarse_density.py:653-656,
    683-691): the raw density at a sample should be exp(-1/2 sdf^2 /
    beta^2), with sdf the sample's offset along its Gaussian's normal."""
    fv = fields.field_values(
        inp.samples, inp.knn_idx, means, opacities, scales, quats,
        beta_mode=beta_mode, density_factor=1.0,
    )
    normals = smallest_axis(scales, quats)[inp.gaussian_idx]
    sdf_est = torch.sum((inp.samples - means[inp.gaussian_idx]) * normals, -1)
    target = torch.exp(-0.5 * sdf_est**2 / torch.clamp(fv.beta, min=1e-12) ** 2)
    return torch.mean(torch.abs(fv.density - target))


def depth_normal_colors(means, scales, quats, camera):
    """The per-Gaussian colours of the depth and normal renders: the view
    depth in all three channels, and the normal flipped toward the camera."""
    homog = torch.cat([means, torch.ones_like(means[:, :1])], dim=-1)
    depth = matvec_rows(homog, camera.world_view[:, 2:3])[:, 0]
    normals = smallest_axis(scales, quats)
    to_cam = camera.cam_center - means
    sign = torch.sign(torch.sum(normals * to_cam, dim=-1, keepdim=True))
    normals = normals * torch.where(sign == 0, 1.0, sign)
    return torch.stack([depth, depth, depth], -1), normals


def render_depth_normal_maps(means, scales, quats, opac, camera, rcfg, normals=True):
    """Alpha-weighted depth and normal maps via the point-colours trick
    (sugar_model.py:2343-2387). Returns (depth [H, W], normal [3, H, W],
    acc [H, W]); acc = 1 - t_final carries a cotangent into the backward
    blend's transmittance row. With ``normals=False`` the normal render is
    skipped and its map is None (the sdf method reads only the depth)."""
    depth_colors, normal_colors = depth_normal_colors(means, scales, quats, camera)
    no_sh = torch.zeros_like(means[:, None])
    out_d = render(
        means, scales, quats, opac, no_sh, camera, rcfg, colors_precomp=depth_colors
    )
    acc = 1.0 - out_d.t_final
    depth_map = out_d.image[0] / torch.clamp(acc, min=1e-6)
    normal_map = None
    if normals:
        out_n = render(
            means, scales, quats, opac, no_sh, camera, rcfg, colors_precomp=normal_colors
        )
        normal_map = out_n.image / torch.clamp(acc, min=1e-6)[None]
    return depth_map, normal_map, acc


def _focals_and_centre(camera, rcfg):
    fx, fy = camera.focals(rcfg.projection_width, rcfg.projection_height)
    cx = (rcfg.projection_width - 1.0) / 2.0
    cy = (rcfg.projection_height - 1.0) / 2.0
    return fx, fy, cx, cy


def normal_from_depth(depth_map, camera, rcfg):
    """2DGS-style normals from depth finite differences
    (coarse_density_and_dn_consistency.py:17-57): [3, H, W] world-space
    unit normals."""
    h, w = depth_map.shape
    dev = depth_map.device
    fx, fy, cx, cy = _focals_and_centre(camera, rcfg)
    xs = (torch.arange(w, dtype=torch.float32, device=dev)[None, :] - cx) / fx
    ys = (torch.arange(h, dtype=torch.float32, device=dev)[:, None] - cy) / fy
    pts_cam = torch.stack([xs * depth_map, ys * depth_map, depth_map], dim=-1)
    dx = torch.diff(pts_cam, dim=1, append=pts_cam[:, -1:])
    dy = torch.diff(pts_cam, dim=0, append=pts_cam[-1:])
    n = torch.cross(dx, dy, dim=-1)
    # NaN-safe normalise (a norm's gradient is NaN at exactly 0)
    n = n * torch.rsqrt(torch.clamp(torch.sum(n * n, dim=-1, keepdim=True), min=1e-18))
    # view -> world: p_world = p_view @ Wv^T for the row-vector world_view
    R = camera.world_view[:3, :3]
    n_world = (
        n[..., 0:1] * R[:, 0][None, None]
        + n[..., 1:2] * R[:, 1][None, None]
        + n[..., 2:3] * R[:, 2][None, None]
    )
    return -n_world.permute(2, 0, 1)  # oriented toward the camera


def dn_consistency_loss(depth_map, normal_map, acc, camera, rcfg):
    """1 - |cos| between rendered normals and depth-derived normals over
    covered pixels (dn_consistency.py:60-97, 644-657)."""
    nd = normal_from_depth(depth_map, camera, rcfg)
    nm = normal_map * torch.rsqrt(
        torch.clamp(torch.sum(normal_map * normal_map, dim=0, keepdim=True), min=1e-18)
    )
    cos = torch.sum(nd * nm, dim=0)
    # |cos| (normals may be flipped), with jnp.abs's derivative 1 at 0: the
    # depth normals of the last row and column are exactly 0
    cos = torch.where(cos >= 0, cos, -cos)
    w = (acc > 0.5).to(torch.float32)
    return torch.sum((1.0 - cos) * w) / torch.clamp(torch.sum(w), min=1.0)


def sample_depth_at_points(depth_map, pts_view, camera, rcfg):
    """Bilinear depth-map lookup at view-space points
    (get_points_depth_in_depth_map, sugar_model.py:1351-1374)."""
    fx, fy, cx, cy = _focals_and_centre(camera, rcfg)
    z = torch.clamp(pts_view[:, 2], min=1e-6)
    px = pts_view[:, 0] / z * fx + cx
    py = pts_view[:, 1] / z * fy + cy
    h, w = depth_map.shape
    px = torch.clamp(px, 0.0, w - 1.001)
    py = torch.clamp(py, 0.0, h - 1.001)
    x0 = torch.floor(px).to(torch.int64)
    y0 = torch.floor(py).to(torch.int64)
    fx_ = px - x0
    fy_ = py - y0
    return (
        depth_map[y0, x0] * (1 - fx_) * (1 - fy_)
        + depth_map[y0, x0 + 1] * fx_ * (1 - fy_)
        + depth_map[y0 + 1, x0] * (1 - fx_) * fy_
        + depth_map[y0 + 1, x0 + 1] * fx_ * fy_
    )


def sdf_estimation_sdf_mode_loss(
    inp: SdfLossInputs,
    means, scales, quats, opacities,
    depth_map, camera, rcfg,
    spatial_extent: float,
    beta_mode: str = "average",
):
    """SDF-mode estimation loss (coarse_sdf.py:577-650): |sdf(x)| should
    match the depth-based estimate |depth(pix(x)) - z(x)|, scaled by
    extent / 10 and clamped."""
    fv = fields.field_values(
        inp.samples, inp.knn_idx, means, opacities, scales, quats,
        beta_mode=beta_mode, density_factor=1.0 / inp.knn_idx.shape[1],
        density_threshold=1.0,
    )
    homog = torch.cat([inp.samples, torch.ones_like(inp.samples[:, :1])], dim=-1)
    pts_view = matvec_rows(homog, camera.world_view[:, :3])
    proj_ok = pts_view[:, 2] > 0.2
    d_map = sample_depth_at_points(depth_map, pts_view, camera, rcfg)
    sdf_est = d_map - pts_view[:, 2]
    std = spatial_extent / 10.0
    err = torch.abs(fv.sdf - torch.abs(sdf_est)) / std
    err = torch.clamp(err, 0.0, 10.0 * spatial_extent)
    w = proj_ok.to(torch.float32)
    return torch.sum(err * w) / torch.clamp(torch.sum(w), min=1.0)


def better_normal_loss(
    inp: SdfLossInputs,
    means: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
) -> torch.Tensor:
    """Align each sample's Gaussian normal with the opacity/offset-weighted
    normals of its neighbours (coarse_density.py:702-730); gradients flow
    through the normals only."""
    nb_op = fields.neighbor_opacities(
        inp.samples, inp.knn_idx, means, opacities, scales, quats
    ).detach()  # [S, K]
    normals = smallest_axis(scales, quats)
    closest_normals = normals[inp.knn_idx]  # [S, K, 3]
    sample_normals = normals[inp.gaussian_idx]  # [S, 3]
    sign = torch.sign(fused_dot3(closest_normals.detach(), sample_normals[:, None].detach()))
    closest_normals = closest_normals * sign[..., None]
    closest_min_scaling = torch.amin(scales, -1)[inp.knn_idx].detach()
    w = torch.abs(
        torch.sum(
            (inp.samples[:, None] - means[inp.knn_idx]) * closest_normals, -1
        ).detach()
    )
    w = nb_op * w / torch.clamp(closest_min_scaling, min=1e-6) ** 2
    w_sum = torch.sum(w, -1).detach()
    w = w / torch.clamp(w_sum, min=1e-6)[:, None]
    blended = torch.sum(w[..., None] * closest_normals, dim=-2)
    return torch.mean(torch.sum((sample_normals - blended) ** 2, dim=-1))
