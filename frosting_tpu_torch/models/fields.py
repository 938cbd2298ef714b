"""Gaussian density / SDF field evaluation (the SuGaR field machinery).

Counterpart of ``frosting_tpu/models/fields.py`` (SuGaR.get_field_values /
get_beta, frosting_scene/sugar_model.py:1203-1347): the density at x is the
sum of the K tracked neighbour Gaussians' un-normalised opacities
  d(x) = sum_j s_j exp(-1/2 || diag(1/sc_j) R_j^T (x - mu_j) ||^2),
and the SDF is the beta-scaled log transform
  sdf(x) = beta(x) (sqrt(-2 log d(x)) - sqrt(-2 log level)).
Batched gather-and-reduce over [M, K] neighbour sets, in plain PyTorch;
``field_values_blocked`` bounds the working set, and ``density_and_grad``
gives shell extraction the density with its gradient in closed form.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from frosting_tpu_torch.ops import quat as quat_ops


class FieldValues(NamedTuple):
    density: torch.Tensor  # [M] raw density (pre-normalisation)
    density_norm: torch.Tensor  # [M] clamp-normalised (<= ~1)
    neighbor_opacities: torch.Tensor  # [M, K]
    beta: torch.Tensor  # [M]
    sdf: torch.Tensor  # [M]


def _warp(x, knn_idx, centers, scales, quats):
    """Per-neighbour [M, K] terms of the Gaussian exponent: (w, u) with
    w_a = (R^T (x - mu))_a / s_a, the warped offset, and u_a = R[:, a] / s_a
    (three [M, K] components each), so that the exponent's derivative is
    d(||w||^2)/dx = 2 sum_a w_a u_a."""

    def g(t):  # [N] -> [M, K]
        return t[knn_idx]

    sh0 = x[:, 0:1] - g(centers[:, 0])
    sh1 = x[:, 1:2] - g(centers[:, 1])
    sh2 = x[:, 2:3] - g(centers[:, 2])
    w, qx, qy, qz = (g(quats[:, i]) for i in range(4))
    # columns of R (= rows of R^T), forward.cu:133-138 convention
    r00 = 1.0 - 2.0 * (qy * qy + qz * qz)
    r01 = 2.0 * (qx * qy - w * qz)
    r02 = 2.0 * (qx * qz + w * qy)
    r10 = 2.0 * (qx * qy + w * qz)
    r11 = 1.0 - 2.0 * (qx * qx + qz * qz)
    r12 = 2.0 * (qy * qz - w * qx)
    r20 = 2.0 * (qx * qz - w * qy)
    r21 = 2.0 * (qy * qz + w * qx)
    r22 = 1.0 - 2.0 * (qx * qx + qy * qy)
    inv0 = 1.0 / torch.clamp(g(scales[:, 0]), min=1e-12)
    inv1 = 1.0 / torch.clamp(g(scales[:, 1]), min=1e-12)
    inv2 = 1.0 / torch.clamp(g(scales[:, 2]), min=1e-12)
    # warped_a = (R^T shift)_a / s_a = (R[., a] . shift) / s_a
    w0 = (r00 * sh0 + r10 * sh1 + r20 * sh2) * inv0
    w1 = (r01 * sh0 + r11 * sh1 + r21 * sh2) * inv1
    w2 = (r02 * sh0 + r12 * sh1 + r22 * sh2) * inv2
    u = ((r00 * inv0, r10 * inv0, r20 * inv0),
         (r01 * inv1, r11 * inv1, r21 * inv1),
         (r02 * inv2, r12 * inv2, r22 * inv2))
    return (w0, w1, w2), u


def neighbor_opacities(
    x: torch.Tensor,  # [M, 3]
    knn_idx: torch.Tensor,  # [M, K]
    centers: torch.Tensor,  # [N, 3]
    strengths: torch.Tensor,  # [N]
    scales: torch.Tensor,  # [N, 3] activated
    quats: torch.Tensor,  # [N, 4] unit
    density_factor: float = 1.0,
) -> torch.Tensor:
    """[M, K] per-neighbour un-normalised opacity contributions
    (sugar_model.py:1305-1309), in the JAX version's component order."""
    (w0, w1, w2), _u = _warp(x, knn_idx, centers, scales, quats)
    maha = torch.clamp(w0 * w0 + w1 * w1 + w2 * w2, 0.0, 1e8)
    return density_factor * strengths[knn_idx] * torch.exp(-0.5 * maha)


def density_and_grad(
    x: torch.Tensor,  # [M, 3]
    knn_idx: torch.Tensor,  # [M, K]
    centers: torch.Tensor,
    strengths: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    neighbor_valid: Optional[torch.Tensor] = None,  # [M, K] bool
):
    """(density [M], d density / dx [M, 3]) with density_factor 1: what the
    JAX extraction takes with ``jax.value_and_grad`` of
    ``field_values(...).density`` (shell.py:159-185, 235-254), in closed
    form: d/dx s exp(-||w||^2 / 2) = -s exp(-||w||^2 / 2) sum_a w_a u_a
    (``_warp``), zero where the clamp of ||w||^2 at 1e8 holds. The density
    is field_values' bitwise. Neighbours flagged False in
    ``neighbor_valid`` (a radius-bounded KNN's filler) contribute 0."""
    (w0, w1, w2), u = _warp(x, knn_idx, centers, scales, quats)
    raw = w0 * w0 + w1 * w1 + w2 * w2
    nb = strengths[knn_idx] * torch.exp(-0.5 * torch.clamp(raw, 0.0, 1e8))
    if neighbor_valid is not None:
        nb = torch.where(neighbor_valid, nb, 0.0)
    coef = torch.where(raw <= 1e8, nb, 0.0)
    grad = torch.stack([
        -torch.sum(coef * (w0 * u[0][c] + w1 * u[1][c] + w2 * u[2][c]), dim=-1)
        for c in range(3)
    ], dim=-1)
    return torch.sum(nb, dim=-1), grad


def field_values(
    x: torch.Tensor,
    knn_idx: torch.Tensor,
    centers: torch.Tensor,
    strengths: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    beta_mode: str = "weighted_average",
    log_beta: Optional[torch.Tensor] = None,
    density_threshold: float = 1.0,
    density_factor: float = 1.0,
    opacity_min_clamp: float = 1e-16,
) -> FieldValues:
    nb = neighbor_opacities(
        x, knn_idx, centers, strengths, scales, quats, density_factor
    )
    density = torch.sum(nb, dim=-1)
    # soft clamp at 1: d >= 1 -> d / stop_grad(d) (sugar_model.py:1311-1312)
    density_norm = torch.where(
        density >= 1.0, density / (density.detach() + 1e-12), density
    )

    min_scaling = torch.amin(scales, dim=-1)[knn_idx]  # [M, K]
    if beta_mode == "learnable":
        if log_beta is None:
            raise ValueError("log_beta required for learnable beta")
        beta = torch.exp(log_beta) * torch.ones(x.shape[0], dtype=x.dtype, device=x.device)
    elif beta_mode == "average":
        beta = torch.mean(min_scaling, dim=-1)
    elif beta_mode == "weighted_average":
        # (sugar_model.py get_beta, "Method 3": zero-opacity points get the
        # scene's largest min-scale so their sdf stays nonzero)
        op_sum = torch.sum(nb, dim=-1, keepdim=True)
        weights = nb / torch.clamp(op_sum, min=opacity_min_clamp)
        beta = torch.sum(min_scaling * weights, dim=-1)
        fallback = torch.amax(torch.amin(scales, dim=-1)).detach()
        beta = torch.where(op_sum[..., 0] == 0.0, fallback, beta)
    else:
        raise ValueError(f"unknown beta_mode {beta_mode}")

    clamped = torch.clamp(density_norm, min=opacity_min_clamp)
    level = torch.tensor(min(density_threshold, 1.0), device=x.device)
    level_term = torch.sqrt(-2.0 * torch.log(level))
    sdf = beta * (torch.sqrt(-2.0 * torch.log(clamped)) - level_term)
    return FieldValues(
        density=density,
        density_norm=density_norm,
        neighbor_opacities=nb,
        beta=beta,
        sdf=sdf,
    )


def field_values_blocked(
    x: torch.Tensor,
    knn_idx: torch.Tensor,
    centers: torch.Tensor,
    strengths: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    block: int = 1 << 19,
    **kw,
) -> FieldValues:
    """field_values over blocks of `block` query points, concatenated:
    bounds the [block, K] intermediates at multi-million-point budgets
    (``frosting_tpu/models/fields.py:136``; no jit cache is needed here)."""
    m = x.shape[0]
    if m <= block:
        return field_values(x, knn_idx, centers, strengths, scales, quats, **kw)
    outs = [
        field_values(x[i:i + block], knn_idx[i:i + block], centers, strengths,
                     scales, quats, **kw)
        for i in range(0, m, block)
    ]
    return FieldValues(*(torch.cat(t) for t in zip(*outs)))


def sample_points_in_gaussians(
    n_samples: int,
    centers: torch.Tensor,  # [N, 3]
    scales: torch.Tensor,  # [N, 3]
    quats: torch.Tensor,  # [N, 4]
    weights: torch.Tensor,  # [N] sampling probabilities (e.g. volumes)
    scale_factor: float = 1.0,
    mask: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
    eps: Optional[torch.Tensor] = None,
):
    """Sample points inside Gaussians, choosing Gaussians ~ weights
    (sugar_model.py:916-959) by inverse-CDF sampling. Returns (points
    [S, 3], gaussian_idx [S]).

    The draws: ``u`` [S], uniform in [0, 1), scaled here by cdf[-1] (the
    normalised cumulative weight's end, as ``jax.random.uniform(maxval=
    cdf[-1])`` scales its draw), and ``eps`` [S, 3], standard normal; each
    comes from ``generator`` when it is not given (a test passes the JAX
    package's own draws)."""
    if mask is not None:
        weights = weights * mask
    dev = centers.device
    p = weights / torch.clamp(torch.sum(weights), min=1e-12)
    cdf = torch.cumsum(p, dim=0)
    if u is None:
        u = torch.rand((n_samples,), generator=generator, device=dev)
    u = u * cdf[-1]
    if eps is None:
        eps = torch.randn((n_samples, 3), generator=generator, device=dev)
    idx = torch.clamp(
        torch.searchsorted(cdf, u, right=True), 0, centers.shape[0] - 1
    )
    eps = eps * scales[idx] * scale_factor
    offs = torch.einsum("sij,sj->si", quat_ops.to_matrix(quats[idx]), eps)
    return centers[idx] + offs, idx
