"""Densification and pruning on the fixed-capacity arena.

Counterpart of ``frosting_tpu/train/densify.py`` (reference
gaussian_model.py:258-400, sugar_densifier.py:10-251). The arena keeps a
static capacity with a validity mask: clone and split requests are matched
to free slots by an argsort allocator, requests past the free slots are
dropped and counted, and the Adam moments of every rewritten row are zeroed
(optimizer.reset_adam_rows). Everything stays on the device: no host sync.

  * stats: accumulate ||dL/dmean2d|| over the iterations where the Gaussian
    was visible (radii > 0);
  * clone: grad >= threshold and max(scale) <= percent_dense * extent;
  * split: grad >= threshold and max(scale) > percent_dense * extent: two
    children sampled inside the Gaussian, scales / 1.6, the original gone;
  * prune: opacity < min_opacity, or screen radius / world size too large;
  * opacity reset: clamp to <= 0.01.

Randomness comes from a ``torch.Generator``; ``_densify_and_prune`` takes
the two [C, 3] standard normal draws as arguments, so a test can hand it
the JAX package's own draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from frosting_tpu_torch.ops import quat as quat_ops
from frosting_tpu_torch.scene.gaussians import GaussianParams, inverse_sigmoid
from frosting_tpu_torch.train import optimizer as opt_lib


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    grad_threshold: float = 0.0002
    percent_dense: float = 0.01
    min_opacity: float = 0.005
    split_scale_div: float = 1.6  # 0.8 * N with N = 2 children
    opacity_reset_value: float = 0.01


@dataclasses.dataclass
class DensifyState:
    grad_accum: torch.Tensor  # [C]
    denom: torch.Tensor  # [C]

    @staticmethod
    def zero(capacity: int, device="cuda") -> "DensifyState":
        return DensifyState(
            grad_accum=torch.zeros((capacity,), device=device),
            denom=torch.zeros((capacity,), device=device),
        )


def update_stats(
    state: DensifyState,
    means2d_grad: torch.Tensor,  # [C, 2] gradient of the screen-space probe
    radii: torch.Tensor,  # [C] int32
    mask: torch.Tensor,  # [C]
    image_size: tuple = (0, 0),  # (W, H); 0 = gradients already NDC-scaled
) -> DensifyState:
    """Accumulate screen-space positional gradient norms. The probe's
    gradients are in pixels, but the reference's threshold (0.0002) applies
    to the CUDA rasterizer's mean2D gradients, which carry the ndc-to-pixel
    Jacobian (0.5 W, 0.5 H): without this rescale the threshold is ~W/2
    times stricter and densification never fires."""
    visible = (radii > 0) & (mask > 0.5)
    g = means2d_grad
    w, h = image_size
    if w:
        g = g * torch.tensor([0.5 * w, 0.5 * h], dtype=g.dtype, device=g.device)
    norm = torch.linalg.vector_norm(g, dim=-1)
    return DensifyState(
        grad_accum=state.grad_accum + torch.where(visible, norm, 0.0),
        denom=state.denom + visible.to(torch.float32),
    )


class DensifyInfo(NamedTuple):
    n_cloned: torch.Tensor
    n_split: torch.Tensor
    n_pruned: torch.Tensor
    n_dropped: torch.Tensor  # requests that found no free slot


def _park_rows(p: GaussianParams, kill: torch.Tensor) -> GaussianParams:
    """Deactivate the rows flagged by kill [C] bool."""
    return dataclasses.replace(
        p,
        mask=p.mask * (~kill).to(p.mask.dtype),
        means3d=torch.where(kill[:, None], 1e6, p.means3d),
        opacities_raw=torch.where(kill, -15.0, p.opacities_raw),
    )


def _scatter_rows(dst_arr, dst, vals):
    """dst_arr with rows dst set to vals; index C (one past the end) drops
    the row, as JAX's ``.at[dst].set(mode="drop")``."""
    ext = torch.cat([dst_arr, dst_arr[:1]])
    ext[dst] = vals
    return ext[:-1]


def densify_and_prune(
    params: GaussianParams,
    opt_state: opt_lib.AdamState,
    state: DensifyState,
    generator: torch.Generator,
    spatial_extent: float,
    cfg: DensifyConfig = DensifyConfig(),
    max_screen_size: float = 0.0,
    max_radii: Optional[torch.Tensor] = None,
) -> Tuple[GaussianParams, DensifyState, DensifyInfo]:
    """Prune, clone and split. Returns (params, zeroed stats, info); the
    Adam moments of rewritten rows are zeroed in opt_state in place."""
    shape = (params.capacity, 3)
    dev = params.means3d.device
    eps1 = torch.randn(shape, generator=generator, device=dev)
    eps2 = torch.randn(shape, generator=generator, device=dev)
    return _densify_and_prune(
        params, opt_state, state, eps1, eps2, spatial_extent, cfg,
        max_screen_size, max_radii,
    )


def _densify_and_prune(
    params, opt_state, state, eps1, eps2, spatial_extent, cfg,
    max_screen_size, max_radii,
):
    """densify_and_prune with the two children's standard normal draws
    [C, 3] given."""
    c = params.capacity
    dev = params.means3d.device
    live = params.mask > 0.5
    grads = state.grad_accum / torch.clamp(state.denom, min=1.0)
    scales = torch.exp(params.scales_log)
    max_scale = scales.amax(dim=-1)
    opac = torch.sigmoid(params.opacities_raw)

    # --- prune ---
    prune = live & (opac < cfg.min_opacity)
    if max_screen_size > 0.0 and max_radii is not None:
        prune |= live & (max_radii > max_screen_size)
        prune |= live & (max_scale > 0.1 * spatial_extent)
    params = _park_rows(params, prune)
    live = params.mask > 0.5

    # --- candidates ---
    hot = live & (grads >= cfg.grad_threshold)
    small = max_scale <= cfg.percent_dense * spatial_extent
    clone = hot & small
    split = hot & ~small

    # children of splits, sampled inside the Gaussian (stds = scales,
    # rotated by R)
    rot = quat_ops.to_matrix(quat_ops.normalize(params.quats_raw))

    def sample_child(eps):
        return params.means3d + torch.einsum("nij,nj->ni", rot, eps * scales)

    child_scales_log = params.scales_log - math.log(cfg.split_scale_div)
    # child 1 overwrites the split original in place
    params = dataclasses.replace(
        params,
        means3d=torch.where(split[:, None], sample_child(eps1), params.means3d),
        scales_log=torch.where(split[:, None], child_scales_log, params.scales_log),
    )

    # --- request list: clones (verbatim copies) and split child 2 ---
    req = clone | split
    req_means = torch.where(split[:, None], sample_child(eps2), params.means3d)
    req_scales_log = torch.where(split[:, None], child_scales_log, params.scales_log)

    # allocator: the j-th request (in row order) takes the j-th free slot
    src = torch.argsort((~req).to(torch.uint8), stable=True)  # requests first
    free = ~(params.mask > 0.5)
    free_order = torch.argsort((~free).to(torch.uint8), stable=True)
    n_req = req.sum()
    n_place = torch.minimum(n_req, free.sum())
    do_place = torch.arange(c, device=dev) < n_place
    dst = torch.where(do_place, free_order, c)  # c: dropped

    def copy_rows(dst_arr, src_arr):
        return _scatter_rows(dst_arr, dst, src_arr[src])

    new_params = GaussianParams(
        means3d=copy_rows(params.means3d, req_means),
        sh_dc=copy_rows(params.sh_dc, params.sh_dc),
        sh_rest=copy_rows(params.sh_rest, params.sh_rest),
        scales_log=copy_rows(params.scales_log, req_scales_log),
        quats_raw=copy_rows(params.quats_raw, params.quats_raw),
        opacities_raw=copy_rows(params.opacities_raw, params.opacities_raw),
        mask=_scatter_rows(params.mask, dst, torch.ones_like(params.mask)),
    )

    # --- optimizer state: zero the moments of rewritten rows ---
    placed = torch.zeros((c + 1,), device=dev).index_add_(
        0, dst, do_place.to(torch.float32)
    )[:c]
    touched = torch.clamp(
        split.to(torch.float32) + placed + prune.to(torch.float32), 0.0, 1.0
    )
    opt_lib.reset_adam_rows(opt_state, {g: touched for g in opt_lib.GROUPS})

    info = DensifyInfo(
        n_cloned=clone.sum().to(torch.int32),
        n_split=split.sum().to(torch.int32),
        n_pruned=prune.sum().to(torch.int32),
        n_dropped=(n_req - n_place).to(torch.int32),
    )
    return new_params, DensifyState.zero(c, device=dev), info


def reset_opacity(
    params: GaussianParams, opt_state: opt_lib.AdamState, value: float = 0.01
) -> GaussianParams:
    """Clamp opacities to <= value and zero the opacity group's Adam
    moments (in opt_state, in place)."""
    limit = inverse_sigmoid(torch.tensor(value, dtype=torch.float32))
    params = dataclasses.replace(
        params,
        opacities_raw=torch.minimum(params.opacities_raw, limit.to(params.mask.device)),
    )
    opt_lib.reset_adam_rows(
        opt_state, {"opacities_raw": torch.ones_like(params.mask)}
    )
    return params
