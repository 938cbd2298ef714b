"""Top-level render: preprocess -> bin -> blend -> compose.

Counterpart of ``frosting_tpu/raster/render.py``, forward only: on the GPU
the blend is the CUDA kernel of ``blend_cuda.py``, which has no backward
yet, so a render that would need gradients there raises.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from frosting_tpu_torch.cameras import Camera
from frosting_tpu_torch.raster.binning import bin_gaussians
from frosting_tpu_torch.raster.blend_cuda import blend_forward
from frosting_tpu_torch.raster.config import RasterConfig
from frosting_tpu_torch.raster.preprocess import Projected, pack_fields, preprocess


class RenderOutput(NamedTuple):
    image: torch.Tensor  # [3, H, W] composited with background
    t_final: torch.Tensor  # [H, W] final transmittance
    radii: torch.Tensor  # [N] int32
    num_instances: torch.Tensor  # [] int64
    overflow: torch.Tensor  # [] bool


def count_instances(
    means3d, scales, quats, opacities, sh, camera, cfg: RasterConfig
) -> int:
    """Instance count of one view (preprocess + bin only), for sizing
    max_instances."""
    proj = preprocess(means3d, scales, quats, opacities, sh, camera, cfg)
    return int(bin_gaussians(proj.rect, proj.depths, proj.valid, cfg).num_instances)


def autotune_max_instances(
    n_instances: int, chunk: int, safety: float = 1.7, minimum: int = 1 << 16
) -> int:
    """max_instances from a measured per-view instance count, with a safety
    factor, rounded up to a multiple of chunk; the overflow flag still
    guards against under-sizing."""
    cap = max(minimum, int(n_instances * safety))
    return -(-cap // chunk) * chunk


def _check_no_grad(proj: Projected) -> None:
    """Every differentiable input of render reaches one of these fields."""
    fields = (proj.means2d, proj.conics, proj.colors, proj.opacities)
    if torch.is_grad_enabled() and any(t.requires_grad for t in fields):
        raise NotImplementedError(
            "render on CUDA is forward-only: the backward blend kernel "
            "(port of blend_pallas.py::blend_backward_pallas) is the next "
            "slice of the port; render under torch.no_grad() or "
            "torch.inference_mode()"
        )


def render(
    means3d: torch.Tensor,
    scales: torch.Tensor,
    quats: torch.Tensor,
    opacities: torch.Tensor,
    sh: torch.Tensor,
    camera: Camera,
    cfg: RasterConfig,
    bg: Optional[torch.Tensor] = None,
    active_sh_degree: Optional[int] = None,
    colors_precomp: Optional[torch.Tensor] = None,
    cov3d_precomp: Optional[torch.Tensor] = None,
    scale_modifier: float = 1.0,
    means2d_probe: Optional[torch.Tensor] = None,
) -> RenderOutput:
    """Gaussian-splat render of one camera, on the device of the inputs.

    `means2d_probe`: optional zeros [N, 2] added to the projected 2D means
    (the JAX reference reads screen-space gradients off it).
    """
    proj = preprocess(
        means3d, scales, quats, opacities, sh, camera, cfg,
        active_sh_degree=active_sh_degree,
        colors_precomp=colors_precomp,
        cov3d_precomp=cov3d_precomp,
        scale_modifier=scale_modifier,
    )
    if means2d_probe is not None:
        proj = proj._replace(means2d=proj.means2d + means2d_probe)
    return render_projected(proj, cfg, bg=bg)


def render_projected(
    proj: Projected, cfg: RasterConfig, bg: Optional[torch.Tensor] = None
) -> RenderOutput:
    """Blend an already-projected Gaussian set."""
    dev = proj.means2d.device
    if dev.type == "cuda":
        _check_no_grad(proj)
    bg = torch.zeros(3, device=dev) if bg is None else bg.to(dev)
    binned = bin_gaussians(proj.rect, proj.depths, proj.valid, cfg)
    out = blend_forward(pack_fields(proj), binned, cfg)
    t_final = out[3]
    image = out[:3] + t_final[None] * bg[:, None, None]
    return RenderOutput(
        image=image,
        t_final=t_final,
        radii=proj.radii,
        num_instances=binned.num_instances,
        overflow=binned.overflow,
    )
