"""Top-level differentiable render: preprocess -> bin -> blend -> compose.

Counterpart of ``frosting_tpu/raster/render.py``. The autograd boundary
(``BlendFunction``) wraps only binning and the blend, as JAX's custom VJP
``_blend`` does: its backward runs the backward blend (the CUDA kernel
``csrc/blend_backward.cu`` on the GPU, the plain version on the CPU) and
sums the per-instance gradient rows into per-Gaussian rows in a fixed
order (``sum_rows_by_gaussian``: a stable sort of the instances by Gaussian
id, then one sequential sum per Gaussian in sorted order; JAX's payload
sorts and prefix differences, ``render.py:117-201``, exist for the TPU). No
step of the backward uses atomics on floats, so render gradients are
bitwise reproducible from run to run on the card, as they are in JAX.
Gradients through preprocess come from autograd.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from frosting_tpu_torch.cameras import Camera
from frosting_tpu_torch.ops import segment
from frosting_tpu_torch.raster.binning import Binned, bin_gaussians
from frosting_tpu_torch.raster.blend_cuda import blend_backward, blend_forward
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


def sum_rows_by_gaussian(
    rows: torch.Tensor,  # [M, W] per-instance rows
    inst_gauss: torch.Tensor,  # [M] int32 Gaussian id of each row
    n_rows: int,  # rows of the result (Gaussians + the sentinel)
) -> torch.Tensor:
    """[n_rows, W]: the sum of each Gaussian's instance rows, taken in a
    fixed order: the rows are ordered by Gaussian id with a stable sort,
    and each Gaussian's run is summed sequentially in that order
    (``segment_reduce`` over offsets found by ``searchsorted``, which needs
    no host sync). ``index_add_`` would sum with atomics on the GPU, whose
    order, and so the last bits of the result, change from run to run."""
    return segment.sum_by_index(rows, inst_gauss, n_rows)


class BlendFunction(torch.autograd.Function):
    """fields [N + 1, 9] (pack_fields) -> (out [4, H, W], num_instances,
    overflow), differentiable in fields. rect, depths and valid come in
    detached: binning is piecewise constant in them. ``forward_fn`` and
    ``backward_fn`` are the blend pair: the device-dispatching wrappers of
    blend_cuda.py on the render path; the plain versions where a check holds
    the kernels against them on the card."""

    @staticmethod
    def forward(ctx, fields, rect, depths, valid, cfg, forward_fn, backward_fn):
        binned = bin_gaussians(rect, depths, valid, cfg)
        out = forward_fn(fields, binned, cfg)
        ctx.save_for_backward(fields, out, binned.inst_gauss, binned.tile_ranges)
        ctx.cfg, ctx.backward_fn = cfg, backward_fn
        ctx.mark_non_differentiable(binned.num_instances, binned.overflow)
        return out, binned.num_instances, binned.overflow

    @staticmethod
    def backward(ctx, g_out, _g_num, _g_overflow):
        fields, out, inst_gauss, tile_ranges = ctx.saved_tensors
        binned = Binned(inst_gauss, tile_ranges, None, None)
        rows = ctx.backward_fn(fields, binned, ctx.cfg, out, g_out.contiguous())
        # the sentinel row (last) is no instance's Gaussian: it stays zero
        dfields = sum_rows_by_gaussian(rows, inst_gauss, fields.shape[0])
        return dfields, None, None, None, None, None, None


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
    pixel_offset=(0, 0),
) -> RenderOutput:
    """Gaussian-splat render of one camera, on the device of the inputs.

    `means2d_probe`: optional zeros [N, 2] added to the projected 2D means;
    its gradient is the screen-space positional gradient that densification
    reads. `pixel_offset` (ox, oy): render the sub-rectangle of the
    projection's full image (cfg.proj_width x cfg.proj_height) whose top-left
    pixel is (ox, oy), cfg.width x cfg.height in size.
    """
    proj = preprocess(
        means3d, scales, quats, opacities, sh, camera, cfg,
        active_sh_degree=active_sh_degree,
        colors_precomp=colors_precomp,
        cov3d_precomp=cov3d_precomp,
        scale_modifier=scale_modifier,
        pixel_offset=pixel_offset,
    )
    if means2d_probe is not None:
        proj = proj._replace(means2d=proj.means2d + means2d_probe)
    return render_projected(proj, cfg, bg=bg)


def render_projected(
    proj: Projected,
    cfg: RasterConfig,
    bg: Optional[torch.Tensor] = None,
    mark: Optional[Callable[[str], None]] = None,
) -> RenderOutput:
    """Blend an already-projected Gaussian set. ``mark(name)``, where given,
    is called as the binning and the forward blend end (a timer's hook)."""
    dev = proj.means2d.device
    bg = torch.zeros(3, device=dev) if bg is None else bg.to(dev)
    forward_fn = blend_forward
    if mark is not None:
        def forward_fn(fields, binned, cfg):
            mark("binning")
            out = blend_forward(fields, binned, cfg)
            mark("B1")
            return out
    out, num_instances, overflow = BlendFunction.apply(
        pack_fields(proj), proj.rect.detach(), proj.depths.detach(),
        proj.valid.detach(), cfg, forward_fn, blend_backward,
    )
    t_final = out[3]
    image = out[:3] + t_final[None] * bg[:, None, None]
    return RenderOutput(
        image=image,
        t_final=t_final,
        radii=proj.radii,
        num_instances=num_instances,
        overflow=overflow,
    )
