"""Frosting refinement: stage 5 of the pipeline.

Counterpart of ``frosting_tpu/train/frosting_trainer.py`` (refined_training,
frosting_trainers/refine.py:21-633): optimise the bary coordinates,
scales, rotations, opacities and SH of the shell-bound Gaussians (and the
background Gaussians) against L1 + D-SSIM, with optional mesh occlusion
culling from per-camera visible-face sets (refine.py:413-455, applied every
``cull_every``-th iteration) and, under ``learn_shell``, the shell's inner
and outer offsets. No densification (refine.py docstring).

The step updates the parameters in place (JAX donates its buffers) and never
waits on the device: a loss that is not finite makes it a no-op, and only
log steps read values back. When the shell does not train, its tensors take
no gradient, and the cells' corners are computed once, without autograd;
when it does, its offsets' gradient comes through gathers whose backward
sums in a fixed order (the cell corners' and the normal consistency's), so
a step is bitwise reproducible on the card either way.
The optimizer is the port's per-group Adam with the frozen groups absent
(optax's ``set_to_zero``). Cameras are visited in the order
``np.random.default_rng(seed)`` gives, as in JAX, so both packages see the
same views.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from frosting_tpu_torch.cameras import Camera
from frosting_tpu_torch.models.frosting import (
    FrostingMeta,
    FrostingParams,
    activate_frosting,
    cell_corners,
    make_meta,
)
from frosting_tpu_torch.ops import mesh as mesh_ops
from frosting_tpu_torch.ops import mesh_raster
from frosting_tpu_torch.ops.ssim import l1_loss, psnr, ssim
from frosting_tpu_torch.raster import RasterConfig, render
from frosting_tpu_torch.raster.render import autotune_max_instances, count_instances
from frosting_tpu_torch.train.optimizer import AdamState, GSOptimizer, expon_lr
from frosting_tpu_torch.utils.profiling import PartTimes

SHELL_GROUPS = ("shell_verts", "inner_dist", "outer_dist")


@dataclasses.dataclass(frozen=True)
class FrostingTrainConfig:
    iterations: int = 15_000  # long preset; 2k short / 7k medium (train.py:140)
    lambda_dssim: float = 0.2
    sh_degree: int = 3
    learn_shell: bool = False
    # group LRs (frosting_optimizer.py:52-143 + 3DGS OptimizationParams)
    bary_lr_init: float = 5e-3
    bary_lr_final: float = 5e-5
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    lr_max_steps: int = 15_000
    eps: float = 1e-15
    white_background: bool = False
    # --regularize_shell (refine.py:144, 513-515; factor train.py:68): the
    # normal consistency of the inner and outer offset surfaces, which train
    # under learn_shell (the reference's shell_base never trains)
    regularize_shell: bool = False
    normal_consistency_factor: float = 0.1
    # occlusion culling (refine.py:136), every cull_every-th iteration
    use_occlusion_culling: bool = False
    cull_every: int = 2
    # size a smaller instance capacity for the culled iterations from the
    # measured culled instance counts (ignored when rcfg_culled is given)
    auto_culled_capacity: bool = True
    culled_capacity_safety: float = 1.4
    log_every: int = 200


def make_frosting_optimizer(cfg: FrostingTrainConfig, spatial_extent: float,
                            background: bool = False) -> GSOptimizer:
    """Per-group Adam of the refinement (frosting_optimizer.py:52-143): the
    bary logits on an exponential schedule, the shell offsets only under
    learn_shell, and with ``background`` the background Gaussians' groups
    (bg_<field>, position on the expon schedule x spatial extent). The base
    mesh and the background mask are frozen."""

    def position():
        return expon_lr(cfg.position_lr_init * spatial_extent,
                        cfg.position_lr_final * spatial_extent,
                        max_steps=cfg.lr_max_steps)

    lrs = {}
    if cfg.learn_shell:
        lrs["inner_dist"] = lrs["outer_dist"] = position()
    lrs.update({
        "bary_logits": expon_lr(cfg.bary_lr_init, cfg.bary_lr_final,
                                max_steps=cfg.lr_max_steps),
        "sh_dc": cfg.feature_lr,
        "sh_rest": cfg.feature_lr / 20.0,
        "opacities_raw": cfg.opacity_lr,
        "scales_log": cfg.scaling_lr,
        "quats_raw": cfg.rotation_lr,
    })
    if background:
        lrs.update({
            "bg_means3d": position(),
            "bg_sh_dc": cfg.feature_lr,
            "bg_sh_rest": cfg.feature_lr / 20.0,
            "bg_opacities_raw": cfg.opacity_lr,
            "bg_scales_log": cfg.scaling_lr,
            "bg_quats_raw": cfg.rotation_lr,
        })
    return GSOptimizer(lrs=lrs, eps=cfg.eps)


def param_groups(p: FrostingParams) -> Dict[str, torch.Tensor]:
    """{group: tensor}: the frosting fields, then bg_<field> for the
    background Gaussians' fields."""
    out = {f.name: getattr(p, f.name) for f in dataclasses.fields(p) if f.name != "bg"}
    if p.bg is not None:
        out.update({f"bg_{f.name}": getattr(p.bg, f.name) for f in dataclasses.fields(p.bg)})
    return out


def with_groups(p: FrostingParams, groups: Dict[str, torch.Tensor]) -> FrostingParams:
    """p with the given groups' tensors in place of its own."""
    own = {k: v for k, v in groups.items() if not k.startswith("bg_")}
    bg = {k[3:]: v for k, v in groups.items() if k.startswith("bg_")}
    return dataclasses.replace(
        p, **own, bg=dataclasses.replace(p.bg, **bg) if bg else p.bg)


def shell_normal_consistency(p: FrostingParams, meta: FrostingMeta,
                             nc_pairs: mesh_ops.PairIncidence,
                             cfg: FrostingTrainConfig) -> torch.Tensor:
    """The normal consistency of the inner and outer offset surfaces
    (verts + dist * normal); its gradient reaches the offsets, through
    gathers whose backward sums in a fixed order. ``nc_pairs``: the
    adjacent face pairs' ``mesh_ops.pair_incidence``."""
    vn = mesh_ops.vertex_normals(p.shell_verts, meta.faces, incidence=meta.incidence)
    l_out = mesh_ops.normal_consistency_loss(
        p.shell_verts + p.outer_dist[:, None] * vn, meta.faces, nc_pairs, meta.incidence)
    l_in = mesh_ops.normal_consistency_loss(
        p.shell_verts + p.inner_dist[:, None] * vn, meta.faces, nc_pairs, meta.incidence)
    return cfg.normal_consistency_factor * 0.5 * (l_out + l_in)


def photometric(image, gt_image, cfg: FrostingTrainConfig) -> torch.Tensor:
    return (1.0 - cfg.lambda_dssim) * l1_loss(image, gt_image) + (
        cfg.lambda_dssim * (1.0 - ssim(image, gt_image)))


def frozen_corners(params: FrostingParams, meta: FrostingMeta, opt: GSOptimizer):
    """The cells' corners [F, 6, 3] when no shell group trains (they are
    then the same at every step); None when one does."""
    if any(g in opt.groups for g in SHELL_GROUPS):
        return None
    with torch.no_grad():
        return cell_corners(params, meta.faces, meta.incidence)


def frozen_shell_reg(params: FrostingParams, meta: FrostingMeta,
                     nc_pairs: Optional[mesh_ops.PairIncidence], opt: GSOptimizer,
                     cfg: FrostingTrainConfig) -> Optional[torch.Tensor]:
    """The shell regulariser when no shell group trains (a constant then,
    added to every step's logged loss); None when one does or when the
    regulariser is off."""
    if not cfg.regularize_shell or nc_pairs is None or any(g in opt.groups
                                                           for g in SHELL_GROUPS):
        return None
    with torch.no_grad():
        return shell_normal_consistency(params, meta, nc_pairs, cfg)


def train_step(
    params: FrostingParams,
    opt_state: AdamState,
    meta: FrostingMeta,
    camera: Camera,
    gt_image: torch.Tensor,  # [3, H, W]
    gauss_mask: torch.Tensor,  # [N_total] 1 = render
    opt: GSOptimizer,
    rcfg: RasterConfig,
    cfg: FrostingTrainConfig,
    active_sh_degree: int,
    nc_pairs: Optional[mesh_ops.PairIncidence] = None,
    corners: Optional[torch.Tensor] = None,
    shell_reg: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """One step on one view, in place on params and opt_state. Returns the
    metrics as device tensors (loss, psnr, overflow). ``corners`` and
    ``shell_reg``: the frozen shell's cell corners (``frozen_corners``) and
    regulariser (``frozen_shell_reg``), computed here when not given."""
    dev = params.bary_logits.device
    bg = torch.full((3,), 1.0 if cfg.white_background else 0.0, device=dev)
    groups = param_groups(params)
    leaves = {g: groups[g].detach().requires_grad_(True) for g in opt.groups}
    p = with_groups(params, leaves)
    trains_shell = any(g in leaves for g in SHELL_GROUPS)
    if corners is None and not trains_shell:
        corners = frozen_corners(params, meta, opt)
    means, scales, quats, opac, sh = activate_frosting(
        p, meta, corners=None if trains_shell else corners)
    out = render(means, scales, quats, opac * gauss_mask, sh, camera, rcfg, bg=bg,
                 active_sh_degree=active_sh_degree)
    loss = photometric(out.image, gt_image, cfg)
    if cfg.regularize_shell and nc_pairs is not None:
        # in the logged loss even when the shell does not train, as in JAX
        if trains_shell:
            shell_reg = shell_normal_consistency(p, meta, nc_pairs, cfg)
        elif shell_reg is None:
            shell_reg = frozen_shell_reg(params, meta, nc_pairs, opt, cfg)
        loss = loss + shell_reg
    grads = torch.autograd.grad(loss, list(leaves.values()))
    loss = loss.detach()
    opt.step(groups, dict(zip(leaves, grads)), opt_state, torch.isfinite(loss))
    return {
        "loss": loss,
        "psnr": psnr(torch.clamp(out.image.detach(), 0.0, 1.0), gt_image),
        "overflow": out.overflow,
    }


@torch.no_grad()
def precompute_visibility(params: FrostingParams, meta: FrostingMeta,
                          cameras: List[Camera], rcfg: RasterConfig) -> torch.Tensor:
    """[n_cams, N_total] float32 per-camera Gaussian visibility from the
    shell faces each camera sees (refine.py:413-455): a frosting Gaussian
    is kept if its cell's face is seen; background Gaussians always are."""
    n_f = params.bary_logits.shape[0]
    n_bg = 0 if params.bg is None else params.bg.capacity
    dev = params.bary_logits.device
    out = torch.ones((len(cameras), n_f + n_bg), device=dev)
    for i, cam in enumerate(cameras):
        pf = mesh_raster.rasterize_mesh(params.shell_verts, meta.faces, cam.to(dev),
                                        rcfg).pix_to_face.reshape(-1)
        seen = torch.zeros((meta.faces.shape[0],), dtype=torch.bool, device=dev)
        seen[pf[pf >= 0]] = True
        out[i, :n_f] = seen[meta.cell_idx].to(torch.float32)
    return out


@torch.no_grad()
def derive_culled_config(params: FrostingParams, meta: FrostingMeta, cameras: List[Camera],
                         vis_masks: torch.Tensor, rcfg: RasterConfig, safety: float = 1.4,
                         max_probe_cameras: int = 16) -> RasterConfig:
    """A RasterConfig for the culled iterations, its capacity sized from the
    culled instance counts of up to max_probe_cameras cameras; rcfg itself
    where that is not smaller."""
    means, scales, quats, opac, sh = activate_frosting(params, meta)
    stride = max(1, len(cameras) // max_probe_cameras)
    n_max = 0
    for i in range(0, len(cameras), stride):
        n_max = max(n_max, count_instances(means, scales, quats, opac * vis_masks[i], sh,
                                           cameras[i].to(means.device), rcfg))
    cap = autotune_max_instances(n_max, rcfg.chunk, safety=safety)
    if cap >= rcfg.max_instances:
        return rcfg
    return dataclasses.replace(rcfg, max_instances=cap)


def train(
    params: FrostingParams,
    meta: FrostingMeta,
    spatial_extent: float,
    cameras: List[Camera],
    gt_images: np.ndarray,  # [n, 3, H, W]
    rcfg: RasterConfig,
    cfg: FrostingTrainConfig = FrostingTrainConfig(),
    start_iteration: int = 0,
    seed: int = 0,
    log_fn=print,
    rcfg_culled: Optional[RasterConfig] = None,
    device="cuda",
    parts: Optional[PartTimes] = None,
):
    """The refinement loop. Returns (params, the metrics of the log steps,
    the culled iterations' RasterConfig or None without culling); the
    caller's params are left as they were. Each log step records its own
    overflow flag (as JAX does) and ``overflow_steps``, the steps since the
    last log step whose instances overflowed the capacity; either is logged
    as a warning. ``rcfg_culled``: the culled iterations' RasterConfig
    (derived from the culled instance counts where not given). ``parts``
    collects the visibility precompute's and the loop's times."""
    parts = parts or PartTimes(device)
    params = with_groups(params, {k: v.detach().to(device, copy=True)
                                  for k, v in param_groups(params).items()})
    meta = make_meta(meta.faces, meta.cell_idx, meta.cell_bounds,
                     n_verts=params.shell_verts.shape[0], device=device)
    opt = make_frosting_optimizer(cfg, spatial_extent, background=params.bg is not None)
    opt_state = opt.init(param_groups(params))
    rng = np.random.default_rng(seed)
    gt_dev = torch.as_tensor(np.asarray(gt_images, np.float32), device=device)
    cameras = [c.to(device) for c in cameras]

    n_total = params.bary_logits.shape[0] + (0 if params.bg is None else params.bg.capacity)
    ones_mask = torch.ones((n_total,), device=device)
    nc_pairs = None
    if cfg.regularize_shell:
        nc_pairs = mesh_ops.pair_incidence(torch.from_numpy(mesh_ops.adjacent_face_pairs(
            meta.faces.cpu().numpy())).to(device), meta.faces.shape[0])
    vis_masks = None
    if cfg.use_occlusion_culling:
        # zero opacity for the Gaussians of unseen cells: the preprocess's
        # opacity-aware cull then emits no instance for them
        with parts.device("visibility precompute"):
            vis_masks = precompute_visibility(params, meta, cameras, rcfg)
        if rcfg_culled is None and cfg.auto_culled_capacity:
            with parts.device("culled capacity"):
                rcfg_culled = derive_culled_config(params, meta, cameras, vis_masks, rcfg,
                                                   safety=cfg.culled_capacity_safety)
            if log_fn and rcfg_culled is not rcfg:
                log_fn(f"[frosting] culled instance capacity {rcfg_culled.max_instances} "
                       f"(full {rcfg.max_instances})")
    corners = frozen_corners(params, meta, opt)
    shell_reg = frozen_shell_reg(params, meta, nc_pairs, opt, cfg)

    history: List[Dict] = []
    overflow_steps = torch.zeros((), dtype=torch.int64, device=device)
    order = rng.permutation(len(cameras))
    pos = 0
    t0, logged = time.time(), start_iteration
    last = start_iteration + cfg.iterations
    with parts.device("refine loop"):
        for it in range(start_iteration + 1, last + 1):
            if pos >= len(order):
                order = rng.permutation(len(cameras))
                pos = 0
            ci = int(order[pos])
            pos += 1
            culled = vis_masks is not None and it % cfg.cull_every == 0
            metrics = train_step(
                params, opt_state, meta, cameras[ci], gt_dev[ci],
                vis_masks[ci] if culled else ones_mask, opt,
                (rcfg_culled or rcfg) if culled else rcfg, cfg, cfg.sh_degree,
                nc_pairs, corners, shell_reg)
            overflow_steps += metrics["overflow"]
            if (it - start_iteration) % cfg.log_every == 0 or it == last:
                m = {
                    "iter": it,
                    "loss": float(metrics["loss"]),
                    "psnr": float(metrics["psnr"]),
                    "overflow": bool(metrics["overflow"]),
                    "overflow_steps": int(overflow_steps),
                    "iters_per_s": (it - logged) / max(time.time() - t0, 1e-9),
                }
                overflow_steps.zero_()
                if (m["overflow"] or m["overflow_steps"]) and log_fn:
                    # an overflow clips the render: surfaced, never ignored
                    log_fn(f"[frosting] WARNING it {it}: instance capacity overflow in "
                           f"{m['overflow_steps']} step(s) (max_instances="
                           f"{rcfg.max_instances}): rendering clipped, raise max_instances")
                t0, logged = time.time(), it
                history.append(m)
                if log_fn:
                    log_fn(f"[frosting] it {m['iter']:6d} loss {m['loss']:.4f} "
                           f"psnr {m['psnr']:.2f} ({m['iters_per_s']:.1f} it/s)")
    return params, history, None if vis_masks is None else (rcfg_culled or rcfg)
