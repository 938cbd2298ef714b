"""Refined (mesh-bound) SuGaR training.

Counterpart of ``frosting_tpu/train/refined_sugar.py`` (the reference's
refined-SuGaR stage, sugar_trainers/refine.py; the binding of
sugar_model.py:186-360): flat Gaussians pinned to the extracted mesh at
fixed barycentric patterns, optimising their in-plane scales, 2D rotations,
opacities, SH and, under ``learn_verts``, the mesh vertices, against
L1 + D-SSIM. Each step renders once through the blend kernels (B1 forward,
B2 backward).

The step updates the parameters in place and never waits on the device, as
the Frosting trainer's does. The optimizer is the port's per-group Adam;
the vertices have no group unless they learn (optax's ``set_to_zero`` in
JAX), and then take no gradient at all. Learned vertices get their gradient
through ``mesh_ops.face_corners``, a fixed-order sum. Cameras are visited
in the order ``np.random.default_rng(seed)`` gives, as in JAX.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from frosting_tpu_torch.cameras import Camera
from frosting_tpu_torch.models.mesh_bound import (
    MeshBoundMeta,
    MeshBoundParams,
    activate_mesh_bound,
)
from frosting_tpu_torch.ops.ssim import l1_loss, psnr, ssim
from frosting_tpu_torch.raster import RasterConfig, render
from frosting_tpu_torch.train.optimizer import AdamState, GSOptimizer, expon_lr
from frosting_tpu_torch.utils.profiling import PartTimes


@dataclasses.dataclass(frozen=True)
class MeshBoundTrainConfig:
    iterations: int = 2_000
    lambda_dssim: float = 0.2
    sh_degree: int = 3
    learn_verts: bool = False
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    lr_max_steps: int = 2_000
    eps: float = 1e-15
    white_background: bool = False
    log_every: int = 200


def make_mesh_bound_optimizer(cfg: MeshBoundTrainConfig, spatial_extent: float) -> GSOptimizer:
    """Per-group Adam: the vertices on the position schedule x spatial
    extent under learn_verts (frozen otherwise), sh_rest at feature_lr / 20."""
    lrs = {}
    if cfg.learn_verts:
        lrs["verts"] = expon_lr(cfg.position_lr_init * spatial_extent,
                                cfg.position_lr_final * spatial_extent,
                                max_steps=cfg.lr_max_steps)
    lrs.update({
        "plane_scales_log": cfg.scaling_lr,
        "complex_rot": cfg.rotation_lr,
        "opacities_raw": cfg.opacity_lr,
        "sh_dc": cfg.feature_lr,
        "sh_rest": cfg.feature_lr / 20.0,
    })
    return GSOptimizer(lrs=lrs, eps=cfg.eps)


def param_groups(p: MeshBoundParams) -> Dict[str, torch.Tensor]:
    return {f.name: getattr(p, f.name) for f in dataclasses.fields(p)}


def photometric(image, gt_image, cfg: MeshBoundTrainConfig) -> torch.Tensor:
    return (1.0 - cfg.lambda_dssim) * l1_loss(image, gt_image) + (
        cfg.lambda_dssim * (1.0 - ssim(image, gt_image)))


def train_step(
    params: MeshBoundParams,
    opt_state: AdamState,
    meta: MeshBoundMeta,
    camera: Camera,
    gt_image: torch.Tensor,  # [3, H, W]
    opt: GSOptimizer,
    rcfg: RasterConfig,
    cfg: MeshBoundTrainConfig,
) -> Dict[str, torch.Tensor]:
    """One step on one view, in place on params and opt_state. Returns the
    metrics as device tensors (loss, psnr, overflow)."""
    dev = params.verts.device
    bg = torch.full((3,), 1.0 if cfg.white_background else 0.0, device=dev)
    groups = param_groups(params)
    leaves = {g: groups[g].detach().requires_grad_(True) for g in opt.groups}
    p = dataclasses.replace(params, **leaves)
    means, scales, quats, opac, sh = activate_mesh_bound(p, meta)
    out = render(means, scales, quats, opac, sh, camera, rcfg, bg=bg,
                 active_sh_degree=cfg.sh_degree)
    loss = photometric(out.image, gt_image, cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    loss = loss.detach()
    opt.step(groups, dict(zip(leaves, grads)), opt_state, torch.isfinite(loss))
    return {
        "loss": loss,
        "psnr": psnr(torch.clamp(out.image.detach(), 0.0, 1.0), gt_image),
        "overflow": out.overflow,
    }


def train(
    params: MeshBoundParams,
    meta: MeshBoundMeta,
    spatial_extent: float,
    cameras: List[Camera],
    gt_images: np.ndarray,  # [n, 3, H, W]
    rcfg: RasterConfig,
    cfg: MeshBoundTrainConfig = MeshBoundTrainConfig(),
    seed: int = 0,
    log_fn=print,
    device="cuda",
    parts: Optional[PartTimes] = None,
):
    """The refinement loop. Returns (params, the metrics of the log steps);
    the caller's params are left as they were. Each log step records its
    own overflow flag and ``overflow_steps``, the steps since the last log
    step whose instances overflowed the capacity. ``parts`` collects the
    loop's time."""
    parts = parts or PartTimes(device)
    params = MeshBoundParams(**{k: v.detach().to(device, copy=True)
                                for k, v in param_groups(params).items()})
    opt = make_mesh_bound_optimizer(cfg, spatial_extent)
    opt_state = opt.init(param_groups(params))
    rng = np.random.default_rng(seed)
    gt_dev = torch.as_tensor(np.asarray(gt_images, np.float32), device=device)
    cameras = [c.to(device) for c in cameras]
    history: List[Dict] = []
    overflow_steps = torch.zeros((), dtype=torch.int64, device=device)
    order = rng.permutation(len(cameras))
    pos = 0
    t0, logged = time.time(), 0
    with parts.device("refine loop"):
        for it in range(1, cfg.iterations + 1):
            if pos >= len(order):
                order = rng.permutation(len(cameras))
                pos = 0
            ci = int(order[pos])
            pos += 1
            metrics = train_step(params, opt_state, meta, cameras[ci], gt_dev[ci], opt, rcfg,
                                 cfg)
            overflow_steps += metrics["overflow"]
            if it % cfg.log_every == 0 or it == cfg.iterations:
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
                    log_fn(f"[refined-sugar] WARNING it {it}: instance capacity overflow in "
                           f"{m['overflow_steps']} step(s) (max_instances="
                           f"{rcfg.max_instances}): rendering clipped, raise max_instances")
                t0, logged = time.time(), it
                history.append(m)
                if log_fn:
                    log_fn(f"[refined-sugar] it {m['iter']:6d} loss {m['loss']:.4f} "
                           f"psnr {m['psnr']:.2f} ({m['iters_per_s']:.1f} it/s)")
    return params, history
