"""Coarse SuGaR training: stage 2 of the pipeline.

Counterpart of ``frosting_tpu/train/sugar_trainer.py`` (frosting_trainers/
coarse_density.py:17-839): continue optimising a 3DGS model with (a)
photometric L1 + D-SSIM, (b) entropy regularisation of visible opacities
for ``entropy_from < it < entropy_until``, (c) past ``sdf_from``, an SDF
estimation loss and the better-normal loss over points sampled in visible
Gaussians, with KNN-16 neighbour sets refreshed every
``reset_neighbors_every`` iterations past ``regularize_from``, and (d) one
hard opacity prune (op < 0.5) at ``hard_prune_at``. Methods: "density"
(coarse_density.py), "sdf" (coarse_sdf.py: depth-anchored |sdf|) and
"dn_consistency" (density + depth-normal consistency).

The optimizer is the port's per-group Adam (train/optimizer.py), a fresh
one per stage: its counts, and so the position schedule, restart at 0 as
``tx.init`` restarts them, although the iterations start at
``start_iteration``. The step updates parameters in place and never waits
on the device; as in the GS trainer, a loss that is not finite makes it a
no-op, and only log steps read values back. The KNN is exact
(ops/knn.py); the sampling draws come from a ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from frosting_tpu_torch.cameras import Camera
from frosting_tpu_torch.models import sugar as sugar_lib
from frosting_tpu_torch.ops import knn as knn_lib
from frosting_tpu_torch.ops.ssim import l1_loss, psnr, ssim
from frosting_tpu_torch.raster import RasterConfig, render
from frosting_tpu_torch.scene.gaussians import GaussianParams, activate
from frosting_tpu_torch.train import densify as densify_lib
from frosting_tpu_torch.train import optimizer as opt_lib


@dataclasses.dataclass(frozen=True)
class SugarTrainConfig:
    iterations: int = 15_000
    start_iteration: int = 7_000  # continues from the 3DGS checkpoint
    lambda_dssim: float = 0.2
    sh_degree: int = 3
    # entropy regularisation (coarse_density.py:106-110)
    entropy_from: int = 7_000
    entropy_until: int = 9_000
    entropy_factor: float = 0.1
    # "density", "sdf" or "dn_consistency"
    method: str = "density"
    dn_consistency_factor: float = 0.05
    spatial_extent: float = 1.0  # used by the sdf-mode loss scaling
    # sdf regularisation (coarse_density.py:112-160): regularize_from opens
    # the KNN refresh window; sdf_from switches the sdf losses on
    regularize_from: int = 7_000
    sdf_from: int = 9_000
    sdf_estimation_factor: float = 0.2
    sdf_better_normal_factor: float = 0.2
    n_sdf_samples: int = 200_000
    sdf_sampling_scale_factor: float = 1.5
    beta_mode: str = "average"
    knn_k: int = 16
    reset_neighbors_every: int = 500
    # hard prune (coarse_density.py:199-202)
    hard_prune_at: int = 9_000
    hard_prune_threshold: float = 0.5
    white_background: bool = False
    log_every: int = 200


def phase_of(it: int, cfg: SugarTrainConfig) -> str:
    """"entropy" for entropy_from < it < entropy_until, "sdf" for
    it > sdf_from, "photo" otherwise."""
    if cfg.entropy_from < it < cfg.entropy_until:
        return "entropy"
    if it > cfg.sdf_from:
        return "sdf"
    return "photo"


def train_step(
    params: GaussianParams,
    opt_state: opt_lib.AdamState,
    camera: Camera,
    gt_image: torch.Tensor,  # [3, H, W]
    knn_idx: torch.Tensor,  # [C, K]
    opt: opt_lib.GSOptimizer,
    rcfg: RasterConfig,
    cfg: SugarTrainConfig,
    active_sh_degree: int,
    phase: str,  # "photo" | "entropy" | "sdf"
    generator: Optional[torch.Generator] = None,
    draws=None,  # (u [S] in [0, 1), eps [S, 3]) in place of the generator's
    mark: Optional[Callable[[str], None]] = None,
) -> Dict[str, torch.Tensor]:
    """One step on one view, in place on params and opt_state. Returns the
    metrics as device tensors (loss, psnr, overflow). ``mark(name)``, where
    given, is called as each part of the step ends (the render, the depth
    and normal renders, the sampling and field losses, the backward, Adam):
    a timer's hook."""
    mark = mark or (lambda _name: None)
    dev = params.means3d.device
    bg = torch.full((3,), 1.0 if cfg.white_background else 0.0, device=dev)
    leaves = {g: getattr(params, g).detach().requires_grad_(True) for g in opt_lib.GROUPS}
    p = dataclasses.replace(params, **leaves)
    means, scales, quats, opac, sh = activate(p)
    out = render(
        means, scales, quats, opac, sh, camera, rcfg, bg=bg,
        active_sh_degree=active_sh_degree,
    )
    loss = (1.0 - cfg.lambda_dssim) * l1_loss(out.image, gt_image) + (
        cfg.lambda_dssim * (1.0 - ssim(out.image, gt_image))
    )
    visible = (out.radii > 0) & (p.mask > 0.5)
    mark("render")

    if phase == "entropy":
        loss = loss + cfg.entropy_factor * sugar_lib.entropy_loss_from_logits(
            p.opacities_raw, visible
        )
    if phase == "sdf":
        maps = None
        if cfg.method in ("sdf", "dn_consistency"):
            maps = sugar_lib.render_depth_normal_maps(
                means, scales, quats, opac, camera, rcfg,
                normals=cfg.method == "dn_consistency",
            )
        mark("depth/normal renders")
        u, eps = draws if draws is not None else (None, None)
        inp = sugar_lib.sample_sdf_points(
            means, scales, quats, knn_idx, visible, cfg.n_sdf_samples,
            cfg.sdf_sampling_scale_factor, generator=generator, u=u, eps=eps,
        )
        if cfg.method == "sdf":
            est = sugar_lib.sdf_estimation_sdf_mode_loss(
                inp, means, scales, quats, opac, maps[0], camera, rcfg,
                cfg.spatial_extent, beta_mode=cfg.beta_mode,
            )
        else:
            est = sugar_lib.sdf_estimation_density_loss(
                inp, means, scales, quats, opac, beta_mode=cfg.beta_mode
            )
        loss = loss + cfg.sdf_estimation_factor * est
        loss = loss + cfg.sdf_better_normal_factor * sugar_lib.better_normal_loss(
            inp, means, scales, quats, opac
        )
        if cfg.method == "dn_consistency":
            loss = loss + cfg.dn_consistency_factor * sugar_lib.dn_consistency_loss(
                *maps, camera, rcfg
            )
        mark("sampling + fields")

    grads = torch.autograd.grad(loss, [leaves[g] for g in opt_lib.GROUPS])
    mark("backward")
    loss = loss.detach()
    opt.step(params, dict(zip(opt_lib.GROUPS, grads)), opt_state, torch.isfinite(loss))
    mark("Adam")
    return {
        "loss": loss,
        "psnr": psnr(torch.clamp(out.image.detach(), 0.0, 1.0), gt_image),
        "overflow": out.overflow,
    }


@torch.no_grad()
def hard_prune(params: GaussianParams, threshold: float = 0.5) -> GaussianParams:
    """Park every live Gaussian whose opacity is below the threshold."""
    kill = (torch.sigmoid(params.opacities_raw) < threshold) & (params.mask > 0.5)
    return densify_lib._park_rows(params, kill)


def compute_knn(params: GaussianParams, k: int = 16) -> torch.Tensor:
    """KNN over the live Gaussian centres; dead arena slots are never
    neighbours."""
    idx, _ = knn_lib.knn(params.means3d, k=k, valid=params.mask > 0.5)
    return idx


def train(
    params: GaussianParams,
    spatial_extent: float,
    cameras: List[Camera],
    gt_images: np.ndarray,  # [n, 3, H, W]
    rcfg: RasterConfig,
    cfg: SugarTrainConfig = SugarTrainConfig(),
    seed: int = 0,
    log_fn=print,
    device="cuda",
):
    """The coarse stage's loop from a stage-1 model. Returns (params, the
    metrics of the log steps); the caller's params are left as they were."""
    params = GaussianParams(**{
        f.name: getattr(params, f.name).detach().to(device, copy=True)
        for f in dataclasses.fields(params)
    })
    opt = opt_lib.make_gs_optimizer(spatial_extent)
    opt_state = opt.init(params)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    rng = np.random.default_rng(seed)
    gt_dev = torch.as_tensor(np.asarray(gt_images, np.float32), device=device)
    cameras = [c.to(device) for c in cameras]
    knn_idx = compute_knn(params, cfg.knn_k)
    history: List[Dict] = []

    order = rng.permutation(len(cameras))
    pos = 0
    t0 = time.time()
    for it in range(cfg.start_iteration, cfg.iterations + 1):
        if pos >= len(order):
            order = rng.permutation(len(cameras))
            pos = 0
        ci = int(order[pos])
        pos += 1

        # KNN tracking is refreshed through the whole regularised window
        # (coarse_density.py:184-189, 563-565)
        if it > cfg.regularize_from and it % cfg.reset_neighbors_every == 0:
            knn_idx = compute_knn(params, cfg.knn_k)
        if it == cfg.hard_prune_at:
            params = hard_prune(params, cfg.hard_prune_threshold)
            knn_idx = compute_knn(params, cfg.knn_k)

        phase = phase_of(it, cfg)
        metrics = train_step(
            params, opt_state, cameras[ci], gt_dev[ci], knn_idx, opt, rcfg, cfg,
            cfg.sh_degree, phase, generator=generator,
        )

        if it % cfg.log_every == 0 or it == cfg.iterations:
            m = {
                "iter": it,
                "loss": float(metrics["loss"]),
                "psnr": float(metrics["psnr"]),
                "phase": phase,
                "n_active": int(params.num_active()),
                "overflow": bool(metrics["overflow"]),
                "iters_per_s": cfg.log_every / max(time.time() - t0, 1e-9),
            }
            t0 = time.time()
            history.append(m)
            if log_fn:
                log_fn(
                    f"[sugar] it {m['iter']:6d} [{phase}] loss "
                    f"{m['loss']:.4f} psnr {m['psnr']:.2f} n {m['n_active']}"
                )
    return params, history
