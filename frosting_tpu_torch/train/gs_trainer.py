"""Vanilla 3DGS trainer: stage 1 of the Frosting pipeline.

Counterpart of ``frosting_tpu/train/gs_trainer.py`` (reference
gaussian_splatting/train.py:32-133): a train step (render -> (1 - lambda) L1
+ lambda (1 - SSIM) -> per-group Adam) and the interval machinery (SH
warm-up, densify every ``densification_interval`` in [densify_from,
densify_until), opacity reset, size pruning). One camera per step, in the
order ``np.random.default_rng(seed).permutation`` gives, as in the JAX
trainer, so both visit the same views.

The step updates the state in place and never waits on the device: a loss
that is not finite makes it a no-op on parameters and optimizer state
(decided by a device flag), and the loop reads values back only at log
steps. On the GPU the render's blend runs through the CUDA kernels
(``raster/blend_cuda.py``); on the CPU through their plain versions.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from frosting_tpu_torch.cameras import Camera
from frosting_tpu_torch.ops.ssim import l1_loss, psnr, ssim
from frosting_tpu_torch.raster import RasterConfig, render
from frosting_tpu_torch.scene.gaussians import (
    GaussianParams,
    activate,
    create_from_pcd,
    params_from_numpy,
)
from frosting_tpu_torch.train import checkpoint as ckpt_lib
from frosting_tpu_torch.train import densify as densify_lib
from frosting_tpu_torch.train import optimizer as opt_lib
from frosting_tpu_torch.utils.profiling import MetricsLogger


@dataclasses.dataclass(frozen=True)
class GSTrainConfig:
    iterations: int = 7_000
    lambda_dssim: float = 0.2
    sh_degree: int = 3
    sh_increase_interval: int = 1_000
    densify_from: int = 500
    densify_until: int = 15_000
    densification_interval: int = 100
    densify_grad_threshold: float = 0.0002
    opacity_reset_interval: int = 3_000
    size_threshold_from: int = 3_000  # prune big screen-size points after
    max_screen_size: float = 20.0
    white_background: bool = False
    capacity: int = 1 << 18
    log_every: int = 200
    # failure recovery: periodic snapshots and rollback on a non-finite loss
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 1_000
    metrics_jsonl: Optional[str] = None


@dataclasses.dataclass
class TrainState:
    params: GaussianParams
    opt_state: opt_lib.AdamState
    dstate: densify_lib.DensifyState
    max_radii: torch.Tensor  # [C] float32 running max screen radius


def init_state(
    points: np.ndarray,
    colors: np.ndarray,
    spatial_extent: float,
    cfg: GSTrainConfig,
    device="cuda",
) -> tuple[TrainState, opt_lib.GSOptimizer]:
    params = create_from_pcd(
        points, colors, cfg.capacity, sh_degree=cfg.sh_degree, device=device
    )
    opt = opt_lib.make_gs_optimizer(spatial_extent)
    return (
        TrainState(
            params=params,
            opt_state=opt.init(params),
            dstate=densify_lib.DensifyState.zero(cfg.capacity, device=device),
            max_radii=torch.zeros((cfg.capacity,), device=device),
        ),
        opt,
    )


def state_from_numpy(
    params: Mapping[str, np.ndarray],
    mu: Mapping[str, np.ndarray],
    nu: Mapping[str, np.ndarray],
    count: Mapping[str, int],
    dstate: Mapping[str, np.ndarray],
    max_radii: np.ndarray,
    device="cuda",
) -> TrainState:
    """A TrainState from numpy: params and DensifyState by field name, the
    per-group Adam moments and step counts by group name (the JAX trainer's
    state carried across mid-training)."""

    def dev(a, dtype=np.float32):
        return torch.from_numpy(np.array(a, dtype)).to(device)

    return TrainState(
        params=params_from_numpy(params, device=device),
        opt_state=opt_lib.AdamState(
            mu={g: dev(mu[g]) for g in opt_lib.GROUPS},
            nu={g: dev(nu[g]) for g in opt_lib.GROUPS},
            count={g: dev(count[g], np.int32) for g in opt_lib.GROUPS},
        ),
        dstate=densify_lib.DensifyState(
            grad_accum=dev(dstate["grad_accum"]), denom=dev(dstate["denom"])
        ),
        max_radii=dev(max_radii),
    )


def clone_state(state: TrainState) -> TrainState:
    """A copy that shares no storage with state (a rollback point)."""
    return copy.deepcopy(state)


def train_step(
    state: TrainState,
    camera: Camera,
    gt_image: torch.Tensor,  # [3, H, W]
    opt: opt_lib.GSOptimizer,
    rcfg: RasterConfig,
    cfg: GSTrainConfig,
    active_sh_degree: int,
):
    """One step on one view, in place on state. Returns (state, metrics);
    the metrics are device tensors (reading them waits for the step)."""
    p = state.params
    dev = p.means3d.device
    bg = torch.full((3,), 1.0 if cfg.white_background else 0.0, device=dev)
    leaves = {g: getattr(p, g).detach().requires_grad_(True) for g in opt_lib.GROUPS}
    probe = torch.zeros((p.capacity, 2), device=dev, requires_grad=True)
    means, scales, quats, opac, sh = activate(dataclasses.replace(p, **leaves))
    # SH warm-up: zero the coefficients above the active degree
    k_act = (active_sh_degree + 1) ** 2
    sh = sh * (torch.arange(sh.shape[1], device=dev) < k_act)[None, :, None]
    out = render(
        means, scales, quats, opac, sh, camera, rcfg, bg=bg, means2d_probe=probe
    )
    loss = (1.0 - cfg.lambda_dssim) * l1_loss(out.image, gt_image) + (
        cfg.lambda_dssim * (1.0 - ssim(out.image, gt_image))
    )
    *grads, probe_grad = torch.autograd.grad(
        loss, [leaves[g] for g in opt_lib.GROUPS] + [probe]
    )
    loss = loss.detach()
    # device-side NaN guard: a non-finite loss makes the step a no-op
    good = torch.isfinite(loss)
    opt.step(p, dict(zip(opt_lib.GROUPS, grads)), state.opt_state, good)
    state.dstate = densify_lib.update_stats(
        state.dstate, torch.where(good, probe_grad, 0.0), out.radii, p.mask,
        image_size=(rcfg.width, rcfg.height),
    )
    state.max_radii = torch.maximum(state.max_radii, out.radii.to(torch.float32))
    metrics = {
        "loss": loss,
        "psnr": psnr(torch.clamp(out.image.detach(), 0.0, 1.0), gt_image),
        "overflow": out.overflow,
        "num_instances": out.num_instances,
    }
    return state, metrics


def densify_step(
    state: TrainState,
    generator: torch.Generator,
    spatial_extent: float,
    cfg: GSTrainConfig,
    use_size_prune: bool,
):
    """Densify and prune, in place on state. Returns (state, DensifyInfo)."""
    dcfg = densify_lib.DensifyConfig(grad_threshold=cfg.densify_grad_threshold)
    state.params, state.dstate, info = densify_lib.densify_and_prune(
        state.params,
        state.opt_state,
        state.dstate,
        generator,
        spatial_extent,
        dcfg,
        max_screen_size=cfg.max_screen_size if use_size_prune else 0.0,
        max_radii=state.max_radii,
    )
    state.max_radii = torch.zeros_like(state.max_radii)
    return state, info


def train(
    cameras: List[Camera],
    gt_images: np.ndarray,  # [n, 3, H, W]
    points: np.ndarray,
    colors: np.ndarray,
    spatial_extent: float,
    rcfg: RasterConfig,
    cfg: GSTrainConfig = GSTrainConfig(),
    seed: int = 0,
    log_fn=print,
    device="cuda",
) -> tuple[TrainState, List[Dict]]:
    """The training loop. Returns the final state and the metrics of the
    log steps; a log step's ``overflow`` says whether that step's render
    overflowed ``rcfg.max_instances``, as in the JAX trainer. With
    ``log_fn``, each densify step's DensifyInfo is logged too (one read-back
    each)."""
    state, opt = init_state(points, colors, spatial_extent, cfg, device=device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    rng = np.random.default_rng(seed)
    history: List[Dict] = []
    gt_dev = torch.as_tensor(np.asarray(gt_images, np.float32), device=device)
    cameras = [c.to(device) for c in cameras]
    mlog = MetricsLogger(cfg.metrics_jsonl)
    snapshot = None  # in-memory rollback point
    if cfg.checkpoint_dir:
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)

    order = rng.permutation(len(cameras))
    pos = 0
    t0 = time.time()
    for it in range(1, cfg.iterations + 1):
        if pos >= len(order):
            order = rng.permutation(len(cameras))
            pos = 0
        ci = int(order[pos])
        pos += 1

        active_deg = min(cfg.sh_degree, (it - 1) // cfg.sh_increase_interval)
        state, metrics = train_step(
            state, cameras[ci], gt_dev[ci], opt, rcfg, cfg, active_deg
        )

        if cfg.checkpoint_every > 0 and it % cfg.checkpoint_every == 0:
            snapshot = clone_state(state)
            if cfg.checkpoint_dir:
                ckpt_lib.save_npz(
                    f"{cfg.checkpoint_dir}/gs_{it:07d}.npz", state.params
                )

        if (
            cfg.densify_from <= it < cfg.densify_until
            and it % cfg.densification_interval == 0
        ):
            state, info = densify_step(
                state, generator, spatial_extent, cfg,
                use_size_prune=it > cfg.size_threshold_from,
            )
            if log_fn:
                log_fn(f"[gs] it {it} densify " + " ".join(
                    f"{k} {int(v)}" for k, v in info._asdict().items()))

        if it % cfg.opacity_reset_interval == 0 and it < cfg.densify_until:
            state.params = densify_lib.reset_opacity(state.params, state.opt_state)

        if it % cfg.log_every == 0 or it == cfg.iterations:
            loss_val = float(metrics["loss"])
            if not np.isfinite(loss_val) and snapshot is not None:
                # the step's guard makes a bad step a no-op, so a non-finite
                # logged loss means the scene itself yields NaNs: roll back
                if log_fn:
                    log_fn(f"[gs] it {it}: non-finite loss, rolling back")
                state = clone_state(snapshot)
            m = {
                "iter": it,
                "loss": loss_val,
                "psnr": float(metrics["psnr"]),
                "n_active": int(state.params.num_active()),
                "overflow": bool(metrics["overflow"]),
                "iters_per_s": cfg.log_every / max(time.time() - t0, 1e-9),
            }
            t0 = time.time()
            history.append(m)
            mlog.log(it, **{k: v for k, v in m.items() if k != "iter"})
            if log_fn:
                log_fn(
                    f"[gs] it {m['iter']:6d} loss {m['loss']:.4f} "
                    f"psnr {m['psnr']:.2f} n {m['n_active']} "
                    f"({m['iters_per_s']:.1f} it/s)"
                )
    mlog.close()
    if cfg.checkpoint_dir:
        ckpt_lib.save_npz(f"{cfg.checkpoint_dir}/gs_final.npz", state.params)
    return state, history


def evaluate(
    state: TrainState,
    cameras: List[Camera],
    gt_images: np.ndarray,
    rcfg: RasterConfig,
    cfg: GSTrainConfig,
) -> Dict[str, float]:
    """Mean PSNR and SSIM of the renders at full SH degree against
    gt_images."""
    dev = state.params.means3d.device
    bg = torch.full((3,), 1.0 if cfg.white_background else 0.0, device=dev)
    psnrs, ssims = [], []
    with torch.inference_mode():
        model = activate(state.params)
        for cam, gt in zip(cameras, gt_images):
            img = render(
                *model, cam.to(dev), rcfg, bg=bg, active_sh_degree=cfg.sh_degree
            ).image
            img = torch.clamp(img, 0.0, 1.0)
            gt = torch.as_tensor(np.asarray(gt, np.float32), device=dev)
            psnrs.append(float(psnr(img, gt)))
            ssims.append(float(ssim(img, gt)))
    return {"psnr": float(np.mean(psnrs)), "ssim": float(np.mean(ssims))}
