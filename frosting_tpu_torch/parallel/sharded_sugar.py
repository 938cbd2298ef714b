"""Sharded coarse-SuGaR training step (stage 2): the data x tile design of
sharded_train.py plus the surface regularisers.

Counterpart of ``frosting_tpu/parallel/sharded_sugar.py``:

  * photometric and entropy: the strip render with the exact halo SSIM, as
    in the 3DGS step; the entropy is a mean over the replicated cloud, so
    each rank adds 1/n_ranks of it;
  * density-mode SDF estimation and better-normal losses: the SAMPLE axis
    is sharded, each rank drawing max(256, n_sdf_samples // n_ranks) points
    of its own and evaluating the KNN field on the replicated cloud; the
    sum over the ranks of their 1/n_ranks shares is a step with the whole
    sample budget, up to the draws;
  * depth-anchored "sdf" mode: each rank renders its DEPTH STRIP from the
    shifted projection with each Gaussian's view depth as its colour; the
    strips are all-gathered over the tile axis into the full depth map,
    whose gather scatters the samples' gradients back to the owning strip.

The parameters stay replicated (no ``shard_params``): the KNN field gathers
arbitrary neighbours of the whole cloud every step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from frosting_tpu_torch.cameras import Camera
from frosting_tpu_torch.models import sugar as sugar_lib
from frosting_tpu_torch.parallel import collectives
from frosting_tpu_torch.parallel.collectives import WORLD, Mesh
from frosting_tpu_torch.parallel.sharded_train import (
    Mark,
    psum_flat,
    route_projected,
    step_stats,
    strip_config,
    strip_loss,
)
from frosting_tpu_torch.raster import RasterConfig
from frosting_tpu_torch.raster.preprocess import Projected, preprocess
from frosting_tpu_torch.raster.render import render_projected
from frosting_tpu_torch.scene.gaussians import GaussianParams, activate
from frosting_tpu_torch.train import optimizer as opt_lib
from frosting_tpu_torch.train.sugar_trainer import SugarTrainConfig

PHASES = ("photo", "entropy", "sdf")


def samples_per_rank(cfg: SugarTrainConfig, mesh: Mesh) -> int:
    return max(256, cfg.n_sdf_samples // mesh.size)


def sample_seed(seed: int, mesh: Mesh) -> int:
    """The seed of this rank's SDF draws: (seed, d * n_tile + t), the
    counterpart of ``jax.random.fold_in(key, data_idx * n_tile + tile_idx)``."""
    index = mesh.data_index * mesh.shape["tile"] + mesh.tile_index
    return int(np.random.SeedSequence([seed, index]).generate_state(1)[0])


def depth_strip(proj: Projected, s_cfg: RasterConfig, mark: Mark = None) -> torch.Tensor:
    """[strip_h, W]: the alpha-weighted view depth of a (shifted) projection,
    the single-device depth render's rows (``sugar.render_depth_normal_maps``)."""
    dproj = proj._replace(colors=torch.stack([proj.depths] * 3, dim=-1))
    dout = render_projected(dproj, s_cfg, bg=torch.zeros(3, device=proj.depths.device),
                            mark=mark)
    acc = 1.0 - dout.t_final
    return dout.image[0] / torch.clamp(acc, min=1e-6)


def make_sharded_sugar_step(
    opt: opt_lib.GSOptimizer,
    rcfg: RasterConfig,
    cfg: SugarTrainConfig,
    mesh: Mesh,
    phase: str,  # "photo" | "entropy" | "sdf" (the regularisers of cfg.method)
):
    """Returns step(params, opt_state, camera, gt_strip, knn_idx, seed=0,
    draws=None, mark=None) -> metrics, run by every rank on its camera and
    GT strip, in place on the replicated params and opt_state. In the sdf
    phase each rank draws from a generator seeded by (seed, its index),
    or takes its draws: (u [S] in [0, 1), eps [S, 3]) for S =
    ``samples_per_rank``. The metrics: the summed loss, and the maximum
    over the mesh of the instances, the overflow flag and the strip PSNR."""
    if phase not in PHASES:
        raise ValueError(f"phase must be one of {PHASES}")
    if cfg.method not in ("density", "sdf"):
        raise ValueError(f"the sharded step has no method {cfg.method!r}")
    n_tile = mesh.shape["tile"]
    s_cfg = strip_config(rcfg, n_tile)
    strip_h = s_cfg.height
    bg_value = 1.0 if cfg.white_background else 0.0
    n_dev = mesh.size
    n_samples = samples_per_rank(cfg, mesh)

    def step(params: GaussianParams, opt_state, camera: Camera, gt_strip: torch.Tensor,
             knn_idx: torch.Tensor, seed: int = 0, draws=None, mark: Mark = None):
        mark = mark or (lambda _name: None)
        dev = params.means3d.device
        t = mesh.tile_index
        bg = torch.full((3,), bg_value, device=dev)
        leaves = {g: getattr(params, g).detach().requires_grad_(True) for g in opt_lib.GROUPS}
        p = dataclasses.replace(params, **leaves)
        means, scales, quats, opac, sh = activate(p)
        shard = means.shape[0] // n_tile
        sl = slice(t * shard, (t + 1) * shard)
        proj_local = preprocess(means[sl], scales[sl], quats[sl], opac[sl], sh[sl], camera,
                                rcfg, active_sh_degree=cfg.sh_degree)
        mark("activation + preprocess")
        proj, _ = route_projected(proj_local, mesh, rcfg, strip_h, False, 0, t * strip_h, s_cfg)
        mark("collectives")
        out = render_projected(proj, s_cfg, bg=bg, mark=mark)
        loss = strip_loss(out.image, gt_strip, mesh, cfg.lambda_dssim)
        live = (proj.radii > 0) & (p.mask > 0.5)
        if phase == "entropy":
            loss = loss + cfg.entropy_factor * sugar_lib.entropy_loss_from_logits(
                p.opacities_raw, live) / n_dev
        if phase == "sdf":
            u, eps = draws if draws is not None else (None, None)
            gen = None
            if draws is None:
                gen = torch.Generator(device=dev)
                gen.manual_seed(sample_seed(seed, mesh))
            inp = sugar_lib.sample_sdf_points(
                means, scales, quats, knn_idx, live, n_samples,
                cfg.sdf_sampling_scale_factor, generator=gen, u=u, eps=eps)
            if cfg.method == "sdf":
                depth_full = collectives.all_gather(depth_strip(proj, s_cfg), mesh, "tile")
                sdf_l = sugar_lib.sdf_estimation_sdf_mode_loss(
                    inp, means, scales, quats, opac, depth_full, camera, rcfg,
                    cfg.spatial_extent, beta_mode=cfg.beta_mode)
            else:
                sdf_l = sugar_lib.sdf_estimation_density_loss(
                    inp, means, scales, quats, opac, beta_mode=cfg.beta_mode)
            bn_l = sugar_lib.better_normal_loss(inp, means, scales, quats, opac)
            loss = loss + (cfg.sdf_estimation_factor * sdf_l
                           + cfg.sdf_better_normal_factor * bn_l) / n_dev
        mark("losses")
        grads = torch.autograd.grad(loss, [leaves[g] for g in opt_lib.GROUPS])
        mark("backward (B2)")
        grads = psum_flat(list(grads), mesh)
        loss = collectives.psum(loss.detach(), mesh, WORLD)
        stats = step_stats(out, gt_strip, mesh)
        mark("all-reduce")
        opt.step(params, dict(zip(opt_lib.GROUPS, grads)), opt_state, torch.isfinite(loss))
        mark("Adam")
        return {"loss": loss, "num_instances": stats[0], "overflow": stats[1],
                "psnr_strip": stats[2]}

    return step


@torch.no_grad()
def render_depth_strips(model, camera: Camera, rcfg: RasterConfig, mesh: Mesh,
                        mark: Mark = None) -> torch.Tensor:
    """The sdf mode's depth map of an activated model (means, scales, quats,
    opacities, sh) as the sharded step makes it: each rank projects its
    slice, the tile axis gathers the projection, each rank renders its depth
    strip, and the strips are gathered into [H, W]."""
    n_tile = mesh.shape["tile"]
    s_cfg = strip_config(rcfg, n_tile)
    t = mesh.tile_index
    means = model[0]
    shard = means.shape[0] // n_tile
    sl = slice(t * shard, (t + 1) * shard)
    mark = mark or (lambda _name: None)
    proj_local = preprocess(*(x[sl] for x in model), camera, rcfg)
    mark("preprocess")
    proj, _ = route_projected(proj_local, mesh, rcfg, s_cfg.height, False, 0,
                              t * s_cfg.height, s_cfg)
    mark("collectives")
    strip = depth_strip(proj, s_cfg, mark)
    return collectives.all_gather(strip, mesh, "tile")
