"""Sharded 3DGS training step: data (cameras) x tile (image strips), with
the per-Gaussian preprocess sharded over the tile ranks.

Counterpart of ``frosting_tpu/parallel/sharded_train.py``. Each rank runs
the step in its own process on its own camera (its data index) and strip
(its tile index):

  * data: each data row trains on another camera; the gradients are summed
    over the whole mesh (the batch mean of the cameras' losses);
  * tile: each rank blends a horizontal strip of its camera's image; the
    strips are independent given their instances, and SSIM crosses the
    seams exactly through a halo exchange (``ops.ssim.ssim_strips``);
  * the preprocess (projection, EWA, SH) runs on a 1/n_tile slice of the
    cloud per rank, and the projected set is all-gathered over the tile
    axis (or routed to the strips that need it, ``exchange.py``); the
    gather's backward sums the strips' cotangents back into the owning
    slice.

With ``shard_params`` the parameters, both Adam moments, the densify
statistics and the running radii are stored sharded over every rank
(``PRIM_SPEC``, ZeRO-3): rank (d, t) owns rows block ``t * n_data + d``.
An all-gather over "data" rebuilds the tile row's contiguous slice, so the
instance order, and with it the binning sort's stable tie-break, is the
replicated path's; the row gradients arrive summed over the whole mesh
through the two gathers' backward. ``make_sharded_densify_step`` then
densifies each shard in place, with its own free slots.

A step updates the state in place, as ``gs_trainer.train_step`` does, and
a loss that is not finite makes it a no-op on every rank (the flag is the
summed loss, equal on all of them).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from frosting_tpu_torch.cameras import Camera
from frosting_tpu_torch.ops.ssim import l1_loss, psnr, ssim_strips
from frosting_tpu_torch.parallel import collectives
from frosting_tpu_torch.parallel.collectives import WORLD, Mesh, make_mesh  # noqa: F401
from frosting_tpu_torch.raster import RasterConfig
from frosting_tpu_torch.raster.preprocess import Projected, preprocess, shift_projected
from frosting_tpu_torch.raster.render import render_projected
from frosting_tpu_torch.scene.gaussians import GaussianParams, activate
from frosting_tpu_torch.train import densify as densify_lib
from frosting_tpu_torch.train import optimizer as opt_lib
from frosting_tpu_torch.train.gs_trainer import GSTrainConfig, TrainState

# The leading-dim layout of primitive-sharded storage: tile-major over the
# flattened mesh, rank (d, t) holding block t * n_data + d
# (``Mesh.flat_index``), so that a gather over "data" yields the tile row's
# contiguous global slice, the rows the replicated path slices.
PRIM_SPEC = ("tile", "data")

Mark = Optional[Callable[[str], None]]
_FIELDS = ("means3d", "sh_dc", "sh_rest", "scales_log", "quats_raw", "opacities_raw", "mask")


def strip_config(rcfg: RasterConfig, n_tile: int) -> RasterConfig:
    """Each rank's raster config: a horizontal strip of the full image,
    projected in the full image's frame."""
    if rcfg.height % n_tile != 0:
        raise ValueError("image height must divide the tile axis")
    strip_h = rcfg.height // n_tile
    if strip_h % rcfg.tile_h != 0:
        raise ValueError("strip height must divide the pixel-tile height")
    max_inst = max(rcfg.chunk, (rcfg.max_instances // n_tile) // rcfg.chunk * rcfg.chunk)
    return dataclasses.replace(
        rcfg,
        height=strip_h,
        proj_width=rcfg.projection_width,
        proj_height=rcfg.projection_height,
        max_instances=max_inst,
    )


def shard_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's block (PRIM_SPEC) of a capacity-leading tensor."""
    if x.shape[0] % mesh.size:
        raise ValueError(f"{x.shape[0]} rows do not divide over {mesh.size} ranks")
    n = x.shape[0] // mesh.size
    b = mesh.flat_index
    return x[b * n:(b + 1) * n].clone()


def unshard_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole capacity-leading tensor from every rank's block: the
    gather over "data" is the tile row's slice, the gather over "tile" the
    rows in order (every rank of the mesh must call it)."""
    with torch.no_grad():
        return collectives.all_gather(collectives.all_gather(x, mesh, "data"), mesh, "tile")


def _capacity_map(state: TrainState, fn) -> TrainState:
    """state with fn applied to every capacity-leading leaf."""
    p = state.params
    return TrainState(
        params=GaussianParams(**{f: fn(getattr(p, f)) for f in _FIELDS}),
        opt_state=opt_lib.AdamState(
            mu={g: fn(v) for g, v in state.opt_state.mu.items()},
            nu={g: fn(v) for g, v in state.opt_state.nu.items()},
            count=dict(state.opt_state.count),
        ),
        dstate=densify_lib.DensifyState(grad_accum=fn(state.dstate.grad_accum),
                                        denom=fn(state.dstate.denom)),
        max_radii=fn(state.max_radii),
    )


def shard_train_state(mesh: Mesh, state: TrainState) -> TrainState:
    """This rank's share of a replicated TrainState: capacity / n_ranks rows
    of the parameters, both Adam moments, the densify statistics and the
    running radii; the step counts stay whole."""
    return _capacity_map(state, lambda x: shard_rows(x, mesh))


def unshard_train_state(mesh: Mesh, state: TrainState) -> TrainState:
    """The replicated TrainState from every rank's share."""
    return _capacity_map(state, lambda x: unshard_rows(x, mesh))


def stack_cameras(cams: List[Camera]) -> List[Camera]:
    """The batch of cameras, one per data row (a list: each rank selects its
    own in ``shard_batch``)."""
    return list(cams)


def shard_batch(mesh: Mesh, cam_batch: List[Camera], gt_batch):
    """(this rank's camera, its strip of that camera's GT [3, strip_h, W])
    on the mesh's device: the camera of its data index, the rows of its tile
    index. gt_batch: [n_data, 3, H, W], numpy or a tensor."""
    d, t = mesh.data_index, mesh.tile_index
    gt = torch.as_tensor(np.asarray(gt_batch[d], np.float32))
    h = gt.shape[1] // mesh.shape["tile"]
    return cam_batch[d].to(mesh.device), gt[:, t * h:(t + 1) * h].contiguous().to(mesh.device)


def gather_projected(proj: Projected, mesh: Mesh, axis: str) -> Projected:
    """Every tile rank's projected slice, concatenated in tile order: one
    differentiable gather of the float fields, one of the integer ones."""
    floats = torch.cat([proj.means2d, proj.conics, proj.colors,
                        proj.opacities[:, None], proj.depths[:, None]], dim=1)
    ints = torch.cat([proj.radii[:, None], proj.rect,
                      proj.valid[:, None].to(torch.int32)], dim=1)
    floats = collectives.all_gather(floats, mesh, axis)
    ints = collectives.all_gather(ints.detach(), mesh, axis)
    return Projected(
        means2d=floats[:, 0:2], conics=floats[:, 2:5], colors=floats[:, 5:8],
        opacities=floats[:, 8], depths=floats[:, 9], radii=ints[:, 0].contiguous(),
        rect=ints[:, 1:5].contiguous(), valid=ints[:, 5] > 0)


def route_projected(proj_local: Projected, mesh: Mesh, rcfg: RasterConfig, strip_h: int,
                    primitive_exchange: bool, exchange_cap: int, y0: int,
                    s_cfg: RasterConfig):
    """(this strip's candidates in its own frame, exchange overflow or None):
    the tile axis's all-gather, or the primitive exchange with
    ``exchange_cap`` slots a pair of ranks, and never more than the rows
    this rank projected, the most it can send one strip (the same
    candidates in the same order, without the empty slots)."""
    n_tile = mesh.shape["tile"]
    overflow = None
    if primitive_exchange:
        from frosting_tpu_torch.parallel.exchange import exchange_projected

        n_local = proj_local.means2d.shape[0]
        cap = min(exchange_cap or n_local, n_local)
        proj, overflow = exchange_projected(proj_local, mesh, "tile", n_tile, strip_h, cap,
                                            rcfg)
    else:
        proj = gather_projected(proj_local, mesh, "tile")
    return shift_projected(proj, (0, y0), s_cfg, tile_aligned=True), overflow


def strip_loss(image, gt_strip, mesh: Mesh, lambda_dssim: float) -> torch.Tensor:
    """This strip's share of the batch-mean photometric loss: L1 and SSIM
    over the strip (SSIM with the neighbours' halo rows), over the number
    of ranks, so that the sum over the mesh is the cameras' mean of the
    full images' (1 - lambda) L1 + lambda (1 - SSIM)."""
    loss = (1.0 - lambda_dssim) * l1_loss(image, gt_strip) + lambda_dssim * (
        1.0 - ssim_strips(image, gt_strip, mesh, "tile"))
    return loss / mesh.size


def psum_flat(tensors: List[torch.Tensor], mesh: Mesh, axis=WORLD) -> List[torch.Tensor]:
    """The sum over the axis of each tensor, in one all-reduce."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    total = collectives.psum(flat, mesh, axis)
    out, at = [], 0
    for t in tensors:
        out.append(total[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


def step_stats(out, gt_strip, mesh: Mesh, extra=()) -> torch.Tensor:
    """[num_instances, overflow, strip PSNR, *extra] as float32, the maximum
    over the mesh."""
    vals = [out.num_instances.to(torch.float32), out.overflow.to(torch.float32),
            psnr(torch.clamp(out.image.detach(), 0.0, 1.0), gt_strip)]
    vals += [torch.as_tensor(e, device=gt_strip.device).to(torch.float32) for e in extra]
    return collectives.pmax(torch.stack(vals), mesh, WORLD)


def make_sharded_train_step(
    opt: opt_lib.GSOptimizer,
    rcfg: RasterConfig,
    cfg: GSTrainConfig,
    mesh: Mesh,
    primitive_exchange: bool = False,
    exchange_cap: int = 0,
    shard_params: bool = False,
):
    """Returns step(state, camera, gt_strip, mark=None) -> (state, metrics),
    run by every rank of the mesh on its own camera and GT strip
    (``shard_batch``), in place on state: the whole TrainState, replicated,
    or this rank's share (``shard_train_state``) under ``shard_params``.
    ``primitive_exchange`` routes the projected Gaussians to the strips
    that need them (``exchange.py``; ``exchange_cap`` rows per pair of
    ranks, at most and by default the slice's size) in place of the
    all-gather.
    ``mark(name)``, where given, is called as each part of the step ends.
    The metrics are device tensors: the summed loss, and the maximum over
    the mesh of the instances, the overflow flag and the strip PSNR."""
    n_data, n_tile = mesh.shape["data"], mesh.shape["tile"]
    s_cfg = strip_config(rcfg, n_tile)
    strip_h = s_cfg.height
    bg_value = 1.0 if cfg.white_background else 0.0

    def step(state: TrainState, camera: Camera, gt_strip: torch.Tensor, mark: Mark = None):
        mark = mark or (lambda _name: None)
        p = state.params
        dev = p.means3d.device
        d, t = mesh.data_index, mesh.tile_index
        y0 = t * strip_h
        bg = torch.full((3,), bg_value, device=dev)
        leaves = {g: getattr(p, g).detach().requires_grad_(True) for g in opt_lib.GROUPS}
        probe = torch.zeros((p.capacity, 2), device=dev, requires_grad=True)
        q = dataclasses.replace(p, **leaves)
        if shard_params:
            # this rank's block -> the tile row's contiguous slice, in one
            # gather whose backward sums the row's gradient over "data"
            q, probe_l = _gather_rows(q, probe, mesh)
            mark("row gather")
        else:
            shard = p.capacity // n_tile
            q = GaussianParams(**{f: getattr(q, f)[t * shard:(t + 1) * shard] for f in _FIELDS})
            probe_l = probe[t * shard:(t + 1) * shard]
        means, scales, quats, opac, sh = activate(q)
        proj_local = preprocess(means, scales, quats, opac, sh, camera, rcfg,
                                active_sh_degree=cfg.sh_degree)
        proj_local = proj_local._replace(means2d=proj_local.means2d + probe_l)
        mark("activation + preprocess")
        proj, x_overflow = route_projected(proj_local, mesh, rcfg, strip_h,
                                           primitive_exchange, exchange_cap, y0, s_cfg)
        if shard_params:
            radii_stats = proj_local.radii
        elif primitive_exchange:
            radii_stats = collectives.all_gather(proj_local.radii, mesh, "tile")
        else:
            radii_stats = proj.radii
        mark("collectives")
        out = render_projected(proj, s_cfg, bg=bg, mark=mark)
        loss = strip_loss(out.image, gt_strip, mesh, cfg.lambda_dssim)
        mark("loss + SSIM")
        *grads, probe_grad = torch.autograd.grad(
            loss, [leaves[g] for g in opt_lib.GROUPS] + [probe])
        mark("backward (B2)")
        if shard_params:
            # the gradients arrived summed over the mesh through the gathers'
            # backward; the radii: the row's maximum over the cameras, then
            # this rank's block of it
            radii_row = collectives.pmax(radii_stats, mesh, "data")
            sub = radii_row.shape[0] // n_data
            radii = radii_row[d * sub:(d + 1) * sub]
        else:
            *grads, probe_grad = psum_flat(grads + [probe_grad], mesh)
            radii = collectives.pmax(radii_stats, mesh, WORLD)
        loss = collectives.psum(loss.detach(), mesh, WORLD)
        extra = () if x_overflow is None else (x_overflow,)
        stats = step_stats(out, gt_strip, mesh, extra)
        mark("all-reduce")
        good = torch.isfinite(loss)
        opt.step(p, dict(zip(opt_lib.GROUPS, grads)), state.opt_state, good)
        state.dstate = densify_lib.update_stats(
            state.dstate, torch.where(good, probe_grad, 0.0), radii, p.mask,
            image_size=(rcfg.width, rcfg.height))
        state.max_radii = torch.maximum(state.max_radii, radii.to(torch.float32))
        mark("Adam")
        metrics = {"loss": loss, "num_instances": stats[0], "overflow": stats[1],
                   "psnr_strip": stats[2]}
        if x_overflow is not None:
            metrics["exchange_overflow"] = stats[3]
        return state, metrics

    return step


def _gather_rows(q: GaussianParams, probe: torch.Tensor, mesh: Mesh):
    """(the tile row's GaussianParams, its probe) from this rank's block:
    every field in one differentiable gather over "data"."""
    r = q.capacity
    cols = [getattr(q, f).reshape(r, -1) for f in _FIELDS] + [probe]
    widths = [c.shape[1] for c in cols]
    row = collectives.all_gather(torch.cat(cols, dim=1), mesh, "data")
    n = row.shape[0]
    parts = torch.split(row, widths, dim=1)
    fields = {f: part.reshape((n,) + getattr(q, f).shape[1:])
              for f, part in zip(_FIELDS, parts)}
    return GaussianParams(**fields), parts[-1]


def shard_seed(seed: int, mesh: Mesh) -> int:
    """The seed of this rank's draws: (seed, its block index), the
    counterpart of ``jax.random.fold_in(key, t * n_data + d)``."""
    return int(np.random.SeedSequence([seed, mesh.flat_index]).generate_state(1)[0])


def make_sharded_densify_step(mesh: Mesh, spatial_extent: float, cfg: GSTrainConfig):
    """Densification on primitive-sharded state: every rank clones, splits
    and prunes its own capacity / n_ranks rows into its own free slots (a
    shard out of free slots drops requests on its own, counted in
    n_dropped), and zeroes the Adam rows it rewrote; nothing is gathered.

    Returns step(state, seed, use_size_prune=False, draws=None) ->
    (state, DensifyInfo summed over the mesh), in place on this rank's
    share (``shard_train_state``). The draws come from a generator seeded
    by (seed, this rank's block), or are passed in: (eps1, eps2), each
    [rows, 3] standard normal."""
    dcfg = densify_lib.DensifyConfig(grad_threshold=cfg.densify_grad_threshold)

    def step(state: TrainState, seed: int, use_size_prune: bool = False, draws=None):
        p = state.params
        if draws is None:
            gen = torch.Generator(device=p.means3d.device)
            gen.manual_seed(shard_seed(seed, mesh))
            draws = (torch.randn((p.capacity, 3), generator=gen, device=p.means3d.device),
                     torch.randn((p.capacity, 3), generator=gen, device=p.means3d.device))
        state.params, state.dstate, info = densify_lib._densify_and_prune(
            p, state.opt_state, state.dstate, draws[0], draws[1], spatial_extent, dcfg,
            cfg.max_screen_size if use_size_prune else 0.0, state.max_radii)
        state.max_radii = torch.zeros_like(state.max_radii)
        total = collectives.psum(torch.stack(list(info)).to(torch.int64), mesh, WORLD)
        return state, densify_lib.DensifyInfo(*total.unbind(0))

    return step
