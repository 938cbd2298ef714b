"""Sharded Frosting refinement step (stage 5), the loop that needs the
devices most: 2M-5M Gaussians for up to 15k iterations.

Counterpart of ``frosting_tpu/parallel/sharded_frosting.py``. The mesh and
axes are sharded_train.py's: "data" over the cameras, "tile" over the image
strips, and the tile axis is also the primitive axis of the per-Gaussian
work. The activation (softmax barycentres times the cell corners) is per
Gaussian given the shell, which is small and replicated, so each rank
activates and projects a 1/n_tile slice of the Frosting Gaussians and of the
background Gaussians, and the tile axis gathers the projected set.

The corners' gradient stays a fixed-order segment sum per cell: the slice's
Gaussians go through ``models.frosting.CornerBlend`` with the slice's own
cell bounds. With ``shard_params`` the primitive leaves (the Gaussians' and
the background's) and their Adam moments are stored sharded over every rank
(``PRIM_SPEC``), and only the vertex leaves (the shell) are all-reduced.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from frosting_tpu_torch.cameras import Camera
from frosting_tpu_torch.models.frosting import (
    CornerBlend,
    FrostingMeta,
    FrostingParams,
    cell_corners,
)
from frosting_tpu_torch.ops import mesh as mesh_ops
from frosting_tpu_torch.ops import quat as quat_ops
from frosting_tpu_torch.parallel import collectives
from frosting_tpu_torch.parallel.collectives import WORLD, Mesh
from frosting_tpu_torch.parallel.sharded_train import (
    PRIM_SPEC,  # noqa: F401
    Mark,
    psum_flat,
    route_projected,
    shard_rows,
    step_stats,
    strip_config,
    strip_loss,
)
from frosting_tpu_torch.raster import RasterConfig
from frosting_tpu_torch.raster.preprocess import preprocess
from frosting_tpu_torch.raster.render import render_projected
from frosting_tpu_torch.scene.gaussians import GaussianParams
from frosting_tpu_torch.train import frosting_trainer
from frosting_tpu_torch.train.frosting_trainer import FrostingTrainConfig
from frosting_tpu_torch.train.optimizer import GSOptimizer

VERTEX_LEAVES = ("shell_verts", "inner_dist", "outer_dist")


def map_frosting_params(params: FrostingParams, big: Callable, rep: Callable) -> FrostingParams:
    """A FrostingParams with ``big`` applied to the primitive-axis leaves
    ([N]-leading: the Gaussians' and every background field) and ``rep``
    to the vertex-axis leaves (replicated): the one map of which leaf lives
    on which axis."""
    fields = {f.name: getattr(params, f.name) for f in dataclasses.fields(params)}
    out = {k: (rep(v) if k in VERTEX_LEAVES else big(v)) for k, v in fields.items()
           if k != "bg"}
    bg = params.bg
    if bg is not None:
        bg = GaussianParams(**{f.name: big(getattr(bg, f.name)) for f in dataclasses.fields(bg)})
    return FrostingParams(**out, bg=bg)


def shard_frosting_params(mesh: Mesh, params: FrostingParams) -> FrostingParams:
    """This rank's share: capacity / n_ranks rows of every primitive leaf
    (block ``Mesh.flat_index``), the vertex leaves whole. Build the
    optimizer state on the share (``opt.init``), so that the Adam moments
    are sharded too."""
    return map_frosting_params(params, lambda x: shard_rows(x, mesh), lambda x: x)


def unshard_frosting_params(mesh: Mesh, params: FrostingParams) -> FrostingParams:
    """The whole FrostingParams from every rank's share."""
    from frosting_tpu_torch.parallel.sharded_train import unshard_rows

    return map_frosting_params(params, lambda x: unshard_rows(x, mesh), lambda x: x)


def _activate_shard(p: FrostingParams, corners: torch.Tensor, cell_idx: torch.Tensor,
                    cell_bounds: Optional[torch.Tensor], rows: slice):
    """Activated arrays of the Frosting Gaussians p's rows ``rows`` (all of
    p's under shard_params), whose cells are cell_idx (those rows')."""
    w = torch.softmax(p.bary_logits[rows], dim=-1)
    means = CornerBlend.apply(w, corners, cell_idx, cell_bounds)
    scales = torch.exp(p.scales_log[rows])
    quats = quat_ops.normalize(p.quats_raw[rows])
    opac = torch.sigmoid(p.opacities_raw[rows])
    sh = torch.cat([p.sh_dc[rows], p.sh_rest[rows]], dim=1)
    return means, scales, quats, opac, sh


def _activate_bg_shard(bg: GaussianParams, rows: slice):
    means = bg.means3d[rows]
    scales = torch.exp(bg.scales_log[rows])
    quats = quat_ops.normalize(bg.quats_raw[rows])
    opac = torch.sigmoid(bg.opacities_raw[rows]) * bg.mask[rows]
    sh = torch.cat([bg.sh_dc[rows], bg.sh_rest[rows]], dim=1)
    return means, scales, quats, opac, sh


def _slice_bounds(cell_bounds: Optional[torch.Tensor], a: int, b: int):
    """The cell bounds of rows [a, b) of a sorted cell_idx, in those rows'
    own numbering; None where cell_idx is unsorted."""
    return None if cell_bounds is None else torch.clamp(cell_bounds - a, 0, b - a)


def make_sharded_frosting_step(
    opt: GSOptimizer,
    rcfg: RasterConfig,
    cfg: FrostingTrainConfig,
    mesh: Mesh,
    meta: FrostingMeta,
    primitive_exchange: bool = False,
    exchange_cap: int = 0,
    shard_params: bool = False,
):
    """Returns step(params, opt_state, camera, gt_strip, mark=None) ->
    metrics, run by every rank on its camera and GT strip
    (``sharded_train.shard_batch``), in place on params and opt_state:
    the whole FrostingParams, replicated, or this rank's share
    (``shard_frosting_params``, with opt_state built on it) under
    ``shard_params``. ``opt``: ``frosting_trainer.make_frosting_optimizer``
    (with ``background`` where params has background Gaussians). The
    metrics: the summed loss, and the maximum over the mesh of the
    instances, the overflow flag and the strip PSNR."""
    n_tile = mesh.shape["tile"]
    s_cfg = strip_config(rcfg, n_tile)
    strip_h = s_cfg.height
    bg_value = 1.0 if cfg.white_background else 0.0
    trains_shell = any(g in opt.groups for g in VERTEX_LEAVES)
    nc_pairs = None
    if cfg.regularize_shell:
        nc_pairs = mesh_ops.pair_incidence(torch.from_numpy(mesh_ops.adjacent_face_pairs(
            meta.faces.cpu().numpy())).to(meta.faces.device), meta.faces.shape[0])
    t = mesh.tile_index
    n = meta.cell_idx.shape[0]
    if n % mesh.size:
        raise ValueError("n_gaussians must divide over the mesh's ranks")
    shard = n // n_tile
    a, b = t * shard, (t + 1) * shard
    cell_idx = meta.cell_idx[a:b]
    cell_bounds = _slice_bounds(meta.cell_bounds, a, b)
    frozen = {}

    def step(params: FrostingParams, opt_state, camera: Camera, gt_strip: torch.Tensor,
             mark: Mark = None):
        mark = mark or (lambda _name: None)
        dev = params.bary_logits.device
        bg_color = torch.full((3,), bg_value, device=dev)
        groups = frosting_trainer.param_groups(params)
        leaves = {g: groups[g].detach().requires_grad_(True) for g in opt.groups}
        p = frosting_trainer.with_groups(params, leaves)
        if not trains_shell and "corners" not in frozen:
            frozen["corners"] = frosting_trainer.frozen_corners(params, meta, opt)
            frozen["reg"] = frosting_trainer.frozen_shell_reg(params, meta, nc_pairs, opt, cfg)
        corners = (cell_corners(p, meta.faces, meta.incidence) if trains_shell
                   else frozen["corners"])
        if shard_params:
            # this rank's blocks -> the tile row's contiguous slices, in one
            # gather whose backward sums the rows' gradient over "data"
            p = _gather_primitive_rows(p, mesh)
            rows = slice(None)
            mark("row gather")
        else:
            rows = slice(a, b)
        parts = [_activate_shard(p, corners, cell_idx, cell_bounds, rows)]
        if p.bg is not None:
            nb = p.bg.capacity if shard_params else p.bg.capacity // n_tile
            if not shard_params and p.bg.capacity % n_tile:
                raise ValueError("bg capacity must divide the tile axis")
            parts.append(_activate_bg_shard(p.bg, slice(None) if shard_params
                                            else slice(t * nb, (t + 1) * nb)))
        arrays = [torch.cat(xs) for xs in zip(*parts)]
        proj_local = preprocess(*arrays, camera, rcfg, active_sh_degree=cfg.sh_degree)
        mark("activation + preprocess")
        proj, x_overflow = route_projected(proj_local, mesh, rcfg, strip_h, primitive_exchange,
                                           exchange_cap, t * strip_h, s_cfg)
        mark("collectives")
        out = render_projected(proj, s_cfg, bg=bg_color, mark=mark)
        loss = strip_loss(out.image, gt_strip, mesh, cfg.lambda_dssim)
        if nc_pairs is not None:
            reg = (frosting_trainer.shell_normal_consistency(p, meta, nc_pairs, cfg)
                   if trains_shell else frozen["reg"])
            loss = loss + reg / mesh.size
        mark("loss + SSIM")
        names = list(leaves)
        grads = list(torch.autograd.grad(loss, [leaves[g] for g in names]))
        mark("backward (B2)")
        if shard_params:
            # the primitive leaves' gradients arrived summed over the mesh;
            # the vertex leaves are replicated and all-reduced
            idx = [i for i, g in enumerate(names) if g in VERTEX_LEAVES]
            if idx:
                for i, g in zip(idx, psum_flat([grads[i] for i in idx], mesh)):
                    grads[i] = g
        else:
            grads = psum_flat(grads, mesh)
        loss = collectives.psum(loss.detach(), mesh, WORLD)
        extra = () if x_overflow is None else (x_overflow,)
        stats = step_stats(out, gt_strip, mesh, extra)
        mark("all-reduce")
        opt.step(groups, dict(zip(names, grads)), opt_state, torch.isfinite(loss))
        mark("Adam")
        metrics = {"loss": loss, "num_instances": stats[0], "overflow": stats[1],
                   "psnr_strip": stats[2]}
        if x_overflow is not None:
            metrics["exchange_overflow"] = stats[3]
        return metrics

    return step


def _gather_primitive_rows(p: FrostingParams, mesh: Mesh) -> FrostingParams:
    """p with every primitive leaf's block replaced by the tile row's slice:
    one differentiable gather over "data" of the Frosting Gaussians' leaves,
    one of the background's."""

    def gather(leaves):
        r = leaves[0].shape[0]
        cols = [x.reshape(r, -1) for x in leaves]
        row = collectives.all_gather(torch.cat(cols, dim=1), mesh, "data")
        parts = torch.split(row, [c.shape[1] for c in cols], dim=1)
        return [part.reshape((row.shape[0],) + x.shape[1:]) for part, x in zip(parts, leaves)]

    names = [f.name for f in dataclasses.fields(p) if f.name not in VERTEX_LEAVES + ("bg",)]
    gathered = dict(zip(names, gather([getattr(p, k) for k in names])))
    bg = p.bg
    if bg is not None:
        bnames = [f.name for f in dataclasses.fields(bg)]
        bg = GaussianParams(**dict(zip(bnames, gather([getattr(bg, k) for k in bnames]))))
    return dataclasses.replace(p, **gathered, bg=bg)
