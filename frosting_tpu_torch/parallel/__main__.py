"""Dry run of the sharded steps on a mesh of any size, held against the
port's single-process steps.

Counterpart of ``__graft_entry__.dryrun_multichip``. Under ``torchrun`` (or
any launcher that sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
MASTER_PORT) every rank runs the chosen checks; without one, the process is
a world of one::

    torchrun --standalone --nproc-per-node 4 -m frosting_tpu_torch.parallel --backend gloo
    python -m frosting_tpu_torch.parallel            # a world of one (NCCL on a card)

By default it runs one sharded 3DGS step and one sharded Frosting step on
tiny shapes. ``--checks`` picks from:

  gs        the replicated step against the single-process batch-mean step
            (``gs_trainer.train_step`` itself for one camera), a second run
            of it bitwise equal, the replicated parameters bitwise equal on
            every rank;
  shard     the same step with ``shard_params`` against the replicated one,
            every rank holding capacity / n_ranks rows; then three steps
            and a sharded densify that must grow the cloud;
  exchange  the primitive exchange against the all-gather, on a 1 x n mesh;
  sugar     one coarse-SuGaR step per phase (photo, entropy, sdf by density)
            and the sdf mode's depth strips against the single-process depth
            render;
  frosting  the Frosting step (with background Gaussians), replicated and
            with ``shard_params``, against the single-process batch-mean
            step (``frosting_trainer.train_step`` for one camera).

Each rank reports its steps' parts (ms; CUDA events on a card), the bytes
its collectives moved, its blend launches and its peak memory; rank 0
prints every rank's report as one JSON line (and writes it to ``--out``).
The process exits nonzero where a check fails. Ranks that share one card
over gloo measure correctness and cost, not scaling.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import Dict, List

import numpy as np
import torch
import torch.distributed as dist

from frosting_tpu_torch.cameras import look_at_camera
from frosting_tpu_torch.models import frosting as frosting_lib
from frosting_tpu_torch.parallel import multihost
from frosting_tpu_torch.parallel import sharded_frosting as sf
from frosting_tpu_torch.parallel import sharded_sugar as ssg
from frosting_tpu_torch.parallel import sharded_train as st
from frosting_tpu_torch.parallel.report import (
    COS_MIN,
    Clock,
    clone,
    cosine,
    counts,
    digest,
    equal_on_every_rank,
    flat_params,
    hold_gs_step,
    photometric,
)
from frosting_tpu_torch.raster import RasterConfig, render
from frosting_tpu_torch.scene import gaussians as gauss_lib
from frosting_tpu_torch.scene import synthetic
from frosting_tpu_torch.train import checkpoint
from frosting_tpu_torch.train import frosting_trainer, gs_trainer, sugar_trainer
from frosting_tpu_torch.train import optimizer as opt_lib

CHECKS = ("gs", "shard", "exchange", "sugar", "frosting")
ORBIT_R = 3.5
EXTENT = 1.1 * ORBIT_R
FROSTING_LOSS_RTOL = 3e-4
ROUTE_RTOL, ROUTE_COS_MIN = 1e-5, 0.9999
DEPTH_TOL = 2e-5


class Report:
    """What this rank measured and checked."""

    def __init__(self, device):
        self.device = device
        self.data: Dict[str, dict] = {}
        self.launches = [0, 0]

    def timed(self, name, mesh, fn):
        """fn(mark) -> metrics, its parts, collective bytes and launches
        recorded under name."""
        clock = Clock(self.device)
        mesh.reset_stats()
        before = counts()
        out = fn(clock.mark)
        self.sync()
        rise = [a - b for a, b in zip(counts(), before)]
        self.launches = [a + b for a, b in zip(self.launches, rise)]
        entry = self.data.setdefault(name, {})
        entry.update({"ms": clock.parts(), "collectives": dict(mesh.stats),
                      "launches": rise})
        if isinstance(out, dict):
            entry["metrics"] = {k: float(v) for k, v in out.items()}
        return out

    def sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()


def orbit_cameras(n, device):
    return [look_at_camera(eye=[ORBIT_R * math.cos(el) * math.cos(az),
                                ORBIT_R * math.cos(el) * math.sin(az),
                                ORBIT_R * math.sin(el)],
                           target=[0.0, 0.0, 0.0], up=(0, 0, 1),
                           fov_x=math.radians(50.0), device=device)
            for az, el in [(2 * math.pi * i / max(n, 1) + 0.5, 0.25) for i in range(n)]]


# --- the single-process references ---


def reference_frosting_step(params, opt_state, meta, cams, gts, opt, rcfg, cfg):
    """``frosting_trainer.train_step`` for one camera; for several, its loss
    averaged over them and one Adam step."""
    dev = params.bary_logits.device
    n_total = params.bary_logits.shape[0] + (0 if params.bg is None else params.bg.capacity)
    if len(cams) == 1:
        return frosting_trainer.train_step(params, opt_state, meta, cams[0], gts[0],
                                           torch.ones(n_total, device=dev), opt, rcfg, cfg,
                                           cfg.sh_degree)
    groups = frosting_trainer.param_groups(params)
    leaves = {g: groups[g].detach().requires_grad_(True) for g in opt.groups}
    model = frosting_lib.activate_frosting(frosting_trainer.with_groups(params, leaves), meta)
    bg = torch.full((3,), 1.0 if cfg.white_background else 0.0, device=dev)
    loss = 0.0
    for cam, gt in zip(cams, gts):
        out = render(*model, cam, rcfg, bg=bg, active_sh_degree=cfg.sh_degree)
        loss = loss + photometric(out.image, gt, cfg.lambda_dssim) / len(cams)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    opt.step(groups, dict(zip(leaves, grads)), opt_state)
    return {"loss": loss.detach()}


def flat_groups(groups: Dict[str, torch.Tensor], names) -> torch.Tensor:
    return torch.cat([groups[g].detach().reshape(-1) for g in names])


# --- the scenes ---


def gs_scene(args, n_cams, device):
    """(GT images [n, 3, H, W] numpy, cameras, the degraded init's
    TrainState and optimizer, GSTrainConfig, RasterConfig): the bench scene
    (bench.py's draws) rendered by the port as the ground truth, and its
    means subsampled and jittered as the start."""
    from frosting_tpu_torch.bench.common import bench_scene

    means, scales, quats, opac, sh = bench_scene(args.gaussians, args.seed, -0.9, 0.9,
                                                 0.003, 0.015)
    gt_model = tuple(torch.from_numpy(a).to(device) for a in (means, scales, quats, opac, sh))
    cams = orbit_cameras(n_cams, device)
    rcfg = RasterConfig(width=args.width, height=args.height, chunk=128,
                        max_instances=args.max_instances)
    gts = synthetic.render_gt_images(gt_model, cams, rcfg, np.zeros(3, np.float32))
    pts, cols = synthetic.degraded_init(gt_model, keep=0.9, jitter=args.jitter, seed=1)
    # room to densify into, in whole blocks of 1024 rows (any mesh of up to
    # 1024 ranks divides it)
    cap = -(-int(len(pts) * 1.25) // 1024) * 1024
    cfg = gs_trainer.GSTrainConfig(capacity=cap, white_background=False)
    state, opt = gs_trainer.init_state(pts, cols, EXTENT, cfg, device=device)
    return gts, cams, state, opt, cfg, rcfg


def frosting_scene(args, n_cams, device):
    """(GT images, cameras, params, meta, RasterConfig): the Frosting init of
    ``--frosting-init`` (a ``checkpoint.save_frosting`` file) or a small
    icosphere init, with ``--background`` background Gaussians added where
    it has none; the GT is the port's render of it, and the start is it
    with its opacities and colours perturbed (seeded)."""
    if args.frosting_init:
        params, meta = checkpoint.load_frosting(args.frosting_init, device=device)
    else:
        params, meta = tiny_frosting_init(args.seed, device)
    rng = np.random.default_rng(args.seed + 7)
    if params.bg is None and args.background:
        d = rng.normal(size=(args.background, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        pts = (d * rng.uniform(5.0, 8.0, (args.background, 1))).astype(np.float32)
        params.bg = gauss_lib.create_from_pcd(pts, rng.uniform(0.2, 0.8, pts.shape),
                                              args.background, device=device)
    cams = orbit_cameras(n_cams, device)
    rcfg = RasterConfig(width=args.width, height=args.height, chunk=128,
                        max_instances=args.max_instances)
    with torch.no_grad():
        gts = synthetic.render_gt_images(frosting_lib.to_gaussians(params, meta), cams, rcfg,
                                         np.zeros(3, np.float32))
        n = params.bary_logits.shape[0]
        gen = torch.Generator(device="cpu").manual_seed(args.seed)
        params.opacities_raw += (torch.randn(n, generator=gen) * 0.3).to(device)
        params.sh_dc += (torch.randn((n, 1, 3), generator=gen) * 0.1).to(device)
        if params.bg is not None:
            nb = params.bg.capacity
            params.bg.sh_dc += (torch.randn((nb, 1, 3), generator=gen) * 0.1).to(device)
    return gts, cams, params, meta, rcfg


def tiny_frosting_init(seed, device):
    """A Frosting model of 1024 Gaussians in an icosphere's 320 cells, drawn
    from a seed (no extraction)."""
    verts, faces = _icosphere(2)
    rng = np.random.default_rng(seed)
    n = 1024
    cell = np.sort(rng.integers(0, len(faces), n))
    d = {
        "shell_verts": verts, "inner_dist": np.full(len(verts), -0.05),
        "outer_dist": np.full(len(verts), 0.05),
        "bary_logits": rng.normal(size=(n, 6)), "scales_log": np.log(
            rng.uniform(0.02, 0.05, (n, 3))),
        "quats_raw": rng.normal(size=(n, 4)), "opacities_raw": rng.normal(size=n),
        "sh_dc": rng.uniform(-1, 1, (n, 1, 3)), "sh_rest": rng.normal(size=(n, 15, 3)) * 0.05,
        "bg": None,
    }
    params = frosting_lib.params_from_numpy(d, device=device)
    bounds = np.searchsorted(cell, np.arange(len(faces) + 1))
    return params, frosting_lib.make_meta(faces, cell, bounds, n_verts=len(verts),
                                          device=device)


def _icosphere(subdiv):
    t = (1 + 5 ** 0.5) / 2
    v = [[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t],
         [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]]
    f = [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9], [5, 11, 4],
         [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8],
         [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]]
    verts = [np.asarray(p, np.float64) / np.linalg.norm(p) for p in v]
    for _ in range(subdiv):
        cache, nf = {}, []

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                cache[key] = len(verts) - 1
            return cache[key]

        for a, b, c in f:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        f = nf
    return np.asarray(verts, np.float32), np.asarray(f, np.int32)


# --- the checks ---


def check_gs(args, mesh, rep: Report, dev):
    """The replicated step against the single-process batch mean, twice
    (bitwise), equal on every rank. Returns the scene for the next checks."""
    n_data = mesh.shape["data"]
    gts, cams, state0, opt, cfg, rcfg = gs_scene(args, n_data, dev)
    camera, gt_strip = st.shard_batch(mesh, st.stack_cameras(cams), gts)
    step = st.make_sharded_train_step(opt, rcfg, cfg, mesh)
    runs = []
    for i in range(2):
        state = clone(state0)
        metrics = rep.timed(f"gs_replicated_{i}", mesh,
                            lambda mark: step(state, camera, gt_strip, mark)[1])
        runs.append((state, metrics))
    state = runs[0][0]
    out = rep.data["gs_replicated_0"]
    tensors = [getattr(state.params, g) for g in opt_lib.GROUPS] + [
        state.dstate.grad_accum, state.dstate.denom, state.max_radii]
    out["bitwise_two_runs"] = digest(tensors) == digest(
        [getattr(runs[1][0].params, g) for g in opt_lib.GROUPS] + [
            runs[1][0].dstate.grad_accum, runs[1][0].dstate.denom, runs[1][0].max_radii])
    out["bitwise_across_ranks"] = equal_on_every_rank(digest(tensors))
    out["overflow"] = float(runs[0][1]["overflow"])
    if mesh.flat_index == 0:
        gt_dev = [torch.from_numpy(g).to(dev) for g in gts]
        held, ref = hold_gs_step(state, float(runs[0][1]["loss"]), state0, cams, gt_dev, opt,
                                 rcfg, cfg)
        out.update(held)
        out["stats_equal"] = {
            "grad_accum_max_off": float((state.dstate.grad_accum - ref.dstate.grad_accum)
                                        .abs().max()),
            "radii_equal": bool(torch.equal(state.max_radii, ref.max_radii))}
        del ref
    return gts, cams, state0, opt, cfg, rcfg, state


def check_shard(args, mesh, rep: Report, dev, scene):
    gts, cams, state0, opt, cfg, rcfg, replicated = scene
    camera, gt_strip = st.shard_batch(mesh, st.stack_cameras(cams), gts)
    step = st.make_sharded_train_step(opt, rcfg, cfg, mesh, shard_params=True)
    sharded = st.shard_train_state(mesh, clone(state0))
    m = rep.timed("gs_shard_params", mesh, lambda mark: step(sharded, camera, gt_strip, mark)[1])
    out = rep.data["gs_shard_params"]
    cap = state0.params.capacity
    out["rows"] = {"params": sharded.params.means3d.shape[0],
                   "adam_mu": sharded.opt_state.mu["means3d"].shape[0],
                   "adam_nu": sharded.opt_state.nu["sh_rest"].shape[0],
                   "grad_accum": sharded.dstate.grad_accum.shape[0],
                   "max_radii": sharded.max_radii.shape[0], "capacity": cap}
    whole = st.unshard_train_state(mesh, sharded)
    upd = flat_params(whole.params) - flat_params(state0.params)
    upd_rep = flat_params(replicated.params) - flat_params(state0.params)
    out["update_cosine_vs_replicated"] = cosine(upd, upd_rep)
    out["loss_vs_replicated"] = abs(float(m["loss"]) - rep.data["gs_replicated_0"]["metrics"][
        "loss"]) / abs(rep.data["gs_replicated_0"]["metrics"]["loss"])
    del whole
    # three steps at a low threshold, then a sharded densify that grows
    cfg_lo = dataclasses.replace(cfg, densify_grad_threshold=1e-6)
    step_lo = st.make_sharded_train_step(opt, rcfg, cfg_lo, mesh, shard_params=True)
    for i in range(3):
        rep.timed(f"gs_shard_step_{i + 2}", mesh,
                  lambda mark: step_lo(sharded, camera, gt_strip, mark)[1])
    n_before = int(st.collectives.psum(sharded.params.num_active().to(torch.int64), mesh,
                                       st.WORLD))
    dstep = st.make_sharded_densify_step(mesh, EXTENT, cfg_lo)
    _, info = rep.timed("gs_shard_densify", mesh, lambda mark: dstep(sharded, 7))
    n_after = int(st.collectives.psum(sharded.params.num_active().to(torch.int64), mesh,
                                      st.WORLD))
    out["densify"] = {"before": n_before, "after": n_after,
                      **{k: int(v) for k, v in info._asdict().items()},
                      "rows_after": sharded.params.means3d.shape[0]}
    m2 = rep.timed("gs_shard_after_densify", mesh,
                   lambda mark: step_lo(sharded, camera, gt_strip, mark)[1])
    out["after_densify_finite"] = bool(math.isfinite(float(m2["loss"])))
    out["params_finite"] = bool(torch.isfinite(sharded.params.means3d).all())


def check_exchange(args, mesh_row, rep: Report, dev, scene):
    """The exchange against the all-gather on a 1 x n mesh (the first
    camera)."""
    gts, cams, state0, opt, cfg, rcfg, _ = scene
    camera, gt_strip = st.shard_batch(mesh_row, st.stack_cameras(cams[:1]), gts[:1])
    outs = {}
    for name, kw in (("gather", {}), ("exchange", {"primitive_exchange": True})):
        step = st.make_sharded_train_step(opt, rcfg, cfg, mesh_row, **kw)
        state = clone(state0)
        m = rep.timed(f"gs_1x{mesh_row.size}_{name}", mesh_row,
                      lambda mark: step(state, camera, gt_strip, mark)[1])
        outs[name] = (state, m)
    (sa, ma), (sx, mx) = outs["gather"], outs["exchange"]
    out = rep.data[f"gs_1x{mesh_row.size}_exchange"]
    out["loss_vs_gather"] = abs(float(mx["loss"]) - float(ma["loss"])) / abs(float(ma["loss"]))
    out["means_update_cosine_vs_gather"] = cosine(sx.params.means3d - state0.params.means3d,
                                                  sa.params.means3d - state0.params.means3d)
    out["exchange_overflow"] = float(mx["exchange_overflow"])


def check_sugar(args, mesh, rep: Report, dev, scene):
    gts, cams, state0, opt0, _cfg, rcfg, _ = scene
    camera, gt_strip = st.shard_batch(mesh, st.stack_cameras(cams), gts)
    params = state0.params
    scfg = sugar_trainer.SugarTrainConfig(method="density", n_sdf_samples=args.sdf_samples,
                                          spatial_extent=EXTENT)
    knn_idx = sugar_trainer.compute_knn(params, scfg.knn_k)
    opt = opt_lib.make_gs_optimizer(EXTENT)
    losses = {}
    for phase in ssg.PHASES:
        p = clone(params)
        opt_state = opt.init(p)
        step = ssg.make_sharded_sugar_step(opt, rcfg, scfg, mesh, phase)
        m = rep.timed(f"sugar_{phase}", mesh,
                      lambda mark: step(p, opt_state, camera, gt_strip, knn_idx, seed=1,
                                        mark=mark))
        losses[phase] = float(m["loss"])
        rep.data[f"sugar_{phase}"]["moved"] = float((p.means3d - params.means3d).abs().max())
    out = rep.data["sugar_sdf"]
    out["regularised_above_photo"] = losses["sdf"] > losses["photo"]
    out["entropy_above_photo"] = losses["entropy"] > losses["photo"]
    # the sdf mode's depth strips, assembled, against the full depth render
    model = gauss_lib.activate(params)
    depth = rep.timed("sugar_depth_strips", mesh,
                      lambda mark: ssg.render_depth_strips(model, camera, rcfg, mesh, mark=mark))
    with torch.no_grad():
        want, _, _ = full_depth(model, camera, rcfg)
    err = (depth - want).abs()
    out_d = rep.data["sugar_depth_strips"]
    out_d["max_abs_err"] = float(err.max())
    out_d["within"] = bool((err <= DEPTH_TOL + DEPTH_TOL * want.abs()).all())


def full_depth(model, camera, rcfg):
    from frosting_tpu_torch.models import sugar as sugar_lib

    means, scales, quats, opac, _sh = model
    return sugar_lib.render_depth_normal_maps(means, scales, quats, opac, camera, rcfg,
                                              normals=False)


def check_frosting(args, mesh, rep: Report, dev):
    n_data = mesh.shape["data"]
    gts, cams, params0, meta, rcfg = frosting_scene(args, n_data, dev)
    camera, gt_strip = st.shard_batch(mesh, st.stack_cameras(cams), gts)
    tcfg = frosting_trainer.FrostingTrainConfig(iterations=1, lr_max_steps=10)
    opt = frosting_trainer.make_frosting_optimizer(tcfg, EXTENT,
                                                   background=params0.bg is not None)
    names = list(opt.groups)
    before = flat_groups(frosting_trainer.param_groups(params0), names)
    results = {}
    for name, shard in (("replicated", False), ("shard_params", True)):
        p = sf.shard_frosting_params(mesh, clone(params0)) if shard else clone(params0)
        opt_state = opt.init(frosting_trainer.param_groups(p))
        step = sf.make_sharded_frosting_step(opt, rcfg, tcfg, mesh, meta, shard_params=shard)
        m = rep.timed(f"frosting_{name}", mesh,
                      lambda mark: step(p, opt_state, camera, gt_strip, mark))
        entry = rep.data[f"frosting_{name}"]
        entry["n_gaussians"] = params0.bary_logits.shape[0]
        entry["n_background"] = 0 if params0.bg is None else params0.bg.capacity
        if shard:
            entry["rows"] = {"bary_logits": p.bary_logits.shape[0],
                             "adam_mu": opt_state.mu["bary_logits"].shape[0],
                             "bg": p.bg.capacity if p.bg is not None else 0}
            whole = sf.unshard_frosting_params(mesh, p)
        else:
            whole = p
            entry["bitwise_across_ranks"] = equal_on_every_rank(
                digest(frosting_trainer.param_groups(p).values()))
        results[name] = (flat_groups(frosting_trainer.param_groups(whole), names), m, whole)
    upd = results["replicated"][0] - before
    upd_sh = results["shard_params"][0] - before
    sh = rep.data["frosting_shard_params"]
    sh["update_cosine_vs_replicated"] = cosine(upd_sh, upd)
    sh["loss_vs_replicated"] = abs(float(results["shard_params"][1]["loss"]) - float(
        results["replicated"][1]["loss"])) / abs(float(results["replicated"][1]["loss"]))
    whole = results["replicated"][2]
    if whole.bg is not None:
        rep.data["frosting_replicated"]["bg_moved"] = float(
            (whole.bg.sh_dc - params0.bg.sh_dc).abs().max())
    if mesh.flat_index == 0:
        ref = clone(params0)
        ref_state = opt.init(frosting_trainer.param_groups(ref))
        gt_dev = [torch.from_numpy(g).to(dev) for g in gts]
        ref_loss = float(reference_frosting_step(ref, ref_state, meta, cams, gt_dev, opt, rcfg,
                                                 tcfg)["loss"])
        ref_upd = flat_groups(frosting_trainer.param_groups(ref), names) - before
        rp = rep.data["frosting_replicated"]
        rp["reference_loss"] = ref_loss
        rp["loss_rel_err"] = abs(float(results["replicated"][1]["loss"]) - ref_loss) / abs(
            ref_loss)
        rp["update_cosine"] = cosine(upd, ref_upd)


def verdicts(report: dict, checks) -> List[str]:
    """The failed checks of every rank's report (rank 0 holds the
    references)."""
    bad = []
    r0 = report[0]
    for rank, rep in enumerate(report):
        d = rep["data"]
        for name, entry in d.items():
            m = entry.get("metrics", {})
            if "loss" in m and not math.isfinite(m["loss"]):
                bad.append(f"rank {rank} {name}: loss {m['loss']}")
            if m.get("overflow", 0) > 0:
                bad.append(f"rank {rank} {name}: instances overflowed")
        if "gs" in checks:
            g = d["gs_replicated_0"]
            if not (g["bitwise_two_runs"] and g["bitwise_across_ranks"]):
                bad.append(f"rank {rank}: the replicated step is not bitwise reproducible")
        if "shard" in checks:
            s = d["gs_shard_params"]
            rows = s["rows"]
            want = rows["capacity"] // rep["mesh_size"]
            if any(v != want for k, v in rows.items() if k != "capacity"):
                bad.append(f"rank {rank}: shard rows {rows}, not {want}")
            if not (s["loss_vs_replicated"] <= ROUTE_RTOL
                    and s["update_cosine_vs_replicated"] > ROUTE_COS_MIN):
                bad.append(f"rank {rank}: shard_params against replicated {s}")
            dn = s["densify"]
            if not (dn["after"] > dn["before"] and dn["n_cloned"] + dn["n_split"] > 0
                    and s["after_densify_finite"] and s["params_finite"]):
                bad.append(f"rank {rank}: the sharded densify {dn}")
        if "exchange" in checks:
            x = d[[k for k in d if k.endswith("_exchange")][0]]
            if not (x["loss_vs_gather"] <= ROUTE_RTOL
                    and x["means_update_cosine_vs_gather"] > ROUTE_COS_MIN
                    and x["exchange_overflow"] == 0):
                bad.append(f"rank {rank}: exchange against all-gather {x}")
        if "sugar" in checks:
            s = d["sugar_sdf"]
            if not (s["regularised_above_photo"] and s["entropy_above_photo"]
                    and all(d[f"sugar_{p}"]["moved"] > 0 for p in ssg.PHASES)):
                bad.append(f"rank {rank}: the SuGaR steps {s}")
            if not d["sugar_depth_strips"]["within"]:
                bad.append(f"rank {rank}: depth strips {d['sugar_depth_strips']}")
        if "frosting" in checks:
            f = d["frosting_shard_params"]
            want = f["n_gaussians"] // rep["mesh_size"]
            if f["rows"]["bary_logits"] != want or f["rows"]["adam_mu"] != want:
                bad.append(f"rank {rank}: frosting shard rows {f['rows']}")
            if not (f["loss_vs_replicated"] <= ROUTE_RTOL
                    and f["update_cosine_vs_replicated"] > ROUTE_COS_MIN):
                bad.append(f"rank {rank}: frosting shard_params against replicated {f}")
            if not d["frosting_replicated"].get("bitwise_across_ranks", False):
                bad.append(f"rank {rank}: frosting replicated params differ across ranks")
    d0 = r0["data"]
    if "gs" in checks:
        g = d0["gs_replicated_0"]
        if not g["ok"]:
            bad.append(f"the sharded 3DGS step against the single-process step: {g}")
    if "frosting" in checks:
        f = d0["frosting_replicated"]
        if not (f["loss_rel_err"] <= FROSTING_LOSS_RTOL and f["update_cosine"] > COS_MIN):
            bad.append(f"the sharded Frosting step against the single-process step: {f}")
        if "bg_moved" in f and not f["bg_moved"] > 0:
            bad.append("the background Gaussians did not move")
    return bad


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m frosting_tpu_torch.parallel",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None,
                    help="nccl (the default on cuda) or gloo (the default on cpu)")
    ap.add_argument("--mesh", default=None,
                    help="n_data x n_tile, e.g. 2x2 (default: n_tile 4, 2 or 1 by the world)")
    ap.add_argument("--checks", default="gs,frosting",
                    help=f"comma-separated, from {','.join(CHECKS)} (or all)")
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--gaussians", type=int, default=2000)
    ap.add_argument("--jitter", type=float, default=0.02)
    ap.add_argument("--max-instances", type=int, default=1 << 16)
    ap.add_argument("--sdf-samples", type=int, default=4096)
    ap.add_argument("--frosting-init", default=None,
                    help="a frosting_init.npz (checkpoint.save_frosting); default a "
                         "1024-Gaussian icosphere init")
    ap.add_argument("--background", type=int, default=256,
                    help="background Gaussians to add where the init has none")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=multihost.DEFAULT_TIMEOUT_S,
                    help="seconds before a collective whose peers are gone fails")
    ap.add_argument("--out", default=None, help="write every rank's report here (JSON)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    torch.set_num_threads(1)  # one per rank, as the launcher's OMP_NUM_THREADS
    checks = CHECKS if args.checks == "all" else tuple(args.checks.split(","))
    for c in checks:
        if c not in CHECKS:
            raise SystemExit(f"unknown check {c!r}")
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("parallel: no CUDA device (pass --device cpu)", file=sys.stderr)
        return 1
    dev = multihost.local_device(args.device)
    multihost.start_world(args.backend, dev, args.timeout)
    rank, world = dist.get_rank(), dist.get_world_size()
    if args.mesh:
        n_data, n_tile = (int(v) for v in args.mesh.lower().split("x"))
    else:
        n_tile = 4 if world % 4 == 0 else 2 if world % 2 == 0 else 1
        n_data = world // n_tile
    rep = Report(dev)
    header = {"rank": rank, "world": world, "backend": dist.get_backend(),
              "device": str(dev), "mesh": [n_data, n_tile], "mesh_size": n_data * n_tile}
    if dev.type == "cuda":
        free, total = torch.cuda.mem_get_info(dev)
        header["free_gib_at_start"] = free / 2**30
        header["card_gib"] = total / 2**30
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    # every rank builds every mesh in the same order
    mesh = multihost.make_hybrid_mesh(n_data, n_tile, device=dev)
    mesh_row = st.make_mesh(1, world, device=dev) if "exchange" in checks else None
    header["tile_rows_local"] = multihost.tile_rows_are_local(mesh)
    scene = None
    if {"gs", "shard", "exchange", "sugar"} & set(checks):
        scene = check_gs(args, mesh, rep, dev)
    if "shard" in checks:
        check_shard(args, mesh, rep, dev, scene)
    if "exchange" in checks:
        check_exchange(args, mesh_row, rep, dev, scene)
    if "sugar" in checks:
        check_sugar(args, mesh, rep, dev, scene)
    del scene
    if "frosting" in checks:
        check_frosting(args, mesh, rep, dev)
    header["seconds"] = time.perf_counter() - t0
    header["launches"] = {"blend_forward": rep.launches[0], "blend_backward": rep.launches[1]}
    if dev.type == "cuda":
        header["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    header["data"] = rep.data
    reports = [None] * world
    dist.all_gather_object(reports, header)
    code = 0
    if rank == 0:
        bad = verdicts(reports, checks)
        line = json.dumps({"parallel": reports, "failed": bad})
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as fh:
                fh.write(line + "\n")
        for r in reports:
            print(f"rank {r['rank']} ({r['backend']}, mesh {r['mesh'][0]}x{r['mesh'][1]}): "
                  f"{r['seconds']:.1f} s, launches {r['launches']}")
        print("FAILED: " + "; ".join(bad) if bad else
              f"parallel dry run ok: {world} rank(s), checks {','.join(checks)}")
        code = 1 if bad else 0
    codes = [code]
    dist.broadcast_object_list(codes, src=0)
    dist.destroy_process_group()
    return codes[0]


if __name__ == "__main__":
    sys.exit(main())
