"""Stages 1-5 with the sharded 3DGS, SuGaR and Frosting steps chained end to
end over a mesh of ranks, and the eval: the counterpart of the JAX
package's ``scripts/pipeline_multichip.py``, whose values are the defaults.

Under ``torchrun`` (or any launcher that sets RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR and MASTER_PORT) every rank runs it on its own device; without
one, the process is a world of one::

    torchrun --standalone --nproc-per-node 4 -m frosting_tpu_torch.parallel.pipeline \\
        --device cpu --backend gloo --mesh 2x2
    python -m frosting_tpu_torch.parallel.pipeline --mesh 1x1   # one NCCL rank on a card

The stages, as the script runs them:

  1. 3DGS from the degraded ground-truth cloud (keep 0.7, jitter 0.05), the
     step replicated over the mesh, no densify. Each iteration's batch is
     n_data cameras drawn without replacement by one numpy generator seeded
     0, which the three trained stages draw from in turn (stage 2 after
     stage 1's draws, stage 5 after stage 2's). Rank 0 holds the first step
     against the single-process step on the same cameras;
  2. coarse SuGaR, density method: the entropy phase for the first 40% of
     the iterations, then the sdf phase, on ``make_gs_optimizer``; the KNN
     recomputed every 25 iterations on the replicated parameters; each
     rank's sdf draws from a generator seeded by (iteration, its index);
  3. the live rows (mask > 0.5) activated and, on rank 0 alone, the shell
     extracted (Poisson 64^3, a 2000-vertex target, 8 neighbours); its
     vertices and faces broadcast over the world;
  4. on rank 0, the Frosting init (8192 Gaussians, no self-intersection
     guard, a torch.Generator seeded 1, SH from the live rows); its
     parameters and meta broadcast over the world, so that every rank holds
     the same tensors bitwise;
  5. the Frosting step with the primitive leaves and their Adam moments
     sharded over every rank and the primitive exchange (a cap of
     max_instances / n_tile rows per pair of ranks, or the rows a rank
     holds where fewer);
  eval: the model gathered on every rank, rendered on rank 0 alone from
     the held-out ring (3 views, radius 3.1, height 1.2); mean PSNR.

Rank 0 prints the result as one JSON line with the keys of the JAX
package's PIPELINE_MC.json (unrounded) and writes it only to ``--out``; the
line before it holds every rank's report per stage (ms per step by part,
CUDA events on a card; collective bytes from ``Mesh.stats``; B1/B2
launches; peak memory; seconds), the checks' digests and the failed checks,
and goes to ``--report``. The process exits nonzero where a check fails:
a loss that is not finite, an overflow, stage 1's first step off the
single-process step, a replicated or broadcast tensor that differs
between ranks, a rank whose share is not capacity / world rows. Nothing
falls back: a CUDA device is required unless ``--device cpu``, and the
backend is the one asked for (NCCL by default on a card).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from frosting_tpu_torch.extract.shell import ShellConfig, extract_shell
from frosting_tpu_torch.models import frosting as frosting_lib
from frosting_tpu_torch.ops.ssim import psnr
from frosting_tpu_torch.parallel import collectives, multihost
from frosting_tpu_torch.parallel import sharded_frosting as sf
from frosting_tpu_torch.parallel import sharded_sugar as ssg
from frosting_tpu_torch.parallel import sharded_train as st
from frosting_tpu_torch.parallel.collectives import WORLD, Mesh
from frosting_tpu_torch.parallel.report import StageReport, digest, hold_gs_step, sync
from frosting_tpu_torch.pipeline import compact
from frosting_tpu_torch.raster import RasterConfig, render
from frosting_tpu_torch.scene import synthetic
from frosting_tpu_torch.scene.gaussians import GaussianParams, activate
from frosting_tpu_torch.train import frosting_trainer, gs_trainer, sugar_trainer
from frosting_tpu_torch.train import optimizer as opt_lib
from frosting_tpu_torch.utils.profiling import PartTimes

ROUTE = "sharded_params + primitive_exchange"
# The script's constants: its seed, cameras (8 on a ring of radius 3.0, 3
# held out on one of 3.1 at height 1.2), degraded init, spatial extent and
# neighbour count; rank 0 runs stages 3-4 alone while the others wait in
# the broadcast, so a collective's timeout allows for a full-width stage 3
SEED, VIEWS, EVAL_VIEWS, KEEP, EXTENT, KNN_K = 0, 8, 3, 0.7, 3.3, 8
TIMEOUT_S = 1800.0


@dataclasses.dataclass
class Scene:
    """The ground truth: training and held-out cameras, their views
    [n, 3, H, W] (numpy, rendered by the port) and the degraded init
    (points, colours)."""

    cams: list
    eval_cams: list
    gt: np.ndarray
    eval_gt: np.ndarray
    points: np.ndarray
    colors: np.ndarray


def make_scene(args, rcfg: RasterConfig, device) -> Scene:
    """The script's scene: ``gaussian_blob_scene(n, seed)`` (or, with
    ``--scene bench``, bench.py's cube of Gaussians) seen by a ring of 8
    cameras at radius 3.0 and a held-out ring at radius 3.1, height 1.2;
    the start is the cloud subsampled (keep) and jittered."""
    if args.scene == "blob":
        gt = synthetic.gaussian_blob_scene(n=args.scene_gaussians, seed=SEED, device=device)
    else:
        from frosting_tpu_torch.bench.common import bench_scene

        gt = tuple(torch.from_numpy(a).to(device) for a in bench_scene(
            args.scene_gaussians, SEED, -0.9, 0.9, 0.003, 0.015))
    cams = synthetic.camera_ring(n_cams=VIEWS, radius=3.0, device=device)
    eval_cams = synthetic.camera_ring(n_cams=EVAL_VIEWS, radius=3.1, height=1.2,
                                      device=device)
    bg = np.zeros(3, np.float32)
    gt_imgs = synthetic.render_gt_images(gt, cams, rcfg, bg)
    eval_imgs = synthetic.render_gt_images(gt, eval_cams, rcfg, bg)
    pts, cols = synthetic.degraded_init(gt, keep=KEEP, jitter=args.jitter)
    return Scene(cams, eval_cams, gt_imgs, eval_imgs, pts, cols)


def batch_schedule(n_cams: int, n_data: int, iters: Sequence[int], seed: int = 0):
    """Each stage's batches of camera indices, in the script's order: one
    generator, ``iters[s]`` draws of n_data cameras without replacement for
    stage s."""
    rng = np.random.default_rng(seed)
    return [[rng.choice(n_cams, n_data, replace=False) for _ in range(n)] for n in iters]


def _batch(mesh: Mesh, scene_cams, gt: np.ndarray, sel):
    return st.shard_batch(mesh, st.stack_cameras([scene_cams[i] for i in sel]), gt[sel])


def _losses(ms: List[torch.Tensor]) -> List[float]:
    return [float(v) for v in torch.stack(ms).cpu()] if ms else []


def _flags(metrics: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    """The largest overflow flags over a stage's steps."""
    out = {}
    for key in ("overflow", "exchange_overflow"):
        vals = [m[key] for m in metrics if key in m]
        if vals:
            out[key] = float(torch.stack(vals).max())
    return out


def run_stage1(mesh: Mesh, points, colors, scene_cams, gt, rcfg: RasterConfig, batches,
               capacity: int = 4096, extent: float = 3.3, state=None):
    """Sharded 3DGS (the step replicated over the mesh, no densify) from
    ``gs_trainer.init_state(points, colors)`` at ``capacity``, or from
    ``state`` (not modified). Rank 0 holds the first step against the
    single-process step on the same cameras and whole images
    (``report.hold_gs_step``: ``gs_trainer.train_step`` itself for one
    camera), outside the stage's launches and seconds. Returns
    (TrainState, losses, stage report)."""
    cfg = gs_trainer.GSTrainConfig(capacity=capacity)
    if state is None:
        state, opt = gs_trainer.init_state(points, colors, extent, cfg, device=mesh.device)
    else:
        state, opt = gs_trainer.clone_state(state), opt_lib.make_gs_optimizer(extent)
    step = st.make_sharded_train_step(opt, rcfg, cfg, mesh)
    rep = StageReport(mesh, mesh.device)
    metrics, held = [], {}
    for it, sel in enumerate(batches):
        cam, gt_strip = _batch(mesh, scene_cams, gt, sel)
        start = None
        if it == 0 and dist.get_rank() == 0:
            start = rep.aside(lambda: gs_trainer.clone_state(state))
        metrics.append(rep.step(lambda mark: step(state, cam, gt_strip, mark)[1]))
        if start is not None:
            gts = [torch.from_numpy(gt[i]).to(mesh.device) for i in sel]
            held = rep.aside(lambda: hold_gs_step(
                state, float(metrics[0]["loss"]), start, [scene_cams[i] for i in sel], gts,
                opt, rcfg, cfg)[0])
            del start
    losses = _losses([m["loss"] for m in metrics])
    extra = {"first_step": held} if held else {}
    return state, losses, rep.end(**extra, **_flags(metrics))


def run_stage2(mesh: Mesh, params: GaussianParams, scene_cams, gt, rcfg: RasterConfig,
               batches, extent: float = 3.3, n_sdf_samples: int = 4096, knn_k: int = 8,
               entropy_fraction: float = 0.4, knn_every: int = 25, seed: int = 0,
               draws=None, knn_fn=None):
    """Sharded coarse SuGaR (density method) from ``params`` (not
    modified): the entropy phase for the first ``entropy_fraction`` of the
    iterations, then the sdf phase; the KNN of the replicated parameters
    recomputed every ``knn_every`` iterations. Each rank's sdf draws come
    from a generator seeded by (seed + iteration, its index), or from
    ``draws[iteration]`` = (u, eps) where given. ``knn_fn(params,
    iteration)``, where given, makes the KNN in place of
    ``sugar_trainer.compute_knn``. Returns (params, losses, phase per
    iteration, stage report)."""
    cfg = sugar_trainer.SugarTrainConfig(method="density", n_sdf_samples=n_sdf_samples,
                                         knn_k=knn_k, spatial_extent=extent)
    opt = opt_lib.make_gs_optimizer(extent)
    params = GaussianParams(**{f.name: getattr(params, f.name).clone()
                               for f in dataclasses.fields(params)})
    opt_state = opt.init(params)
    steps = {ph: ssg.make_sharded_sugar_step(opt, rcfg, cfg, mesh, ph)
             for ph in ("entropy", "sdf")}
    n_entropy = int(round(entropy_fraction * len(batches)))
    rep = StageReport(mesh, mesh.device)
    metrics, phases, knn_idx = [], [], None
    for it, sel in enumerate(batches):
        ph = "entropy" if it < n_entropy else "sdf"
        if it % knn_every == 0:
            knn_idx = (knn_fn(params, it) if knn_fn is not None
                       else sugar_trainer.compute_knn(params, knn_k))
        cam, gt_strip = _batch(mesh, scene_cams, gt, sel)
        d = None if draws is None or ph != "sdf" else draws[it]
        metrics.append(rep.step(lambda mark: steps[ph](
            params, opt_state, cam, gt_strip, knn_idx, seed=seed + it, draws=d, mark=mark)))
        phases.append(ph)
    losses = _losses([m["loss"] for m in metrics])
    return params, losses, phases, rep.end(**_flags(metrics))


def run_stage3(mesh: Mesh, params: GaussianParams, scene_cams, rcfg: RasterConfig,
               shell_cfg: ShellConfig):
    """The live rows of ``params``, activated, and on rank 0 the shell
    extracted from them; the vertices and faces broadcast over the world.
    Returns (live rows, activated model, verts [V, 3] float32, faces
    [F, 3] int64 on the mesh's device, stage report)."""
    rep = StageReport(mesh, mesh.device)
    live = compact(params)
    model = activate(live)
    timings = {}
    if dist.get_rank() == 0:
        verts, faces, aux = extract_shell(*model[:4], scene_cams, rcfg, shell_cfg)
        timings = aux["timings_ms"]
        mine = [torch.from_numpy(np.asarray(verts, np.float32)),
                torch.from_numpy(np.asarray(faces, np.int64))]
    else:
        mine = None
    verts, faces = collectives.broadcast(mine, mesh, WORLD, src=0)
    return live, model, verts, faces, rep.end(parts_ms=timings)


def run_stage4(mesh: Mesh, verts: torch.Tensor, faces: torch.Tensor, model, live: GaussianParams,
               n_gaussians: int = 8192, knn_k: int = 8, extent: float = 3.3, seed: int = 1):
    """On rank 0, ``init_frosting`` on the shell with the activated live
    rows (SH from ``live``), its draws from a torch.Generator seeded
    ``seed``; the parameters and the meta's arrays broadcast over the world,
    and every rank's meta built from them. Returns (FrostingParams,
    FrostingMeta, stage report)."""
    rep = StageReport(mesh, mesh.device)
    fcfg = frosting_lib.FrostingConfig(n_gaussians=n_gaussians, knn_k=knn_k,
                                       avoid_self_intersections=False)
    names = [f.name for f in dataclasses.fields(frosting_lib.FrostingParams) if f.name != "bg"]
    parts = PartTimes(mesh.device)
    mine = None
    if dist.get_rank() == 0:
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed(seed)
        fparams, meta = frosting_lib.init_frosting(
            verts, faces, *model[:4], live, fcfg, extent, generator=gen, parts=parts)
        mine = [getattr(fparams, k) for k in names] + [meta.faces, meta.cell_idx,
                                                       meta.cell_bounds]
    got = collectives.broadcast(mine, mesh, WORLD, src=0)
    fparams = frosting_lib.FrostingParams(**dict(zip(names, got[:len(names)])))
    meta = frosting_lib.make_meta(*got[len(names):], n_verts=fparams.shell_verts.shape[0],
                                  device=mesh.device)
    return fparams, meta, rep.end(parts_ms=parts.result())


def run_stage5(mesh: Mesh, fparams: frosting_lib.FrostingParams, meta, scene_cams, gt,
               rcfg: RasterConfig, batches, extent: float = 3.3):
    """The sharded Frosting refinement from the whole ``fparams`` (not
    modified): this rank's share of the primitive leaves and its Adam
    moments, the primitive exchange with the script's max_instances /
    n_tile rows per pair of ranks (no more than a rank holds:
    ``sharded_train.route_projected``), ``len(batches)`` iterations on that
    learning-rate schedule. Returns (this rank's share, losses, stage
    report)."""
    n_tile = mesh.shape["tile"]
    cfg = frosting_trainer.FrostingTrainConfig(iterations=len(batches),
                                               lr_max_steps=len(batches))
    opt = frosting_trainer.make_frosting_optimizer(cfg, extent)
    share = sf.shard_frosting_params(mesh, fparams)
    share = sf.map_frosting_params(share, lambda x: x.clone(), lambda x: x.clone())
    opt_state = opt.init(frosting_trainer.param_groups(share))
    step = sf.make_sharded_frosting_step(
        opt, rcfg, cfg, mesh, meta, shard_params=True, primitive_exchange=True,
        exchange_cap=rcfg.max_instances // n_tile)
    rep = StageReport(mesh, mesh.device)
    metrics = []
    for sel in batches:
        cam, gt_strip = _batch(mesh, scene_cams, gt, sel)
        metrics.append(rep.step(lambda mark: step(share, opt_state, cam, gt_strip, mark)))
    losses = _losses([m["loss"] for m in metrics])
    rows = {"params": share.bary_logits.shape[0],
            "adam_mu": opt_state.mu["bary_logits"].shape[0],
            "adam_nu": opt_state.nu["sh_rest"].shape[0]}
    return share, losses, rep.end(rows=rows, **_flags(metrics))


def run_eval(mesh: Mesh, share: frosting_lib.FrostingParams, meta, eval_cams, eval_gt,
             rcfg: RasterConfig):
    """The whole model from every rank's share (a collective), then on rank
    0 a single-device render of each held-out view against its ground
    truth. Returns (the whole FrostingParams, [PSNR per view] on rank 0 and
    None elsewhere, stage report)."""
    rep = StageReport(mesh, mesh.device)
    whole = sf.unshard_frosting_params(mesh, share)
    psnrs = None
    if dist.get_rank() == 0:
        bg = torch.zeros(3, device=mesh.device)
        with torch.no_grad():
            model = frosting_lib.activate_frosting(whole, meta)
            psnrs = [float(psnr(torch.clamp(render(*model, cam, rcfg, bg=bg).image, 0.0, 1.0),
                                torch.from_numpy(img).to(mesh.device)))
                     for cam, img in zip(eval_cams, eval_gt)]
    return whole, psnrs, rep.end()


def _progress(name, stage):
    if dist.get_rank() == 0:
        print(f"[pipeline] {name}: {stage['seconds']:.1f} s, launches {stage['launches']}",
              file=sys.stderr, flush=True)


def _last10(losses):
    return float(np.mean(losses[-10:]))


def run(args, mesh: Mesh):
    """Every stage on this rank; returns (result on rank 0 / None, this
    rank's report)."""
    dev = mesh.device
    t_start = time.time()
    rcfg = RasterConfig(width=args.width, height=args.height, tile_w=args.tile_w,
                        tile_h=args.tile_h, chunk=args.chunk, max_instances=args.max_instances)
    report = {"rank": dist.get_rank(), "world": dist.get_world_size(),
              "backend": dist.get_backend(), "device": str(dev),
              "mesh": [mesh.shape["data"], mesh.shape["tile"]], "stages": {}, "digests": {}}
    stages, digests = report["stages"], report["digests"]
    rep = StageReport(mesh, dev)
    scene = make_scene(args, rcfg, dev)
    stages["scene"] = rep.end(views=len(scene.cams), eval_views=len(scene.eval_cams),
                              points=int(len(scene.points)))
    _progress("scene", stages["scene"])
    batches = batch_schedule(len(scene.cams), mesh.shape["data"],
                             (args.gs_iters, args.sugar_iters, args.refine_iters), seed=SEED)

    state, losses1, stages["gs_sharded"] = run_stage1(
        mesh, scene.points, scene.colors, scene.cams, scene.gt, rcfg, batches[0],
        args.capacity, EXTENT)
    _progress("stage 1", stages["gs_sharded"])
    digests["gs_sharded"] = digest([getattr(state.params, g) for g in opt_lib.GROUPS]
                                   + [state.params.mask])
    params2, losses2, phases, stages["sugar_sharded"] = run_stage2(
        mesh, state.params, scene.cams, scene.gt, rcfg, batches[1], EXTENT,
        args.sdf_samples, KNN_K, seed=SEED)
    del state
    _progress("stage 2", stages["sugar_sharded"])
    digests["sugar_sharded"] = digest([getattr(params2, f.name)
                                       for f in dataclasses.fields(params2)])
    shell_cfg = ShellConfig(poisson_resolution=args.poisson_resolution,
                            target_vertices=args.target_vertices, knn_k=KNN_K)
    live, model, verts, faces, stages["shell"] = run_stage3(mesh, params2, scene.cams, rcfg,
                                                            shell_cfg)
    del params2
    _progress("stage 3", stages["shell"])
    digests["shell"] = digest([verts, faces])
    fparams, meta, stages["frosting_init"] = run_stage4(
        mesh, verts, faces, model, live, args.frosting_gaussians, KNN_K, EXTENT,
        seed=SEED + 1)
    del live, model
    _progress("stage 4", stages["frosting_init"])
    digests["frosting_init"] = digest(list(frosting_trainer.param_groups(fparams).values())
                                      + [meta.faces, meta.cell_idx, meta.cell_bounds])
    digests["frosting_shell_is_the_shell"] = bool(torch.equal(fparams.shell_verts, verts))
    share, losses5, stages["refine_sharded"] = run_stage5(
        mesh, fparams, meta, scene.cams, scene.gt, rcfg, batches[2], EXTENT)
    del fparams
    _progress("stage 5", stages["refine_sharded"])
    digests["refine_sharded_vertex_leaves"] = digest(
        [getattr(share, k) for k in sf.VERTEX_LEAVES])
    whole, psnrs, stages["eval"] = run_eval(mesh, share, meta, scene.eval_cams,
                                            scene.eval_gt, rcfg)
    digests["refine_sharded_whole"] = digest(list(frosting_trainer.param_groups(whole).values()))
    for name, losses in (("gs_sharded", losses1), ("sugar_sharded", losses2),
                         ("refine_sharded", losses5)):
        stages[name]["losses"] = losses
    stages["sugar_sharded"]["phases"] = phases
    report["shell"] = [int(verts.shape[0]), int(faces.shape[0])]
    if dist.get_rank() != 0:
        return None, report
    result = {
        "mesh": f"{mesh.shape['data']}x{mesh.shape['tile']}",
        "stages": {
            "gs_sharded": {"iters": len(losses1), "loss_first": losses1[0],
                           "loss_last": _last10(losses1)},
            "sugar_sharded": {"iters": len(losses2), "loss_last": _last10(losses2)},
            "shell": {"verts": int(verts.shape[0]), "faces": int(faces.shape[0])},
            "frosting_init": {"n_gaussians": int(whole.bary_logits.shape[0])},
            "refine_sharded": {
                "iters": len(losses5), "route": ROUTE,
                "param_shard_rows_per_chip": int(share.bary_logits.shape[0]),
                "loss_first": losses5[0], "loss_last": _last10(losses5)},
        },
        "eval_psnr": float(np.mean(psnrs)),
        "wall_clock_s": time.time() - t_start,
    }
    return result, report


def failed_checks(reports: List[dict], frosting_gaussians: int) -> List[str]:
    """What failed over every rank's report."""
    bad = []
    r0 = reports[0]
    for r in reports:
        for name, stage in r["stages"].items():
            for loss in stage.get("losses", []):
                if not math.isfinite(loss):
                    bad.append(f"rank {r['rank']} {name}: a loss of {loss}")
                    break
            for flag in ("overflow", "exchange_overflow"):
                if stage.get(flag, 0) > 0:
                    bad.append(f"rank {r['rank']} {name}: {flag}")
        held = r["stages"]["gs_sharded"].get("first_step")
        if r["rank"] == 0 and not (held and held["ok"]):
            bad.append(f"stage 1's first step against the single-process step: {held}")
        rows = r["stages"]["refine_sharded"]["rows"]
        want = frosting_gaussians // r["world"]
        if any(v != want for v in rows.values()):
            bad.append(f"rank {r['rank']}: stage-5 rows {rows}, not {want}")
        if not r["digests"]["frosting_shell_is_the_shell"]:
            bad.append(f"rank {r['rank']}: the Frosting init's shell is not the broadcast shell")
        for key, value in r["digests"].items():
            if value != r0["digests"][key]:
                bad.append(f"rank {r['rank']}: {key} differs from rank 0's")
        if r["stages"]["gs_sharded"]["losses"] != r0["stages"]["gs_sharded"]["losses"]:
            bad.append(f"rank {r['rank']}: stage-1 losses differ from rank 0's")
    return bad


def run_checked(args, mesh: Mesh):
    """``run``, every rank's report gathered on every rank, and the failed
    checks over them: (result on rank 0 / None, reports, failed)."""
    result, report = run(args, mesh)
    sync(mesh.device)
    reports = [None] * dist.get_world_size()
    dist.all_gather_object(reports, report)
    return result, reports, failed_checks(reports, args.frosting_gaussians)


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="python -m frosting_tpu_torch.parallel.pipeline",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--backend", default=None,
                    help="nccl (the default on cuda) or gloo (the default on cpu)")
    ap.add_argument("--mesh", default="2x4", help="n_data x n_tile (default 2x4)")
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--tile-w", type=int, default=32)
    ap.add_argument("--tile-h", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--max-instances", type=int, default=1 << 15)
    ap.add_argument("--scene", choices=("blob", "bench"), default="blob",
                    help="gaussian_blob_scene (default) or bench.py's cube of Gaussians")
    ap.add_argument("--scene-gaussians", type=int, default=3000)
    ap.add_argument("--jitter", type=float, default=0.05,
                    help="the degraded init's jitter, world units")
    ap.add_argument("--capacity", type=int, default=4096)
    ap.add_argument("--gs-iters", type=int, default=150)
    ap.add_argument("--sugar-iters", type=int, default=100)
    ap.add_argument("--refine-iters", type=int, default=150)
    ap.add_argument("--sdf-samples", type=int, default=4096)
    ap.add_argument("--poisson-resolution", type=int, default=64)
    ap.add_argument("--target-vertices", type=int, default=2000)
    ap.add_argument("--frosting-gaussians", type=int, default=8192)
    ap.add_argument("--out", default=None, help="write the result JSON here")
    ap.add_argument("--report", default=None, help="write every rank's report here (JSON)")
    return ap.parse_args(argv)


def _write(path, obj):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(json.dumps(obj) + "\n")


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("pipeline: no CUDA device (pass --device cpu)", file=sys.stderr)
        return 1
    dev = multihost.local_device(args.device)
    multihost.start_world(args.backend, dev, TIMEOUT_S)
    world = dist.get_world_size()
    if world > 1:
        torch.set_num_threads(1)  # one per rank, as the launcher's OMP_NUM_THREADS
    n_data, n_tile = (int(v) for v in args.mesh.lower().split("x"))
    if n_data * n_tile != world:
        raise SystemExit(f"pipeline: a {args.mesh} mesh needs {n_data * n_tile} ranks, "
                         f"the world has {world}")
    if args.frosting_gaussians % world:
        raise SystemExit("pipeline: --frosting-gaussians must divide over the ranks")
    mesh = multihost.make_hybrid_mesh(n_data, n_tile, device=dev)
    result, reports, bad = run_checked(args, mesh)
    code = 0
    if dist.get_rank() == 0:
        line = {"pipeline_ranks": reports, "failed": bad}
        if args.report:
            _write(args.report, line)
        print(json.dumps(line))
        for r in reports:
            s = r["stages"]
            print(f"rank {r['rank']} ({r['backend']}, mesh {r['mesh'][0]}x{r['mesh'][1]}): "
                  + ", ".join(f"{k} {v['seconds']:.1f} s {v['launches']}" for k, v in s.items()),
                  file=sys.stderr)
        if bad:
            print("FAILED: " + "; ".join(bad), file=sys.stderr)
            code = 1
        if args.out:
            _write(args.out, result)
        print(json.dumps(result))
    codes = [code]
    dist.broadcast_object_list(codes, src=0)
    dist.destroy_process_group()
    return codes[0]


if __name__ == "__main__":
    sys.exit(main())
