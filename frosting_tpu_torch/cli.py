"""Command-line entry point: the train_full_pipeline.py analogue.

Usage:
  python -m frosting_tpu_torch.cli -s <colmap_scene_dir> -o <output_dir> \
      [--regularization density|sdf|dn_consistency] [--gaussians 2000000] \
      [--refinement-time short|medium|long] [--low-poly] [--white-bg] \
      [--export-obj] [--eval] [--tiny] [--device cuda|cpu]

Counterpart of ``frosting_tpu/cli.py``, with its flags and defaults plus
``--device`` (default ``cuda``; ``cpu`` runs the blend kernels' plain
versions). Runs all six stages in process (``pipeline.run_pipeline``) and
writes:
  output/<name>/gs.ply            vanilla 3DGS checkpoint (viewer PLY)
  output/<name>/sugar.ply         coarse SuGaR checkpoint
  output/<name>/shell.ply         extracted base mesh
  output/<name>/frosting.ply      refined frosting as viewer PLY
  output/<name>/frosting.npz      frosting params (exact resume)
  output/<name>/mesh.obj/.mtl/.png  textured mesh (--export-obj)
  output/<name>/metrics.json      eval-split PSNR/SSIM(/LPIPS) (--eval)

``main`` is parse -> ``load_scene`` -> ``build_config`` -> ``run_pipeline``
-> ``write_outputs``; a caller may change the config between the steps.
The JAX CLI's multi-host initialisation has no counterpart yet.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="frosting_tpu_torch.cli", description=__doc__)
    p.add_argument("-s", "--scene", required=True, help="COLMAP scene dir")
    p.add_argument("-o", "--output", default="output")
    p.add_argument(
        "-r", "--regularization", default="density",
        choices=["density", "sdf", "dn_consistency"],
    )
    p.add_argument("--gaussians", type=int, default=2_000_000)
    p.add_argument(
        "--refinement-time", default="long", choices=["short", "medium", "long"],
    )
    p.add_argument("--low-poly", action="store_true")
    p.add_argument("--white-bg", action="store_true")
    p.add_argument("--export-obj", action="store_true")
    p.add_argument("--eval", action="store_true", help="hold out every 8th view")
    p.add_argument("--resolution-scale", type=int, default=1)
    p.add_argument("--iterations-3dgs", type=int, default=7_000)
    p.add_argument("--capacity", type=int, default=1 << 19)
    p.add_argument("--max-instances", type=int, default=1 << 21)
    p.add_argument(
        "--learn-shell", action="store_true",
        help="optimize the shell inner/outer offsets during refinement "
        "(train.py --learn_shell)",
    )
    p.add_argument(
        "--regularize-shell", action="store_true",
        help="normal-consistency regularization of the learned offset "
        "surfaces (train.py --regularize_shell)",
    )
    p.add_argument(
        "-n", "--normal-consistency-factor", type=float, default=0.1,
        help="weight of the shell normal-consistency term (train.py:68)",
    )
    p.add_argument(
        "--tiny", action="store_true",
        help="minutes-scale smoke preset (tiny budgets for all stages)",
    )
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def raster_config(args, width: int, height: int):
    """The RasterConfig of the flags at the scene's image size."""
    from frosting_tpu_torch.raster import RasterConfig

    return RasterConfig(width=width, height=height, chunk=32 if args.tiny else 128,
                        max_instances=8192 if args.tiny else args.max_instances)


def load_scene(args):
    """(scene, train cameras, GT images [n, 3, H, W], RasterConfig, output
    directory output/<scene name>, created)."""
    from frosting_tpu_torch.scene import dataset

    scene = dataset.load_colmap_scene(
        args.scene, resolution_scale=args.resolution_scale, eval_split=args.eval,
        device=args.device)
    out_dir = os.path.join(args.output, os.path.basename(os.path.normpath(args.scene)))
    os.makedirs(out_dir, exist_ok=True)
    cams = [c.camera for c in scene.train_cameras]
    gt = np.stack([c.image() for c in scene.train_cameras])
    return scene, cams, gt, raster_config(args, gt.shape[-1], gt.shape[-2]), out_dir


def build_config(args, spatial_extent: float):
    """The PipelineConfig of the flags: the --tiny preset, or the full
    budgets (JAX's cli.py:109-169)."""
    from frosting_tpu_torch import pipeline
    from frosting_tpu_torch.extract.shell import ShellConfig
    from frosting_tpu_torch.models import frosting as frosting_lib
    from frosting_tpu_torch.train import frosting_trainer, gs_trainer, sugar_trainer

    refine_iters = {"short": 2_000, "medium": 7_000, "long": 15_000}[args.refinement_time]
    if args.tiny:
        return pipeline.PipelineConfig(
            gs=gs_trainer.GSTrainConfig(
                iterations=80, capacity=min(args.capacity, 2048),
                densify_from=10_000, opacity_reset_interval=10_000,
                sh_increase_interval=30, log_every=40,
                white_background=args.white_bg,
            ),
            sugar=sugar_trainer.SugarTrainConfig(
                method=args.regularization, start_iteration=81,
                iterations=160, entropy_from=80, entropy_until=110,
                sdf_from=110, hard_prune_at=115, hard_prune_threshold=0.1,
                n_sdf_samples=2048, reset_neighbors_every=40, knn_k=8,
                spatial_extent=spatial_extent, log_every=40,
                white_background=args.white_bg,
            ),
            shell=ShellConfig(poisson_resolution=64, target_vertices=3000, knn_k=8),
            frosting=frosting_lib.FrostingConfig(n_gaussians=4096, knn_k=8),
            refine=frosting_trainer.FrostingTrainConfig(
                iterations=120, lr_max_steps=120, log_every=40,
                white_background=args.white_bg,
                learn_shell=args.learn_shell,
                regularize_shell=args.regularize_shell,
                normal_consistency_factor=args.normal_consistency_factor,
            ),
        )
    return pipeline.PipelineConfig(
        gs=gs_trainer.GSTrainConfig(
            iterations=args.iterations_3dgs,
            capacity=args.capacity,
            white_background=args.white_bg,
        ),
        sugar=sugar_trainer.SugarTrainConfig(
            method=args.regularization,
            start_iteration=args.iterations_3dgs,
            spatial_extent=spatial_extent,
            white_background=args.white_bg,
        ),
        shell=ShellConfig(target_vertices=200_000 if args.low_poly else 1_000_000),
        frosting=frosting_lib.FrostingConfig(n_gaussians=args.gaussians),
        refine=frosting_trainer.FrostingTrainConfig(
            iterations=refine_iters,
            lr_max_steps=refine_iters,
            white_background=args.white_bg,
            learn_shell=args.learn_shell,
            regularize_shell=args.regularize_shell,
            normal_consistency_factor=args.normal_consistency_factor,
        ),
        use_background_gaussians=(args.regularization == "sdf"),
    )


def write_outputs(args, out, scene, cams, rcfg, out_dir, parts=None):
    """Write run_pipeline's artifacts to out_dir; with test cameras, render
    them and write metrics.json. Returns the metrics, or None. gs.ply is
    written only where stage 1 ran (not resumed from a cache)."""
    from frosting_tpu_torch import metrics as metrics_lib
    from frosting_tpu_torch import pipeline
    from frosting_tpu_torch.models.frosting import activate_frosting
    from frosting_tpu_torch.raster import render
    from frosting_tpu_torch.scene import gaussians as gauss_lib
    from frosting_tpu_torch.train import checkpoint
    from frosting_tpu_torch.utils import ply as ply_io
    from frosting_tpu_torch.utils.profiling import PartTimes

    parts = parts or PartTimes(args.device)
    fparams, meta = out["frosting_params"], out["frosting_meta"]
    if "gs_state" in out:
        with parts.host("gs.ply write"):
            gauss_lib.save_ply(out["gs_state"].params, os.path.join(out_dir, "gs.ply"))
    with parts.host("sugar.ply write"):
        gauss_lib.save_ply(out["sugar_params"], os.path.join(out_dir, "sugar.ply"))
    with parts.host("shell.ply write"):
        v = out["shell_verts"]
        ply_io.write_ply(os.path.join(out_dir, "shell.ply"),
                         {"x": v[:, 0], "y": v[:, 1], "z": v[:, 2]}, faces=out["shell_faces"])
    with parts.host("frosting.ply write"):
        pipeline.export_frosting_ply(fparams, meta, os.path.join(out_dir, "frosting.ply"))
    with parts.host("frosting.npz write"):
        checkpoint.save_frosting(os.path.join(out_dir, "frosting.npz"), fparams, meta)

    if args.export_obj:
        from frosting_tpu_torch.extract import texture as texture_lib

        with parts.host("textured mesh (bake + OBJ)"):
            texture_lib.extract_textured_mesh(fparams, meta, cams, rcfg,
                                              os.path.join(out_dir, "mesh.obj"))

    if not scene.test_cameras:
        return None
    with parts.host("metrics"), torch.inference_mode():
        model = activate_frosting(fparams, meta)
        bg = torch.full((3,), 1.0 if args.white_bg else 0.0, device=args.device)
        results = metrics_lib.evaluate_views(
            lambda cam: render(*model, cam, rcfg, bg=bg).image,
            [c.camera for c in scene.test_cameras],
            np.stack([c.image() for c in scene.test_cameras]),
            metrics_lib.get_lpips(args.device),
        )
        del model
    metrics_lib.write_metrics(os.path.join(out_dir, "metrics.json"), results)
    print("eval:", results)
    return results


def main(argv=None):
    """Run the pipeline; returns (run_pipeline's result, the metrics or
    None)."""
    from frosting_tpu_torch import pipeline
    from frosting_tpu_torch.parallel import multihost

    args = build_parser().parse_args(argv)
    # a no-op in one process; under a launcher, the process group first
    multihost.initialize(device=args.device)
    scene, cams, gt, rcfg, out_dir = load_scene(args)
    cfg = build_config(args, scene.spatial_extent)
    out = pipeline.run_pipeline(cams, gt, scene.points, scene.colors, scene.spatial_extent,
                                rcfg, cfg, device=args.device)
    results = write_outputs(args, out, scene, cams, rcfg, out_dir)
    print(f"done -> {out_dir}")
    return out, results


if __name__ == "__main__":
    main()
