"""Per-stage command line of the port: stage 1 (3DGS), stage 2 (coarse
SuGaR), stage 3 (shell extraction), refined SuGaR, stages 4-5 (the Frosting
layer), stage 6 (the textured mesh) and rendering of a scene on disk.

Counterpart of the ``train-gs``, ``train-sugar``, ``extract-shell``,
``train-refined-sugar``, ``train-frosting``, ``extract-texture``,
``render``, ``metrics``, ``full-eval`` and ``convert`` commands of
``frosting_tpu/stages_cli.py``. Each command reads and writes artifacts in
-o/--output (gs.ply, sugar.ply, shell.ply, shell_lowpoly.ply,
refined_sugar.npz / .ply, frosting.npz, frosting.ply, mesh.obj / .mtl /
.png, renders/, metrics.json), so the stages run and resume
independently:

  python -m frosting_tpu_torch.stages_cli train-gs       -s SCENE -o OUT [...]
  python -m frosting_tpu_torch.stages_cli train-sugar    -s SCENE -o OUT -r density|sdf|dn_consistency
  python -m frosting_tpu_torch.stages_cli extract-shell  -s SCENE -o OUT [--both-poly] [--method surface|centers|marching]
  python -m frosting_tpu_torch.stages_cli train-refined-sugar -s SCENE -o OUT [--gaussians-per-triangle 1|3|4|6]
  python -m frosting_tpu_torch.stages_cli train-frosting -s SCENE -o OUT [--occlusion-culling] [--learn-shell] [...]
  python -m frosting_tpu_torch.stages_cli extract-texture -s SCENE -o OUT [--texture-size 1024]
  python -m frosting_tpu_torch.stages_cli render         -s SCENE -o OUT
  python -m frosting_tpu_torch.stages_cli metrics        -s SCENE -o OUT [--eval]
  python -m frosting_tpu_torch.stages_cli full-eval      -s SCENE -o OUT [...]
  python -m frosting_tpu_torch.stages_cli convert        -s RAW_DIR

SCENE is a COLMAP scene (sparse/0 or sparse, and images/). The commands run
on the CUDA card by default; ``--device cpu`` runs them on the CPU, through
the blend kernels' plain versions. ``render`` and ``metrics`` render
frosting.npz where there is one, gs.ply otherwise; ``metrics`` writes
metrics.json (LPIPS where FROSTING_TPU_LPIPS_WEIGHTS names weights);
``convert`` needs the ``colmap`` binary on PATH.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch


def _common(p):
    p.add_argument("-s", "--scene", required=True)
    p.add_argument("-o", "--output", default="output")
    p.add_argument("--resolution-scale", type=int, default=1)
    p.add_argument("--eval", action="store_true")
    p.add_argument("--white-bg", action="store_true")
    p.add_argument("--max-instances", type=int, default=1 << 21)
    p.add_argument("--chunk", type=int, default=128)
    p.add_argument("--device", default="cuda")


def _load_scene(args):
    """(scene, train cameras, GT images [n, 3, H, W], RasterConfig)."""
    from frosting_tpu_torch.raster import RasterConfig
    from frosting_tpu_torch.scene import dataset

    scene = dataset.load_colmap_scene(
        args.scene,
        resolution_scale=args.resolution_scale,
        eval_split=args.eval,
        device=args.device,
    )
    cams = [c.camera for c in scene.train_cameras]
    gt = np.stack([c.image() for c in scene.train_cameras])
    h, w = gt.shape[-2:]
    rcfg = RasterConfig(
        width=w, height=h, chunk=args.chunk, max_instances=args.max_instances
    )
    os.makedirs(args.output, exist_ok=True)
    return scene, cams, gt, rcfg


def cmd_train_gs(args):
    """Returns the trainer's log-step metrics."""
    from frosting_tpu_torch.scene import gaussians as gauss_lib
    from frosting_tpu_torch.train import gs_trainer

    scene, cams, gt, rcfg = _load_scene(args)
    cfg = gs_trainer.GSTrainConfig(
        iterations=args.iterations,
        capacity=args.capacity,
        white_background=args.white_bg,
    )
    state, history = gs_trainer.train(
        cams, gt, scene.points, scene.colors, scene.spatial_extent, rcfg, cfg,
        device=args.device,
    )
    gauss_lib.save_ply(state.params, os.path.join(args.output, "gs.ply"))
    print("wrote", os.path.join(args.output, "gs.ply"))
    return history


def cmd_train_sugar(args):
    """Returns the trainer's log-step metrics."""
    from frosting_tpu_torch.scene import gaussians as gauss_lib
    from frosting_tpu_torch.train import sugar_trainer

    scene, cams, gt, rcfg = _load_scene(args)
    params = gauss_lib.load_ply(
        os.path.join(args.output, "gs.ply"), capacity=args.capacity,
        device=args.device,
    )
    cfg = sugar_trainer.SugarTrainConfig(
        method=args.regularization,
        start_iteration=args.start_iteration,
        iterations=args.iterations,
        spatial_extent=scene.spatial_extent,
        white_background=args.white_bg,
    )
    params, history = sugar_trainer.train(
        params, scene.spatial_extent, cams, gt, rcfg, cfg, device=args.device
    )
    gauss_lib.save_ply(params, os.path.join(args.output, "sugar.ply"))
    print("wrote", os.path.join(args.output, "sugar.ply"))
    return history


def _mesh_path(out):
    return os.path.join(out, "shell.ply")


def save_mesh(path, verts, faces):
    from frosting_tpu_torch.utils import ply as ply_io

    v = np.asarray(verts, np.float32)
    ply_io.write_ply(
        path, {"x": v[:, 0], "y": v[:, 1], "z": v[:, 2]},
        faces=np.asarray(faces, np.int32),
    )


def load_mesh(path):
    """(verts [V, 3] float32, faces [F, 3] int64) of a PLY mesh."""
    from frosting_tpu_torch.utils import ply as ply_io

    d = ply_io.read_ply(path)
    v = np.stack([d["vertex"]["x"], d["vertex"]["y"], d["vertex"]["z"]], 1).astype(np.float32)
    f = np.asarray(d["face"]["vertex_indices"], np.int64)
    return v, f


def cmd_extract_shell(args):
    """Extract shell.ply (and shell_lowpoly.ply with --both-poly) from
    sugar.ply; returns the extraction's aux (timings_ms per part, vertex
    and face counts)."""
    from frosting_tpu_torch.extract.shell import ShellConfig, extract_shell
    from frosting_tpu_torch.scene.gaussians import activate

    _scene, cams, _gt, rcfg = _load_scene(args)
    means, scales, quats, opac, _sh = activate(load_live_gaussians(
        os.path.join(args.output, "sugar.ply"), device=args.device))
    cfg = ShellConfig(
        surface_level=args.surface_level,
        poisson_resolution=args.poisson_resolution,
        target_vertices=200_000 if args.low_poly else 1_000_000,
        target_vertices_low=200_000 if args.both_poly else None,
        cleaning_quantile=args.cleaning_quantile,
        fg_split=args.fg_split,
        method=args.method,
        marching_resolution=args.marching_resolution,
    )
    with torch.no_grad():
        verts, faces, aux = extract_shell(
            means.detach(), scales.detach(), quats.detach(), opac.detach(), cams, rcfg, cfg,
            verbose=True)
    save_mesh(_mesh_path(args.output), verts, faces)
    print("wrote", _mesh_path(args.output), len(verts), "verts")
    out = {"timings_ms": aux["timings_ms"], "verts": len(verts), "faces": len(faces),
           "poisson_resolutions": aux.get("poisson_resolutions")}
    if "low_poly" in aux:
        lp = os.path.join(args.output, "shell_lowpoly.ply")
        save_mesh(lp, *aux["low_poly"])
        print("wrote", lp, len(aux["low_poly"][0]), "verts")
        out["verts_low"] = len(aux["low_poly"][0])
    return out


def load_live_gaussians(path, device="cuda"):
    """The live rows of a PLY checkpoint as GaussianParams."""
    from frosting_tpu_torch.pipeline import compact
    from frosting_tpu_torch.scene import gaussians as gauss_lib

    return compact(gauss_lib.load_ply(path, device=device))


def cmd_train_frosting(args):
    """Build the Frosting layer around shell.ply from sugar.ply (stage 4)
    and refine it (stage 5); write frosting.npz and frosting.ply. Returns
    the refinement's log-step metrics, the parts' times (ms), the
    initialised model (params, meta), the refined params and the culled
    iterations' instance capacity (None without culling)."""
    from frosting_tpu_torch.models import frosting as frosting_lib
    from frosting_tpu_torch.pipeline import export_frosting_ply
    from frosting_tpu_torch.scene.gaussians import activate
    from frosting_tpu_torch.train import checkpoint, frosting_trainer
    from frosting_tpu_torch.utils.profiling import PartTimes

    parts = PartTimes(args.device)
    scene, cams, gt, rcfg = _load_scene(args)
    params = load_live_gaussians(os.path.join(args.output, "sugar.ply"), device=args.device)
    verts, faces = load_mesh(_mesh_path(args.output))
    with torch.no_grad():
        means, scales, quats, opac, _sh = activate(params)
    fcfg = frosting_lib.FrostingConfig(n_gaussians=args.gaussians)
    with parts.device("init"):
        fparams, meta = frosting_lib.init_frosting(
            verts, faces, means, scales, quats, opac, params, fcfg, scene.spatial_extent,
            use_background=args.use_background,
            generator=torch.Generator(device=args.device).manual_seed(0), parts=parts)
    tcfg = frosting_trainer.FrostingTrainConfig(
        iterations=args.iterations,
        lr_max_steps=args.iterations,
        white_background=args.white_bg,
        use_occlusion_culling=args.occlusion_culling,
        learn_shell=args.learn_shell,
        regularize_shell=args.regularize_shell,
        normal_consistency_factor=args.normal_consistency_factor,
    )
    trained, history, rcfg_culled = frosting_trainer.train(
        fparams, meta, scene.spatial_extent, cams, gt, rcfg, tcfg, device=args.device,
        parts=parts)
    with parts.host("checkpoint write"):
        checkpoint.save_frosting(os.path.join(args.output, "frosting.npz"), trained, meta)
    with parts.host("PLY write"):
        export_frosting_ply(trained, meta, os.path.join(args.output, "frosting.ply"))
    print("wrote", os.path.join(args.output, "frosting.npz"))
    return {"history": history, "timings_ms": parts.result(), "init": (fparams, meta),
            "trained": trained,
            "culled_max_instances": None if rcfg_culled is None else rcfg_culled.max_instances}


def cmd_train_refined_sugar(args):
    """Refined (mesh-bound) SuGaR on shell.ply, seeded from sugar.ply; write
    refined_sugar.npz (JAX's leaves and dtypes) and refined_sugar.ply.
    Returns the log-step metrics, the parts' times (ms) and the trained
    (params, meta)."""
    from frosting_tpu_torch.models.mesh_bound import activate_mesh_bound
    from frosting_tpu_torch.pipeline import export_gaussians_ply, train_refined_sugar
    from frosting_tpu_torch.train import checkpoint
    from frosting_tpu_torch.utils.profiling import PartTimes

    parts = PartTimes(args.device)
    scene, cams, gt, rcfg = _load_scene(args)
    params = load_live_gaussians(os.path.join(args.output, "sugar.ply"), device=args.device)
    verts, faces = load_mesh(_mesh_path(args.output))
    rs_params, rs_meta, history = train_refined_sugar(
        verts, faces, params.means3d.detach(), params, scene.spatial_extent, cams, gt, rcfg,
        iterations=args.iterations, n_per_triangle=args.gaussians_per_triangle,
        white_background=args.white_bg, device=args.device, parts=parts)
    with parts.host("checkpoint write"):
        checkpoint.save_npz(os.path.join(args.output, "refined_sugar.npz"), rs_params)
    with parts.host("PLY write"), torch.no_grad():
        export_gaussians_ply(*activate_mesh_bound(rs_params, rs_meta),
                             os.path.join(args.output, "refined_sugar.ply"))
    print("wrote", os.path.join(args.output, "refined_sugar.ply"))
    return {"history": history, "timings_ms": parts.result(), "trained": (rs_params, rs_meta)}


def cmd_extract_texture(args):
    """Bake frosting.npz into mesh.obj / mesh.mtl / mesh.png (stage 6).
    Returns the parts' times (ms), the seen texel share and the texel
    counts."""
    from frosting_tpu_torch.extract import texture as texture_lib
    from frosting_tpu_torch.train import checkpoint
    from frosting_tpu_torch.utils.profiling import PartTimes

    parts = PartTimes(args.device)
    _scene, cams, _gt, rcfg = _load_scene(args)
    with parts.host("checkpoint load"):
        fparams, meta = checkpoint.load_frosting(
            os.path.join(args.output, "frosting.npz"), device=args.device)
    stats = texture_lib.extract_textured_mesh(
        fparams, meta, cams, rcfg, os.path.join(args.output, "mesh.obj"),
        texture_size=args.texture_size, parts=parts)
    print("wrote", os.path.join(args.output, "mesh.obj"))
    return {"timings_ms": parts.result(), **stats}


def _load_model(args):
    """The activated model to render: frosting.npz where there is one, the
    live rows of gs.ply otherwise."""
    from frosting_tpu_torch.models import frosting as frosting_lib
    from frosting_tpu_torch.scene.gaussians import activate
    from frosting_tpu_torch.train import checkpoint

    npz = os.path.join(args.output, "frosting.npz")
    with torch.no_grad():
        if os.path.exists(npz):
            return frosting_lib.to_gaussians(*checkpoint.load_frosting(npz, device=args.device))
        return activate(load_live_gaussians(os.path.join(args.output, "gs.ply"),
                                            device=args.device))


def cmd_render(args):
    """Render frosting.npz (or gs.ply where there is none) from the train
    and test cameras into renders/{split}_{i:05d}.png."""
    from frosting_tpu_torch.raster import render
    from frosting_tpu_torch.utils.png import encode_png

    scene, cams, _gt, rcfg = _load_scene(args)
    model = _load_model(args)
    bg = torch.full((3,), 1.0 if args.white_bg else 0.0, device=args.device)
    out_dir = os.path.join(args.output, "renders")
    os.makedirs(out_dir, exist_ok=True)
    test_cams = [c.camera for c in scene.test_cameras]
    with torch.inference_mode():
        for split, cs in (("train", cams), ("test", test_cams)):
            for i, cam in enumerate(cs):
                img = render(*model, cam, rcfg, bg=bg).image.cpu().numpy()
                img = np.clip(img, 0, 1)
                data = encode_png((img.transpose(1, 2, 0) * 255).astype(np.uint8))
                with open(os.path.join(out_dir, f"{split}_{i:05d}.png"), "wb") as f:
                    f.write(data)
    print("wrote", out_dir)


def cmd_metrics(args):
    """PSNR / SSIM (/ LPIPS) of frosting.npz (or gs.ply) over the test
    split, or the train views where there is none, into metrics.json.
    Returns the metrics."""
    from frosting_tpu_torch import metrics as metrics_lib
    from frosting_tpu_torch.raster import render

    scene, cams, gt, rcfg = _load_scene(args)
    model = _load_model(args)
    bg = torch.full((3,), 1.0 if args.white_bg else 0.0, device=args.device)
    eval_cams = [c.camera for c in scene.test_cameras] or cams
    eval_gt = np.stack([c.image() for c in scene.test_cameras]) if scene.test_cameras else gt
    with torch.inference_mode():
        res = metrics_lib.evaluate_views(
            lambda cam: render(*model, cam, rcfg, bg=bg).image, eval_cams, eval_gt,
            lpips=metrics_lib.get_lpips(args.device))
    metrics_lib.write_metrics(os.path.join(args.output, "metrics.json"), res)
    print(json.dumps(res))
    return res


def cmd_full_eval(args):
    """train-gs -> train-sugar -> extract-shell -> train-frosting ->
    metrics, sequentially (full_eval.py analogue): the JAX package's chain,
    each command given this one's --device."""
    common = ["-s", args.scene, "-o", args.output,
              "--resolution-scale", str(args.resolution_scale)]
    if args.eval:
        common.append("--eval")
    if args.white_bg:
        common.append("--white-bg")
    common += ["--device", args.device]
    main(["train-gs", *common, "--iterations", str(args.iterations),
          "--capacity", str(args.capacity)])
    main(["train-sugar", *common, "-r", args.regularization,
          "--start-iteration", str(args.iterations),
          "--capacity", str(args.capacity)])
    main(["extract-shell", *common]
         + (["--low-poly"] if args.low_poly else [])
         + (["--fg-split"] if args.fg_split else []))
    main(["train-frosting", *common, "--gaussians", str(args.gaussians)]
         + (["--use-background"] if args.use_background else [])
         + (["--occlusion-culling"] if args.occlusion_culling else []))
    main(["metrics", *common])


def cmd_convert(args):
    """COLMAP driver (gaussian_splatting/convert.py analogue): runs the
    colmap binary on a raw image folder if available."""
    import shutil
    import subprocess

    if shutil.which("colmap") is None:
        sys.exit(
            "convert requires the `colmap` binary on PATH "
            "(feature extraction + mapper), which this environment "
            "does not ship. Provide a scene with sparse/0 instead."
        )
    src = args.scene
    db = os.path.join(src, "distorted", "database.db")
    os.makedirs(os.path.dirname(db), exist_ok=True)
    for cmdline in (
        ["colmap", "feature_extractor", "--database_path", db,
         "--image_path", os.path.join(src, "input"),
         "--ImageReader.camera_model", "OPENCV"],
        ["colmap", "exhaustive_matcher", "--database_path", db],
        ["colmap", "mapper", "--database_path", db,
         "--image_path", os.path.join(src, "input"),
         "--output_path", os.path.join(src, "distorted", "sparse")],
    ):
        subprocess.run(cmdline, check=True)
    print("COLMAP reconstruction complete")


def build_parser():
    p = argparse.ArgumentParser(prog="frosting_tpu_torch.stages_cli")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("train-gs")
    _common(sp)
    sp.add_argument("--iterations", type=int, default=7_000)
    sp.add_argument("--capacity", type=int, default=1 << 19)
    sp.set_defaults(fn=cmd_train_gs)

    sp = sub.add_parser("train-sugar")
    _common(sp)
    sp.add_argument(
        "-r", "--regularization", default="density",
        choices=["density", "sdf", "dn_consistency"],
    )
    sp.add_argument("--start-iteration", type=int, default=7_000)
    sp.add_argument("--iterations", type=int, default=8_000)
    sp.add_argument("--capacity", type=int, default=1 << 19)
    sp.set_defaults(fn=cmd_train_sugar)

    sp = sub.add_parser("extract-shell")
    _common(sp)
    sp.add_argument("--surface-level", type=float, default=0.3)
    sp.add_argument("--poisson-resolution", type=int, default=0)
    sp.add_argument("--cleaning-quantile", type=float, default=0.1)
    sp.add_argument("--low-poly", action="store_true")
    # BOTH the 1M high-poly and a 200k low-poly mesh from one
    # reconstruction (shell.ply + shell_lowpoly.ply), coarse_shell.py:105-108
    sp.add_argument("--both-poly", action="store_true")
    sp.add_argument("--fg-split", action="store_true")
    sp.add_argument("--method", default="surface", choices=["surface", "centers", "marching"])
    sp.add_argument("--marching-resolution", type=int, default=256)
    sp.set_defaults(fn=cmd_extract_shell)

    sp = sub.add_parser("train-frosting")
    _common(sp)
    sp.add_argument("--gaussians", type=int, default=2_000_000)
    sp.add_argument("--iterations", type=int, default=15_000)
    sp.add_argument("--use-background", action="store_true")
    sp.add_argument("--occlusion-culling", action="store_true")
    sp.add_argument("--learn-shell", action="store_true")
    sp.add_argument("--regularize-shell", action="store_true")
    sp.add_argument("--normal-consistency-factor", type=float, default=0.1)
    sp.set_defaults(fn=cmd_train_frosting)

    sp = sub.add_parser("train-refined-sugar")
    _common(sp)
    sp.add_argument("--iterations", type=int, default=2_000)
    sp.add_argument("--gaussians-per-triangle", type=int, default=6, choices=[1, 3, 4, 6])
    sp.set_defaults(fn=cmd_train_refined_sugar)

    sp = sub.add_parser("extract-texture")
    _common(sp)
    sp.add_argument("--texture-size", type=int, default=1024)
    sp.set_defaults(fn=cmd_extract_texture)

    sp = sub.add_parser("render")
    _common(sp)
    sp.set_defaults(fn=cmd_render)

    sp = sub.add_parser("metrics")
    _common(sp)
    sp.set_defaults(fn=cmd_metrics)

    sp = sub.add_parser("full-eval")
    _common(sp)
    sp.add_argument("--iterations", type=int, default=7_000)
    sp.add_argument("--capacity", type=int, default=1 << 19)
    sp.add_argument(
        "-r", "--regularization", default="density",
        choices=["density", "sdf", "dn_consistency"],
    )
    sp.add_argument("--low-poly", action="store_true")
    sp.add_argument("--fg-split", action="store_true")
    sp.add_argument("--gaussians", type=int, default=2_000_000)
    sp.add_argument("--use-background", action="store_true")
    sp.add_argument("--occlusion-culling", action="store_true")
    sp.set_defaults(fn=cmd_full_eval)

    sp = sub.add_parser("convert")
    sp.add_argument("-s", "--scene", required=True)
    sp.set_defaults(fn=cmd_convert)
    return p


def main(argv=None):
    """Run one command; returns what the command returns (train-gs and
    train-sugar: their log-step metrics; extract-shell: its timings and
    counts; train-frosting: its metrics, timings, initialised and refined
    models; train-refined-sugar: its metrics, timings and trained model;
    extract-texture: its timings and texel statistics; metrics: the
    metrics)."""
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
