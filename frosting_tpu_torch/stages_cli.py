"""Per-stage command line of the port: stage 1 (3DGS), stage 2 (coarse
SuGaR), stage 3 (shell extraction) and rendering of a scene on disk.

Counterpart of the ``train-gs``, ``train-sugar``, ``extract-shell`` and
``render`` commands of ``frosting_tpu/stages_cli.py``. Each command reads
and writes artifacts in -o/--output (gs.ply, sugar.ply, shell.ply,
shell_lowpoly.ply, renders/), so the stages run and resume independently:

  python -m frosting_tpu_torch.stages_cli train-gs      -s SCENE -o OUT [...]
  python -m frosting_tpu_torch.stages_cli train-sugar   -s SCENE -o OUT -r density|sdf|dn_consistency
  python -m frosting_tpu_torch.stages_cli extract-shell -s SCENE -o OUT [--both-poly] [--method surface|centers|marching]
  python -m frosting_tpu_torch.stages_cli render        -s SCENE -o OUT

SCENE is a COLMAP scene (sparse/0 or sparse, and images/). The commands run
on the CUDA card by default; ``--device cpu`` runs them on the CPU, through
the blend kernels' plain versions. ``render`` renders gs.ply: the frosting
model's branch of the JAX command is not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

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
    from frosting_tpu_torch.scene import gaussians as gauss_lib

    params = gauss_lib.load_ply(path, device=device)
    live = params.mask > 0.5
    return type(params)(**{
        f.name: getattr(params, f.name)[live] for f in dataclasses.fields(params)
    })


def cmd_render(args):
    """Render gs.ply from the train and test cameras into
    renders/{split}_{i:05d}.png."""
    from frosting_tpu_torch.raster import render
    from frosting_tpu_torch.scene.gaussians import activate
    from frosting_tpu_torch.utils.png import encode_png

    if os.path.exists(os.path.join(args.output, "frosting.npz")):
        raise NotImplementedError(
            "rendering a frosting.npz model is not ported yet; "
            "this command renders gs.ply")
    scene, cams, _gt, rcfg = _load_scene(args)
    model = activate(load_live_gaussians(
        os.path.join(args.output, "gs.ply"), device=args.device))
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

    sp = sub.add_parser("render")
    _common(sp)
    sp.set_defaults(fn=cmd_render)
    return p


def main(argv=None):
    """Run one command; returns what the command returns (the training
    commands: their log-step metrics; extract-shell: its timings and
    counts)."""
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
