"""Render Blender-edited or animated scenes: the render_blender_scene.py
analogue (reference :17-156).

Counterpart of ``frosting_tpu/blender_cli.py``, with its flags and a
``--device`` (``cuda`` by default; ``cpu`` runs the blend's plain version):

  python -m frosting_tpu_torch.blender_cli \\
      --package scene_package.json \\
      --checkpoints modelA.npz modelB.npz \\
      --out frames/ [--width 1920 --height 1080] [--frames 0 100] \\
      [--deformation-threshold 2.0] [--adaptation simple|complex] \\
      [--occlusion-culling] [--max-instances N]

Each checkpoint is a ``save_frosting`` npz whose mesh index matches the
package's mesh order. Per frame: LBS-pose each armatured mesh, rebuild the
composite shell, adapt the covariances and SH through the per-cell
transforms, and render from the package's camera track through the forward
blend (B1), one launch per frame. Frames are written as
``frame_{i:05d}.png`` by ``utils/png.py`` (no PIL).
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch


def build_parser():
    p = argparse.ArgumentParser(prog="frosting_tpu_torch.blender_cli", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--package", required=True)
    p.add_argument("--checkpoints", nargs="+", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--width", type=int, default=0, help="0 = package camera")
    p.add_argument("--height", type=int, default=0)
    p.add_argument("--frames", type=int, nargs=2, default=None)
    p.add_argument("--deformation-threshold", type=float, default=2.0)
    # reference flags: --adaptation {simple,complex}, thickness rescaling
    # method {median,triangle,none} (render_blender_scene.py:17-156)
    p.add_argument("--adaptation", choices=["simple", "complex"], default="complex")
    p.add_argument("--thickness-rescale", choices=["median", "triangle", "none"],
                   default="median")
    p.add_argument("--max-instances", type=int, default=1 << 21)
    # reference flags (render_blender_scene.py:42-61)
    p.add_argument("--white-background", action="store_true")
    p.add_argument("--sh-degree", type=int, default=3)
    p.add_argument(
        "--export-frame-as-ply", type=int, default=None,
        help="export this frame's edited Gaussians as a viewer-compatible PLY "
        "(covariances eigendecomposed to scales/quats; SH coefficients exported "
        "unrotated, like the reference's convert_frosting_into_gaussians path)")
    p.add_argument(
        "--render-background-gaussians", action=argparse.BooleanOptionalAction, default=True,
        help="composite the (world-transformed) background Gaussians of the first "
        "checkpoint that has them (reference default True)")
    p.add_argument(
        "--occlusion-culling", action="store_true",
        help="render only Gaussians whose shell face is visible this frame (posed-shell "
        "rasterization), padded to one capacity over all frames as the JAX CLI does")
    p.add_argument("--device", default="cuda")
    return p


@torch.no_grad()
def edited_to_gaussian_params(eg, sh_degree: int):
    """EditedGaussians -> viewer-layout GaussianParams: the transformed
    covariances eigendecomposed into (scales, quats). SH coefficients stay
    unrotated, as the reference's PLY export keeps them
    (blender/frosting_utils.py:577-578 -> convert_frosting_into_gaussians)."""
    from frosting_tpu_torch.ops import cov as cov_ops
    from frosting_tpu_torch.ops import quat as quat_ops
    from frosting_tpu_torch.scene.gaussians import GaussianParams, inverse_sigmoid

    eigval, eigvec = torch.linalg.eigh(cov_ops.unpack_cov3d(eg.cov6))
    scales = torch.sqrt(torch.clamp(eigval, min=1e-14))  # [N, 3] ascending
    rot = torch.where(torch.linalg.det(eigvec)[:, None, None] < 0, -eigvec, eigvec)
    n = eg.means.shape[0]
    return GaussianParams(
        means3d=eg.means,
        sh_dc=eg.sh[:, :1],
        sh_rest=eg.sh[:, 1:],
        scales_log=torch.log(scales),
        quats_raw=quat_ops.from_matrix(rot),
        opacities_raw=inverse_sigmoid(torch.clamp(eg.opacities, 1e-5, 1 - 1e-5)),
        mask=torch.ones((n,), device=eg.means.device),
    )


def package_camera(package, i_frame, width, height, device="cuda"):
    """A Camera from the package's per-frame camera track
    (render_blender_scene.py's camera handling)."""
    from frosting_tpu_torch.cameras import make_camera

    cam = package["raw"]["camera"]
    lens = float(cam["lens"][i_frame % len(cam["lens"])])
    sensor = float(cam.get("sensor_width", 36.0))
    fov_x = 2.0 * math.atan(sensor / (2.0 * lens))
    m = np.asarray(cam["matrix_world"][i_frame % len(cam["matrix_world"])], np.float64)
    # Blender's camera looks down -Z with +Y up; to the 3DGS convention
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    w2c = np.linalg.inv(m @ flip)
    aspect = height / max(width, 1)
    fov_y = 2.0 * math.atan(math.tan(fov_x / 2.0) * aspect)
    return make_camera(w2c[:3, :3].T, w2c[:3, 3], fov_x, fov_y, device=device)


def main(argv=None):
    """Render the frames; returns per-frame stats (adaptation and render ms,
    the masked Gaussians of the complex adaptation, the instances and
    overflow), the polar factor's SVD ms per frame and the culled
    capacity (None without culling)."""
    args = build_parser().parse_args(argv)

    from frosting_tpu_torch.models import editing
    from frosting_tpu_torch.ops import mesh_raster
    from frosting_tpu_torch.raster import RasterConfig
    from frosting_tpu_torch.scene.gaussians import save_ply
    from frosting_tpu_torch.train.checkpoint import load_frosting
    from frosting_tpu_torch.utils.png import encode_png
    from frosting_tpu_torch.utils.profiling import PartTimes

    dev = args.device
    package = editing.load_blender_package(args.package)
    models = [load_frosting(p, device=dev) for p in args.checkpoints]
    scene = editing.build_composite_scene(models)
    del models

    cam_meta = package["raw"]["camera"]
    n_frames = len(cam_meta["lens"])
    f0, f1 = args.frames if args.frames else (0, n_frames)
    width = args.width or int(cam_meta.get("width", 1920))
    height = args.height or int(cam_meta.get("height", 1080))
    rcfg = RasterConfig(width=width, height=height, chunk=128, max_instances=args.max_instances)
    bg = torch.ones((3,), device=dev) if args.white_background else None
    meshes = [None if m is None else {k: torch.as_tensor(m[k], device=dev) for k in (
        "tpose_points", "weights", "rest_matrices", "pose_matrices")}
        for m in package["meshes"]]

    def posed_verts(i_frame):
        verts = scene.params.shell_verts
        for i_mesh, mesh in enumerate(meshes):
            if mesh is None:
                continue
            posed = editing.lbs_pose_verts(mesh["tpose_points"], mesh["weights"],
                                           mesh["rest_matrices"],
                                           mesh["pose_matrices"][:, i_frame % n_frames])
            s, e = scene.vert_ranges[i_mesh]
            verts = torch.cat([verts[:s], posed, verts[e:]])
        return verts

    def adapt(verts, parts):
        if args.adaptation == "simple":
            return editing.adapt_frosting_simple(scene.params, scene.meta, verts,
                                                 thickness_rescale=args.thickness_rescale)
        # the deformation-threshold opacity masking applies only to the
        # complex adaptation (blender/frosting_utils.py:532)
        return editing.adapt_frosting(scene.params, scene.meta, verts,
                                      deformation_threshold=args.deformation_threshold,
                                      thickness_rescale=args.thickness_rescale, parts=parts)

    # Occlusion culling (render_blender_scene.py:47-49): rasterize the POSED
    # shell per frame, keep the Gaussians of the seen cells, every frame
    # padded to one capacity (a multiple of 1024) with zero-opacity rows, as
    # the JAX CLI does
    vis_by_frame, cap = {}, None
    if args.occlusion_culling:
        cell_idx = scene.meta.cell_idx
        n_faces = scene.meta.faces.shape[0]
        masks = []
        for i_frame in range(f0, f1):
            pf = mesh_raster.rasterize_mesh(
                posed_verts(i_frame), scene.meta.faces,
                package_camera(package, i_frame, width, height, dev), rcfg).pix_to_face
            seen = torch.zeros((n_faces + 1,), dtype=torch.bool, device=dev)
            seen[pf[pf >= 0]] = True
            masks.append(seen[cell_idx])
        cap = -(-max(int(m.sum()) for m in masks) // 1024) * 1024
        for i_frame, m in zip(range(f0, f1), masks):
            order = torch.argsort((~m).to(torch.uint8), stable=True)[:cap]
            vis_by_frame[i_frame] = (order, m[order])
        print(f"occlusion culling: {len(cell_idx)} gaussians -> capacity {cap} "
              f"({cap / max(len(cell_idx), 1):.0%})")

    bg_eg = None
    if args.render_background_gaussians and scene.params.bg is not None:
        bg_eg = editing.background_to_edited(scene.params.bg)

    os.makedirs(args.out, exist_ok=True)
    frames = []
    for i_frame in range(f0, f1):
        parts = PartTimes(dev)
        with parts.device("adaptation"):
            eg = adapt(posed_verts(i_frame), parts)
        cam = package_camera(package, i_frame, width, height, dev)
        if args.export_frame_as_ply is not None and i_frame == args.export_frame_as_ply:
            if bg_eg is not None:
                eg = editing.concat_edited(eg, bg_eg)
            path = os.path.join(args.out, f"frame_{i_frame:05d}.ply")
            save_ply(edited_to_gaussian_params(eg, args.sh_degree), path)
            print(f"frame {i_frame} exported as PLY: {path}")
            continue
        masked = int((eg.opacities == 0).sum()) if args.adaptation == "complex" else 0
        if args.occlusion_culling:
            idx, valid = vis_by_frame[i_frame]
            eg = editing.EditedGaussians(
                means=eg.means[idx], cov6=eg.cov6[idx],
                opacities=torch.where(valid, eg.opacities[idx], 0.0),
                sh=eg.sh[idx], sh_rotations=eg.sh_rotations[idx])
        # background Gaussians composite after culling (always kept, like the
        # reference's visibility handling of the background)
        if bg_eg is not None:
            eg = editing.concat_edited(eg, bg_eg)
        with torch.inference_mode(), parts.device("render"):
            out = editing.render_edited(eg, cam, rcfg, bg=bg, active_sh_degree=args.sh_degree)
        img = np.clip(out.image.cpu().numpy().transpose(1, 2, 0), 0, 1)
        with open(os.path.join(args.out, f"frame_{i_frame:05d}.png"), "wb") as fh:
            fh.write(encode_png((img * 255).astype(np.uint8)))
        ms = parts.result()
        frames.append({"frame": i_frame, "adapt_ms": ms["adaptation"],
                       "render_ms": ms["render"],
                       "svd_ms": ms.get("svd (polar factor per cell)", 0.0), "masked": masked,
                       "instances": int(out.num_instances), "overflow": bool(out.overflow)})
        print(f"frame {i_frame} done")
    return {"frames": frames, "culled_capacity": cap}


if __name__ == "__main__":
    main()
