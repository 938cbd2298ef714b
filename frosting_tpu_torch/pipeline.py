"""Refined SuGaR on an extracted shell, and export of trained models as
3DGS-viewer PLY files.

Counterpart of ``train_refined_sugar`` (its init apart, as
``init_refined_sugar``), ``export_gaussians_ply`` and
``export_frosting_ply`` of ``frosting_tpu/pipeline.py``; the PLY files, over
the port's ``utils/ply.py``, are byte for byte what the JAX package writes
for the same arrays. The pipeline runner (``run_pipeline``, the
stage-artifact cache) is not ported yet: ROADMAP item A12.
"""

from __future__ import annotations

import numpy as np
import torch

from frosting_tpu_torch.models import frosting as frosting_lib
from frosting_tpu_torch.utils import ply as ply_io


@torch.no_grad()
def init_refined_sugar(verts, faces, coarse_means: torch.Tensor, coarse_params,
                       n_per_triangle: int = 6, device="cuda"):
    """The mesh-bound model of refined SuGaR: flat Gaussians pinned to the
    mesh triangles (sugar_model.py:186-360), their SH-dc seeded from each
    vertex's nearest coarse Gaussian (the exact KNN, k = 1). Returns
    (MeshBoundParams, MeshBoundMeta)."""
    from frosting_tpu_torch.models import mesh_bound as mb_lib
    from frosting_tpu_torch.ops import knn as knn_lib
    from frosting_tpu_torch.ops import sh as sh_ops

    v = torch.from_numpy(np.asarray(verts, np.float32)).to(coarse_means.device)
    idx = knn_lib.knn_query(v, coarse_means, k=1)[0][:, 0]
    vert_colors = sh_ops.sh_to_rgb(coarse_params.sh_dc[idx, 0]).cpu().numpy()
    return mb_lib.init_mesh_bound(np.asarray(verts), np.asarray(faces),
                                  n_per_triangle=n_per_triangle, vertex_colors=vert_colors,
                                  device=device)


def train_refined_sugar(
    verts,  # [V, 3] array
    faces,  # [F, 3] array
    coarse_means: torch.Tensor,  # [N, 3]
    coarse_params,  # GaussianParams: the SH source
    spatial_extent: float,
    cameras,
    gt_images: np.ndarray,
    rcfg,
    iterations: int = 2_000,
    n_per_triangle: int = 6,
    white_background: bool = False,
    seed: int = 0,
    log_fn=print,
    device="cuda",
    parts=None,
):
    """Refined mesh-bound SuGaR on an extracted shell: init_refined_sugar's
    model, its in-plane scales, rotations, opacities and SH optimised
    against the photometric loss. Returns (MeshBoundParams, MeshBoundMeta,
    history); ``parts`` collects the init's and the loop's times."""
    from frosting_tpu_torch.train import refined_sugar as rs_trainer
    from frosting_tpu_torch.utils.profiling import PartTimes

    parts = parts or PartTimes(device)
    with parts.device("init (vertex colour KNN + mesh binding)"):
        rs_params, rs_meta = init_refined_sugar(verts, faces, coarse_means, coarse_params,
                                                n_per_triangle, device)
    rs_cfg = rs_trainer.MeshBoundTrainConfig(
        iterations=iterations, lr_max_steps=iterations, white_background=white_background)
    rs_params, rs_hist = rs_trainer.train(
        rs_params, rs_meta, spatial_extent, cameras, gt_images, rcfg, rs_cfg, seed=seed,
        log_fn=log_fn, device=device, parts=parts)
    return rs_params, rs_meta, rs_hist


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def export_gaussians_ply(means, scales, quats, opac, sh, path: str) -> None:
    """Write activated Gaussian arrays (tensors or arrays) as a
    3DGS-viewer PLY (gaussian_model.py:177-208 field layout)."""
    means, scales, quats, opac, sh = (_host(a) for a in (means, scales, quats, opac, sh))
    n = means.shape[0]
    props = {
        "x": means[:, 0],
        "y": means[:, 1],
        "z": means[:, 2],
        "nx": np.zeros(n, np.float32),
        "ny": np.zeros(n, np.float32),
        "nz": np.zeros(n, np.float32),
    }
    dc = sh[:, :1].transpose(0, 2, 1).reshape(n, -1)
    for i in range(dc.shape[1]):
        props[f"f_dc_{i}"] = dc[:, i]
    rest = sh[:, 1:].transpose(0, 2, 1).reshape(n, -1)
    for i in range(rest.shape[1]):
        props[f"f_rest_{i}"] = rest[:, i]
    opac = np.clip(opac, 1e-6, 1 - 1e-6)
    props["opacity"] = np.log(opac / (1 - opac)).astype(np.float32)
    scl = np.log(np.maximum(scales, 1e-12))
    for i in range(3):
        props[f"scale_{i}"] = scl[:, i]
    for i in range(4):
        props[f"rot_{i}"] = quats[:, i]
    ply_io.write_ply(path, props)


@torch.no_grad()
def export_frosting_ply(fparams, meta, path: str) -> None:
    """The refined frosting as a 3DGS-viewer PLY
    (convert_frosting_into_gaussians -> save_ply, refine.py:585-599)."""
    export_gaussians_ply(*frosting_lib.to_gaussians(fparams, meta), path)
