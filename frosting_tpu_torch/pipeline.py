"""End-to-end Frosting pipeline orchestration, refined SuGaR on an
extracted shell, and export of trained models as 3DGS-viewer PLY files.

Counterpart of ``frosting_tpu/pipeline.py``. ``run_pipeline`` is the
single-call analogue of train_full_pipeline.py (reference :121-208),
running all stages in process instead of chaining subprocesses:

  1. vanilla 3DGS optimization               (train/gs_trainer.py)
  2. coarse SuGaR surface regularization     (train/sugar_trainer.py)
  3. shell base-mesh extraction              (extract/shell.py)
  3b. optional refined (mesh-bound) SuGaR    (train/refined_sugar.py)
  4. frosting layer initialization           (models/frosting.py)
  5. frosting refinement                     (train/frosting_trainer.py)

The exports (PLY files) are ``export_gaussians_ply`` and
``export_frosting_ply``, byte for byte what the JAX package writes for the
same arrays. The stage cache (``cache_dir``) uses the JAX package's file
names and keys, so a cache written by either package resumes in the other.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from frosting_tpu_torch.extract.shell import ShellConfig, extract_shell
from frosting_tpu_torch.models import frosting as frosting_lib
from frosting_tpu_torch.scene.gaussians import GaussianParams, activate
from frosting_tpu_torch.train import checkpoint as ckpt_lib
from frosting_tpu_torch.train import frosting_trainer, gs_trainer, sugar_trainer
from frosting_tpu_torch.utils import ply as ply_io
from frosting_tpu_torch.utils.profiling import PartTimes


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    gs: gs_trainer.GSTrainConfig = gs_trainer.GSTrainConfig()
    sugar: sugar_trainer.SugarTrainConfig = sugar_trainer.SugarTrainConfig()
    shell: ShellConfig = ShellConfig()
    frosting: frosting_lib.FrostingConfig = frosting_lib.FrostingConfig()
    refine: frosting_trainer.FrostingTrainConfig = frosting_trainer.FrostingTrainConfig()
    use_background_gaussians: bool = False
    # optional refined-SuGaR stage between shell extraction and frosting
    # (the reference's refined mesh-bound SuGaR, sugar_model.py:186-360):
    # 0 = skip; >0 = train that many iterations of mesh-bound Gaussians
    # on the extracted shell and report it in the results dict
    refined_sugar_iterations: int = 0
    refined_sugar_n_per_triangle: int = 6


def _save_gaussians(path: str, params: GaussianParams) -> None:
    """The stage-2 cache file: one array per GaussianParams field, under
    its name (the JAX package's sugar_params.npz)."""
    np.savez(path, **{f.name: getattr(params, f.name).detach().cpu().numpy()
                      for f in dataclasses.fields(params)})


def _load_gaussians(path: str, device) -> GaussianParams:
    with np.load(path) as z:
        return GaussianParams(**{f.name: torch.from_numpy(z[f.name]).to(device)
                                 for f in dataclasses.fields(GaussianParams)})


def compact(params: GaussianParams) -> GaussianParams:
    """The live rows (mask > 0.5) of an arena: dead slots are parked at
    1e6, which would wreck the KNN grids and misalign the SH transfer of
    the host-driven extraction and init stages."""
    live = params.mask > 0.5
    return GaussianParams(**{f.name: getattr(params, f.name)[live]
                             for f in dataclasses.fields(params)})


def run_pipeline(
    cameras: List,
    gt_images: np.ndarray,  # [n, 3, H, W]
    points: np.ndarray,
    colors: np.ndarray,
    spatial_extent: float,
    rcfg,
    cfg: PipelineConfig,
    seed: int = 0,
    log_fn=print,
    cache_dir: Optional[str] = None,
    device="cuda",
    parts: Optional[PartTimes] = None,
) -> Dict:
    """Run stages 1-5 on `device`; returns a dict with every stage's
    artifacts under the JAX package's keys.

    cache_dir: optional stage-artifact caching (the in-process analogue
    of the reference's inter-stage artifact files,
    train_full_pipeline.py:155-208): completed stages write their hand-off
    artifact there (sugar_params.npz, shell.npz, frosting_init.npz) and are
    SKIPPED on a re-run, so a long pipeline survives a crash without
    redoing finished stages. Skipped stages leave their history entries
    (gs_state etc.) unset in the result. Every stage that draws takes
    `seed`: the trainers as in JAX, the frosting init through a
    ``torch.Generator`` where JAX's uses ``jax.random.key(seed)``.
    ``parts`` collects each stage's time."""
    out: Dict = {}
    parts = parts or PartTimes(device)
    ck = (lambda n: os.path.join(cache_dir, n)) if cache_dir else None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)

    if ck and os.path.exists(ck("sugar_params.npz")):
        if log_fn:
            log_fn("=== stages 1-2: resumed from cache ===")
        with parts.host("resume stages 1-2"):
            params = _load_gaussians(ck("sugar_params.npz"), device)
        out["sugar_params"] = params
    else:
        if log_fn:
            log_fn("=== stage 1: vanilla 3DGS ===")
        with parts.host("stage 1 (3DGS)"):
            state, gs_hist = gs_trainer.train(
                cameras, gt_images, points, colors, spatial_extent, rcfg, cfg.gs,
                seed=seed, log_fn=log_fn, device=device)
        out["gs_state"] = state
        out["gs_history"] = gs_hist

        if log_fn:
            log_fn("=== stage 2: coarse SuGaR ===")
        with parts.host("stage 2 (SuGaR)"):
            params, sugar_hist = sugar_trainer.train(
                state.params, spatial_extent, cameras, gt_images, rcfg, cfg.sugar,
                seed=seed, log_fn=log_fn, device=device)
        out["sugar_params"] = params
        out["sugar_history"] = sugar_hist
        if ck:
            with parts.host("cache write"):
                _save_gaussians(ck("sugar_params.npz"), params)

    with parts.device("compaction"), torch.no_grad():
        params_live = compact(params)
        means, scales, quats, opac, _sh = activate(params_live)

    if ck and os.path.exists(ck("shell.npz")):
        if log_fn:
            log_fn("=== stage 3: resumed from cache ===")
        with parts.host("resume stage 3"), np.load(ck("shell.npz")) as z:
            verts, faces = z["verts"], z["faces"]
            shell_aux = {"poisson_resolutions": [int(r) for r in z["poisson_res"]]}
    else:
        if log_fn:
            log_fn("=== stage 3: shell extraction ===")
        with parts.host("stage 3 (shell)"), torch.no_grad():
            verts, faces, shell_aux = extract_shell(
                means, scales, quats, opac, cameras, rcfg, cfg.shell, verbose=bool(log_fn))
        if ck:
            with parts.host("cache write"):
                np.savez(ck("shell.npz"), verts=np.asarray(verts), faces=np.asarray(faces),
                         poisson_res=np.asarray(shell_aux.get("poisson_resolutions", []),
                                                np.int64))
    out["shell_verts"] = verts
    out["shell_faces"] = faces
    out["shell_poisson_resolutions"] = shell_aux.get("poisson_resolutions", [])

    if cfg.refined_sugar_iterations > 0:
        if log_fn:
            log_fn("=== stage 3b: refined SuGaR (mesh-bound) ===")
        with parts.host("stage 3b (refined SuGaR)"):
            rs_params, rs_meta, rs_hist = train_refined_sugar(
                verts, faces, means, params_live, spatial_extent, cameras, gt_images, rcfg,
                iterations=cfg.refined_sugar_iterations,
                n_per_triangle=cfg.refined_sugar_n_per_triangle,
                white_background=cfg.refine.white_background,
                seed=seed, log_fn=log_fn, device=device)
        out["refined_sugar_params"] = rs_params
        out["refined_sugar_meta"] = rs_meta
        out["refined_sugar_history"] = rs_hist

    if ck and os.path.exists(ck("frosting_init.npz")):
        if log_fn:
            log_fn("=== stage 4: resumed from cache ===")
        with parts.host("resume stage 4"):
            fparams, meta = ckpt_lib.load_frosting(ck("frosting_init.npz"), device=device)
    else:
        if log_fn:
            log_fn("=== stage 4: frosting init ===")
        with parts.host("stage 4 (frosting init)"):
            fparams, meta = frosting_lib.init_frosting(
                verts, faces, means, scales, quats, opac, params_live, cfg.frosting,
                spatial_extent, use_background=cfg.use_background_gaussians,
                generator=torch.Generator(device=device).manual_seed(seed))
        if ck:
            with parts.host("cache write"):
                ckpt_lib.save_frosting(ck("frosting_init.npz"), fparams, meta)
    out["frosting_meta"] = meta
    del means, scales, quats, opac, params_live

    if log_fn:
        log_fn("=== stage 5: frosting refinement ===")
    with parts.host("stage 5 (refinement)"):
        fparams, refine_hist, _culled = frosting_trainer.train(
            fparams, meta, spatial_extent, cameras, gt_images, rcfg, cfg.refine,
            seed=seed, log_fn=log_fn, device=device)
    out["frosting_params"] = fparams
    out["refine_history"] = refine_hist
    return out


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
