"""Shell (base mesh) extraction: stage 3 of the pipeline.

Counterpart of ``frosting_tpu/extract/shell.py`` (extract_shell_base_from_
coarse_sugar, frosting_extractors/coarse_shell.py:52-909):

  per camera:  expected-depth map from the Gaussian rasterizer (colours =
               view depth and mean scale, the forward blend kernel B1) ->
               back-project the covered pixels' rays -> `n_ray_samples`
               points over +/- range_sigma mean scales around the depth ->
               density and its gradient at each (exact query KNN over the
               Gaussian centres, one index for every camera) -> the first
               and last level crossings give OUTER and INNER surface
               points, the density gradient the normals;
  then:        statistical outlier removal (host) -> FFT Poisson
               reconstruction and marching tetrahedra (device) -> quantile
               cleaning (exact nearest-support distances, device) -> QEM
               decimation (host C++, one thread per budget) -> projection
               onto the surface points (host) -> visibility culling of
               connected components (mesh rasterizer, device).

Every array of the per-camera sweep, the Poisson solve and the marching
lives on the device of the Gaussians, and so do the quantile cleaning's
distances; the outlier removal, the projection and the decimation are
numpy / scipy / C++ on the host, as in JAX. ``extract_shell``
records the milliseconds of each part in ``aux["timings_ms"]``: CUDA events
around device parts on a CUDA device, the host clock around host parts.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch
from scipy.spatial import cKDTree

from frosting_tpu_torch.cameras import Camera
from frosting_tpu_torch.extract import meshclean
from frosting_tpu_torch.extract.marching import marching_tets
from frosting_tpu_torch.extract.poisson import poisson_reconstruct
from frosting_tpu_torch.models import fields
from frosting_tpu_torch.ops import knn as knn_lib
from frosting_tpu_torch.ops import mesh as mesh_ops
from frosting_tpu_torch.ops.cov import matvec_rows
from frosting_tpu_torch.raster import RasterConfig, render
from frosting_tpu_torch.utils.profiling import PartTimes

# Query points per block of the density sweep: bounds the [block, k]
# intermediates of the KNN and the field.
DENSITY_BLOCK = 1 << 20
# The density's KNN leaves out references farther than this many of the
# largest Gaussian scale: there every term of the density is
# s exp(-||w||^2 / 2) with ||w||^2 >= 256, which is 0 in float32 (and so is
# its gradient), so the density and gradient equal those of the unbounded
# exact KNN bitwise, while a sample in empty space costs one grid pass.
DENSITY_RADIUS_SCALES = 16.0


@dataclasses.dataclass(frozen=True)
class ShellConfig:
    surface_level: float = 0.3  # train.py:37 default 0.3
    n_ray_samples: int = 21  # frosting_model.py:178 "21 samples over +/-3sigma"
    range_sigma: float = 3.0
    knn_k: int = 16
    # 0 = auto: resolution 2^depth from the NN-distance heuristic
    # (compute_optimal_poisson_depth, coarse_shell.py:17-49), capped at
    # max_poisson_resolution
    poisson_resolution: int = 0
    # 1024^3 = depth 10, the reference's real-scene default
    # (coarse_shell.py:80); solved on the device at every resolution
    max_poisson_resolution: int = 1024
    target_vertices: int = 1_000_000  # high_poly default (train.py:118-121)
    # second decimation target (the reference emits BOTH 1M and 200k
    # meshes per extraction, coarse_shell.py:105-108): when set, the same
    # Poisson mesh is also decimated/cleaned to this budget and returned
    # in aux["low_poly"] = (verts, faces)
    target_vertices_low: Optional[int] = None
    outlier_k: int = 20
    outlier_std: float = 2.0
    # fraction of least-supported Poisson vertices to drop
    # (vertices_density_quantile, coarse_shell.py:466-506)
    cleaning_quantile: float = 0.1
    # fg/bg split by camera-centered bbox (coarse_shell.py:382-405): fg
    # within fg_bbox_factor x spatial extent, bg within bg_bbox_factor x;
    # each half gets its own Poisson + cleaning + decimation
    fg_split: bool = False
    fg_bbox_factor: float = 1.0
    bg_bbox_factor: float = 4.0
    # snap mesh verts onto extracted surface points (coarse_shell.py:526-554)
    project_on_surface: bool = True
    # visibility-based connected-component culling (coarse_shell.py:565-617);
    # None disables it and keeps only the largest component
    visibility_threshold: Optional[float] = 0.001
    # "surface" (the paper's ray-sampled level crossings), "centers"
    # (Poisson on the Gaussian centres with density-gradient normals,
    # coarse_shell.py:637-772) or "marching" (marching tetrahedra of the
    # density on a regular grid, coarse_shell.py:773-907)
    method: str = "surface"
    marching_resolution: int = 256
    # centers path: drop near-transparent gaussians before meshing
    # (coarse_shell.py:251-257)
    centers_min_opacity: float = 0.5


def render_depth(means, scales, quats, opac, sh, camera: Camera, rcfg: RasterConfig):
    """Alpha-weighted expected depth + mean 3D scale per pixel + alpha."""
    ones = torch.ones_like(means[:, :1])
    depth = matvec_rows(torch.cat([means, ones], dim=-1), camera.world_view[:, 2:3])[:, 0]
    mean_scale = torch.mean(scales, dim=-1)
    feat = torch.stack([depth, mean_scale, torch.zeros_like(depth)], dim=-1)
    out = render(means, scales, quats, opac, sh, camera, rcfg,
                 bg=torch.zeros(3, device=means.device), colors_precomp=feat)
    acc = 1.0 - out.t_final
    depth_map = out.image[0] / torch.clamp(acc, min=1e-6)
    scale_map = out.image[1] / torch.clamp(acc, min=1e-6)
    return depth_map, scale_map, acc


def eval_density_blocks(means, scales, quats, opac, pts: torch.Tensor, k: int,
                        index: Optional[knn_lib.KnnIndex] = None,
                        block: int = DENSITY_BLOCK, parts: Optional[PartTimes] = None):
    """(density [M], d density / dx [M, 3]) over an arbitrary point set on
    the Gaussians' device, in blocks of `block` points (the reference's
    2M-points-per-pass loop, coarse_shell.py:799-805), every block against
    one KNN index over the centres."""
    parts = parts or PartTimes("cpu")
    index = index or knn_lib.knn_prepare(means, k)
    radius = DENSITY_RADIUS_SCALES * float(scales.max())
    dens, grad = [], []
    for i in range(0, len(pts), block):
        p = pts[i:i + block]
        with parts.device("query KNN"):
            idx, d2 = knn_lib.knn_query_indexed(index, p, k, radius=radius)
        with parts.device("density + gradient"):
            d, g = fields.density_and_grad(p, idx, means, opac, scales, quats,
                                           neighbor_valid=torch.isfinite(d2))
        dens.append(d)
        grad.append(g)
    if not dens:
        return pts.new_zeros((0,)), pts.new_zeros((0, 3))
    return torch.cat(dens), torch.cat(grad)


@torch.no_grad()
def level_points_from_camera(
    means, scales, quats, opac,
    camera: Camera,
    rcfg: RasterConfig,
    cfg: ShellConfig,
    index: Optional[knn_lib.KnnIndex] = None,
    parts: Optional[PartTimes] = None,
):
    """Returns (outer_pts [P,3], outer_normals [P,3], inner_pts [P,3],
    valid [P]) for every pixel of this camera (P = H W; rows where valid is
    False are zero). Only the covered pixels' samples are evaluated: the
    JAX version evaluates every pixel's and discards the others."""
    parts = parts or PartTimes("cpu")
    dev = means.device
    s = cfg.n_ray_samples
    with parts.device("depth render"):
        sh_dummy = torch.zeros((means.shape[0], 1, 3), device=dev)
        depth_map, scale_map, acc = render_depth(
            means, scales, quats, opac, sh_dummy, camera, rcfg)
    h, w = depth_map.shape
    covered = (acc > 0.5).reshape(-1)
    pix = torch.nonzero(covered, as_tuple=True)[0]

    # back-project pixel positions (no half-pixel offset; principal point
    # (W - 1) / 2, as JAX): ray dir in world space
    xs = (pix % w).to(torch.float32)
    ys = (pix // w).to(torch.float32)
    fx, fy = camera.focals(rcfg.projection_width, rcfg.projection_height)
    cx = (rcfg.projection_width - 1.0) / 2.0
    cy = (rcfg.projection_height - 1.0) / 2.0
    dir_cam = torch.stack([(xs - cx) / fx, (ys - cy) / fy, torch.ones_like(xs)], dim=-1)
    rot = camera.world_view[:3, :3]  # row-vector: p_view = p_world @ rot
    dir_world = matvec_rows(dir_cam, rot.T)  # view -> world rotation
    origin = camera.cam_center

    t_mid = depth_map.reshape(-1)[pix]  # view z equals the ray parameter
    rng = cfg.range_sigma * torch.clamp(scale_map.reshape(-1)[pix], min=1e-4)
    ts = torch.linspace(-1.0, 1.0, s, device=dev)
    t_samples = t_mid[:, None] + rng[:, None] * ts  # [P, S]
    pts = origin + dir_world[:, None, :] * t_samples[..., None]

    index = index or knn_lib.knn_prepare(means, cfg.knn_k)
    dens, dgrad = eval_density_blocks(means, scales, quats, opac, pts.reshape(-1, 3),
                                      cfg.knn_k, index=index, parts=parts)
    dens = dens.reshape(-1, s)
    dgrad = dgrad.reshape(-1, s, 3)

    above = dens > cfg.surface_level  # [P, S]
    any_above = torch.any(above, dim=-1)
    # argmax takes the first maximal index, as jnp.argmax does
    first = torch.argmax(above.to(torch.int8), dim=-1)
    last = s - 1 - torch.argmax(torch.flip(above, [-1]).to(torch.int8), dim=-1)

    def take(a, i):
        return torch.gather(a, 1, i[:, None])[:, 0]

    def crossing(k0, k1):
        """Linear interpolation of the level crossing between samples k0
        and k1."""
        d0, d1 = take(dens, k0), take(dens, k1)
        t0, t1 = take(t_samples, k0), take(t_samples, k1)
        dd = d1 - d0
        a = torch.clamp((cfg.surface_level - d0)
                        / torch.where(torch.abs(dd) < 1e-12, 1e-12, dd), 0.0, 1.0)
        return t0 + a * (t1 - t0)

    # outer: density rises through the level before `first`; inner: it
    # falls back through it after `last`
    t_outer = crossing(torch.clamp(first - 1, min=0), first)
    t_inner = crossing(last, torch.clamp(last + 1, max=s - 1))
    outer = origin + dir_world * t_outer[:, None]
    inner = origin + dir_world * t_inner[:, None]
    g_outer = torch.gather(dgrad, 1, first[:, None, None].expand(-1, 1, 3))[:, 0]
    normals = -g_outer / torch.clamp(torch.linalg.norm(g_outer, dim=-1, keepdim=True), min=1e-9)

    def full(x):
        out = torch.zeros((h * w,) + x.shape[1:], dtype=x.dtype, device=dev)
        out[pix] = x
        return out

    return full(outer), full(normals), full(inner), full(any_above)


def _centers_point_cloud(means, scales, quats, opac, cfg: ShellConfig, index, parts):
    """Ablation point cloud: gaussian centers + density-gradient normals
    (coarse_shell.py:637-772)."""
    pts = means[opac >= cfg.centers_min_opacity]
    _d, g = eval_density_blocks(means, scales, quats, opac, pts, cfg.knn_k,
                                index=index, parts=parts)
    n = -g / torch.clamp(torch.linalg.norm(g, dim=1, keepdim=True), min=1e-9)
    return pts, n


def _camera_box(cameras):
    """(mean camera centre [3] float32, 1.1 x the largest distance of a
    camera from it), in the JAX version's float32 arithmetic."""
    centers = np.stack([c.cam_center.cpu().numpy() for c in cameras])
    avg = centers.mean(axis=0)
    extent = 1.1 * float(np.linalg.norm(centers - avg[None], axis=1).max())
    return avg, extent


def _marching_mesh(means, scales, quats, opac, cameras, cfg: ShellConfig, index,
                   parts, verbose):
    """Ablation mesh: marching tetrahedra over a regular density grid
    spanning +/- the camera spatial extent around the mean camera center
    (coarse_shell.py:773-907 uses 512^3 mcubes on the same bbox)."""
    dev = means.device
    avg, extent = _camera_box(cameras)
    res = cfg.marching_resolution
    lin = torch.from_numpy(np.linspace(-1.0, 1.0, res, dtype=np.float32) * extent).to(dev)
    grid = torch.stack(torch.meshgrid(lin, lin, lin, indexing="ij"), dim=-1).reshape(-1, 3)
    pts = grid + torch.from_numpy(avg).to(dev)
    del grid
    dens, _g = eval_density_blocks(means, scales, quats, opac, pts, cfg.knn_k,
                                   index=index, parts=parts)
    del pts, _g
    spacing = (2.0 * extent / (res - 1),) * 3
    origin = torch.from_numpy((avg - extent).astype(np.float64))
    with parts.device("marching"):
        verts, faces = marching_tets(dens.reshape(res, res, res), cfg.surface_level,
                                     origin=origin, spacing=spacing)
    if verbose:
        print(f"[shell/marching] res {res}: {len(verts)} verts "
              f"{len(faces)} faces pre-decimation")
    return verts.cpu().numpy(), faces.cpu().numpy()


def auto_poisson_resolution(
    points: np.ndarray,
    max_resolution: int = 256,
    cell_size_nn_distance_ratio: float = 100.0,
    quantile: float = 0.1,
) -> int:
    """Grid resolution 2^depth from the reference's auto-depth heuristic
    (compute_optimal_poisson_depth, coarse_shell.py:17-49):
    depth = floor(-log2(ratio * q)) where q is the 10%-quantile SQUARED NN
    distance normalized by the bbox size (PyTorch3D's knn_points returns
    squared distances and the reference feeds them in unrooted)."""
    if len(points) < 4:
        return 64
    sub = points
    if len(sub) > 100_000:
        sub = sub[:: len(sub) // 100_000]
    bbox = 1.1 * float(np.max(sub.max(0) - sub.min(0)))
    d, _ = cKDTree(sub).query(sub, k=2, workers=-1)
    q = float(np.quantile(d[:, 1], quantile)) ** 2 / max(bbox, 1e-12)
    depth = int(np.floor(-np.log2(max(cell_size_nn_distance_ratio * q, 1e-12))))
    depth = max(6, min(depth, int(np.log2(max_resolution))))
    return 1 << depth


def _reconstruct_half(pts, nrm, cfg: ShellConfig, device, parts, verbose, tag):
    """Outliers (host) -> Poisson (auto depth; device) -> quantile clean
    (host) for one half of the cloud (numpy in, numpy out)."""
    if len(pts) < 16:
        return None
    with parts.host("outlier removal"):
        pts_f, _keep, (nrm_f,) = meshclean.remove_statistical_outliers(
            pts, k=cfg.outlier_k, std_ratio=cfg.outlier_std, extra=[nrm])
    with parts.host("auto resolution"):
        res = cfg.poisson_resolution or auto_poisson_resolution(
            pts_f, cfg.max_poisson_resolution)
    verts, faces = poisson_reconstruct(
        torch.from_numpy(np.ascontiguousarray(pts_f)).to(device),
        torch.from_numpy(np.ascontiguousarray(nrm_f)).to(device), res, parts=parts)
    verts, faces = verts.cpu().numpy(), faces.cpu().numpy()
    if verbose:
        print(f"[shell/{tag}] poisson res {res}: {len(verts)} verts {len(faces)} faces",
              flush=True)
    with parts.device("unsupported-vertex cleaning"):
        verts, faces = meshclean.remove_unsupported_vertices(
            verts, faces, pts_f, cfg.cleaning_quantile, device=device)
    return verts, faces, res


@torch.no_grad()
def extract_shell(
    means, scales, quats, opac,
    cameras: List[Camera],
    rcfg: RasterConfig,
    cfg: ShellConfig = ShellConfig(),
    verbose: bool = False,
) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Full shell extraction on the device of the Gaussians. Returns
    (verts, faces, aux) as numpy, aux holding the raw surface
    points/normals, the inner points, the Poisson resolutions, the low-poly
    mesh where asked for, and ``timings_ms`` per part."""
    if cfg.method not in ("surface", "centers", "marching"):
        raise ValueError(f"unknown extraction method {cfg.method!r}")
    parts = PartTimes(means.device)
    index = knn_lib.knn_prepare(means, cfg.knn_k)

    if cfg.method == "marching":
        verts, faces = _marching_mesh(means, scales, quats, opac, cameras, cfg, index,
                                      parts, verbose)
        with parts.host("QEM decimation"):
            verts, faces = meshclean.decimate(verts, faces, cfg.target_vertices)
        with parts.device("visibility culling"):
            if cfg.visibility_threshold is not None:
                verts, faces = meshclean.visibility_cull_components(
                    verts, faces, cameras, rcfg, cfg.visibility_threshold)
            else:
                verts, faces = meshclean.largest_component(verts, faces)
        if verbose:
            print(f"[shell] cleaned mesh: {len(verts)} verts {len(faces)} faces")
        vn = mesh_ops.vertex_normals(
            torch.from_numpy(np.asarray(verts, np.float32)).to(means.device),
            torch.from_numpy(np.asarray(faces, np.int64)).to(means.device)).cpu().numpy()
        aux = {"surface_points": verts, "surface_normals": vn, "inner_points": verts,
               "timings_ms": parts.result()}
        return verts, faces, aux

    if cfg.method == "centers":
        pts, nrm = _centers_point_cloud(means, scales, quats, opac, cfg, index, parts)
        pts, nrm = pts.cpu().numpy(), nrm.cpu().numpy()
        if verbose:
            print(f"[shell] {len(pts)} gaussian centers as surface points")
        return _mesh_from_point_cloud(pts, nrm, pts, cameras, rcfg, cfg, parts, verbose)

    all_pts, all_nrm, all_inner = [], [], []
    for i, cam in enumerate(cameras):
        o, nrm, inner, valid = level_points_from_camera(
            means, scales, quats, opac, cam, rcfg, cfg, index=index, parts=parts)
        all_pts.append(o[valid].cpu().numpy())
        all_nrm.append(nrm[valid].cpu().numpy())
        all_inner.append(inner[valid].cpu().numpy())
        if verbose:
            print(f"[shell] camera {i + 1}/{len(cameras)}: "
                  f"{len(all_pts[-1])} level points", flush=True)
    pts = np.concatenate(all_pts)
    nrm = np.concatenate(all_nrm)
    inner = np.concatenate(all_inner)
    if verbose:
        print(f"[shell] {len(pts)} surface points from {len(cameras)} cameras")
    return _mesh_from_point_cloud(pts, nrm, inner, cameras, rcfg, cfg, parts, verbose)


def _mesh_from_point_cloud(pts, nrm, inner, cameras, rcfg: RasterConfig,
                           cfg: ShellConfig, parts: PartTimes, verbose):
    """Shared reconstruction tail: (oriented point cloud) -> fg/bg Poisson
    -> quantile clean -> decimate -> projection -> visibility culling."""
    device = cameras[0].world_view.device
    if cfg.fg_split:
        # camera-centered fg/bg split (coarse_shell.py:382-405)
        avg, extent = _camera_box(cameras)
        off = np.abs(pts - avg[None]).max(axis=1)
        fg_mask = off < cfg.fg_bbox_factor * extent
        bg_mask = (~fg_mask) & (off < cfg.bg_bbox_factor * extent)
        halves = [(pts[m], nrm[m], tag) for m, tag in ((fg_mask, "fg"), (bg_mask, "bg"))]
    else:
        halves = [(pts, nrm, "all")]
    raw_halves = [
        h for h in (_reconstruct_half(p, n, cfg, device, parts, verbose, tag)
                    for p, n, tag in halves)
        if h is not None
    ]
    if not raw_halves:
        raise ValueError(
            "shell extraction found no reconstructable surface: every "
            "fg/bg half had fewer than 16 level-crossing points (check "
            "surface_level / camera coverage / the coarse model's opacity)")
    poisson_res = [r for _v, _f, r in raw_halves]
    raw_halves = [(v, f) for v, f, _r in raw_halves]

    # every (budget, half) decimation at once, one thread each: QEM is
    # serial host C++ that releases the interpreter lock, and the results
    # are those of one after the other
    targets = [cfg.target_vertices] + (
        [cfg.target_vertices_low] if cfg.target_vertices_low else [])
    with parts.host("QEM decimation"):
        with ThreadPoolExecutor(len(targets) * len(raw_halves)) as pool:
            futures = {t: [pool.submit(meshclean.decimate, v, f, t) for v, f in raw_halves]
                       for t in targets}
            decimated = {t: [fut.result() for fut in futs] for t, futs in futures.items()}

    def finalize(target):
        """Merge the halves decimated to one budget and run the clean tail
        (projection + visibility culling)."""
        verts, faces = meshclean.merge_meshes(decimated[target])
        if cfg.project_on_surface:
            with parts.host("projection"):
                verts = meshclean.project_on_points(verts, pts)
        with parts.device("visibility culling"):
            if cfg.visibility_threshold is not None:
                verts, faces = meshclean.visibility_cull_components(
                    verts, faces, cameras, rcfg, cfg.visibility_threshold)
            else:
                verts, faces = meshclean.largest_component(verts, faces)
        return verts, faces

    verts, faces = finalize(cfg.target_vertices)
    if verbose:
        print(f"[shell] cleaned mesh: {len(verts)} verts {len(faces)} faces", flush=True)
    aux = {
        "surface_points": pts,
        "surface_normals": nrm,
        "inner_points": inner,
        "poisson_resolutions": poisson_res,
    }
    # second budget from the same reconstruction (coarse_shell.py:105-108
    # emits both the 1M high-poly and 200k low-poly meshes per run)
    if cfg.target_vertices_low:
        aux["low_poly"] = finalize(cfg.target_vertices_low)
        if verbose:
            print(f"[shell] low-poly mesh: {len(aux['low_poly'][0])} verts "
                  f"{len(aux['low_poly'][1])} faces")
    aux["timings_ms"] = parts.result()
    return verts, faces, aux
