"""Times the parts of stage 3 (shell extraction) one by one, at full width,
on one CUDA card, beside the host alternatives the port did not take.

Run from the root of the repository on a machine with a CUDA card:

    python3 extract_parts.py

The model is chip_smoke.py's known answer (1M Gaussians of scale 0.01 and
opacity 0.9 on the unit sphere, seed 0) seen from the stages path's 8
views at 1920x1080 (r 3.5). It times, with the host clock after a
synchronise: the per-view sweep (level_points_from_camera, its parts by
CUDA events), the outlier removal, the Poisson solve at the auto
resolution (its parts by CUDA events, peak device memory), the quantile
cleaning's nearest-support distances on the card (meshclean.
nearest_distances) and, for a random sample of the Poisson mesh's
vertices, the same query by a host cKDTree (as the JAX package makes it),
the mesh rasterizer on the Poisson mesh for one view, and QEM on a
1.33M-vertex sphere mesh. The Poisson mesh's radii show its spurious inner
sheet. The last line is one JSON object of the numbers.
"""

import json
import math
import sys
import time

import numpy as np
import torch
from scipy.spatial import cKDTree

from frosting_tpu_torch.extract import marching, meshclean, poisson, shell
from frosting_tpu_torch.ops import knn as knn_lib
from frosting_tpu_torch.ops import mesh_raster
from frosting_tpu_torch.raster import RasterConfig
from frosting_tpu_torch.utils import viewer
from frosting_tpu_torch.utils.profiling import PartTimes

DEV = "cuda"
VIEWS = tuple((2 * math.pi * i / 8, 0.15 + 0.15 * (i % 3)) for i in range(8))
KD_SAMPLE = 200_000


def since(t0):
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main():
    if not torch.cuda.is_available():
        print("extract_parts: no CUDA device", file=sys.stderr)
        return 1
    out = {"device": torch.cuda.get_device_name(0)}
    rng = np.random.default_rng(0)
    d = rng.normal(size=(1_000_000, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    means = torch.from_numpy(d.astype(np.float32)).to(DEV)
    scales = torch.full((len(d), 3), 0.01, device=DEV)
    quats = torch.zeros((len(d), 4), device=DEV)
    quats[:, 0] = 1.0
    opac = torch.full((len(d),), 0.9, device=DEV)
    cams = [viewer._orbit_camera(az, el, 3.5, device=DEV) for az, el in VIEWS]
    rcfg = RasterConfig(width=1920, height=1080, chunk=128, max_instances=1 << 24)
    cfg = shell.ShellConfig()

    index = knn_lib.knn_prepare(means, cfg.knn_k)
    pts, nrm, views = [], [], []
    for cam in cams:
        parts = PartTimes(DEV)
        t0 = time.perf_counter()
        o, n, _inner, valid = shell.level_points_from_camera(
            means, scales, quats, opac, cam, rcfg, cfg, index=index, parts=parts)
        pts.append(o[valid].cpu().numpy())
        nrm.append(n[valid].cpu().numpy())
        views.append({"s": since(t0), **parts.result()})
    out["views"] = views
    pts, nrm = np.concatenate(pts), np.concatenate(nrm)
    print(f"sweep: {len(pts)} level points; per view {json.dumps(views[-1])}", flush=True)

    t0 = time.perf_counter()
    pts_f, _keep, (nrm_f,) = meshclean.remove_statistical_outliers(pts, extra=[nrm])
    out["outlier_removal_s"] = since(t0)
    res = shell.auto_poisson_resolution(pts_f, cfg.max_poisson_resolution)
    torch.cuda.reset_peak_memory_stats()
    parts = PartTimes(DEV)
    t0 = time.perf_counter()
    v, f = poisson.poisson_reconstruct(torch.from_numpy(pts_f).to(DEV),
                                       torch.from_numpy(nrm_f).to(DEV), res, parts=parts)
    out["poisson"] = {"resolution": res, "s": since(t0), **parts.result(),
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "verts": len(v), "faces": len(f)}
    v, f = v.cpu().numpy(), f.cpu().numpy()
    r = np.linalg.norm(v, axis=1)
    out["poisson"]["inner_sheet_share"] = float((r < 0.9).mean())
    out["poisson"]["radius_quantiles"] = np.quantile(r, [0, 0.01, 0.5, 0.99, 1]).tolist()
    print(f"Poisson: {json.dumps(out['poisson'])}", flush=True)

    t0 = time.perf_counter()
    dist = meshclean.nearest_distances(v, pts_f, DEV)
    out["device_distances_s"] = since(t0)
    sample = rng.choice(len(v), KD_SAMPLE, replace=False)
    t0 = time.perf_counter()
    tree = cKDTree(pts_f)
    out["ckdtree_build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    kd, _ = tree.query(v[sample], k=1, workers=-1)
    out["ckdtree_query_us_per_vertex"] = (time.perf_counter() - t0) / KD_SAMPLE * 1e6
    out["ckdtree_equals_device"] = bool(np.array_equal(kd, dist[sample]))
    print(f"distances: device {out['device_distances_s']:.2f} s for {len(v)} vertices; "
          f"cKDTree {out['ckdtree_query_us_per_vertex']:.1f} us a vertex "
          f"({KD_SAMPLE} sampled), equal {out['ckdtree_equals_device']}", flush=True)

    vt, ft = torch.from_numpy(v.astype(np.float32)).to(DEV), torch.from_numpy(f).to(DEV)
    t0 = time.perf_counter()
    mesh_raster.rasterize_mesh(vt, ft, cams[0], rcfg)
    out["raster_poisson_mesh_s"] = since(t0)
    del vt, ft

    n = 400
    lin = torch.linspace(-1.3, 1.3, n, device=DEV)
    g = 1.0 - torch.sqrt(lin[:, None, None] ** 2 + lin[None, :, None] ** 2
                         + lin[None, None, :] ** 2)
    cv, cf = marching.marching_tets(g, 0.0, origin=(-1.3,) * 3, spacing=(2.6 / (n - 1),) * 3)
    cv, cf = cv.cpu().numpy(), cf.cpu().numpy()
    t0 = time.perf_counter()
    dv, _df = meshclean.decimate(cv, cf, len(cv) // 8)
    out["qem"] = {"verts_in": len(cv), "verts_out": len(dv), "s": time.perf_counter() - t0}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
