"""Times the quantile cleaning's exact nearest-support distances of stage 3
pass by pass, at full width, on one CUDA card, for three ways of growing
the search radius.

Run from the root of the repository on a machine with a CUDA card:

    python3 cleaning_radius.py

The model is chip_smoke.py's known answer for stage 3 (1M Gaussians of scale
0.01 and opacity 0.9 on the unit sphere, seed 0) seen from the stages path's
8 views at 1920x1080 (r 3.5). extract_shell runs at its defaults up to the
Poisson mesh; then, for the quantile cleaning's distances (the vertices'
nearest surface point, enough of them for the 0.9 quantile):

- fourfold: the radius starts at 4 cells of the support cloud's grid and
  grows fourfold, every pass over every vertex (the port before the
  radius doubled);
- oracle: one pass over the vertices left past 4 cells, at exactly the
  radius the quantile's order statistics need (a bound, not a method);
- doubling: the radius doubles from 8 cells, each pass over the vertices
  still past it (meshclean.nearest_distances).

Each pass's grids are logged (cell size, queries, candidate distances, the
largest candidate list, seconds after a synchronise). The Poisson mesh's
radii show its spurious inner sheet. `--device cpu` runs a small version
(4000 Gaussians, 96x64, Poisson 64^3) as a smoke test. The last line is
"RESULT " and one JSON object.
"""

import argparse
import json
import math
import time

import numpy as np
import torch

from frosting_tpu_torch.extract import meshclean, shell
from frosting_tpu_torch.ops import knn
from frosting_tpu_torch.raster import RasterConfig
from frosting_tpu_torch.utils import viewer

QUANTILE = 0.1  # ShellConfig.cleaning_quantile


class _Done(Exception):
    """Stops extract_shell once the distances are timed."""


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = args.device
    small = dev == "cpu"
    n = 4000 if small else 1_000_000
    rng = np.random.default_rng(0)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    means = torch.tensor(d, dtype=torch.float32, device=dev)
    scales = torch.full((n, 3), 0.01 * math.sqrt(1_000_000 / n), device=dev)
    quats = torch.zeros((n, 4), device=dev)
    quats[:, 0] = 1.0
    opac = torch.full((n,), 0.9, device=dev)
    cams = [viewer._orbit_camera(2 * math.pi * i / 8, 0.15 + 0.15 * (i % 3), 3.5, device=dev)
            for i in range(8)]
    w, h = (96, 64) if small else (1920, 1080)
    rcfg = RasterConfig(width=w, height=h, chunk=128, max_instances=1 << 24)
    cfg = shell.ShellConfig(poisson_resolution=64 if small else 0)

    def sync():
        if dev != "cpu":
            torch.cuda.synchronize()

    grids = []
    grid_pass = knn._grid_pass

    def logged_pass(grid, points, qp, k, self_ids=None):
        sync()
        t0 = time.perf_counter()
        out = grid_pass(grid, points, qp, k, self_ids)
        sync()
        total = out[3]
        grids.append({"cell": grid.cell, "queries": len(qp), "candidates": int(total.sum()),
                      "most": int(total.max()) if len(total) else 0,
                      "s": time.perf_counter() - t0})
        return out

    result = {}

    def one_pass(index, q, radius):
        grids.clear()
        sync()
        t0 = time.perf_counter()
        _, d2 = knn.knn_query_indexed(index, q, 1, radius=radius)
        sync()
        return d2[:, 0], {"radius": radius, "queries": len(q),
                          "s": time.perf_counter() - t0, "grids": list(grids)}

    def distances(verts, _faces, support, quantile, device="cuda"):
        r = np.linalg.norm(verts, axis=1)
        m = len(verts)
        enough = int(np.floor((1.0 - quantile) * (m - 1))) + 2
        result.update(vertices=m, support=len(support), enough=enough,
                      inner_share=float((r < 0.9).mean()),
                      radius_quantiles=np.quantile(r, [0, .01, .05, .1, .15, .5, 1]).tolist())
        index = knn.knn_prepare(torch.as_tensor(np.asarray(support, np.float64),
                                                device=device), k=1)
        cell0 = result["cell0"] = index.cell0
        q = torch.as_tensor(np.asarray(verts, np.float64), device=device)
        knn._grid_pass = logged_pass
        try:
            passes, radius = [], 4.0 * cell0
            while True:
                d2, rec = one_pass(index, q, radius)
                rec["found"] = int(torch.isfinite(d2).sum())
                passes.append(rec)
                print("fourfold " + json.dumps(rec), flush=True)
                if rec["found"] >= enough:
                    break
                radius *= 4.0
            dist = np.sort(np.sqrt(d2[torch.isfinite(d2)].cpu().numpy()))
            result["fourfold"] = {"s": sum(p["s"] for p in passes), "passes": passes}
            need = float(dist[enough - 1]) * (1 + 1e-9)
            result["needed_radius"] = need

            first, rec = one_pass(index, q, 4.0 * cell0)
            todo = torch.nonzero(~torch.isfinite(first), as_tuple=True)[0]
            _, rec = one_pass(index, q[todo], need)
            result["oracle"] = rec
            print("oracle " + json.dumps(rec), flush=True)

            passes, found, radius = [], len(q) - len(todo), 8.0 * cell0
            while found < enough:
                d2, rec = one_pass(index, q[todo], radius)
                ok = torch.isfinite(d2)
                found += int(ok.sum())
                todo = todo[~ok]
                passes.append(rec)
                print("doubling " + json.dumps(rec), flush=True)
                radius *= 2.0
            result["doubling"] = {"s": sum(p["s"] for p in passes), "passes": passes}
        finally:
            knn._grid_pass = grid_pass
        raise _Done

    cleaning = meshclean.remove_unsupported_vertices
    meshclean.remove_unsupported_vertices = distances
    t0 = time.perf_counter()
    try:
        shell.extract_shell(means, scales, quats, opac, cams, rcfg, cfg, verbose=True)
    except _Done:
        pass
    finally:
        meshclean.remove_unsupported_vertices = cleaning
    result["s"] = time.perf_counter() - t0
    print(f"fourfold {result['fourfold']['s']:.2f} s, oracle {result['oracle']['s']:.2f} s, "
          f"doubling {result['doubling']['s']:.2f} s (cell {result['cell0']:.5f}, needed "
          f"radius {result['needed_radius']:.4f})", flush=True)
    print("RESULT " + json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
