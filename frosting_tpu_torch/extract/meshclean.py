"""Mesh/point cleaning: outlier removal, decimation, connected components.

Counterpart of ``frosting_tpu/extract/meshclean.py`` (the stand-ins for
Open3D's remove_statistical_outlier, simplify_quadric_decimation,
cluster_connected_triangles and remove_triangles_by_mask of the
reference's coarse_shell.py:430-617). Host-side numpy / scipy, as in JAX,
except two parts on a device: ``remove_unsupported_vertices`` finds its
nearest-support distances by the exact query KNN (``nearest_distances``;
on an extraction's Poisson mesh, whose spurious inner sheet lies inside
the closed surface, cKDTree's query visits most of the tree for each of
those vertices: extract_parts.py times both), and
``visibility_cull_components`` rasterizes on the cameras' device.

``decimate`` is quadric-error-metric edge collapse in C++
(``csrc/qem.cpp``, the port's copy of ``frosting_tpu/native/qem.cpp``,
built with g++ at first use by ``_build.py``). Where the JAX version falls
back to vertex clustering on any error, this one raises: a failed build or
a failed decimation is an error, not a coarser mesh.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components
from scipy.spatial import cKDTree

from frosting_tpu_torch import _build

_PTR = ctypes.c_void_p
_I64 = ctypes.c_int64


def remove_statistical_outliers(
    points: np.ndarray, k: int = 20, std_ratio: float = 2.0, extra=None
):
    """Drop points whose mean k-NN distance exceeds mean + std_ratio*std.
    Returns (filtered points, keep mask); `extra` arrays are filtered too."""
    tree = cKDTree(points)
    d, _ = tree.query(points, k=k + 1, workers=-1)
    md = d[:, 1:].mean(axis=1)
    keep = md <= md.mean() + std_ratio * md.std()
    out = points[keep]
    if extra is not None:
        return out, keep, [e[keep] for e in extra]
    return out, keep


def qem_decimate(
    verts: np.ndarray, faces: np.ndarray, target_vertices: int
) -> Tuple[np.ndarray, np.ndarray]:
    """QEM edge-collapse decimation to about target_vertices vertices
    (float64 verts, int64 faces). Raises RuntimeError if the library does
    not build or the decimation fails (fewer than 4 target vertices, an
    empty mesh)."""
    lib = _build.load("qem")
    lib.qem_decimate.restype = ctypes.c_int
    lib.qem_decimate.argtypes = [_PTR, _I64, _PTR, _I64, _I64, _PTR, _PTR, _PTR, _PTR]
    v = np.ascontiguousarray(verts, np.float64)
    f = np.ascontiguousarray(faces, np.int64)
    if v.ndim != 2 or v.shape[1] != 3 or f.ndim != 2 or f.shape[1] != 3:
        raise ValueError(f"verts {v.shape} and faces {f.shape} must be [n, 3]")
    if len(f) and (f.min() < 0 or f.max() >= len(v)):
        raise ValueError("a face index is out of range")
    out_v = np.empty_like(v)
    out_f = np.empty_like(f)
    nv_out = _I64(0)
    nf_out = _I64(0)
    ok = lib.qem_decimate(
        v.ctypes.data, len(v), f.ctypes.data, len(f), int(target_vertices),
        out_v.ctypes.data, ctypes.byref(nv_out), out_f.ctypes.data, ctypes.byref(nf_out),
    )
    if not ok:
        raise RuntimeError(
            f"qem_decimate failed ({len(v)} verts, {len(f)} faces, target "
            f"{target_vertices})")
    return out_v[: nv_out.value].copy(), out_f[: nf_out.value].copy()


def decimate(
    verts: np.ndarray, faces: np.ndarray, target_vertices: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Quadric-error-metric decimation (``qem_decimate``); a mesh already
    within the budget is returned as it is."""
    if len(verts) <= target_vertices:
        return verts, faces
    return qem_decimate(verts, faces, target_vertices)


def decimate_vertex_clustering(
    verts: np.ndarray, faces: np.ndarray, target_vertices: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Cluster vertices on a uniform grid sized to approximate
    target_vertices; collapse faces, drop degenerates."""
    if len(verts) <= target_vertices:
        return verts, faces
    lo, hi = verts.min(0), verts.max(0)
    span = np.maximum(hi - lo, 1e-12)
    # surface scaling: occupied cells ~ (res)^2 for a surface -> res from
    # sqrt; refine by iteration
    res = max(4, int(np.sqrt(target_vertices) * 1.3))
    for _ in range(8):
        cell = np.floor((verts - lo) / span * (res - 1e-6)).astype(np.int64)
        key = (cell[:, 0] * res + cell[:, 1]) * res + cell[:, 2]
        uniq, inv = np.unique(key, return_inverse=True)
        if len(uniq) <= target_vertices * 1.1:
            break
        res = int(res * 0.8)
    # cluster means
    new_verts = np.zeros((len(uniq), 3))
    cnt = np.zeros(len(uniq))
    np.add.at(new_verts, inv, verts)
    np.add.at(cnt, inv, 1.0)
    new_verts /= cnt[:, None]
    new_faces = inv[faces]
    good = (
        (new_faces[:, 0] != new_faces[:, 1])
        & (new_faces[:, 1] != new_faces[:, 2])
        & (new_faces[:, 0] != new_faces[:, 2])
    )
    new_faces = new_faces[good]
    # drop duplicate faces
    sf = np.sort(new_faces, axis=1)
    _, first = np.unique(sf, axis=0, return_index=True)
    new_faces = new_faces[np.sort(first)]
    return new_verts, new_faces


def nearest_distances(points: np.ndarray, support_points: np.ndarray, device="cuda",
                      enough: int = 0) -> np.ndarray:
    """Euclidean distance of each point to its nearest support point, as
    cKDTree(support_points).query(points, k=1) gives it (float64, summed in
    the same order), by the exact query KNN of ops/knn.py on `device`.

    Distances are exact up to a search radius, inf past it: the radius
    starts at four grid cells of the support cloud and doubles until at
    least `enough` points lie within it (all of them by default), each pass
    searching only the points still past the radius. A point far from the
    cloud then costs one grid pass: cKDTree's query visits most of the tree
    for a point inside a closed surface, nearly equidistant from all of it.
    The radius grows by two and not more because a pass's cost grows with
    the square of its radius for points that lie that far from a surface
    cloud (the grid's cells get that wide): a Poisson mesh's spurious inner
    sheet, where the cleaning's quantile falls."""
    from frosting_tpu_torch.ops import knn

    index = knn.knn_prepare(
        torch.as_tensor(np.asarray(support_points, np.float64), device=device), k=1)
    q = torch.as_tensor(np.asarray(points, np.float64), device=device)
    enough = enough or len(points)
    d2 = torch.full((len(q),), float("inf"), dtype=index.refs.dtype, device=device)
    todo = torch.arange(len(q), device=device)
    radius = 4.0 * index.cell0
    while True:
        _, got = knn.knn_query_indexed(index, q[todo], 1, radius=radius)
        found = torch.isfinite(got[:, 0])
        d2[todo[found]] = got[found, 0]
        todo = todo[~found]
        if len(q) - len(todo) >= enough:
            # numpy's sqrt rounds correctly; torch's vectorised CPU one may
            # not, and cKDTree's distances are correctly rounded
            return np.sqrt(d2.cpu().numpy())
        radius *= 2.0


def remove_unsupported_vertices(
    verts: np.ndarray,
    faces: np.ndarray,
    support_points: np.ndarray,
    quantile: float,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Drop the `quantile` fraction of vertices farthest from the input
    surface cloud (the density-quantile vertex cleaning of
    coarse_shell.py:466-506: support = inverse NN-distance to the cloud).
    The distances come from ``nearest_distances`` on `device`, exact for
    every vertex up to the two order statistics np.quantile reads; a
    vertex past them is farther than the cutoff, as its exact distance
    would be."""
    if quantile <= 0.0 or len(verts) == 0:
        return verts, faces
    n = len(verts)
    lo = int(np.floor((1.0 - quantile) * (n - 1)))
    d = nearest_distances(verts, support_points, device, enough=min(lo + 2, n))
    cutoff = np.quantile(d, 1.0 - quantile)
    bad_v = d > cutoff
    keep_f = ~bad_v[faces].any(axis=1)
    return keep_faces(verts, faces, keep_f)


def project_on_points(
    verts: np.ndarray, support_points: np.ndarray, blend: float = 1.0
) -> np.ndarray:
    """Snap mesh vertices onto their nearest extracted surface point
    (coarse_shell.py:526-554); blend<1 moves only partway."""
    tree = cKDTree(support_points)
    _, idx = tree.query(verts, k=1, workers=-1)
    return verts * (1.0 - blend) + support_points[idx] * blend


def merge_meshes(parts) -> Tuple[np.ndarray, np.ndarray]:
    """Concatenate (verts, faces) pairs with vertex offsets."""
    parts = [p for p in parts if p is not None and len(p[0])]
    vs, fs, off = [], [], 0
    for v, f in parts:
        vs.append(v)
        fs.append(np.asarray(f) + off)
        off += len(v)
    return np.concatenate(vs), np.concatenate(fs)


def face_components(faces: np.ndarray, n_verts: int) -> np.ndarray:
    """Label connected components over shared vertices. Returns per-face
    component ids."""
    f = np.asarray(faces)
    rows = np.concatenate([f[:, 0], f[:, 1]])
    cols = np.concatenate([f[:, 1], f[:, 2]])
    graph = coo_matrix(
        (np.ones(len(rows)), (rows, cols)), shape=(n_verts, n_verts)
    )
    _, vlabels = connected_components(graph, directed=False)
    return vlabels[f[:, 0]]


def keep_faces(
    verts: np.ndarray, faces: np.ndarray, mask: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Keep masked faces and compact unused vertices."""
    f = faces[mask]
    used = np.zeros(len(verts), bool)
    used[f] = True
    remap = np.cumsum(used) - 1
    return verts[used], remap[f]


def largest_component(verts, faces):
    labels = face_components(faces, len(verts))
    vals, cnts = np.unique(labels, return_counts=True)
    best = vals[np.argmax(cnts)]
    return keep_faces(verts, faces, labels == best)


def visibility_cull_components(
    verts: np.ndarray,
    faces: np.ndarray,
    cameras,
    rcfg,
    vis_threshold: float = 0.001,
) -> Tuple[np.ndarray, np.ndarray]:
    """Drop connected components whose fraction of camera-visible faces is
    below vis_threshold (coarse_shell.py:565-617: per-camera rasterize,
    count pix_to_face hits per component), rasterizing on the cameras'
    device. The fraction per component is one bincount of the seen faces
    by label (the JAX version loops over the components)."""
    from frosting_tpu_torch.ops import mesh_raster

    labels = face_components(faces, len(verts))
    dev = cameras[0].world_view.device
    vt = torch.as_tensor(np.asarray(verts, np.float32), device=dev)
    ft = torch.as_tensor(np.asarray(faces, np.int64), device=dev)
    seen = torch.zeros(len(faces), dtype=torch.bool, device=dev)
    for cam in cameras:
        pf = mesh_raster.rasterize_mesh(vt, ft, cam, rcfg).pix_to_face.reshape(-1)
        seen[pf[pf >= 0]] = True
    seen = seen.cpu().numpy()
    # a label's share of seen faces (labels of no face: 0 of 0, never read)
    n_seen = np.bincount(labels, weights=seen)
    n_all = np.bincount(labels)
    frac = np.divide(n_seen, n_all, out=np.zeros_like(n_seen), where=n_all > 0)
    keep = frac[labels] >= vis_threshold
    if not keep.any():  # never drop everything
        return largest_component(verts, faces)
    return keep_faces(verts, faces, keep)
