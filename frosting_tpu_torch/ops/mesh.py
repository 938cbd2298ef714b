"""Triangle-mesh operations: normals, smoothness losses, topology.

Counterpart of ``frosting_tpu/ops/mesh.py`` (the PyTorch3D mesh ops the
reference leans on: Meshes normals, mesh_normal_consistency,
mesh_laplacian_smoothing). The tensor functions run on the device of their
inputs; ``edges_from_faces`` and ``adjacent_face_pairs`` are host-side
topology over numpy arrays, as in JAX. The scatter-adds are ``index_add_``,
whose float atomics on the GPU sum in a varying order: these ops feed
extraction's per-vertex normals and the later stages' losses, where the
last bits do not matter.
"""

from __future__ import annotations

import numpy as np
import torch


def _corners(verts, faces):
    faces = faces.long()
    return verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]


def face_normals(verts: torch.Tensor, faces: torch.Tensor, eps=1e-12):
    """[F, 3] unit normals (CCW winding)."""
    v0, v1, v2 = _corners(verts, faces)
    n = torch.linalg.cross(v1 - v0, v2 - v0)
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=eps)


def face_areas(verts: torch.Tensor, faces: torch.Tensor):
    v0, v1, v2 = _corners(verts, faces)
    return 0.5 * torch.linalg.norm(torch.linalg.cross(v1 - v0, v2 - v0), dim=-1)


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor, eps=1e-12):
    """[V, 3] area-weighted unit vertex normals (PyTorch3D convention)."""
    v0, v1, v2 = _corners(verts, faces)
    fn = torch.linalg.cross(v1 - v0, v2 - v0)  # area-weighted
    vn = torch.zeros_like(verts)
    for i in range(3):
        vn.index_add_(0, faces[:, i].long(), fn)
    return vn / torch.clamp(torch.linalg.norm(vn, dim=-1, keepdim=True), min=eps)


def edges_from_faces(faces: np.ndarray) -> np.ndarray:
    """Unique undirected edges [E, 2] (host-side, static topology)."""
    e = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0
    )
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0)


def laplacian_smoothing_loss(verts: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Uniform-weight Laplacian smoothing: || v - mean(neighbors) ||
    (mesh_laplacian_smoothing(method="uniform"))."""
    edges = edges.long()
    deg = torch.zeros((verts.shape[0],), dtype=verts.dtype, device=verts.device)
    acc = torch.zeros_like(verts)
    for a, b in ((0, 1), (1, 0)):
        acc = acc.index_add(0, edges[:, a], verts[edges[:, b]])
        deg = deg.index_add(0, edges[:, a], torch.ones_like(edges[:, a], dtype=verts.dtype))
    mean_nb = acc / torch.clamp(deg[:, None], min=1.0)
    lap = torch.where(deg[:, None] > 0, verts - mean_nb, 0.0)
    return torch.mean(torch.linalg.norm(lap, dim=-1))


def adjacent_face_pairs(faces: np.ndarray) -> np.ndarray:
    """[P, 2] indices of face pairs sharing an edge (host-side)."""
    f = np.asarray(faces)
    edges = np.concatenate(
        [f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0
    )
    edges = np.sort(edges, axis=1)
    face_idx = np.tile(np.arange(len(f)), 3)
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    es, fi = edges[order], face_idx[order]
    same = (es[1:] == es[:-1]).all(axis=1)
    return np.stack([fi[:-1][same], fi[1:][same]], axis=1)


def normal_consistency_loss(
    verts: torch.Tensor, faces: torch.Tensor, pairs: torch.Tensor
) -> torch.Tensor:
    """1 - cos between adjacent face normals (mesh_normal_consistency)."""
    fn = face_normals(verts, faces)
    pairs = pairs.long()
    n0, n1 = fn[pairs[:, 0]], fn[pairs[:, 1]]
    return torch.mean(1.0 - torch.sum(n0 * n1, dim=-1))


def barycentric_interpolate(
    values: torch.Tensor,  # [V, C]
    faces: torch.Tensor,  # [F, 3]
    face_idx: torch.Tensor,  # [...] int
    bary: torch.Tensor,  # [..., 3]
):
    """Interpolate per-vertex values at barycentric positions on faces."""
    tri = values[faces.long()[face_idx.long()]]  # [..., 3, C]
    return torch.sum(tri * bary[..., None], dim=-2)
