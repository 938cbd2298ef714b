"""Triangle-mesh operations: normals, smoothness losses, topology.

Counterpart of ``frosting_tpu/ops/mesh.py`` (the PyTorch3D mesh ops the
reference leans on: Meshes normals, mesh_normal_consistency,
mesh_laplacian_smoothing). The tensor functions run on the device of their
inputs; ``edges_from_faces`` and ``adjacent_face_pairs`` are host-side
topology over numpy arrays, as in JAX. ``vertex_normals`` sums the face
normals into the vertices in a fixed order (``ops/segment.py``), with no
float atomics, so its result is bitwise reproducible on the card: the
Frosting layer offsets every cell corner along these normals and freezes
vertices on a strict inside test, where one flipped bit could change which
ones freeze. The order is that of JAX's three scatters on the CPU (corner
0 of every face in face order, then corner 1, then corner 2), and depends
only on the faces: build it once per mesh (``vertex_incidence``).
The same incidence gives gathers of face corners a fixed-order backward
(``face_corners``, ``face_normals`` given it, and ``normal_consistency_loss``,
whose face pairs come as a ``PairIncidence``), which a trained shell or learned vertices
need for reproducible gradients. ``laplacian_smoothing_loss`` still sums
with ``index_add``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from frosting_tpu_torch.ops import segment


def _corners(verts, faces, incidence=None):
    if incidence is not None:
        tri = face_corners(verts, faces, incidence)
        return tri[:, 0], tri[:, 1], tri[:, 2]
    faces = faces.long()
    return verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]


def face_normals(verts: torch.Tensor, faces: torch.Tensor, eps=1e-12,
                 incidence: Optional[VertexIncidence] = None):
    """[F, 3] unit normals (CCW winding); with ``incidence`` the corners'
    gather has a fixed-order backward."""
    v0, v1, v2 = _corners(verts, faces, incidence)
    n = torch.linalg.cross(v1 - v0, v2 - v0)
    return n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=eps)


def face_areas(verts: torch.Tensor, faces: torch.Tensor):
    v0, v1, v2 = _corners(verts, faces)
    return 0.5 * torch.linalg.norm(torch.linalg.cross(v1 - v0, v2 - v0), dim=-1)


class VertexIncidence(NamedTuple):
    """The faces around each vertex, in the order their normals are summed."""

    face: torch.Tensor  # [3F] face of each (vertex, face corner) incidence
    offsets: torch.Tensor  # [V + 1] bounds of each vertex's run in `face`
    order: torch.Tensor  # [3F] each incidence's position in the corner-major list


def vertex_incidence(faces: torch.Tensor, n_verts: int) -> VertexIncidence:
    """The (vertex, face corner) incidences of a mesh ordered by vertex with
    a stable sort of the corner-major list (corner 0 of faces 0..F-1, then
    corner 1, then corner 2)."""
    order, offsets = segment.sort_by_index(faces.long().t().reshape(-1), n_verts)
    return VertexIncidence(order % faces.shape[0], offsets, order)


def face_corners(x: torch.Tensor, faces: torch.Tensor,
                 incidence: Optional[VertexIncidence] = None) -> torch.Tensor:
    """[F, 3, C]: x[faces] for per-vertex rows x [V, C]. With ``incidence``
    (of these faces) its backward sums each vertex's corner rows in the
    incidence's fixed order (``segment.gather_rows``), with no float
    atomics; without, it is the plain gather."""
    faces = faces.long()
    if incidence is None:
        return x[faces]
    flat = segment.gather_rows(x, faces.t().reshape(-1), incidence.order, incidence.offsets)
    return flat.reshape((3, faces.shape[0]) + x.shape[1:]).transpose(0, 1)


def vertex_normals(verts: torch.Tensor, faces: torch.Tensor, eps=1e-12,
                   incidence: Optional[VertexIncidence] = None):
    """[V, 3] area-weighted unit vertex normals (PyTorch3D convention),
    summed in the fixed order of ``incidence`` (built here when not given)."""
    if incidence is None:
        incidence = vertex_incidence(faces, verts.shape[0])
    v0, v1, v2 = _corners(verts, faces)
    fn = torch.linalg.cross(v1 - v0, v2 - v0)  # area-weighted
    vn = segment.segment_sum(fn[incidence.face], incidence.offsets)
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


class PairIncidence(NamedTuple):
    """Adjacent face pairs with the fixed order their gathers' backward sums
    in: ``segment.sort_by_index`` of the pair-major list (pairs[:, 0], then
    pairs[:, 1])."""

    index: torch.Tensor  # [2P] the pair-major list of faces
    order: torch.Tensor  # [2P]
    offsets: torch.Tensor  # [F + 1]


def pair_incidence(pairs: torch.Tensor, n_faces: int) -> PairIncidence:
    index = pairs.long().t().reshape(-1)
    return PairIncidence(index, *segment.sort_by_index(index, n_faces))


def normal_consistency_loss(
    verts: torch.Tensor, faces: torch.Tensor, pairs: PairIncidence,
    incidence: Optional[VertexIncidence] = None,
) -> torch.Tensor:
    """1 - cos between adjacent face normals (mesh_normal_consistency), over
    the face pairs of ``pairs`` (``pair_incidence``); with the faces'
    ``incidence`` too every gather has a fixed-order backward, so the loss's
    gradient is bitwise reproducible."""
    fn = face_normals(verts, faces, incidence=incidence)
    n0, n1 = segment.gather_rows(fn, pairs.index, pairs.order, pairs.offsets).reshape(2, -1, 3)
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
