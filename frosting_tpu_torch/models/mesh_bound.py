"""Mesh-bound Gaussians (refined SuGaR): flat Gaussians pinned to the
triangles of a mesh at fixed barycentric patterns.

Counterpart of ``frosting_tpu/models/mesh_bound.py`` (the surface-mesh
binding of the SuGaR model, sugar_model.py:186-360; scaling / quaternion
composition :440-503): n in {1, 3, 4, 6} Gaussians per face at fixed
barycentric positions, each with 2 learnable in-plane log-scales and a
learnable 2D rotation stored as a complex number; the third axis is the
face normal with a constant tiny thickness.

``init_mesh_bound`` computes on the host in numpy as JAX does, then moves
the parameters to the device. ``activate_mesh_bound`` gathers the face
corners through ``mesh_ops.face_corners`` with the mesh's vertex incidence
(``MeshBoundMeta.incidence``): where the vertices learn, their gradient is
summed in a fixed order, with no float atomics, and is bitwise reproducible
on the card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from frosting_tpu_torch.ops import mesh as mesh_ops
from frosting_tpu_torch.ops import quat as quat_ops
from frosting_tpu_torch.ops import sh as sh_ops

# Fixed barycentric patterns and incircle radii (sugar_model.py:186-227)
BARY_PATTERNS = {
    1: (
        [[1 / 3, 1 / 3, 1 / 3]],
        1.0 / 2.0 / math.sqrt(3.0),
    ),
    3: (
        [[1 / 2, 1 / 4, 1 / 4], [1 / 4, 1 / 2, 1 / 4], [1 / 4, 1 / 4, 1 / 2]],
        1.0 / 2.0 / (math.sqrt(3.0) + 1.0),
    ),
    4: (
        [
            [1 / 3, 1 / 3, 1 / 3],
            [2 / 3, 1 / 6, 1 / 6],
            [1 / 6, 2 / 3, 1 / 6],
            [1 / 6, 1 / 6, 2 / 3],
        ],
        1.0 / (4.0 * math.sqrt(3.0)),
    ),
    6: (
        [
            [2 / 3, 1 / 6, 1 / 6],
            [1 / 6, 2 / 3, 1 / 6],
            [1 / 6, 1 / 6, 2 / 3],
            [1 / 6, 5 / 12, 5 / 12],
            [5 / 12, 1 / 6, 5 / 12],
            [5 / 12, 5 / 12, 1 / 6],
        ],
        1.0 / (4.0 + 2.0 * math.sqrt(3.0)),
    ),
}


@dataclasses.dataclass
class MeshBoundParams:
    """Optimisable state; the faces and the pattern are in MeshBoundMeta.
    The field order is JAX's (the leaves of its ``.npz``)."""

    verts: torch.Tensor  # [V, 3] (optimised when the positions learn)
    plane_scales_log: torch.Tensor  # [N, 2]
    complex_rot: torch.Tensor  # [N, 2] in-plane rotation (normalised on use)
    opacities_raw: torch.Tensor  # [N]
    sh_dc: torch.Tensor  # [N, 1, 3]
    sh_rest: torch.Tensor  # [N, K-1, 3]


class MeshBoundMeta(NamedTuple):
    faces: torch.Tensor  # [F, 3] int64
    n_per_triangle: int
    thickness: float  # constant normal-axis scale
    # the faces' vertex incidence: the fixed order of the corner gathers'
    # backward (None: the plain gather)
    incidence: Optional[mesh_ops.VertexIncidence] = None


def make_meta(faces, n_per_triangle: int, thickness: float, n_verts: Optional[int] = None,
              device="cuda") -> MeshBoundMeta:
    """MeshBoundMeta on `device` from an array or tensor of faces, with its
    vertex incidence built (n_verts: by default the largest index + 1)."""
    faces = (faces if torch.is_tensor(faces) else torch.from_numpy(np.array(faces))).to(
        device=device, dtype=torch.int64)
    n_verts = int(faces.max()) + 1 if n_verts is None else n_verts
    return MeshBoundMeta(faces, int(n_per_triangle), float(thickness),
                         mesh_ops.vertex_incidence(faces, n_verts))


def params_from_numpy(d, device="cuda") -> MeshBoundParams:
    """The port's MeshBoundParams from the JAX package's (a MeshBoundParams
    of arrays, or a mapping with its field names)."""
    get = d.get if isinstance(d, Mapping) else lambda k: getattr(d, k)
    return MeshBoundParams(**{
        f.name: torch.from_numpy(np.array(get(f.name), np.float32)).to(device)
        for f in dataclasses.fields(MeshBoundParams)})


def meta_from_numpy(m, n_verts: Optional[int] = None, device="cuda") -> MeshBoundMeta:
    """The port's MeshBoundMeta from the JAX package's (faces,
    n_per_triangle, thickness)."""
    return make_meta(np.asarray(m.faces), m.n_per_triangle, m.thickness, n_verts, device)


def init_mesh_bound(
    verts: np.ndarray,
    faces: np.ndarray,
    n_per_triangle: int = 6,
    sh_degree: int = 3,
    vertex_colors: Optional[np.ndarray] = None,
    thickness_factor: float = 1e-4,
    init_opacity: float = 0.9,
    device="cuda",
) -> Tuple[MeshBoundParams, MeshBoundMeta]:
    """Flat Gaussians at the pattern's positions on every face, their
    in-plane scales the pattern's incircle radius times the face's shortest
    side, coloured from vertex_colors [V, 3] where given."""
    bary, radius = BARY_PATTERNS[n_per_triangle]
    bary = np.asarray(bary, np.float32)
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces)
    f = len(faces)
    n = f * n_per_triangle
    tri = verts[faces]  # [F, 3, 3]
    sides = np.linalg.norm(tri - tri[:, [1, 2, 0]], axis=-1)  # [F, 3]
    scale0 = radius * sides.min(axis=1)  # [F]
    plane_scales = np.repeat(scale0, n_per_triangle)[:, None].repeat(2, 1)
    if vertex_colors is not None:
        fc = np.asarray(vertex_colors)[faces]  # [F, 3, 3]
        cols = np.einsum("gk,fkc->fgc", bary, fc).reshape(n, 3)
        sh_dc = sh_ops.rgb_to_sh(torch.from_numpy(np.asarray(cols, np.float32)))[:, None]
    else:
        sh_dc = torch.zeros((n, 1, 3))
    extent = float(np.linalg.norm(verts.max(0) - verts.min(0)))
    x = torch.tensor(init_opacity, dtype=torch.float32)
    params = MeshBoundParams(
        verts=torch.from_numpy(verts.copy()),
        plane_scales_log=torch.log(torch.clamp(
            torch.from_numpy(np.asarray(plane_scales, np.float32)), min=1e-8)),
        complex_rot=torch.cat([torch.ones((n, 1)), torch.zeros((n, 1))], dim=1),
        opacities_raw=torch.full((n,), float(torch.log(x / (1.0 - x)))),
        sh_dc=sh_dc.to(torch.float32),
        sh_rest=torch.zeros((n, sh_ops.num_sh_coeffs(sh_degree) - 1, 3)),
    )
    params = MeshBoundParams(**{k: v.to(device) for k, v in dataclasses.asdict(params).items()})
    return params, make_meta(faces, n_per_triangle, thickness_factor * extent, len(verts),
                             device)


def activate_mesh_bound(p: MeshBoundParams, meta: MeshBoundMeta):
    """-> (means, scales, quats, opacities, sh), ready for the rasterizer.
    Each Gaussian's frame: axis 0 the face normal (the thickness), axes 1-2
    the in-plane basis rotated by the learned complex number
    (sugar_model.py:469-495)."""
    bary, _ = BARY_PATTERNS[meta.n_per_triangle]
    bary = torch.tensor(bary, dtype=torch.float32, device=p.verts.device)  # [G, 3]
    g = bary.shape[0]
    tri = mesh_ops.face_corners(p.verts, meta.faces, meta.incidence)  # [F, 3, 3]
    f = tri.shape[0]
    # the einsum "gk,fkc->fgc", its k terms added in order
    means = (bary[None, :, 0, None] * tri[:, None, 0] + bary[None, :, 1, None] * tri[:, None, 1]
             + bary[None, :, 2, None] * tri[:, None, 2]).reshape(-1, 3)

    n0 = mesh_ops.face_normals(p.verts, meta.faces, incidence=meta.incidence)  # [F, 3]
    e1 = tri[:, 0] - tri[:, 1]
    b1 = e1 / torch.clamp(torch.linalg.norm(e1, dim=-1, keepdim=True), min=1e-12)
    b2 = torch.linalg.cross(n0, b1)
    b2 = b2 / torch.clamp(torch.linalg.norm(b2, dim=-1, keepdim=True), min=1e-12)

    cr = p.complex_rot
    cr = cr * torch.rsqrt(torch.clamp(torch.sum(cr * cr, dim=-1, keepdim=True), min=1e-18))
    cr = cr.reshape(f, g, 2)
    r1 = cr[..., 0:1] * b1[:, None] + cr[..., 1:2] * b2[:, None]
    r2 = -cr[..., 1:2] * b1[:, None] + cr[..., 0:1] * b2[:, None]
    R = torch.stack([n0[:, None].expand(r1.shape), r1, r2], dim=-1).reshape(-1, 3, 3)
    quats = quat_ops.from_matrix(R)

    plane = torch.exp(p.plane_scales_log)
    scales = torch.cat([torch.full((plane.shape[0], 1), meta.thickness, device=plane.device),
                        plane], dim=1)
    opac = torch.sigmoid(p.opacities_raw)
    sh = torch.cat([p.sh_dc, p.sh_rest], dim=1)
    return means, scales, quats, opac, sh
