"""Editing and animation runtime: pose the shell, adapt the frosting.

Counterpart of ``frosting_tpu/models/editing.py`` (the Blender-package
editing stack, blender/frosting_utils.py and frosting_model.py's
editability machinery :900-1183). Frosting Gaussian centres are a function
of the shell (softmax barycentrics over the cell corners), so editing
positions is free: replace shell_verts and re-render. What needs explicit
adaptation is the second-order geometry: per-cell affine transforms rotate
and scale each Gaussian's covariance (the reference's torch.linalg.solve
canonical transforms, frosting_model.py:1013-1121), and the polar factor of
the same transform rotates its SH through the view direction
(get_frosting_sh_rotations, blender/frosting_utils.py:519-534).

What differs from the JAX version, on purpose:
- the polar factor (an SVD) and its quaternion are computed once per cell
  and then gathered per Gaussian (JAX decomposes every Gaussian's copy of
  its cell's matrix); the factor is unique for a non-singular transform;
- the small products (normal equations, A Sigma A^T, u v^T) are unrolled
  elementwise sums, exact float32 on the card (no TF32 path);
- the "triangle" thickness average sums per vertex in a fixed order
  (``ops/segment.py``), not a float scatter-add;
- ``load_blender_package`` maps the vertex groups to bones in one pass over
  the flattened lists, not a Python loop per vertex; the same weights.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from frosting_tpu_torch.models import frosting as frosting_lib
from frosting_tpu_torch.ops import cov as cov_ops
from frosting_tpu_torch.ops import quat as quat_ops
from frosting_tpu_torch.ops import segment
from frosting_tpu_torch.utils.profiling import PartTimes


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched a @ b for [..., n, k] x [..., k, m] as an elementwise sum over
    k (exact float32 on the card)."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def median_midpoint(x: torch.Tensor, dim: Optional[int] = None) -> torch.Tensor:
    """``jnp.median``: the mean of the two middle values of an even count,
    as (low + high) * 0.5 (``torch.median`` returns the lower one); over
    every value when dim is None."""
    if dim is None:
        x, dim = x.reshape(-1), 0
    s = torch.sort(x, dim=dim).values
    n = s.shape[dim]
    return (s.select(dim, (n - 1) // 2) + s.select(dim, n // 2)) * 0.5


def cell_affine_transforms(
    ref_corners: torch.Tensor,  # [F, 6, 3]
    new_corners: torch.Tensor,  # [F, 6, 3]
) -> torch.Tensor:
    """[F, 3, 3] least-squares linear map per cell: A minimising
    ||A Xc - Yc|| over the 6 centred corners (the reference solves the same
    normal equations with torch.linalg.solve, frosting_model.py:1114-1119)."""
    xc = ref_corners - ref_corners.mean(dim=1, keepdim=True)
    yc = new_corners - new_corners.mean(dim=1, keepdim=True)
    xtx = _mm(xc.transpose(1, 2), xc)
    ytx = _mm(yc.transpose(1, 2), xc)
    # regularise degenerate (flat) cells
    xtx = xtx + 1e-8 * torch.eye(3, device=xtx.device)
    return torch.linalg.solve(xtx.transpose(-1, -2), ytx.transpose(-1, -2)).transpose(-1, -2)


class EditedGaussians(NamedTuple):
    means: torch.Tensor
    cov6: torch.Tensor  # transformed covariance (the render's cov3d_precomp)
    opacities: torch.Tensor
    sh: torch.Tensor
    sh_rotations: torch.Tensor  # [N, 4] quats rotating view dirs for SH


def _corner_dists(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """[F, 3] each corner's distance to its face's centroid."""
    tri = verts[faces.long()]
    return torch.linalg.norm(tri - tri.mean(dim=1, keepdim=True), dim=-1)


def thickness_rescale_factors(
    ref_verts: torch.Tensor,  # [V, 3] shell verts at make-editable time
    new_verts: torch.Tensor,  # [V, 3] edited shell verts
    faces: torch.Tensor,  # [F, 3]
    mode: str = "median",
) -> torch.Tensor:
    """[V] factor rescaling the frosting thickness when the mesh is edited
    (frosting_model.py:649-705). "median": one global factor, the ratio of
    the median corner-to-centroid distances over all faces. "triangle": each
    face's ratio of median corner distances, averaged onto its vertices.
    "none": ones."""
    v = ref_verts.shape[0]
    if mode == "none":
        return torch.ones((v,), device=ref_verts.device)
    ref_d = _corner_dists(ref_verts, faces)
    new_d = _corner_dists(new_verts, faces)
    if mode == "median":
        factor = median_midpoint(new_d) / torch.clamp(median_midpoint(ref_d), min=1e-12)
        return torch.full((v,), 1.0, device=ref_verts.device) * factor
    if mode == "triangle":
        per_face = median_midpoint(new_d, -1) / torch.clamp(median_midpoint(ref_d, -1),
                                                           min=1e-12)  # [F]
        idx = faces.long().reshape(-1)
        num = segment.sum_by_index(torch.repeat_interleave(per_face, 3), idx, v)
        cnt = torch.bincount(idx, minlength=v).to(num.dtype)  # integer counts: exact
        return num / torch.clamp(cnt, min=1.0)
    raise ValueError(f"unknown thickness rescale mode: {mode}")


def _pack_cov(s: torch.Tensor) -> torch.Tensor:
    return torch.stack([s[:, 0, 0], s[:, 0, 1], s[:, 0, 2], s[:, 1, 1], s[:, 1, 2], s[:, 2, 2]],
                       dim=-1)


def polar_rotations(A: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] the proper rotation of each matrix's polar decomposition:
    u v^T from its SVD, with u's third column negated where det(u v^T) < 0."""
    u, _s, vt = torch.linalg.svd(A)
    R = _mm(u, vt)
    sign = torch.sign(torch.linalg.det(R))
    u = torch.cat([u[..., :2], u[..., 2:] * sign[..., None, None]], dim=-1)
    return _mm(u, vt)


@torch.no_grad()
def adapt_frosting(
    params: frosting_lib.FrostingParams,
    meta: frosting_lib.FrostingMeta,
    new_shell_verts: torch.Tensor,
    deformation_threshold: float = 2.0,
    thickness_rescale: str = "median",
    parts: Optional[PartTimes] = None,
) -> EditedGaussians:
    """Render-ready Gaussians for an edited or posed shell ('complex'
    adaptation: the full per-cell affine on the covariance).

    deformation_threshold: Gaussians whose cell stretched by more than this
    factor get opacity 0 (render_blender_scene.py's deformation masking,
    blender/frosting_utils.py:537-548). thickness_rescale: "median" |
    "triangle" | "none" (render_blender_scene.py --editable_thickness,
    fm:649-705). ``parts`` times the polar factor's SVD apart."""
    parts = parts or PartTimes("cpu")
    faces, cell_idx = meta.faces, meta.cell_idx
    factor = thickness_rescale_factors(params.shell_verts, new_shell_verts, faces,
                                       thickness_rescale)
    edited = dataclasses.replace(params, shell_verts=new_shell_verts,
                                 inner_dist=params.inner_dist * factor,
                                 outer_dist=params.outer_dist * factor)
    ref_corners = frosting_lib.cell_corners(params, faces, meta.incidence)
    new_corners = frosting_lib.cell_corners(edited, faces, meta.incidence)
    A = cell_affine_transforms(ref_corners, new_corners)  # [F, 3, 3]
    A_g = A[cell_idx]  # [N, 3, 3]

    means = frosting_lib.gaussian_centers(edited, faces, cell_idx, meta.cell_bounds,
                                          meta.incidence)
    cov6 = cov_ops.cov3d_from_scale_quat(torch.exp(params.scales_log),
                                         quat_ops.normalize(params.quats_raw))
    sigma_new = _mm(_mm(A_g, cov_ops.unpack_cov3d(cov6)), A_g.transpose(1, 2))
    del A_g

    # deformation masking (_get_edited_points_deformation_mask,
    # blender/frosting_utils.py:535-548): a face's ratio is the largest of
    # its corners' centroid distances, new over reference
    ratios = torch.amax(_corner_dists(new_shell_verts, faces)
                        / torch.clamp(_corner_dists(params.shell_verts, faces), min=1e-12),
                        dim=-1)  # [F]
    opac = torch.sigmoid(params.opacities_raw)
    opac = torch.where(ratios[cell_idx] > deformation_threshold, 0.0, opac)

    # SH rotation: the polar part of each cell's transform (the analogue of
    # get_frosting_sh_rotations' quaternion delta), per cell, then gathered
    with parts.device("svd (polar factor per cell)"):
        R = polar_rotations(A)
    sh_rot = quat_ops.from_matrix(R)[cell_idx]
    sh = torch.cat([params.sh_dc, params.sh_rest], dim=1)
    return EditedGaussians(means=means, cov6=_pack_cov(sigma_new), opacities=opac, sh=sh,
                           sh_rotations=sh_rot)


def _face_frames(verts: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """[F, 3, 3] orthonormal frame per face (rows: tangent, bitangent,
    normal)."""
    tri = verts[faces.long()]
    t1 = tri[:, 1] - tri[:, 0]
    t1 = t1 / torch.clamp(torch.linalg.norm(t1, dim=-1, keepdim=True), min=1e-12)
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)
    t2 = torch.linalg.cross(n, t1)
    return torch.stack([t1, t2, n], dim=1)


@torch.no_grad()
def adapt_frosting_simple(
    params: frosting_lib.FrostingParams,
    meta: frosting_lib.FrostingMeta,
    new_shell_verts: torch.Tensor,
    thickness_rescale: str = "median",
) -> EditedGaussians:
    """'Simple' adaptation (use_simple_adapt, frosting_model.py:739-791):
    each Gaussian rigidly follows its cell's face rotation (q' = q_face_delta
    q) and its scales are multiplied by the thickness factor; faster than
    the per-cell affine, less accurate under shear."""
    faces, cell_idx = meta.faces, meta.cell_idx
    edited = dataclasses.replace(params, shell_verts=new_shell_verts)
    means = frosting_lib.gaussian_centers(edited, faces, cell_idx, meta.cell_bounds,
                                          meta.incidence)
    ref_f = _face_frames(params.shell_verts, faces)  # [F, 3, 3]
    new_f = _face_frames(new_shell_verts, faces)
    # the rotation sending the reference basis to the new one: with
    # row-stacked orthonormal frames B, R = B_new^T B_ref (R t_ref = t_new)
    delta = quat_ops.from_matrix(_mm(new_f.transpose(1, 2), ref_f))[cell_idx]
    quats_new = quat_ops.multiply(delta, quat_ops.normalize(params.quats_raw))
    factor = thickness_rescale_factors(params.shell_verts, new_shell_verts, faces,
                                       thickness_rescale)
    # per Gaussian: the mean of its cell's vertex factors
    fv = factor[faces.long()]
    f_g = ((fv[:, 0] + fv[:, 1] + fv[:, 2]) / 3.0)[cell_idx]
    scales = torch.exp(params.scales_log) * f_g[:, None]
    cov6 = cov_ops.cov3d_from_scale_quat(scales, quats_new)
    opac = torch.sigmoid(params.opacities_raw)
    sh = torch.cat([params.sh_dc, params.sh_rest], dim=1)
    return EditedGaussians(means=means, cov6=cov6, opacities=opac, sh=sh, sh_rotations=delta)


def render_edited(eg: EditedGaussians, camera, rcfg, bg=None, active_sh_degree: int = 3):
    """Render adapted Gaussians through the rasterizer's cov3d_precomp path,
    their SH evaluated along the view directions rotated back by
    sh_rotations."""
    from frosting_tpu_torch.ops import sh as sh_ops
    from frosting_tpu_torch.raster import render

    dirs = eg.means - camera.cam_center
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True), min=1e-12)
    dirs_rot = quat_ops.apply(quat_ops.conjugate(eg.sh_rotations), dirs)
    colors = torch.clamp(sh_ops.eval_sh(active_sh_degree, eg.sh, dirs_rot) + 0.5, min=0.0)
    n = eg.means.shape[0]
    dev = eg.means.device
    dummy_scales = torch.ones((n, 3), device=dev)
    dummy_quats = torch.cat([torch.ones((n, 1), device=dev), torch.zeros((n, 3), device=dev)],
                            dim=1)
    return render(eg.means, dummy_scales, dummy_quats, eg.opacities, eg.sh, camera, rcfg,
                  bg=bg, colors_precomp=colors, cov3d_precomp=eg.cov6)


# --- linear blend skinning + Blender package loading ---


def lbs_pose_verts(
    tpose_points: torch.Tensor,  # [V, 3]
    bone_weights: torch.Tensor,  # [V, B]
    rest_matrices: torch.Tensor,  # [B, 4, 4] bone rest transforms
    pose_matrices: torch.Tensor,  # [B, 4, 4] bone pose transforms
) -> torch.Tensor:
    """v' = sum_b w_vb M_pose_b M_rest_b^-1 v (apply_poses_to_scene,
    blender/frosting_utils.py:474-516); column-vector matrices."""
    deltas = _mm(pose_matrices, torch.linalg.inv(rest_matrices))  # [B, 4, 4]
    homog = torch.cat([tpose_points, torch.ones_like(tpose_points[:, :1])], dim=-1)
    per_bone = torch.sum(deltas[None, :, :3, :] * homog[:, None, None, :], dim=-1)  # [V, B, 3]
    return torch.sum(bone_weights[..., None] * per_bone, dim=1)


class CompositeScene(NamedTuple):
    """Several frosting models merged into one renderable scene
    (build_composite_scene, blender/frosting_utils.py:171-471)."""

    params: frosting_lib.FrostingParams
    meta: frosting_lib.FrostingMeta
    vert_ranges: np.ndarray  # [M, 2] shell-vertex [start, end) per model
    gauss_ranges: np.ndarray  # [M, 2] Gaussian [start, end) per model


def transform_background(bg, T):
    """Rigid + uniform-scale world transform of background Gaussians (their
    means transformed and quats premultiplied by the world rotation,
    blender/frosting_utils.py:364-371; bound to no shell, editing leaves
    them rigid)."""
    T = torch.as_tensor(np.asarray(T, np.float32), device=bg.means3d.device)
    t3 = T[:3, :3]
    s = torch.abs(torch.linalg.det(t3)) ** (1.0 / 3.0)
    rot = t3 / torch.clamp(s, min=1e-12)
    homog = torch.cat([bg.means3d, torch.ones_like(bg.means3d[:, :1])], -1)
    rq = quat_ops.from_matrix(rot[None])[0]
    return dataclasses.replace(
        bg,
        means3d=_mm(homog, T.t())[:, :3],
        quats_raw=quat_ops.multiply(rq.expand(bg.quats_raw.shape), bg.quats_raw),
        scales_log=bg.scales_log + torch.log(torch.clamp(s, min=1e-12)),
    )


def background_to_edited(bg) -> EditedGaussians:
    """Background Gaussians as EditedGaussians rows, so the editing render
    composites them with the adapted frosting (render_composited_image
    appends the background opacities, bf:570-572)."""
    from frosting_tpu_torch.scene.gaussians import activate

    means, scales, quats, opac, sh = activate(bg)
    cov6 = cov_ops.cov3d_from_scale_quat(scales, quats)
    n, dev = means.shape[0], means.device
    ident = torch.cat([torch.ones((n, 1), device=dev), torch.zeros((n, 3), device=dev)], -1)
    return EditedGaussians(means=means, cov6=cov6, opacities=opac, sh=sh, sh_rotations=ident)


def concat_edited(a: EditedGaussians, b: EditedGaussians) -> EditedGaussians:
    return EditedGaussians(*(torch.cat([x, y]) for x, y in zip(a, b)))


def build_composite_scene(
    models,  # list of (FrostingParams, FrostingMeta)
    world_transforms=None,  # optional [M] 4x4 column-vector matrices
    keep_background: bool = True,
) -> CompositeScene:
    """Concatenate frosting models into one scene; the per-model vertex
    ranges let each mesh be posed on its own.

    Background Gaussians: as in the reference (bf:360-371), the FIRST model
    carrying a background contributes it, transformed by its world matrix;
    the others' are dropped (a composite scene has one world)."""
    v_off = g_off = 0
    vert_ranges, gauss_ranges, parts, faces = [], [], [], []
    for i, (p, m) in enumerate(models):
        if world_transforms is not None:
            T = torch.as_tensor(np.asarray(world_transforms[i], np.float32),
                                device=p.shell_verts.device)
            homog = torch.cat([p.shell_verts, torch.ones_like(p.shell_verts[:, :1])], -1)
            p = dataclasses.replace(p, shell_verts=_mm(homog, T.t())[:, :3])
        nv, ng = p.shell_verts.shape[0], p.bary_logits.shape[0]
        vert_ranges.append((v_off, v_off + nv))
        gauss_ranges.append((g_off, g_off + ng))
        parts.append(p)
        faces.append(m.faces.long() + v_off)
        v_off += nv
        g_off += ng

    def cat(field):
        return torch.cat([getattr(p, field) for p in parts])

    bg = None
    if keep_background:
        for i, (p, _m) in enumerate(models):
            if p.bg is not None:
                bg = p.bg
                if world_transforms is not None:
                    bg = transform_background(bg, world_transforms[i])
                break
    params = frosting_lib.FrostingParams(
        **{f.name: cat(f.name) for f in dataclasses.fields(frosting_lib.FrostingParams)
           if f.name != "bg"}, bg=bg)
    # the cells index the concatenated faces
    face_off = np.cumsum([0] + [len(f) for f in faces[:-1]])
    cells = [m.cell_idx.long() + int(face_off[i]) for i, (_p, m) in enumerate(models)]
    bounds = None
    if all(m.cell_bounds is not None for _p, m in models):
        bounds = torch.cat([m.cell_bounds[:-1].long() + int(gauss_ranges[i][0])
                            for i, (_p, m) in enumerate(models)]
                           + [torch.tensor([g_off], device=cells[0].device)])
    meta = frosting_lib.make_meta(torch.cat(faces), torch.cat(cells), bounds, n_verts=v_off,
                                  device=params.shell_verts.device)
    return CompositeScene(params=params, meta=meta, vert_ranges=np.asarray(vert_ranges),
                          gauss_ranges=np.asarray(gauss_ranges))


def pose_composite(scene: CompositeScene, mesh_index: int,
                   new_verts_for_mesh: torch.Tensor) -> torch.Tensor:
    """The full shell_verts with one model's vertices replaced
    (apply_poses_to_scene writes per-mesh slices,
    blender/frosting_utils.py:505-516)."""
    s, e = scene.vert_ranges[mesh_index]
    out = scene.params.shell_verts.clone()
    out[s:e] = new_verts_for_mesh
    return out


def _bone_weights(groups, weights, bone_names) -> np.ndarray:
    """[V, B] float32 raw weights: vertex i's weight of each group that is a
    bone (zip of its groups and weights; a repeated group keeps its last)."""
    v, b = len(groups), len(bone_names)
    out = np.zeros((v, b), np.float32)
    lens = np.fromiter((min(len(g), len(w)) for g, w in zip(groups, weights)), np.int64, v)
    flat_g = [g for gs, n in zip(groups, lens.tolist()) for g in gs[:n]]
    flat_w = np.fromiter((w for ws, n in zip(weights, lens.tolist()) for w in ws[:n]),
                         np.float64, int(lens.sum()))
    if not flat_g:
        return out
    name_to_idx = {n: i for i, n in enumerate(bone_names)}
    col = np.fromiter((name_to_idx.get(g, -1) for g in flat_g), np.int64, len(flat_g))
    row = np.repeat(np.arange(v), lens)
    keep = col >= 0
    # assigned in list order: a later entry for the same (vertex, bone) wins
    out[row[keep], col[keep]] = flat_w[keep].astype(np.float32)
    return out


def load_blender_package(path: str) -> Dict:
    """Parse a Blender-exported JSON package (bones, weights, frames,
    cameras) into numpy structures (load_blender_package,
    blender/frosting_utils.py:15-104)."""
    with open(path) as f:
        package = json.load(f)
    out: Dict = {"raw": package, "meshes": []}
    for mesh_dict in package.get("bones", []):
        if not mesh_dict:
            out["meshes"].append(None)
            continue
        vd, ad = mesh_dict["vertex"], mesh_dict["armature"]
        tpose = np.asarray(vd["tpose_points"], np.float32)
        bone_names = list(ad["rest_bones"].keys())
        weights = _bone_weights(vd["groups"][:len(tpose)], vd["weights"][:len(tpose)],
                                bone_names)
        wsum = weights.sum(axis=1, keepdims=True)
        weights = np.where(wsum > 0, weights / np.maximum(wsum, 1e-12), 0.0)
        rest = np.stack([np.asarray(ad["rest_bones"][n], np.float32) for n in bone_names])
        pose = np.stack([np.asarray(ad["pose_bones"][n], np.float32)
                         for n in bone_names])  # [B, T, 4, 4]
        out["meshes"].append({
            "tpose_points": tpose,
            "weights": weights,
            "bone_names": bone_names,
            "rest_matrices": rest,
            "pose_matrices": pose,
            "matrix_world": np.asarray(vd["matrix_world"], np.float32),
        })
    return out
