"""Frosting model (stages 4-5): Gaussians parameterised by softmax
barycentric coordinates inside the prismatic cells of an adaptive-thickness
shell.

Counterpart of ``frosting_tpu/models/frosting.py``. The shell is two offset
sheets of the base mesh along its vertex normals; each base face spans a
6-corner prismatic cell (3 inner then 3 outer vertices), and every frosting
Gaussian lives in one cell at point = softmax(bary_logits) . cell corners.
Vertex normals point outward, so outer_dist >= 0 >= inner_dist.

What differs from the JAX version, on purpose:
- ``gaussian_centers``' backward (``CornerBlend``) sums the corner
  gradients per cell as a segment sum over the sorted ``cell_idx``
  (``ops/segment.py``): exact to one rounding per row, with no float
  atomics, where JAX takes prefix differences of a cumsum (which cancel at
  2M rows in float32) and lane-major transposes (a TPU gather workaround);
- init's self-intersection loop and cell allocation run on the device of
  the Gaussians (JAX routes both to the host CPU, a TPU workaround), with
  the random draws from a ``torch.Generator`` or passed in (a test hands
  over JAX's own ``jax.random`` draws);
- the cells' corners gather the sheets through ``mesh_ops.face_corners``,
  whose backward sums each vertex's rows in a fixed order (a learned
  shell's offsets get bitwise reproducible gradients);
- the KNN is exact (``ops/knn.py``);
- init reports its parts' times through a ``PartTimes`` in place of JAX's
  ``FROSTING_INIT_DEBUG`` switch.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from frosting_tpu_torch.models import fields
from frosting_tpu_torch.ops import knn as knn_lib
from frosting_tpu_torch.ops import mesh as mesh_ops
from frosting_tpu_torch.ops import quat as quat_ops
from frosting_tpu_torch.ops import segment
from frosting_tpu_torch.ops import sh as sh_ops
from frosting_tpu_torch.scene.gaussians import (
    GaussianParams,
    activate,
    inverse_sigmoid,
    params_from_numpy as gaussians_from_numpy,
)
from frosting_tpu_torch.utils.profiling import PartTimes

# Query points per KNN block of init's level search: bounds the [block, k]
# intermediates of the query KNN and the field at ~20M points.
LEVEL_BLOCK = 1 << 20


@dataclasses.dataclass
class FrostingParams:
    """Optimisable frosting state; the mesh topology is in FrostingMeta.
    ``bg`` holds the background Gaussians (vanilla Gaussians outside the
    shell's bounding box), trained with their own groups."""

    shell_verts: torch.Tensor  # [V, 3] base mesh (frozen)
    inner_dist: torch.Tensor  # [V] <= 0
    outer_dist: torch.Tensor  # [V] >= 0
    bary_logits: torch.Tensor  # [N, 6]
    scales_log: torch.Tensor  # [N, 3]
    quats_raw: torch.Tensor  # [N, 4]
    opacities_raw: torch.Tensor  # [N]
    sh_dc: torch.Tensor  # [N, 1, 3]
    sh_rest: torch.Tensor  # [N, K-1, 3]
    bg: Optional[GaussianParams] = None


class FrostingMeta(NamedTuple):
    faces: torch.Tensor  # [F, 3] int64
    cell_idx: torch.Tensor  # [N] int64 cell (face) of each frosting Gaussian
    # [F + 1] bounds of each cell's run in a SORTED cell_idx; None for an
    # unsorted one
    cell_bounds: Optional[torch.Tensor] = None
    # the order in which face normals are summed into vertex normals
    # (make_meta builds it; vertex_normals builds it where it is None)
    incidence: Optional[mesh_ops.VertexIncidence] = None


@dataclasses.dataclass(frozen=True)
class FrostingConfig:
    n_gaussians: int = 2_000_000  # train.py:71 default budget
    frosting_level: float = 0.01  # train.py:87
    n_samples_per_vertex: int = 21  # frosting_model.py:178
    proposal_std_range: float = 3.0  # initial_proposal_std_range
    min_frosting_size: float = 0.001
    knn_k: int = 16
    sh_degree: int = 3
    # offsets limited to this multiple of the local mean edge length (a
    # fast pre-clamp; the guard is the incremental-growth loop)
    max_offset_edge_factor: float = 1.5
    # grow the offsets in n increments, freezing vertices whose sheet point
    # lands inside another cell (frosting_model.py:398-435)
    avoid_self_intersections: bool = True
    self_intersection_iters: int = 20
    self_intersection_knn: int = 8


def _index(a, device) -> torch.Tensor:
    t = a if torch.is_tensor(a) else torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=torch.int64)


def make_meta(faces, cell_idx, cell_bounds=None, n_verts=None, device="cuda") -> FrostingMeta:
    """FrostingMeta on `device` from arrays or tensors, with its vertex
    incidence built (n_verts: the shell's vertex count, by default the
    largest index in faces + 1)."""
    faces = _index(faces, device)
    n_verts = int(faces.max()) + 1 if n_verts is None else n_verts
    return FrostingMeta(faces, None if cell_idx is None else _index(cell_idx, device),
                        None if cell_bounds is None else _index(cell_bounds, device),
                        mesh_ops.vertex_incidence(faces, n_verts))


def meta_from_numpy(d, n_verts=None, device="cuda") -> FrostingMeta:
    """The port's FrostingMeta from the JAX package's (a FrostingMeta of
    numpy arrays, or a mapping with its field names)."""
    get = d.get if isinstance(d, Mapping) else lambda k: getattr(d, k)
    return make_meta(get("faces"), get("cell_idx"), get("cell_bounds"), n_verts, device)


def params_from_numpy(d, device="cuda") -> FrostingParams:
    """The port's FrostingParams from the JAX package's (a FrostingParams of
    numpy arrays, or a mapping with its field names; ``bg`` a
    GaussianParams of arrays, a mapping or None)."""
    get = d.get if isinstance(d, Mapping) else lambda k: getattr(d, k)
    bg = get("bg")
    if bg is not None and not isinstance(bg, Mapping):
        bg = {f.name: getattr(bg, f.name) for f in dataclasses.fields(bg)}
    return FrostingParams(
        **{f.name: torch.from_numpy(np.array(get(f.name), np.float32)).to(device)
           for f in dataclasses.fields(FrostingParams) if f.name != "bg"},
        bg=None if bg is None else gaussians_from_numpy(bg, device=device),
    )


def contract(x: torch.Tensor, c: torch.Tensor, L: float) -> torch.Tensor:
    """MipNeRF360-style contraction of points beyond distance L from c
    (frosting_model.py:36-48): damps the cell volumes of unbounded
    background geometry."""
    d = torch.clamp(torch.linalg.norm(x - c, dim=-1, keepdim=True), min=1e-12)
    contracted = c + L * (2.0 - L / d) * (x - c) / d
    return torch.where(d > L, contracted, x)


def shell_sheets(p: FrostingParams, faces: torch.Tensor,
                 incidence: Optional[mesh_ops.VertexIncidence] = None):
    """(inner [V, 3], outer [V, 3], normals [V, 3])."""
    normals = mesh_ops.vertex_normals(p.shell_verts, faces, incidence=incidence)
    inner = p.shell_verts + p.inner_dist[:, None] * normals
    outer = p.shell_verts + p.outer_dist[:, None] * normals
    return inner, outer, normals


def cell_corners(p: FrostingParams, faces: torch.Tensor,
                 incidence: Optional[mesh_ops.VertexIncidence] = None) -> torch.Tensor:
    """[F, 6, 3]: the inner triangle's vertices, then the outer's. With
    ``incidence`` the corners' gathers sum their gradient in its fixed order
    (a learned shell's offsets get bitwise reproducible gradients)."""
    inner, outer, _ = shell_sheets(p, faces, incidence)
    return torch.cat([mesh_ops.face_corners(inner, faces, incidence),
                      mesh_ops.face_corners(outer, faces, incidence)], dim=1)


def _weighted_corners(w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """[N, 3] sum_k w[:, k] g[:, k], added in k order as the JAX version adds."""
    out = w[:, 0:1] * g[:, 0]
    for k in range(1, 6):
        out = out + w[:, k:k + 1] * g[:, k]
    return out


class CornerBlend(torch.autograd.Function):
    """means [N, 3] = sum_k w[n, k] corners[cell_idx[n], k], differentiable
    in w [N, 6] and corners [F, 6, 3]. The backward re-gathers the corners
    for d w, and sums d corners[f] = sum over cell f's rows of w[n, k]
    g[n, c] as a segment sum over the rows sorted by cell (``cell_bounds``
    for a sorted cell_idx; otherwise a stable sort of cell_idx first):
    bitwise reproducible, where autograd's backward of corners[cell_idx]
    would scatter-add N rows with float atomics."""

    @staticmethod
    def forward(ctx, w, corners, cell_idx, cell_bounds):
        ctx.save_for_backward(w, corners, cell_idx, cell_bounds)
        return _weighted_corners(w, corners[cell_idx])

    @staticmethod
    def backward(ctx, g_means):
        w, corners, cell_idx, cell_bounds = ctx.saved_tensors
        d_w = d_corners = None
        if ctx.needs_input_grad[0]:
            g = corners[cell_idx]
            d_w = torch.stack([
                g_means[:, 0] * g[:, k, 0] + g_means[:, 1] * g[:, k, 1]
                + g_means[:, 2] * g[:, k, 2] for k in range(6)], dim=-1)
        if ctx.needs_input_grad[1]:
            n_cells = corners.shape[0]
            rows = (w[:, :, None] * g_means[:, None, :]).reshape(-1, 18)
            if cell_bounds is None:
                order, cell_bounds = segment.sort_by_index(cell_idx, n_cells)
                rows = rows[order]
            d_corners = segment.segment_sum(rows, cell_bounds).reshape(n_cells, 6, 3)
        return d_w, d_corners, None, None


def blend_corners(bary_logits, corners, cell_idx, cell_bounds=None) -> torch.Tensor:
    """[N, 3] softmax(bary_logits) . corners[cell_idx]."""
    w = torch.softmax(bary_logits, dim=-1)
    return CornerBlend.apply(w, corners, cell_idx, cell_bounds)


def gaussian_centers(p: FrostingParams, faces, cell_idx, cell_bounds=None,
                     incidence: Optional[mesh_ops.VertexIncidence] = None) -> torch.Tensor:
    """[N, 3], differentiable in the bary logits and the shell."""
    return blend_corners(p.bary_logits, cell_corners(p, faces, incidence), cell_idx,
                         cell_bounds)


def activate_frosting(p: FrostingParams, meta: FrostingMeta, corners=None):
    """-> (means, scales, quats, opacities, sh) of the frosting Gaussians,
    then the background Gaussians, ready for the rasterizer. ``corners``:
    the cells' corners where the caller has them (a frozen shell's, computed
    once without autograd)."""
    if corners is None:
        corners = cell_corners(p, meta.faces, meta.incidence)
    means = blend_corners(p.bary_logits, corners, meta.cell_idx, meta.cell_bounds)
    scales = torch.exp(p.scales_log)
    quats = quat_ops.normalize(p.quats_raw)
    opac = torch.sigmoid(p.opacities_raw)
    sh = torch.cat([p.sh_dc, p.sh_rest], dim=1)
    if p.bg is not None:
        bm, bs, bq, bo, bsh = activate(p.bg)
        means = torch.cat([means, bm])
        scales = torch.cat([scales, bs])
        quats = torch.cat([quats, bq])
        opac = torch.cat([opac, bo])
        sh = torch.cat([sh, bsh])
    return means, scales, quats, opac, sh


def to_gaussians(p: FrostingParams, meta: FrostingMeta):
    """Plain activated Gaussian arrays (the PLY export's path,
    convert_frosting_into_gaussians, frosting_model.py:2211-2285)."""
    return activate_frosting(p, meta)


def level_samples(s: int) -> np.ndarray:
    """[s] float32: the points of JAX's ``jnp.linspace(-1.0, 1.0, s)`` as it
    computes them on the CPU (step = iota * f32(1 / (s - 1)) rounded, the
    last point 1; point = iota / (s - 1) - (1 - step) with the product
    unrounded); numpy's float64 linspace, or torch's, round other points
    differently."""
    f = np.float32
    if s == 1:
        return np.full((1,), -1.0, f)
    it = np.arange(s - 1, dtype=np.float64)
    exact = it * np.float64(f(1.0) / f(s - 1))
    one_minus = (1.0 - exact.astype(f).astype(np.float64)).astype(f)
    return np.concatenate([(exact - one_minus).astype(f), [f(1.0)]]).astype(f)


def level_dists_along_normals(
    shell_verts: torch.Tensor,
    normals: torch.Tensor,
    g_means: torch.Tensor,
    g_scales: torch.Tensor,
    g_quats: torch.Tensor,
    g_opac: torch.Tensor,
    cfg: FrostingConfig,
    range_per_vertex: torch.Tensor,  # [V] search half-range
    parts: Optional[PartTimes] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inner and outer crossings of the frosting level's density along
    each vertex normal (frosting_model.py:2016-2208): (inner_dist <= 0,
    outer_dist >= 0)."""
    parts = parts or PartTimes("cpu")
    v, s = shell_verts.shape[0], cfg.n_samples_per_vertex
    ts = torch.from_numpy(level_samples(s)).to(shell_verts.device)
    offsets = range_per_vertex[:, None] * ts[None, :]  # [V, S]
    flat = (shell_verts[:, None, :] + normals[:, None, :] * offsets[..., None]).reshape(-1, 3)
    with parts.device("level distances: KNN"):
        index = knn_lib.knn_prepare(g_means, cfg.knn_k)
        knn_idx = torch.cat([knn_lib.knn_query_indexed(index, flat[i:i + LEVEL_BLOCK],
                                                       cfg.knn_k)[0]
                             for i in range(0, len(flat), LEVEL_BLOCK)])
    with parts.device("level distances: density"):
        dens = fields.field_values_blocked(
            flat, knn_idx, g_means, g_opac, g_scales, g_quats, beta_mode="average",
        ).density.reshape(v, s)
        del knn_idx

        above_b = dens > cfg.frosting_level
        any_above = above_b.any(dim=-1)
        above = above_b.to(torch.uint8)  # argmax takes no bool
        first = torch.argmax(above, dim=-1)
        last = s - 1 - torch.argmax(above.flip(-1), dim=-1)

        def interp(k_after, direction):
            k0 = torch.clamp(k_after - direction, 0, s - 1)[:, None]
            k1 = k_after[:, None]
            d0, d1 = dens.gather(1, k0)[:, 0], dens.gather(1, k1)[:, 0]
            o0, o1 = offsets.gather(1, k0)[:, 0], offsets.gather(1, k1)[:, 0]
            den = torch.where(torch.abs(d1 - d0) < 1e-12, 1e-12, d1 - d0)
            a = torch.clamp((cfg.frosting_level - d0) / den, 0.0, 1.0)
            return o0 + a * (o1 - o0)

        inner_off = interp(first, 1)  # crossing into the level from below
        outer_off = interp(last, -1)
        fallback = cfg.min_frosting_size * torch.mean(range_per_vertex)
        inner = torch.where(any_above, torch.clamp(inner_off, max=0.0), -fallback)
        outer = torch.where(any_above, torch.clamp(outer_off, min=0.0), fallback)
    return inner, outer


def _cell_face_planes(inner_tri: torch.Tensor, outer_tri: torch.Tensor):
    """The 5 face planes of each prismatic cell (is_inside_frosting,
    frosting_model.py:1680-1724: 3 side quads, inner cap, outer cap), each
    normal oriented into the cell (toward its centroid, so the test does not
    depend on the winding; a plane through the centroid keeps its normal).
    inner_tri / outer_tri: [F, 3, 3]. Returns (normals, points) [F, 5, 3]."""
    i0, i1, i2 = inner_tri[:, 0], inner_tri[:, 1], inner_tri[:, 2]
    o0, o1, o2 = outer_tri[:, 0], outer_tri[:, 1], outer_tri[:, 2]

    def nrm(a, b):
        c = torch.linalg.cross(a, b)
        return c / torch.clamp(torch.linalg.norm(c, dim=-1, keepdim=True), min=1e-12)

    normals = torch.stack([
        nrm(i1 - i0, o0 - i0),
        nrm(i2 - i1, o1 - i1),
        nrm(o0 - i0, i2 - i0),
        nrm(i2 - i0, i1 - i0),  # inner cap
        nrm(o1 - o0, o2 - o0),  # outer cap
    ], dim=1)
    points = torch.stack([i0, i1, i0, i0, o0], dim=1)
    center = torch.cat([inner_tri, outer_tri], dim=1).mean(dim=1, keepdim=True)
    sign = torch.sign(torch.sum((center - points) * normals, dim=-1, keepdim=True))
    return normals * torch.where(sign == 0.0, 1.0, sign), points


class _Cells(NamedTuple):
    normals: torch.Tensor  # [F, 5, 3] inward plane normals
    points: torch.Tensor  # [F, 5, 3] a point of each plane
    index: knn_lib.KnnIndex  # over the cell centres


def _cells(inner_verts, outer_verts, faces, k) -> _Cells:
    faces = faces.long()
    inner_tri, outer_tri = inner_verts[faces], outer_verts[faces]
    normals, points = _cell_face_planes(inner_tri, outer_tri)
    centers = torch.cat([inner_tri, outer_tri], dim=1).mean(dim=1)
    index = knn_lib.knn_prepare(centers, k)
    index.grid(0)  # the finest grid, which every query takes first
    return _Cells(normals, points, index)


def _inside(points, cells: _Cells, scene_scale, k, proj_th, exclude_cells=None):
    """[P] bool: the point lies inside one of its k nearest cells, strictly:
    all 5 signed plane distances > scene_scale * proj_th."""
    knn_idx, _ = knn_lib.knn_query_indexed(cells.index, points, k)
    proj = torch.sum((points[:, None, None] - cells.points[knn_idx]) * cells.normals[knn_idx],
                     dim=-1)  # [P, k, 5]
    inside_cell = torch.all(proj > scene_scale * proj_th, dim=-1)
    if exclude_cells is not None:
        inside_cell &= knn_idx != exclude_cells[:, None]
    return torch.any(inside_cell, dim=-1)


def is_inside_cells(
    points: torch.Tensor,  # [P, 3]
    inner_verts: torch.Tensor,  # [V, 3]
    outer_verts: torch.Tensor,  # [V, 3]
    faces: torch.Tensor,  # [F, 3]
    scene_scale: float,
    k: int = 8,
    proj_th: float = 1e-6,
    exclude_cells: Optional[torch.Tensor] = None,  # [P] cell to skip per point
) -> torch.Tensor:
    """True where a point lies inside one of its k nearest prismatic cells
    (is_inside_frosting, frosting_model.py:1675-1737)."""
    return _inside(points, _cells(inner_verts, outer_verts, faces, k), scene_scale, k,
                   proj_th, exclude_cells)


@torch.no_grad()
def avoid_self_intersections(
    shell_verts: torch.Tensor,  # [V, 3]
    normals: torch.Tensor,  # [V, 3] outward vertex normals
    faces: torch.Tensor,  # [F, 3]
    inner_target: torch.Tensor,  # [V] <= 0
    outer_target: torch.Tensor,  # [V] >= 0
    scene_scale: float,
    n_iters: int = 20,
    k: int = 8,
    parts: Optional[PartTimes] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grow the inner and outer offsets toward their targets in n_iters
    steps, freezing a vertex whose sheet point falls inside another cell
    (the constructor's loop, frosting_model.py:398-435). A sheet vertex lies
    on the planes of its own cells, which the strict inside test leaves out.
    Each step builds one KNN index over its cells' centres, which both
    sheets' tests query."""
    parts = parts or PartTimes("cpu")
    v = shell_verts.shape[0]
    inner = torch.zeros((v,), dtype=shell_verts.dtype, device=shell_verts.device)
    outer = torch.zeros_like(inner)
    in_frozen = torch.zeros((v,), dtype=torch.bool, device=shell_verts.device)
    out_frozen = torch.zeros_like(in_frozen)
    step_in, step_out = inner_target / n_iters, outer_target / n_iters
    for _ in range(n_iters):
        cand_in = torch.where(in_frozen, inner, inner + step_in)
        cand_out = torch.where(out_frozen, outer, outer + step_out)
        iv = shell_verts + cand_in[:, None] * normals
        ov = shell_verts + cand_out[:, None] * normals
        with parts.device("self-intersection: index builds"):
            cells = _cells(iv, ov, faces, k)
        with parts.device("self-intersection: queries + tests"):
            bad_in = _inside(iv, cells, scene_scale, k, 1e-6)
            bad_out = _inside(ov, cells, scene_scale, k, 1e-6)
            inner = torch.where(bad_in, inner, cand_in)
            outer = torch.where(bad_out, outer, cand_out)
            in_frozen |= bad_in
            out_frozen |= bad_out
    return inner, outer


@torch.no_grad()
def init_frosting(
    shell_verts,  # [V, 3] array or tensor
    faces,  # [F, 3] array or tensor
    g_means: torch.Tensor,
    g_scales: torch.Tensor,
    g_quats: torch.Tensor,
    g_opac: torch.Tensor,
    gaussians: Optional[GaussianParams],  # the 3DGS params for SH / background
    cfg: FrostingConfig,
    spatial_extent: float = 1.0,
    use_background: bool = False,
    contract_points: bool = False,
    camera_center=None,
    generator: Optional[torch.Generator] = None,
    u_cell: Optional[torch.Tensor] = None,
    u_bary: Optional[torch.Tensor] = None,
    parts: Optional[PartTimes] = None,
) -> Tuple[FrostingParams, FrostingMeta]:
    """Build the frosting layer around a shell mesh on the device of the
    Gaussians (frosting_model.py constructor, :288-591).

    The draws: ``u_cell`` [n] (each Gaussian's cell, by inverse CDF over
    the cell volumes) and ``u_bary`` [n, 6] (its barycentric coordinates,
    from the sorted-uniform differences of the first five), uniform in
    [0, 1); each comes from ``generator`` when not given. ``parts``
    collects the parts' times."""
    parts = parts or PartTimes("cpu")
    dev = g_means.device
    shell_verts = (shell_verts if torch.is_tensor(shell_verts)
                   else torch.from_numpy(np.array(shell_verts))).to(dev, torch.float32)
    v = shell_verts.shape[0]
    meta = make_meta(faces, None, None, v, dev)
    faces_t = meta.faces
    n_faces = faces_t.shape[0]
    n = cfg.n_gaussians

    with parts.device("vertex normals"):
        normals = mesh_ops.vertex_normals(shell_verts, faces_t, incidence=meta.incidence)
    # the std of the nearby Gaussians along the normal (fm:299-309)
    with parts.device("vertex stds"):
        kidx, _ = knn_lib.knn_query(shell_verts, g_means, k=min(cfg.knn_k, 16))
        nb_quats, nb_scales = g_quats[kidx], g_scales[kidx]
        local_n = quat_ops.apply(quat_ops.conjugate(nb_quats),
                                 normals[:, None].expand(nb_quats.shape[:2] + (3,)))
        stds = torch.linalg.norm(nb_scales * local_n, dim=-1).mean(dim=1)
        del kidx, nb_quats, nb_scales, local_n

    inner_dist, outer_dist = level_dists_along_normals(
        shell_verts, normals, g_means, g_scales, g_quats, g_opac, cfg,
        range_per_vertex=cfg.proposal_std_range * stds, parts=parts)

    # pre-clamp by the local mean edge length (bounds the KNN window the
    # intersection tests must cover); sums in a fixed order, as JAX's two
    # scatters add them
    with parts.device("edge clamp"):
        edges = torch.cat([faces_t[:, [0, 1]], faces_t[:, [1, 2]], faces_t[:, [2, 0]]])
        el = torch.linalg.norm(shell_verts[edges[:, 0]] - shell_verts[edges[:, 1]], dim=-1)
        ends = torch.cat([edges[:, 0], edges[:, 1]])
        acc = segment.sum_by_index(torch.cat([el, el]), ends, v)
        deg = torch.bincount(ends, minlength=v).to(torch.float32)
        cap = cfg.max_offset_edge_factor * (acc / torch.clamp(deg, min=1.0))
        inner_dist = torch.maximum(inner_dist, -cap)
        outer_dist = torch.minimum(outer_dist, cap)

    if cfg.avoid_self_intersections:
        inner_dist, outer_dist = avoid_self_intersections(
            shell_verts, normals, faces_t, inner_dist, outer_dist,
            scene_scale=spatial_extent, n_iters=cfg.self_intersection_iters,
            k=cfg.self_intersection_knn, parts=parts)
    min_sz = cfg.min_frosting_size * spatial_extent
    outer_dist = torch.clamp(outer_dist, min=min_sz)
    inner_dist = torch.clamp(inner_dist, max=-min_sz)

    # cell volumes ~ base area x mean thickness (fm:437-495); for unbounded
    # scenes both in contracted space, so that distant background cells do
    # not swallow the budget (fm:443-471)
    with parts.device("volumes"):
        vol_verts, thick_v = shell_verts, outer_dist - inner_dist
        if contract_points:
            c = (torch.as_tensor(np.asarray(camera_center, np.float32), device=dev).reshape(1, 3)
                 if camera_center is not None else torch.zeros((1, 3), device=dev))
            vol_verts = contract(shell_verts, c, spatial_extent)
            d = torch.linalg.norm(shell_verts - c, dim=-1)
            damp = torch.where(d > spatial_extent,
                               (spatial_extent / torch.clamp(d, min=1e-12)) ** 2, 1.0)
            thick_v = thick_v * damp
        areas = mesh_ops.face_areas(vol_verts, faces_t)
        thick = thick_v[faces_t].mean(dim=1)
        volumes = areas * torch.clamp(thick, min=cfg.min_frosting_size * spatial_extent)

    # volume-proportional allocation by inverse CDF, then SORTED by cell
    # (the distribution is unchanged: every other per-Gaussian quantity is
    # drawn iid afterwards), so the corner gradients reduce per segment
    with parts.device("allocation"):
        if u_cell is None:
            u_cell = torch.rand((n,), generator=generator, device=dev)
        if u_bary is None:
            u_bary = torch.rand((n, 6), generator=generator, device=dev)
        p = volumes / torch.clamp(volumes.sum(), min=1e-30)
        cdf = segment.cumsum(p)  # torch.cumsum's 1-D scan varies on the card
        cell_idx = torch.clamp(torch.searchsorted(cdf, u_cell.to(dev) * cdf[-1], right=True),
                               0, n_faces - 1)
        cell_idx, _ = torch.sort(cell_idx)
        cell_bounds = torch.searchsorted(
            cell_idx, torch.arange(n_faces + 1, device=dev, dtype=cell_idx.dtype))
        # random barycentric init: sorted-uniform differences (fm:502-507)
        u = u_bary.to(dev).clone()
        u[:, -1] = 1.0
        u, _ = torch.sort(u, dim=-1)
        bary = torch.cat([u[:, :1], u[:, 1:] - u[:, :-1]], dim=-1)
        bary_logits = torch.log(torch.clamp(bary, min=1e-8))
        del u, bary, cdf, p
    meta = meta._replace(cell_idx=cell_idx, cell_bounds=cell_bounds)

    params = FrostingParams(
        shell_verts=shell_verts,
        inner_dist=inner_dist,
        outer_dist=outer_dist,
        bary_logits=bary_logits,
        scales_log=torch.zeros((n, 3), device=dev),
        quats_raw=torch.cat([torch.ones((n, 1), device=dev), torch.zeros((n, 3), device=dev)], 1),
        opacities_raw=torch.full(
            (n,), float(inverse_sigmoid(torch.tensor(0.1, dtype=torch.float32))), device=dev),
        sh_dc=torch.zeros((n, 1, 3), device=dev),
        sh_rest=torch.zeros((n, sh_ops.num_sh_coeffs(cfg.sh_degree) - 1, 3), device=dev),
    )

    # scale init: the KNN distance among the frosting points, clamped by the
    # longest edge of the cell
    with parts.device("scale KNN"):
        corners = cell_corners(params, faces_t, meta.incidence)
        pts = blend_corners(bary_logits, corners, cell_idx, cell_bounds)
        d2 = torch.clamp(knn_lib.mean_knn_sqdist(pts, k=3), min=1e-7)
        side = torch.linalg.norm(corners[:, 3:] - corners[:, :3], dim=-1)  # [F, 3]
        base = torch.linalg.norm(corners[:, [0, 1, 2]] - corners[:, [1, 2, 0]], dim=-1)
        max_len = torch.maximum(side.amax(-1), base.amax(-1))[cell_idx]
        scales0 = torch.sqrt(torch.minimum(d2, max_len * max_len))
        params.scales_log = torch.log(scales0)[:, None].repeat(1, 3)
        del corners, d2, max_len, scales0

    # SH from the closest source Gaussian (fm:517-556)
    if gaussians is not None:
        with parts.device("SH transfer"):
            closest = knn_lib.knn_query(pts, g_means, k=1)[0][:, 0]
            params.sh_dc = gaussians.sh_dc[closest]
            params.sh_rest = gaussians.sh_rest[closest]

    if use_background and gaussians is not None:
        lo, hi = shell_verts.amin(0), shell_verts.amax(0)
        inside = torch.all((gaussians.means3d > lo) & (gaussians.means3d < hi), dim=-1)
        bg_mask = (~inside) & (gaussians.mask > 0.5)
        params.bg = dataclasses.replace(gaussians, mask=bg_mask.to(torch.float32))
    return params, meta
