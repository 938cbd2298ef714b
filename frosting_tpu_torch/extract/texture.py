"""Textured-mesh extraction (stage 6): UV atlas, colour baking, OBJ export.

Counterpart of ``frosting_tpu/extract/texture.py``
(compute_textured_mesh_for_frosting_mesh and the OBJ export,
frosting_utils/texture.py:11-181): a block UV atlas packs two triangles per
square texel block with inset corners; each view's render of the frosting
(the forward blend, B1) is averaged into the texels its pixels land on,
through the mesh rasterizer's pix_to_face and barycentrics; texels no view
sees take their face's nearest-Gaussian colour.

What differs from the JAX version, on purpose:
- ``uv_atlas`` is vectorised (JAX loops over the faces in Python), with the
  same float64 arithmetic, so its UVs are bitwise JAX's;
- the texel sums are fixed-order segment sums keyed by texel id
  (``ops/segment.py``), not a float scatter-add, so a bake is bitwise
  reproducible on the card; each view's sum is added to the running total;
- the fill colour's nearest Gaussian comes from the exact device KNN
  (``ops/knn.knn_query``, k = 1) in place of a host cKDTree: both are exact,
  only ties may differ;
- the PNG is written by ``utils/png.py`` (no PIL): the same pixels, other
  bytes. The OBJ and MTL text are byte for byte JAX's, formatted a block of
  lines at a time rather than one f-string per line.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from frosting_tpu_torch.cameras import Camera
from frosting_tpu_torch.ops import knn as knn_lib
from frosting_tpu_torch.ops import mesh_raster, segment
from frosting_tpu_torch.ops import sh as sh_ops
from frosting_tpu_torch.raster import RasterConfig, render
from frosting_tpu_torch.utils.png import encode_png
from frosting_tpu_torch.utils.profiling import PartTimes

# rows of the OBJ formatted at once: bounds the writer's transient arrays
OBJ_ROWS = 1 << 17


def uv_atlas(n_faces: int, texture_size: int) -> Tuple[np.ndarray, int]:
    """Face corner UVs [F, 3, 2] float64 in [0, 1] (v up, the OBJ convention)
    and the blocks per side. Each square block holds 2 triangles
    (texture.py:35-72); corners are inset by a fraction of the block so
    bilinear lookups do not bleed."""
    blocks_per_side = int(math.ceil(math.sqrt((n_faces + 1) // 2)))
    block = 1.0 / blocks_per_side
    inset = 0.12 * block
    f = np.arange(n_faces, dtype=np.int64)
    b = f // 2
    x0 = (b % blocks_per_side) * block
    y0 = (b // blocks_per_side) * block
    x1, y1 = x0 + block, y0 + block
    lower = [[x0 + inset, y0 + inset], [x1 - 2 * inset, y0 + inset],
             [x0 + inset, y1 - 2 * inset]]  # lower-left triangle (even faces)
    upper = [[x1 - inset, y1 - inset], [x0 + 2 * inset, y1 - inset],
             [x1 - inset, y0 + 2 * inset]]  # upper-right triangle (odd faces)
    even = (f % 2 == 0)[:, None, None]
    uvs = np.where(even, np.moveaxis(np.asarray(lower), -1, 0),
                   np.moveaxis(np.asarray(upper), -1, 0))
    return uvs.astype(np.float64), blocks_per_side


def texel_ids(pix_to_face: torch.Tensor, bary: torch.Tensor, uvs: torch.Tensor,
              texture_size: int) -> torch.Tensor:
    """[P] texel id of each pixel's UV (row from the top, v up); uncovered
    pixels get texture_size^2, one past the last texel."""
    pf = pix_to_face.reshape(-1)
    br = bary.reshape(-1, 3)
    tri = uvs[torch.clamp(pf, min=0)]  # [P, 3, 2]
    # the corners' weighted sum in corner order, as JAX's sum adds them
    uv = tri[:, 0] * br[:, 0:1] + tri[:, 1] * br[:, 1:2] + tri[:, 2] * br[:, 2:3]
    tx = torch.clamp(uv[:, 0] * texture_size, 0, texture_size - 1)
    ty = torch.clamp((1.0 - uv[:, 1]) * texture_size, 0, texture_size - 1)
    tid = ty.to(torch.int64) * texture_size + tx.to(torch.int64)
    return torch.where(pf >= 0, tid, texture_size * texture_size)


def bake_texture(
    verts: torch.Tensor,  # [V, 3]
    faces: torch.Tensor,  # [F, 3]
    render_fn: Callable[[Camera], torch.Tensor],  # camera -> [3, H, W] image
    cameras: List[Camera],
    rcfg: RasterConfig,
    texture_size: int = 1024,
    face_fill_colors: Optional[np.ndarray] = None,  # [F, 3]
    stats: Optional[Dict] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Bake the views' renders into a texture. Returns (texture [S, S, 3]
    float32 in [0, 1], face UVs [F, 3, 2] float64). ``stats`` (a dict)
    receives the texel counts [S, S] and the seen share."""
    dev = verts.device
    f = int(faces.shape[0])
    n_tex = texture_size * texture_size
    uvs, blocks_per_side = uv_atlas(f, texture_size)
    uvs_t = torch.from_numpy(uvs.astype(np.float32)).to(dev)
    acc = torch.zeros((n_tex, 3), device=dev)
    cnt = torch.zeros((n_tex,), dtype=torch.int64, device=dev)
    with torch.inference_mode():
        for cam in cameras:
            image = render_fn(cam)
            frags = mesh_raster.rasterize_mesh(verts, faces, cam, rcfg)
            tid = texel_ids(frags.pix_to_face, frags.bary, uvs_t, texture_size)
            order, offsets = segment.sort_by_index(tid, n_tex + 1)
            cols = image.reshape(3, -1).t()
            acc += segment.segment_sum(cols[order], offsets)[:n_tex]
            cnt += (offsets[1:] - offsets[:-1])[:n_tex]
            del frags, tid, order, offsets, cols
    tex = acc.cpu().numpy().reshape(texture_size, texture_size, 3)
    count = cnt.cpu().numpy().reshape(texture_size, texture_size).astype(np.float32)
    seen = count > 0
    tex[seen] /= count[seen][:, None]
    if stats is not None:
        stats["texel_counts"] = count
        stats["seen_share"] = float(seen.mean())

    # unseen texels take their face's fill colour (texture.py:94-110)
    if face_fill_colors is not None:
        ys, xs = np.nonzero(~seen)
        u = (xs + 0.5) / texture_size
        v = 1.0 - (ys + 0.5) / texture_size
        bx = np.clip((u * blocks_per_side).astype(int), 0, blocks_per_side - 1)
        by = np.clip((v * blocks_per_side).astype(int), 0, blocks_per_side - 1)
        lu = u * blocks_per_side - bx
        lv = v * blocks_per_side - by
        tri = (lu + lv > 1.0).astype(int)  # upper-right half of the block
        fid = np.minimum((by * blocks_per_side + bx) * 2 + tri, f - 1)
        tex[ys, xs] = face_fill_colors[fid]
    return np.clip(tex, 0.0, 1.0), uvs


@torch.no_grad()
def face_average_sh_colors(
    face_centers: torch.Tensor,  # [F, 3]
    g_means: torch.Tensor,  # [N, 3]
    g_sh_dc: torch.Tensor,  # [N, 1, 3]
) -> np.ndarray:
    """[F, 3] float32: the DC colour of each face centre's nearest Gaussian
    (the reference's SH-average fill, texture.py:156-164), from the exact
    device KNN."""
    idx = knn_lib.knn_query(face_centers, g_means, k=1)[0][:, 0]
    return torch.clamp(sh_ops.sh_to_rgb(g_sh_dc[idx, 0]), 0.0, 1.0).cpu().numpy()


def _write_rows(out, fmt: str, rows: np.ndarray) -> None:
    """Write fmt % row for each row of rows [n, k], OBJ_ROWS rows at a time,
    each block by one ``%`` over the block's values as Python numbers: the
    bytes of one f-string per line."""
    for s in range(0, len(rows), OBJ_ROWS):
        block = rows[s:s + OBJ_ROWS]
        out.write(((fmt * len(block)) % tuple(block.ravel().tolist())).encode())


def export_obj(
    path: str,
    verts: np.ndarray,  # [V, 3]
    faces: np.ndarray,  # [F, 3]
    uvs: np.ndarray,  # [F, 3, 2]
    texture: np.ndarray,  # [S, S, 3] float
) -> None:
    """Write the OBJ, its MTL and PNG beside it (save_obj analogue,
    refine.py:623); the OBJ and MTL text byte for byte the JAX writer's."""
    base = os.path.splitext(path)[0]
    name = os.path.basename(base)
    with open(base + ".png", "wb") as fh:
        fh.write(encode_png((texture * 255).astype(np.uint8)))
    with open(base + ".mtl", "w") as m:
        m.write(f"newmtl material_0\nmap_Kd {name}.png\n")
    verts = np.asarray(verts)
    faces = np.asarray(faces).astype(np.int64)
    # every value formatted as the Python float (double) it converts to
    fv = verts.astype(np.float64)
    fuv = np.asarray(uvs, np.float64).reshape(-1, 2)
    t = 3 * np.arange(len(faces), dtype=np.int64)
    fidx = np.stack([faces[:, 0] + 1, t + 1, faces[:, 1] + 1, t + 2, faces[:, 2] + 1, t + 3],
                    axis=1)
    with open(path, "wb") as o:
        o.write(f"mtllib {name}.mtl\nusemtl material_0\n".encode())
        _write_rows(o, "v %.6f %.6f %.6f\n", fv)
        _write_rows(o, "vt %.6f %.6f\n", fuv)
        _write_rows(o, "f %d/%d %d/%d %d/%d\n", fidx)


def extract_textured_mesh(
    fparams,
    meta,
    cameras: List[Camera],
    rcfg: RasterConfig,
    path: str,
    texture_size: int = 1024,
    sh_degree: int = 3,
    parts: Optional[PartTimes] = None,
) -> Dict:
    """Stage 6: bake the refined frosting into a textured OBJ at path (with
    its .mtl and .png; extract_mesh_and_texture_from_frosting,
    textured_mesh.py:16-128). B1 renders each view once. Returns the seen
    share and the texel counts; ``parts`` collects the parts' times."""
    from frosting_tpu_torch.models.frosting import activate_frosting

    parts = parts or PartTimes("cpu")
    verts, faces = fparams.shell_verts, meta.faces
    dev = verts.device
    with torch.inference_mode():
        model = activate_frosting(fparams, meta)

        def render_cam(cam):
            return torch.clamp(render(*model, cam.to(dev), rcfg,
                                      active_sh_degree=sh_degree).image, 0.0, 1.0)

        with parts.device("fill colours (KNN)"):
            tri = verts[faces.long()]
            fc = (tri[:, 0] + tri[:, 1] + tri[:, 2]) / 3.0  # numpy's float32 mean
            fill = face_average_sh_colors(fc, model[0], model[4][:, :1])
            del tri, fc
        stats: Dict = {}
        with parts.device("bake (render + mesh raster + texel sums)"):
            tex, uvs = bake_texture(verts, faces, render_cam, cameras, rcfg, texture_size,
                                    fill, stats)
        del model
    with parts.host("OBJ + MTL + PNG write"):
        export_obj(path, verts.cpu().numpy(), faces.cpu().numpy(), uvs, tex)
    return stats
