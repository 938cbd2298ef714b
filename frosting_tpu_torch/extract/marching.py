"""Marching tetrahedra iso-surface extraction, on the device of the grid.

Counterpart of ``frosting_tpu/extract/marching.py`` (numpy on the host):
each grid cube splits into 6 tetrahedra; a tetrahedron crossing the iso
level yields 1 or 2 triangles whose vertices are edge interpolations. No
case tables, no ambiguous configurations.

The same arithmetic as the numpy version: the field stays float32 (the
level compared and interpolated in float32, as numpy's weak Python
scalars do), positions are float64, corner ids and edge keys are global
int64 (an edge key reaches nx*ny*nz squared, 1.15e18 at 1024^3), so cubes
processed in z-slabs weld exactly. Cubes whose 8 corners all lie on one
side of the level are culled before they are expanded to tetrahedra (they
yield no triangle), which bounds a slab's id arrays by its crossing cubes.
Triangles come out in the numpy version's order, so the welded vertex ids
and faces are the same.
"""

from __future__ import annotations

from typing import Tuple

import torch

# Standard decomposition of the cube (corners c0..c7, bit order x + 2y + 4z)
# into 6 tetrahedra sharing the main diagonal 0-7:
_TETS = ((0, 1, 3, 7), (0, 3, 2, 7), (0, 2, 6, 7), (0, 6, 4, 7), (0, 4, 5, 7), (0, 5, 1, 7))
_CORNER_OFFSETS = tuple((x, y, z) for z in (0, 1) for y in (0, 1) for x in (0, 1))


def _collect_slab(grid, level, origin, spacing, z0, z1):
    """Crossing triangles of the cube layers [z0, z1) of the grid [nx, ny,
    nz]; ids, positions and interpolations in global coordinates. Returns
    (keys [m, 3], pos [m, 3, 3], anchor ids [m], sign [m]) or None."""
    dev = grid.device
    nx, ny, nz = grid.shape
    slab = grid[:, :, z0:z1 + 1]
    snx, sny, snz = slab.shape
    corners = [
        slab[ox:snx - 1 + ox, oy:sny - 1 + oy, oz:snz - 1 + oz].reshape(-1)
        for ox, oy, oz in _CORNER_OFFSETS
    ]
    n_above = sum((c > level).to(torch.int8) for c in corners)
    cube = torch.nonzero((n_above > 0) & (n_above < 8), as_tuple=True)[0]
    if len(cube) == 0:
        return None
    # integer GLOBAL coordinates of each crossing cube's corner 0 (cubes in
    # C order over x, y, z, as numpy's meshgrid(indexing="ij") lists them)
    cz = cube % (snz - 1) + z0
    cy = (cube // (snz - 1)) % (sny - 1)
    cx = cube // ((snz - 1) * (sny - 1))
    offs = torch.tensor(_CORNER_OFFSETS, dtype=torch.int64, device=dev)
    # global corner ids for welding: id = x + nx*(y + ny*z)
    ids8 = ((cx[:, None] + offs[:, 0]) + nx * ((cy[:, None] + offs[:, 1])
                                               + ny * (cz[:, None] + offs[:, 2])))
    tets = torch.tensor(_TETS, dtype=torch.int64, device=dev)
    tet_ids = ids8[:, tets].reshape(-1, 4)  # [ntets, 4]
    grid_flat = grid.reshape(-1)

    def value(ids):  # C-order flat index of a global corner id
        x, y, z = ids % nx, (ids // nx) % ny, ids // (nx * ny)
        return grid_flat[(x * ny + y) * nz + z]

    def corner_pos(ids):
        x, y, z = ids % nx, (ids // nx) % ny, ids // (nx * ny)
        return origin + spacing * torch.stack([x, y, z], dim=-1)

    above = value(tet_ids) > level  # [ntets, 4]
    n_above = above.sum(dim=1)

    def edge_vertex(id_a, id_b):
        """Interpolated iso vertex on edge (a, b); returns (key, pos)."""
        va, vb = value(id_a), value(id_b)
        t = (level - va) / torch.where(torch.abs(vb - va) < 1e-30, 1e-30, vb - va)
        t = torch.clamp(t, 0.0, 1.0)
        pos = corner_pos(id_a) * (1 - t[:, None]) + corner_pos(id_b) * t[:, None]
        key = torch.where(
            id_a < id_b,
            id_a * (nx * ny * nz) + id_b,
            id_b * (nx * ny * nz) + id_a,
        )
        return key, pos

    tris = []  # (keys [m,3], pos [m,3,3], anchor ids [m], sign [m])

    # Case 1 / 3: exactly one corner above (sign +1: normal away from it)
    # or exactly one below (sign -1: normal toward it).
    for side, sign in ((above, 1.0), (~above, -1.0)):
        rows = torch.nonzero(side.sum(dim=1) == 1, as_tuple=True)[0]
        if len(rows) == 0:
            continue
        iso_corner = torch.argmax(side[rows].to(torch.int8), dim=1)
        ids = tet_ids[rows]
        r = torch.arange(len(rows), device=dev)
        a = ids[r, iso_corner]
        k0, p0 = edge_vertex(a, ids[r, (iso_corner + 1) % 4])
        k1, p1 = edge_vertex(a, ids[r, (iso_corner + 2) % 4])
        k2, p2 = edge_vertex(a, ids[r, (iso_corner + 3) % 4])
        tris.append((torch.stack([k0, k1, k2], 1), torch.stack([p0, p1, p2], 1), a,
                     torch.full((len(rows),), sign, dtype=torch.float64, device=dev)))

    # Case 2: two above, two below -> quad (2 triangles); anchor above.
    rows = torch.nonzero(n_above == 2, as_tuple=True)[0]
    if len(rows):
        ids = tet_ids[rows]
        # above corners first, each side in corner order (numpy's stable
        # argsort of ~above)
        order = torch.argsort((~above[rows]).to(torch.int8), dim=1, stable=True)
        idx = torch.gather(ids, 1, order)
        a0, a1, b0, b1 = idx[:, 0], idx[:, 1], idx[:, 2], idx[:, 3]
        k00, p00 = edge_vertex(a0, b0)
        k01, p01 = edge_vertex(a0, b1)
        k10, p10 = edge_vertex(a1, b0)
        k11, p11 = edge_vertex(a1, b1)
        ones = torch.ones(len(rows), dtype=torch.float64, device=dev)
        tris.append((torch.stack([k00, k01, k11], 1), torch.stack([p00, p01, p11], 1), a0, ones))
        tris.append((torch.stack([k00, k11, k10], 1), torch.stack([p00, p11, p10], 1), a0, ones))

    return tuple(torch.cat([t[i] for t in tris]) for i in range(4))


@torch.no_grad()
def marching_tets(
    grid: torch.Tensor,  # [Nx, Ny, Nz] float32 scalar field
    level: float,
    origin=(0.0, 0.0, 0.0),
    spacing=(1.0, 1.0, 1.0),
    max_slab_cubes: int = 32_000_000,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Extract the iso-surface {field == level} on the grid's device.
    Returns (verts [V, 3] float64, faces [F, 3] int64) with vertices welded
    on shared tet edges. Triangles are oriented so normals point toward
    LOWER field values (outward for a density field). Grids whose cube
    count exceeds max_slab_cubes are processed in z-slabs (identical
    output, bounded memory)."""
    dev = grid.device
    nx, ny, nz = grid.shape
    origin = torch.as_tensor(origin, dtype=torch.float64, device=dev)
    spacing = torch.as_tensor(spacing, dtype=torch.float64, device=dev)

    per_layer = max(1, (nx - 1) * (ny - 1))
    slab_layers = max(1, min(nz - 1, max_slab_cubes // per_layer))
    parts = []
    for z0 in range(0, nz - 1, slab_layers):
        z1 = min(z0 + slab_layers, nz - 1)  # cube layers [z0, z1)
        out = _collect_slab(grid, level, origin, spacing, z0, z1)
        if out is not None:
            parts.append(out)
    if not parts:
        return (torch.zeros((0, 3), dtype=torch.float64, device=dev),
                torch.zeros((0, 3), dtype=torch.int64, device=dev))

    all_keys, all_pos, all_anchor, all_sign = (
        torch.cat([p[i] for p in parts]) for i in range(4))

    # weld vertices by edge key; an edge met from both ends may carry
    # positions that differ in the last bit: take its last occurrence, as
    # numpy's verts[inv] = pos leaves it
    uniq, inv = torch.unique(all_keys.reshape(-1), sorted=True, return_inverse=True)
    last = torch.full((len(uniq),), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, inv, torch.arange(len(inv), device=dev), "amax")
    verts = all_pos.reshape(-1, 3)[last]
    faces = inv.reshape(-1, 3)

    # orient: normal points away from the above-side anchor (toward lower
    # field values)
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    n = torch.linalg.cross(v1 - v0, v2 - v0)
    centroid = (v0 + v1 + v2) / 3.0
    x = all_anchor % nx
    y = (all_anchor // nx) % ny
    z = all_anchor // (nx * ny)
    anchor_pos = origin + spacing * torch.stack([x, y, z], dim=-1)
    outward = all_sign * torch.sum(n * (centroid - anchor_pos), dim=1) >= 0
    faces = torch.where(outward[:, None], faces, faces[:, [0, 2, 1]])
    return verts, faces
