"""Vanilla 3DGS parameter store: raw (pre-activation) tensors in a
fixed-capacity arena with a validity mask, and the 3DGS-viewer PLY format.

Counterpart of ``frosting_tpu/scene/gaussians.py``. Activations match the
reference (gaussian_model.py:26-41): exp scales, sigmoid opacity,
normalised quaternions.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from frosting_tpu_torch.ops import quat as quat_ops
from frosting_tpu_torch.ops import sh as sh_ops
from frosting_tpu_torch.utils import ply as ply_io


@dataclasses.dataclass
class GaussianParams:
    """Raw parameters. Leading dim = capacity; rows with mask 0 are dead
    arena slots."""

    means3d: torch.Tensor  # [C, 3]
    sh_dc: torch.Tensor  # [C, 1, 3]
    sh_rest: torch.Tensor  # [C, K-1, 3]
    scales_log: torch.Tensor  # [C, 3]
    quats_raw: torch.Tensor  # [C, 4]
    opacities_raw: torch.Tensor  # [C] logit
    mask: torch.Tensor  # [C] float32 0/1

    @property
    def capacity(self) -> int:
        return self.means3d.shape[0]

    def num_active(self) -> torch.Tensor:
        return torch.sum(self.mask).to(torch.int32)


def activate(
    p: GaussianParams,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (means3d, scales, quats, opacities, sh). Dead slots get opacity 0."""
    scales = torch.exp(p.scales_log)
    quats = quat_ops.normalize(p.quats_raw)
    opac = torch.sigmoid(p.opacities_raw) * p.mask
    sh = torch.cat([p.sh_dc, p.sh_rest], dim=1)
    return p.means3d, scales, quats, opac, sh


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))


def mean_knn_dist_sq(points: np.ndarray, k: int = 3) -> np.ndarray:
    """Mean squared distance to the k nearest neighbours, on the host: the
    scale initialiser (replaces simple-knn distCUDA2). Exact, by
    scipy's cKDTree; runs once at scene creation."""
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    d, _ = tree.query(points, k=k + 1, workers=-1)
    return (d[:, 1:] ** 2).mean(axis=1)


def create_from_pcd(
    points: np.ndarray,  # [N, 3]
    colors: np.ndarray,  # [N, 3] in [0, 1]
    capacity: int,
    sh_degree: int = 3,
    init_opacity: float = 0.1,
    device="cuda",
) -> GaussianParams:
    """Reference create_from_pcd (gaussian_model.py:124-147): SH DC from
    RGB, isotropic log-scale from the mean 3-NN distance, opacity logit of
    0.1. Dead slots are parked far away (means 1e6) with tiny scales
    (log -10), opacity logit -15 and the identity quaternion."""
    n = points.shape[0]
    if n > capacity:
        raise ValueError(f"point cloud ({n}) exceeds capacity ({capacity})")
    k = sh_ops.num_sh_coeffs(sh_degree)

    dist2 = np.maximum(mean_knn_dist_sq(points), 1e-7)
    scales_log = np.repeat(np.log(np.sqrt(dist2))[:, None], 3, axis=1)

    def park(a, fill=0.0):
        out = np.full((capacity,) + a.shape[1:], fill, np.float32)
        out[:n] = a
        return out

    quats = np.zeros((capacity, 4), np.float32)
    quats[:, 0] = 1.0
    mask = np.zeros((capacity,), np.float32)
    mask[:n] = 1.0
    sh_dc = sh_ops.rgb_to_sh(torch.from_numpy(np.asarray(colors, np.float32)))
    logit = float(inverse_sigmoid(torch.tensor(init_opacity, dtype=torch.float32)))
    return params_from_numpy(
        {
            "means3d": park(np.asarray(points, np.float32), fill=1e6),
            "sh_dc": park(sh_dc.numpy()[:, None, :]),
            "sh_rest": park(np.zeros((n, k - 1, 3), np.float32)),
            "scales_log": park(scales_log, fill=-10.0),
            "quats_raw": quats,
            "opacities_raw": park(np.full((n,), logit), fill=-15.0),
            "mask": mask,
        },
        device=device,
    )


def params_from_numpy(d: Mapping[str, np.ndarray], device="cuda") -> GaussianParams:
    """GaussianParams from {field: array}, e.g. the JAX package's parameters
    as ``{f.name: np.asarray(getattr(p, f.name)) for f in fields(p)}``."""
    return GaussianParams(
        **{
            f.name: torch.from_numpy(np.array(d[f.name], np.float32)).to(device)
            for f in dataclasses.fields(GaussianParams)
        }
    )


# --- 3DGS-viewer-compatible PLY checkpoint format (gaussian_model.py:177-256)


def save_ply(p: GaussianParams, path: str) -> None:
    live = p.mask.detach().cpu().numpy() > 0.5
    n_active = int(live.sum())

    def host(t):
        return t.detach().cpu().numpy()[live]

    means = host(p.means3d)
    props = {
        "x": means[:, 0],
        "y": means[:, 1],
        "z": means[:, 2],
        "nx": np.zeros(n_active, np.float32),
        "ny": np.zeros(n_active, np.float32),
        "nz": np.zeros(n_active, np.float32),
    }
    # SH stored channel-major (transpose(1, 2) then flatten), as the reference
    dc = host(p.sh_dc).transpose(0, 2, 1).reshape(n_active, -1)
    for i in range(dc.shape[1]):
        props[f"f_dc_{i}"] = dc[:, i]
    rest = host(p.sh_rest).transpose(0, 2, 1).reshape(n_active, -1)
    for i in range(rest.shape[1]):
        props[f"f_rest_{i}"] = rest[:, i]
    props["opacity"] = host(p.opacities_raw)
    scl = host(p.scales_log)
    for i in range(3):
        props[f"scale_{i}"] = scl[:, i]
    rot = host(p.quats_raw)
    for i in range(4):
        props[f"rot_{i}"] = rot[:, i]
    ply_io.write_ply(path, props)


def load_ply(
    path: str, capacity: Optional[int] = None, sh_degree: int = 3, device="cuda"
) -> GaussianParams:
    v = ply_io.read_ply(path)["vertex"]
    n = len(v["x"])
    cap = capacity or n
    k = sh_ops.num_sh_coeffs(sh_degree)

    means = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    dc = np.stack([v[f"f_dc_{i}"] for i in range(3)], axis=1).astype(np.float32)
    n_rest = 3 * (k - 1)
    rest = np.stack(
        [v[f"f_rest_{i}"] for i in range(n_rest)], axis=1
    ).astype(np.float32)
    rest = rest.reshape(n, 3, k - 1).transpose(0, 2, 1)  # channel-major on disk
    scl = np.stack([v[f"scale_{i}"] for i in range(3)], axis=1).astype(np.float32)
    rot = np.stack([v[f"rot_{i}"] for i in range(4)], axis=1).astype(np.float32)
    opac = np.asarray(v["opacity"], np.float32)

    def park(a, fill=0.0):
        out = np.full((cap,) + a.shape[1:], fill, np.float32)
        out[:n] = a
        return out

    mask = np.zeros((cap,), np.float32)
    mask[:n] = 1.0
    # dead slots parked far away with tiny scale and low opacity
    return params_from_numpy(
        {
            "means3d": park(means, fill=1e6),
            "sh_dc": park(dc.reshape(n, 1, 3)),
            "sh_rest": park(rest),
            "scales_log": park(scl, fill=-10.0),
            "quats_raw": park(rot),
            "opacities_raw": park(opac, fill=-15.0),
            "mask": mask,
        },
        device=device,
    )
