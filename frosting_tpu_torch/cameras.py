"""Camera model: 3DGS-convention pinhole cameras holding torch tensors.

Counterpart of ``frosting_tpu/cameras.py``. Matrices are stored in the
ROW-VECTOR convention, p_view = [p, 1] @ world_view, as the reference hands
them to the CUDA rasterizer (transposed getWorld2View2).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Tuple

import numpy as np
import torch


def world_to_view(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """4x4 world->view (getWorld2View2, graphics_utils.py:52-63),
    COLUMN-vector convention; R is stored transposed as in COLMAP loaders."""
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    return Rt


def projection_matrix(
    znear: float,
    zfar: float,
    fov_x: float,
    fov_y: float,
    pp_x: float = 0.5,
    pp_y: float = 0.5,
) -> np.ndarray:
    """OpenGL-style perspective with z in [0, 1] (graphics_utils.py:66-87),
    COLUMN-vector convention. pp_x/pp_y: principal point as a fraction of
    the image size (0.5 = centred); the off-centre terms land in column 2."""
    tan_x = math.tan(fov_x / 2.0)
    tan_y = math.tan(fov_y / 2.0)
    P = np.zeros((4, 4), dtype=np.float64)
    P[0, 0] = 1.0 / tan_x
    P[1, 1] = 1.0 / tan_y
    P[0, 2] = 2.0 * pp_x - 1.0
    P[1, 2] = 2.0 * pp_y - 1.0
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


@dataclasses.dataclass(frozen=True)
class Camera:
    """One 3DGS camera. All matrices row-vector convention; the image size
    lives in RasterConfig."""

    world_view: torch.Tensor  # [4, 4]  p_view = [p,1] @ world_view
    full_proj: torch.Tensor  # [4, 4]  p_clip = [p,1] @ full_proj
    cam_center: torch.Tensor  # [3]
    tan_fov_x: torch.Tensor  # []
    tan_fov_y: torch.Tensor  # []

    def focals(self, width: int, height: int) -> Tuple[torch.Tensor, torch.Tensor]:
        return (
            width / (2.0 * self.tan_fov_x),
            height / (2.0 * self.tan_fov_y),
        )

    def to(self, device) -> "Camera":
        return Camera(
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
            }
        )


def camera_from_numpy(d: Mapping[str, np.ndarray], device="cuda") -> Camera:
    """Camera from {field: array}, e.g. the JAX package's camera as
    ``{f.name: np.asarray(getattr(cam, f.name)) for f in fields(cam)}``."""
    return Camera(
        **{
            f.name: torch.from_numpy(np.array(d[f.name], np.float32)).to(device)
            for f in dataclasses.fields(Camera)
        }
    )


def make_camera(
    R: np.ndarray,
    t: np.ndarray,
    fov_x: float,
    fov_y: float,
    znear: float = 0.01,
    zfar: float = 100.0,
    pp_x: float = 0.5,
    pp_y: float = 0.5,
    device="cuda",
) -> Camera:
    """Camera from COLMAP-style R (cam-to-world rotation, as the reference's
    loaders give it) and translation t (world->cam). pp_x/pp_y: principal
    point as a fraction of the image size (0.5 = centred)."""
    wv = world_to_view(np.asarray(R, np.float64), np.asarray(t, np.float64))
    proj = projection_matrix(znear, zfar, fov_x, fov_y, pp_x, pp_y)
    full = proj @ wv  # column-vector composition
    center = np.linalg.inv(wv)[:3, 3]
    return camera_from_numpy(
        {
            "world_view": wv.T,
            "full_proj": full.T,
            "cam_center": center,
            "tan_fov_x": math.tan(fov_x / 2.0),
            "tan_fov_y": math.tan(fov_y / 2.0),
        },
        device=device,
    )


def look_at_camera(
    eye, target, up=(0.0, 1.0, 0.0), fov_x=math.radians(60), fov_y=None, **kw
) -> Camera:
    """Camera at `eye` looking at `target`, +z forward (3DGS convention).
    Keyword arguments go to make_camera (znear, zfar, pp_x, pp_y, device)."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    # rows of the world->cam rotation (x=right, y=down, z=forward)
    Rcw = np.stack([right, down, fwd], axis=0)
    t = -Rcw @ eye
    if fov_y is None:
        fov_y = fov_x
    return make_camera(Rcw.T, t, fov_x, fov_y, **kw)


def ndc_to_pix(v: torch.Tensor, size: int) -> torch.Tensor:
    """NDC [-1, 1] -> pixel centres (ndc2Pix, auxiliary.h:41-44)."""
    return ((v + 1.0) * size - 1.0) * 0.5
