"""COLMAP sparse-reconstruction parsers (binary and text).

The port's own copy of ``frosting_tpu/scene/colmap.py`` (struct + numpy;
reference gaussian_splatting/scene/colmap_loader.py:43-294): cameras,
images (poses) and the seed point cloud.
"""

from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict, Tuple

import numpy as np

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


@dataclasses.dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray

    def focal_and_pp(self) -> Tuple[float, float, float, float]:
        if self.model == "SIMPLE_PINHOLE" or self.model == "SIMPLE_RADIAL":
            f, cx, cy = self.params[:3]
            return f, f, cx, cy
        if self.model in ("PINHOLE", "OPENCV", "FULL_OPENCV", "RADIAL"):
            if self.model == "RADIAL":
                f, cx, cy = self.params[:3]
                return f, f, cx, cy
            fx, fy, cx, cy = self.params[:4]
            return fx, fy, cx, cy
        raise ValueError(f"unsupported COLMAP camera model {self.model}")


@dataclasses.dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray  # wxyz, world->cam rotation
    tvec: np.ndarray
    camera_id: int
    name: str

    def rotation(self) -> np.ndarray:
        """world->cam rotation matrix from qvec."""
        w, x, y, z = self.qvec
        return np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ]
        )


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_bin(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            out[cam_id] = ColmapCamera(cam_id, name, int(w), int(h), params)
    return out


def read_images_bin(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path, "rb") as f:
        (num,) = _read(f, "<Q")
        for _ in range(num):
            img_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (n_pts,) = _read(f, "<Q")
            f.seek(24 * n_pts, os.SEEK_CUR)  # skip 2D points (x, y, id3d)
            out[img_id] = ColmapImage(
                img_id, qvec, tvec, cam_id, name.decode("utf-8")
            )
    return out


def read_points3d_bin(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """-> (xyz [N,3] f64, rgb [N,3] u8). Records are 43 bytes (id, xyz,
    rgb, error) and a track of 8-byte entries: the loop walks only the
    track lengths, numpy gathers the fields."""
    with open(path, "rb") as f:
        buf = f.read()
    (num,) = struct.unpack_from("<Q", buf, 0)
    offs = np.empty(num, np.int64)
    pos = 8
    for i in range(num):
        offs[i] = pos
        (track_len,) = struct.unpack_from("<Q", buf, pos + 43)
        pos += 51 + 8 * track_len
    raw = np.frombuffer(buf, np.uint8)
    xyz = raw[offs[:, None] + np.arange(8, 32)].copy().view("<f8")
    rgb = raw[offs[:, None] + np.arange(32, 35)]
    return xyz.astype(np.float64).reshape(num, 3), rgb.reshape(num, 3)


def read_cameras_txt(path: str) -> Dict[int, ColmapCamera]:
    out = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id = int(parts[0])
            model = parts[1]
            w, h = int(parts[2]), int(parts[3])
            params = np.array([float(p) for p in parts[4:]])
            out[cam_id] = ColmapCamera(cam_id, model, w, h, params)
    return out


def read_images_txt(path: str) -> Dict[int, ColmapImage]:
    out = {}
    with open(path) as f:
        lines = [
            l.strip()
            for l in f
            if l.strip() and not l.strip().startswith("#")
        ]
    for i in range(0, len(lines), 2):  # every other line is 2D points
        parts = lines[i].split()
        img_id = int(parts[0])
        qvec = np.array([float(x) for x in parts[1:5]])
        tvec = np.array([float(x) for x in parts[5:8]])
        cam_id = int(parts[8])
        name = parts[9]
        out[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name)
    return out


def read_points3d_txt(path: str) -> Tuple[np.ndarray, np.ndarray]:
    xyzs, rgbs = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyzs.append([float(x) for x in parts[1:4]])
            rgbs.append([int(x) for x in parts[4:7]])
    return np.array(xyzs, np.float64), np.array(rgbs, np.uint8)


def read_model(sparse_dir: str):
    """Read a COLMAP sparse model dir (binary preferred, text fallback).
    -> (cameras dict, images dict, xyz, rgb)"""
    if os.path.exists(os.path.join(sparse_dir, "cameras.bin")):
        cams = read_cameras_bin(os.path.join(sparse_dir, "cameras.bin"))
        imgs = read_images_bin(os.path.join(sparse_dir, "images.bin"))
        xyz, rgb = read_points3d_bin(os.path.join(sparse_dir, "points3D.bin"))
    else:
        cams = read_cameras_txt(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_txt(os.path.join(sparse_dir, "images.txt"))
        xyz, rgb = read_points3d_txt(os.path.join(sparse_dir, "points3D.txt"))
    return cams, imgs, xyz, rgb
