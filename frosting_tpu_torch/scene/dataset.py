"""Scene/dataset assembly: COLMAP or NeRF-synthetic sources -> camera list,
GT images, seed point cloud, spatial extent.

Counterpart of ``frosting_tpu/scene/dataset.py`` (reference gaussian_
splatting/scene/dataset_readers.py:68-259, frosting_scene/gs_model.py:
112-150): every-8th-image eval split, white compositing of RGBA,
NeRF++-style extent. Images are decoded and resized by ``utils/image.py``
in place of PIL, to the same arrays.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import List, Optional, Tuple

import numpy as np

from frosting_tpu_torch.cameras import Camera, focal_to_fov, make_camera
from frosting_tpu_torch.scene import colmap as colmap_io
from frosting_tpu_torch.utils import image as image_io


@dataclasses.dataclass
class CameraInfo:
    camera: Camera
    image_path: Optional[str]
    image_name: str
    width: int
    height: int
    # cached image array [3, H, W] (filled lazily)
    _image: Optional[np.ndarray] = None

    def image(self, bg: Tuple[float, float, float] = (1.0, 1.0, 1.0)):
        """[3, H, W]: float32, or float64 for four-channel files, which are
        composited over bg in float64 as the JAX loader does. Every mode
        flows as ``np.asarray(im).astype(np.float32) / 255.0`` makes it flow
        there, quirks kept for parity: a CMYK view composites its K channel
        as if it were alpha, a 16-bit ("I;16") view reaches 257, a palette
        view is its indices."""
        if self._image is None:
            arr, mode = image_io.read_image(self.image_path)
            if (arr.shape[1], arr.shape[0]) != (self.width, self.height):
                arr = image_io.resize(arr, mode, (self.width, self.height))
            arr = arr.astype(np.float32) / 255.0
            if arr.ndim == 2:
                arr = arr[..., None].repeat(3, -1)
            if arr.shape[-1] == 4:
                rgb, a = arr[..., :3], arr[..., 3:]
                arr = rgb * a + np.asarray(bg) * (1.0 - a)
            self._image = arr[..., :3].transpose(2, 0, 1).copy()
        return self._image


@dataclasses.dataclass
class SceneData:
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    points: np.ndarray  # [N, 3]
    colors: np.ndarray  # [N, 3] in [0, 1]
    spatial_extent: float  # NeRF++-style camera-extent radius


def nerfpp_extent(cam_centers: np.ndarray) -> float:
    """getNerfppNorm (dataset_readers.py): 1.1 * max distance to the average
    camera center."""
    center = cam_centers.mean(axis=0, keepdims=True)
    return float(np.linalg.norm(cam_centers - center, axis=1).max() * 1.1)


def load_colmap_scene(
    source_dir: str,
    images_dir: str = "images",
    resolution_scale: int = 1,
    eval_split: bool = True,
    llffhold: int = 8,
    device="cuda",
) -> SceneData:
    sparse = os.path.join(source_dir, "sparse", "0")
    if not os.path.isdir(sparse):
        sparse = os.path.join(source_dir, "sparse")
    cams, imgs, xyz, rgb = colmap_io.read_model(sparse)

    infos: List[CameraInfo] = []
    centers = []
    for img in sorted(imgs.values(), key=lambda im: im.name):
        cam = cams[img.camera_id]
        fx, fy, cx, cy = cam.focal_and_pp()
        fov_x = focal_to_fov(fx, cam.width)
        fov_y = focal_to_fov(fy, cam.height)
        R = img.rotation().T  # cam->world rotation, as the reference stores it
        # principal point as a size fraction: invariant under downscale
        camera = make_camera(
            R, img.tvec, fov_x, fov_y,
            pp_x=cx / cam.width, pp_y=cy / cam.height, device=device,
        )
        centers.append(-img.rotation().T @ img.tvec)
        infos.append(
            CameraInfo(
                camera=camera,
                image_path=os.path.join(source_dir, images_dir, img.name),
                image_name=img.name,
                width=cam.width // resolution_scale,
                height=cam.height // resolution_scale,
            )
        )
    extent = nerfpp_extent(np.stack(centers))
    if eval_split:
        train = [c for i, c in enumerate(infos) if i % llffhold != 0]
        test = [c for i, c in enumerate(infos) if i % llffhold == 0]
    else:
        train, test = infos, []
    return SceneData(
        train_cameras=train,
        test_cameras=test,
        points=xyz.astype(np.float32),
        colors=(rgb.astype(np.float32) / 255.0),
        spatial_extent=extent,
    )


def load_gs_cameras_json(
    gs_output_path: str,
    source_dir: Optional[str] = None,
    max_img_size: int = 1920,
    device="cuda",
) -> List[CameraInfo]:
    """Cameras of a 3DGS-training ``cameras.json`` (interop with upstream
    3DGS outputs; load_gs_cameras, frosting_scene/cameras.py:15-139), with
    the reference's max-size downscale rule."""
    with open(os.path.join(gs_output_path, "cameras.json")) as f:
        transforms = sorted(json.load(f), key=lambda c: c["img_name"])

    infos = []
    for cam in transforms:
        w, h = int(cam["width"]), int(cam["height"])
        if max(w, h) > max_img_size:
            scale = max(w, h) / max_img_size
            w, h = int(w / scale), int(h / scale)
        fov_x = focal_to_fov(float(cam["fx"]), cam["width"])
        fov_y = focal_to_fov(float(cam["fy"]), cam["height"])
        R = np.asarray(cam["rotation"], np.float64)  # cam->world
        pos = np.asarray(cam["position"], np.float64)
        infos.append(
            CameraInfo(
                camera=make_camera(R, -R.T @ pos, fov_x, fov_y, device=device),
                image_path=(
                    os.path.join(source_dir, "images", cam["img_name"])
                    if source_dir
                    else None
                ),
                image_name=cam["img_name"],
                width=w,
                height=h,
            )
        )
    return infos


def load_blender_scene(
    source_dir: str,
    split: str = "train",
    white_background: bool = True,
    n_random_points: int = 100_000,
    extent: float = 1.3,
    seed: int = 0,
    device="cuda",
) -> SceneData:
    """NeRF-synthetic transforms_{split}.json loader (dataset_readers.py
    readNerfSyntheticInfo): random seed points in [-extent, extent]^3, as
    no point cloud exists. ``white_background`` is accepted for the
    reference's signature; compositing happens in ``CameraInfo.image``."""
    with open(os.path.join(source_dir, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    fov_x = float(meta["camera_angle_x"])

    infos: List[CameraInfo] = []
    centers = []
    for frame in meta["frames"]:
        c2w = np.array(frame["transform_matrix"], np.float64)
        # NeRF convention: flip the y and z axes to the 3DGS/COLMAP one
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        path = os.path.join(source_dir, frame["file_path"] + ".png")
        width, height = image_io.image_size(path)
        fov_y = 2.0 * math.atan(math.tan(fov_x / 2.0) * height / width)
        infos.append(
            CameraInfo(
                camera=make_camera(
                    w2c[:3, :3].T, w2c[:3, 3], fov_x, fov_y, device=device
                ),
                image_path=path,
                image_name=os.path.basename(frame["file_path"]),
                width=width,
                height=height,
            )
        )
        centers.append(c2w[:3, 3])

    rng = np.random.default_rng(seed)
    points = rng.uniform(-extent, extent, (n_random_points, 3)).astype(np.float32)
    colors = rng.uniform(0.0, 1.0, (n_random_points, 3)).astype(np.float32)
    return SceneData(
        train_cameras=infos,
        test_cameras=[],
        points=points,
        colors=colors,
        spatial_extent=nerfpp_extent(np.stack(centers)),
    )
