"""Export of trained models as 3DGS-viewer PLY files.

Counterpart of ``export_gaussians_ply`` and ``export_frosting_ply`` of
``frosting_tpu/pipeline.py``, over the port's ``utils/ply.py``; the files
are byte for byte what the JAX package writes for the same arrays. The
pipeline runner (``run_pipeline``, the stage-artifact cache) is not ported
yet: ROADMAP item A12.
"""

from __future__ import annotations

import numpy as np
import torch

from frosting_tpu_torch.models import frosting as frosting_lib
from frosting_tpu_torch.utils import ply as ply_io


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def export_gaussians_ply(means, scales, quats, opac, sh, path: str) -> None:
    """Write activated Gaussian arrays (tensors or arrays) as a
    3DGS-viewer PLY (gaussian_model.py:177-208 field layout)."""
    means, scales, quats, opac, sh = (_host(a) for a in (means, scales, quats, opac, sh))
    n = means.shape[0]
    props = {
        "x": means[:, 0],
        "y": means[:, 1],
        "z": means[:, 2],
        "nx": np.zeros(n, np.float32),
        "ny": np.zeros(n, np.float32),
        "nz": np.zeros(n, np.float32),
    }
    dc = sh[:, :1].transpose(0, 2, 1).reshape(n, -1)
    for i in range(dc.shape[1]):
        props[f"f_dc_{i}"] = dc[:, i]
    rest = sh[:, 1:].transpose(0, 2, 1).reshape(n, -1)
    for i in range(rest.shape[1]):
        props[f"f_rest_{i}"] = rest[:, i]
    opac = np.clip(opac, 1e-6, 1 - 1e-6)
    props["opacity"] = np.log(opac / (1 - opac)).astype(np.float32)
    scl = np.log(np.maximum(scales, 1e-12))
    for i in range(3):
        props[f"scale_{i}"] = scl[:, i]
    for i in range(4):
        props[f"rot_{i}"] = quats[:, i]
    ply_io.write_ply(path, props)


@torch.no_grad()
def export_frosting_ply(fparams, meta, path: str) -> None:
    """The refined frosting as a 3DGS-viewer PLY
    (convert_frosting_into_gaussians -> save_ply, refine.py:585-599)."""
    export_gaussians_ply(*frosting_lib.to_gaussians(fparams, meta), path)
