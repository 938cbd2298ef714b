"""Flat ``.npz`` checkpoints of the trainers' parameters.

Counterpart of ``save_npz``/``load_npz`` and ``save_frosting``/
``load_frosting`` in ``frosting_tpu/train/checkpoint.py``, without orbax.
``save_npz`` stores a parameter dataclass's leaves as ``leaf_0``,
``leaf_1``, ... in its field order, the order in which JAX flattens it
(GaussianParams' seven, MeshBoundParams' six). ``save_frosting`` stores a
frosting model by name: its fields, ``bg_<field>`` for the background
Gaussians and ``meta_faces``, ``meta_cell_idx``, ``meta_cell_bounds``,
float32 and int32 as JAX writes them. A file either package writes loads
in the other.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from frosting_tpu_torch.scene.gaussians import GaussianParams


def save_npz(path: str, params) -> None:
    """A parameter dataclass (GaussianParams, MeshBoundParams) as its
    leaves in field order."""
    np.savez(
        path,
        **{
            f"leaf_{i}": getattr(params, f.name).detach().cpu().numpy()
            for i, f in enumerate(dataclasses.fields(params))
        },
    )


def load_npz(path: str, device="cuda", cls=GaussianParams):
    """A save_npz file (either package's) as a `cls` on `device`."""
    with np.load(path) as z:
        return cls(
            **{
                f.name: torch.from_numpy(z[f"leaf_{i}"]).to(device)
                for i, f in enumerate(dataclasses.fields(cls))
            }
        )


def save_frosting(path: str, params, meta) -> None:
    """A self-describing frosting checkpoint: params, topology and the
    background Gaussians (refine.py:574-581)."""

    def host(t, dtype=np.float32):
        return np.asarray(t.detach().cpu().numpy(), dtype)

    arrays = {f.name: host(getattr(params, f.name))
              for f in dataclasses.fields(params) if f.name != "bg"}
    if params.bg is not None:
        for f in dataclasses.fields(params.bg):
            arrays[f"bg_{f.name}"] = host(getattr(params.bg, f.name))
    arrays["meta_faces"] = host(meta.faces, np.int32)
    arrays["meta_cell_idx"] = host(meta.cell_idx, np.int32)
    if meta.cell_bounds is not None:
        arrays["meta_cell_bounds"] = host(meta.cell_bounds, np.int32)
    np.savez(path, **arrays)


def load_frosting(path: str, device="cuda"):
    """(FrostingParams, FrostingMeta) from a save_frosting file (either
    package's)."""
    from frosting_tpu_torch.models import frosting as frosting_lib

    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    bg = None
    if "bg_means3d" in d:
        bg = {f.name: d[f"bg_{f.name}"] for f in dataclasses.fields(GaussianParams)}
    params = frosting_lib.params_from_numpy(dict(d, bg=bg), device=device)
    meta = frosting_lib.make_meta(d["meta_faces"], d["meta_cell_idx"],
                                  d.get("meta_cell_bounds"),
                                  n_verts=params.shell_verts.shape[0], device=device)
    return params, meta
