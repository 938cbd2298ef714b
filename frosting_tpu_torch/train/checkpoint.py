"""Flat ``.npz`` checkpoints of the trainer's parameters.

Counterpart of ``save_npz``/``load_npz`` in ``frosting_tpu/train/
checkpoint.py``, without orbax: the leaves are stored as ``leaf_0`` ...
``leaf_6`` in GaussianParams' field order, the order in which JAX flattens
that dataclass, so a ``.npz`` the JAX trainer wrote loads here and the
other way round.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from frosting_tpu_torch.scene.gaussians import GaussianParams


def save_npz(path: str, params: GaussianParams) -> None:
    np.savez(
        path,
        **{
            f"leaf_{i}": getattr(params, f.name).detach().cpu().numpy()
            for i, f in enumerate(dataclasses.fields(GaussianParams))
        },
    )


def load_npz(path: str, device="cuda") -> GaussianParams:
    z = np.load(path)
    return GaussianParams(
        **{
            f.name: torch.from_numpy(z[f"leaf_{i}"]).to(device)
            for i, f in enumerate(dataclasses.fields(GaussianParams))
        }
    )
