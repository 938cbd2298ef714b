"""Per-group Adam with the 3DGS exponential position schedule.

Counterpart of ``frosting_tpu/train/optimizer.py`` (reference
gaussian_model.py:149-175) and of the Frosting trainer's optax
``multi_transform``: one Adam per parameter group (the groups are those
given a learning rate; a frozen field has none), b1 0.9, b2 0.999, eps
1e-15 added outside the square root, bias correction, the position LR a
log-linear schedule scaled by the scene's spatial extent, ``sh_rest`` at
``feature_lr / 20`` and ``mask`` frozen. The arithmetic follows optax's
``scale_by_adam`` + ``scale_by_learning_rate`` step for step: each group
keeps its own step count, and the schedule reads the count from before the
step's increment.

A small Adam over explicit tensors, not ``torch.optim.Adam``, because the
trainer needs two things that class does not give plainly: (1) a step that
is a no-op on parameters, moments and counts alike when the loss is not
finite, decided on the device without a host sync (every update is a
``torch.where`` on a device flag, and the counts are device tensors); (2)
moment rows that densification zeroes in place (``reset_adam_rows``). The
state is a plain dataclass of dicts, so a JAX optimizer state converts into
it field by field (``gs_trainer.state_from_numpy``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Union

import torch

# The optimised fields of GaussianParams (the groups of make_gs_optimizer);
# ``mask`` is frozen.
GROUPS = ("means3d", "sh_dc", "sh_rest", "scales_log", "quats_raw", "opacities_raw")
B1, B2 = 0.9, 0.999

Schedule = Callable[[torch.Tensor], torch.Tensor]


def expon_lr(
    lr_init: float,
    lr_final: float,
    lr_delay_steps: int = 0,
    lr_delay_mult: float = 1.0,
    max_steps: int = 1_000_000,
) -> Schedule:
    """Log-linear decay with an optional sine delay ramp
    (frosting_utils/general_utils.py:22-56), as a function of the step
    count tensor -> float32 tensor."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        step = step.to(torch.float32)
        if lr_init == 0.0 and lr_final == 0.0:
            return torch.zeros_like(step)
        if lr_delay_steps > 0:
            ramp = torch.clamp(step / lr_delay_steps, 0.0, 1.0)
            delay = lr_delay_mult + (1.0 - lr_delay_mult) * torch.sin(
                0.5 * math.pi * ramp
            )
        else:
            delay = 1.0
        t = torch.clamp(step / max_steps, 0.0, 1.0)
        log_init = torch.log(torch.tensor(lr_init, dtype=torch.float32))
        log_final = torch.log(torch.tensor(lr_final, dtype=torch.float32))
        return delay * torch.exp(
            log_init.to(step.device) * (1.0 - t) + log_final.to(step.device) * t
        )

    return schedule


@dataclasses.dataclass(frozen=True)
class GSOptimConfig:
    """Reference defaults (gaussian_splatting/arguments/__init__.py:74-81)."""

    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    eps: float = 1e-15


@dataclasses.dataclass
class AdamState:
    """Per-group first and second moments (shaped as the field) and step
    counts ([] int32 tensors)."""

    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    count: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class GSOptimizer:
    """Learning rate per group (a float, or a schedule of the step count)
    and Adam's eps."""

    lrs: Dict[str, Union[float, Schedule]]
    eps: float = 1e-15

    @property
    def groups(self):
        """The trained groups: those with a learning rate. A frozen field
        (optax's ``set_to_zero``) is simply absent."""
        return tuple(self.lrs)

    def init(self, params) -> AdamState:
        fields = {g: _group(params, g) for g in self.groups}
        return AdamState(
            mu={g: torch.zeros_like(t) for g, t in fields.items()},
            nu={g: torch.zeros_like(t) for g, t in fields.items()},
            count={
                g: torch.zeros((), dtype=torch.int32, device=t.device)
                for g, t in fields.items()
            },
        )

    @torch.no_grad()
    def step(
        self,
        params,
        grads: Dict[str, torch.Tensor],
        state: AdamState,
        good: Optional[torch.Tensor] = None,
    ) -> None:
        """One Adam step of every group, in place on params and state. With
        ``good`` (a [] bool device tensor) false, params, moments and counts
        are left as they were."""
        for g in self.groups:
            p = _group(params, g)
            grad = grads[g]
            if good is not None:
                grad = torch.where(good, grad, 0.0)
            mu = (1.0 - B1) * grad + B1 * state.mu[g]
            nu = (1.0 - B2) * (grad * grad) + B2 * state.nu[g]
            count = state.count[g] + 1
            c = count.to(torch.float32)
            mu_hat = mu / (1.0 - torch.pow(B1, c))
            nu_hat = nu / (1.0 - torch.pow(B2, c))
            update = mu_hat / (torch.sqrt(nu_hat) + self.eps)
            lr = self.lrs[g]
            if callable(lr):
                lr = lr(state.count[g])  # the count before this step
            new_p = p + (-lr) * update
            if good is not None:
                new_p = torch.where(good, new_p, p)
                mu = torch.where(good, mu, state.mu[g])
                nu = torch.where(good, nu, state.nu[g])
                count = torch.where(good, count, state.count[g])
            p.copy_(new_p)
            state.mu[g] = mu
            state.nu[g] = nu
            state.count[g] = count


def _group(params, g: str) -> torch.Tensor:
    """A group's tensor: a field of a params dataclass, or an entry of a
    {group: tensor} mapping (the Frosting trainer names its background
    Gaussians' fields bg_<field>)."""
    return params[g] if isinstance(params, Mapping) else getattr(params, g)


def make_gs_optimizer(
    spatial_extent: float, cfg: GSOptimConfig = GSOptimConfig()
) -> GSOptimizer:
    """The 3DGS optimizer over GaussianParams; ``mask`` is frozen."""
    return GSOptimizer(
        lrs={
            "means3d": expon_lr(
                cfg.position_lr_init * spatial_extent,
                cfg.position_lr_final * spatial_extent,
                lr_delay_mult=cfg.position_lr_delay_mult,
                max_steps=cfg.position_lr_max_steps,
            ),
            "sh_dc": cfg.feature_lr,
            "sh_rest": cfg.feature_lr / 20.0,
            "opacities_raw": cfg.opacity_lr,
            "scales_log": cfg.scaling_lr,
            "quats_raw": cfg.rotation_lr,
        },
        eps=cfg.eps,
    )


def reset_adam_rows(state: AdamState, field_masks: Dict[str, torch.Tensor]) -> None:
    """Zero the Adam moments of arena rows, in place: ``field_masks`` maps
    field names to [C] row masks (1 = reset that row). With a fixed-capacity
    arena this replaces the reference's optimizer-state surgery on
    densify/prune (sugar_densifier.py:48-128). Counts are left alone."""
    for f, m in field_masks.items():
        keep = (1.0 - m).reshape((-1,) + (1,) * (state.mu[f].dim() - 1))
        state.mu[f] = state.mu[f] * keep
        state.nu[f] = state.nu[f] * keep
