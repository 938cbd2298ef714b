"""What a rank measures and checks in the multi-device entry points: ms per
part of a step, the blend launches, collective bytes, peak memory, digests
that say whether a tensor is bitwise the same on every rank, and the
single-process 3DGS step that a sharded one is held to."""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import time
from typing import Dict, List

import torch
import torch.distributed as dist

from frosting_tpu_torch.ops.ssim import l1_loss, ssim
from frosting_tpu_torch.raster import blend_cuda, render
from frosting_tpu_torch.scene import gaussians as gauss_lib
from frosting_tpu_torch.train import densify as densify_lib
from frosting_tpu_torch.train import gs_trainer
from frosting_tpu_torch.train import optimizer as opt_lib

# the held bounds: tests/test_sharded.py's for a sharded step against the
# single-device batch mean
LOSS_RTOL, COS_MIN = 2e-4, 0.999
# the port's parity rule for one step against another: at most 1% of the
# values off by more than 1e-5 + 1e-4 |want|, none by more than 2 lr
STEP_ATOL, STEP_RTOL, STEP_FRACTION = 1e-5, 1e-4, 0.01


class Clock:
    """ms per part of one run: CUDA events on a card, the host clock on the
    CPU; ``mark(name)`` ends a part."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks = []
        self.mark("start")

    def mark(self, name):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def parts(self) -> Dict[str, float]:
        if self.cuda:
            self.marks[-1][1].synchronize()
            span = [(n, a.elapsed_time(b)) for (_, a), (n, b) in zip(self.marks, self.marks[1:])]
        else:
            span = [(n, (b - a) * 1e3) for (_, a), (n, b) in zip(self.marks, self.marks[1:])]
        out = {}
        for name, ms in span:
            out[name] = out.get(name, 0.0) + ms
        out["total"] = sum(ms for _, ms in span)
        return out


def counts():
    """(B1, B2) launches so far in this process (CPU calls are not counted)."""
    return (blend_cuda.blend_forward.launches, blend_cuda.blend_backward.launches)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class StageReport:
    """One stage of a run on this rank, from its construction to ``end``:
    the mean ms per step by part over the steps run through ``step``, the
    bytes of the mesh's collectives (``Mesh.stats``), the blend launches,
    the peak device memory and the seconds."""

    def __init__(self, mesh, device):
        self.mesh, self.device = mesh, torch.device(device)
        self.clocks: List[Clock] = []
        sync(self.device)
        mesh.reset_stats()
        self.before = counts()
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.t0 = time.perf_counter()

    def step(self, fn):
        """fn(mark) with a Clock of its own; returns fn's result."""
        clock = Clock(self.device)
        out = fn(clock.mark)
        self.clocks.append(clock)
        return out

    def aside(self, fn):
        """fn() outside the stage: its launches and seconds are not the
        stage's (a reference computed to hold a step against)."""
        sync(self.device)
        before, t0 = counts(), time.perf_counter()
        out = fn()
        sync(self.device)
        self.before = tuple(b + a - c for b, a, c in zip(self.before, counts(), before))
        self.t0 += time.perf_counter() - t0
        return out

    def end(self, **extra) -> dict:
        sync(self.device)
        seconds = time.perf_counter() - self.t0
        parts: Dict[str, float] = {}
        for clock in self.clocks:
            for name, ms in clock.parts().items():
                parts[name] = parts.get(name, 0.0) + ms / len(self.clocks)
        out = {"seconds": seconds, "steps": len(self.clocks), "ms_per_step": parts,
               "collectives": dict(self.mesh.stats),
               "launches": [a - b for a, b in zip(counts(), self.before)]}
        if self.device.type == "cuda":
            out["peak_gib"] = torch.cuda.max_memory_allocated(self.device) / 2**30
        out.update(extra)
        return out


def digest(tensors) -> str:
    """A hash of the tensors' bytes, in order."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def equal_on_every_rank(value) -> bool:
    """True where every rank of the default group passed an equal value
    (every rank must call it)."""
    vals = [None] * dist.get_world_size()
    dist.all_gather_object(vals, value)
    return all(v == vals[0] for v in vals)


# --- the single-process 3DGS step a sharded one is held to ---


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    return float(torch.dot(a, b) / (a.norm() * b.norm() + 1e-12))


def step_parity(got: torch.Tensor, want: torch.Tensor, lr: float) -> dict:
    """The port's parity rule for a step's parameters against another's."""
    off = (got - want).abs()
    loose = off > STEP_ATOL + STEP_RTOL * want.abs()
    return {"fraction_off": float(loose.double().mean()), "max_off": float(off.max()),
            "ok": bool(loose.double().mean() <= STEP_FRACTION and off.max() <= 2 * lr)}


def flat_params(p) -> torch.Tensor:
    return torch.cat([getattr(p, g).detach().reshape(-1) for g in opt_lib.GROUPS])


def clone(x):
    """A deep copy of a state (tensors cloned)."""
    return copy.deepcopy(x)


def photometric(image, gt, lam):
    return (1.0 - lam) * l1_loss(image, gt) + lam * (1.0 - ssim(image, gt))


def reference_gs_step(state, cams, gts, opt, rcfg, cfg):
    """The single-process step on the cameras' mean loss, in place on state:
    ``gs_trainer.train_step`` for one camera; for several, its loss
    averaged over them, one Adam step, the probe gradients summed and the
    radii's maximum in the statistics (the sharded step's semantics)."""
    if len(cams) == 1:
        return gs_trainer.train_step(state, cams[0], gts[0], opt, rcfg, cfg, cfg.sh_degree)[1]
    p = state.params
    dev = p.means3d.device
    bg = torch.full((3,), 1.0 if cfg.white_background else 0.0, device=dev)
    leaves = {g: getattr(p, g).detach().requires_grad_(True) for g in opt_lib.GROUPS}
    probe = torch.zeros((p.capacity, 2), device=dev, requires_grad=True)
    model = gauss_lib.activate(dataclasses.replace(p, **leaves))
    loss, radii = 0.0, None
    for cam, gt in zip(cams, gts):
        out = render(*model, cam, rcfg, bg=bg, means2d_probe=probe)
        loss = loss + photometric(out.image, gt, cfg.lambda_dssim) / len(cams)
        radii = out.radii if radii is None else torch.maximum(radii, out.radii)
    *grads, probe_grad = torch.autograd.grad(loss, [leaves[g] for g in opt_lib.GROUPS] + [probe])
    opt.step(p, dict(zip(opt_lib.GROUPS, grads)), state.opt_state)
    state.dstate = densify_lib.update_stats(state.dstate, probe_grad, radii, p.mask,
                                            image_size=(rcfg.width, rcfg.height))
    state.max_radii = torch.maximum(state.max_radii, radii.to(torch.float32))
    return {"loss": loss.detach()}


def hold_gs_step(state, loss: float, state0, cams, gts, opt, rcfg, cfg):
    """A sharded 3DGS step's result (``state``, its summed ``loss``) from
    ``state0`` against ``reference_gs_step`` from a copy of it on the same
    cameras and whole GT images. One camera: the port's parity rule on
    every group and the loss to rtol 1e-5; several: the batch mean's loss
    to LOSS_RTOL and the update's cosine above COS_MIN. Returns (the
    verdict as a dict with "ok", the reference state)."""
    ref = clone(state0)
    ref_loss = float(reference_gs_step(ref, cams, gts, opt, rcfg, cfg)["loss"])
    upd = flat_params(state.params) - flat_params(state0.params)
    ref_upd = flat_params(ref.params) - flat_params(state0.params)
    lr = float(opt.lrs["means3d"](torch.zeros((), dtype=torch.int32)))
    out = {"reference_loss": ref_loss, "loss_rel_err": abs(loss - ref_loss) / abs(ref_loss),
           "update_cosine": cosine(upd, ref_upd),
           "parity": {g: step_parity(getattr(state.params, g), getattr(ref.params, g),
                                     lr if g == "means3d" else opt.lrs[g])
                      for g in opt_lib.GROUPS}}
    if len(cams) == 1:
        out["ok"] = (all(v["ok"] for v in out["parity"].values())
                     and out["loss_rel_err"] <= 1e-5)
    else:
        out["ok"] = out["loss_rel_err"] <= LOSS_RTOL and out["update_cosine"] > COS_MIN
    return out, ref
