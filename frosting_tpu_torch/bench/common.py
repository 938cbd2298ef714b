"""What the port's measurement entry points share: the card's peak rates,
its name and power limit, bench.py's synthetic scene, the capacity
autotune, the timed render loops, and three timers.

- ``bench_scene`` draws ``bench.py`` / ``scripts/bench_1080p.py``'s scene
  with numpy, in their exact order, so that both packages see the same
  Gaussians.
- ``fwd_bwd_loop`` and ``fwd_loop`` are bench.py's loops: each iteration
  perturbs the opacities and means (bench.py:101-102, 112-113) and adds
  ``sum|grad|`` of the opacities (an L1 loss against a zero target) or the
  image's sum to an accumulator on the device; ``measure`` times them.
- ``timed`` times one call of a loop: CUDA events on the card, the host
  clock on the CPU (where only the tests call it).
- ``cuda_ms`` is the median of single calls timed with CUDA events.
- ``graph_ms`` replays a CUDA graph of many calls and keeps the fastest
  replay: the card's counterpart of the TPU scripts' "fori_loop in one
  dispatch", for kernels far shorter than the host's time to launch them.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable, Tuple

import numpy as np
import torch

from frosting_tpu_torch.raster.config import RasterConfig
from frosting_tpu_torch.raster.render import (
    autotune_max_instances,
    count_instances,
    render,
)

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): 3.35 TB/s
# HBM3 and 67 TFLOP/s FP32 outside the tensor cores, i.e. 132 SMs x 128 FP32
# lanes x 2 flops x 1.98 GHz. The SFU issues 16 transcendentals per SM per
# clock: 132 x 16 x 1.98e9 = 4.18e12 exp/s. Packed bf16x2 FMA outside the
# tensor cores runs at twice the FP32 rate (the Hopper white paper's
# 133.8 TFLOP/s "BF16 non-tensor").
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
SFU_OPS_S = 132 * 16 * (FP32_FLOP_S / (132 * 128 * 2))
BF16X2_FLOP_S = 2 * FP32_FLOP_S


def smi() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def bench_scene(n, seed, lo, hi, s_lo, s_hi):
    """bench.py / scripts/bench_1080p.py's scene as float32 numpy arrays
    (means, scales, quats, opacities, sh)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(lo, hi, (n, 3))
    scales = np.exp(rng.uniform(np.log(s_lo), np.log(s_hi), (n, 3)))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.3, 0.95, n)
    sh = rng.normal(size=(n, 16, 3)) * 0.2
    sh[:, 0] = (means + 1.0) * 0.7
    return [np.asarray(a, np.float32) for a in (means, scales, quats, opac, sh)]


def autotuned_config(gs, camera, probe_capacity: int, safety: float = 1.25,
                     **cfg) -> Tuple[RasterConfig, int]:
    """bench.py's capacity autotune: count one view's instances under a
    probe capacity, then size max_instances to safety x that count (a
    multiple of the chunk). Returns (config, instance count)."""
    probe = RasterConfig(max_instances=probe_capacity, **cfg)
    with torch.no_grad():
        n_inst = count_instances(*gs, camera, probe)
    cap = autotune_max_instances(n_inst, probe.chunk, safety=safety)
    return RasterConfig(max_instances=cap, **cfg), n_inst


def timed(fn: Callable, device) -> Tuple[float, object]:
    """(ms, result) of one call of fn: CUDA events on a CUDA device, the
    host clock on the CPU."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        result = fn()
        return (time.perf_counter() - t0) * 1e3, result
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    result = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), result


def cuda_ms(fn: Callable, reps: int) -> float:
    """Median device time of fn over reps runs, after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    return statistics.median(timed(fn, "cuda")[0] for _ in range(reps))


def graph_ms(fn: Callable, iters: int = 100, repeats: int = 5) -> float:
    """ms per call of fn: iters calls captured in one CUDA graph, replayed
    repeats times, the fastest replay over iters. fn runs once first,
    uncaptured (it builds and loads what it launches), and must neither
    synchronise nor read back to the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        best = min(best, timed(graph.replay, "cuda")[0] / iters)
    del graph
    return best


def perturbed(means, opac, i: int, salt: float):
    """bench.py's inputs of iteration i: (means + 1e-5 i + 1e-3 salt,
    clip(opac + 0.001 i + salt, 0, 1))."""
    return means + 1e-5 * i + salt * 1e-3, torch.clamp(opac + 0.001 * i + salt, 0, 1)


def opacity_grad(gs, camera, cfg: RasterConfig, target, i: int, salt: float):
    """The gradient of mean|image - target| in the opacities alone at
    iteration i (bench.py's jax.grad(loss, argnums=3): no other leaf needs
    a gradient)."""
    means, scales, quats, opac, sh = gs
    means_i, opac_i = perturbed(means, opac, i, salt)
    opac_i = opac_i.detach().requires_grad_(True)
    out = render(means_i, scales, quats, opac_i, sh, camera, cfg)
    loss = torch.mean(torch.abs(out.image - target))
    (grad,) = torch.autograd.grad(loss, opac_i)
    return grad


def fwd_bwd_loop(gs, camera, cfg: RasterConfig, target, iters: int, salt: float):
    """Sum over iters iterations of sum|opacity gradient|, on the device."""
    acc = torch.zeros((), device=gs[0].device)
    for i in range(iters):
        acc = acc + opacity_grad(gs, camera, cfg, target, i, salt).abs().sum()
    return acc


def fwd_loop(gs, camera, cfg: RasterConfig, iters: int, salt: float):
    """Sum over iters iterations of the rendered image's sum, on the
    device."""
    means, scales, quats, opac, sh = gs
    acc = torch.zeros((), device=means.device)
    with torch.no_grad():
        for i in range(iters):
            means_i, opac_i = perturbed(means, opac, i, salt)
            acc = acc + render(means_i, scales, quats, opac_i, sh, camera, cfg).image.sum()
    return acc


def measure(gs, camera, cfg: RasterConfig, iters: int, fwd_bwd_salts,
            fwd_salts, device) -> Tuple[float, float]:
    """(fwd+bwd ms, fwd-only ms) of iters iterations: each loop runs once
    with salt 0 to warm up, then once per salt; the fastest run counts.
    Raises if an accumulator is not finite."""
    target = torch.zeros((3, cfg.height, cfg.width), device=device)
    best = []
    for loop, salts in (
        (lambda s: fwd_bwd_loop(gs, camera, cfg, target, iters, s), fwd_bwd_salts),
        (lambda s: fwd_loop(gs, camera, cfg, iters, s), fwd_salts),
    ):
        loop(0.0)
        runs = [timed(lambda: loop(s), device) for s in salts]
        if not all(torch.isfinite(acc) for _, acc in runs):
            raise AssertionError("a bench accumulator is not finite")
        best.append(min(ms for ms, _ in runs))
    return best[0], best[1]


def device_label(device) -> str:
    """nvidia-smi's name and power limit on a CUDA device, else the device."""
    return smi() if torch.device(device).type == "cuda" else str(device)
