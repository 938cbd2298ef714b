"""Production-scale rasterizer benchmark on a CUDA card: 1920x1080 @ 1M
Gaussians.

    python -m frosting_tpu_torch.bench.bench_1080p

Port of ``scripts/bench_1080p.py``: its scene (seed 0), the default 32x16
tile, chunk 128, max_instances autotuned x1.25 from a 1<<22 probe, and
bench.py's loops (``bench/common.py``) at 5 iterations: one warm-up run
with salt 0, then one timed run each, fwd+bwd (salt 0.017) and fwd-only
(salt 0.013). Prints the instance count and capacity, then one JSON line:
metric, value (Mpix/s), unit, instances, ms_per_iter, fwd_only_mpix_s,
fwd_only_fps and the device. It writes no file: BENCH_1080P.json at the
repository's root is the JAX package's TPU record. Without a CUDA device
it exits nonzero.
"""

from __future__ import annotations

import json
import sys

import torch

from frosting_tpu_torch.bench.common import (
    autotuned_config,
    bench_scene,
    device_label,
    measure,
)
from frosting_tpu_torch.cameras import look_at_camera


def setup(device="cuda", n=1_000_000, width=1920, height=1080):
    """scripts/bench_1080p.py's scene on device, its camera and its
    autotuned config: (gs, camera, cfg, instance count)."""
    arrays = bench_scene(n, 0, -0.9, 0.9, 0.003, 0.015)
    gs = tuple(torch.from_numpy(a).to(device) for a in arrays)
    cam = look_at_camera(eye=[0.0, 0.0, -3.0], target=[0.0, 0.0, 0.0], device=device)
    cfg, n_inst = autotuned_config(gs, cam, 1 << 22, width=width, height=height,
                                   chunk=128)
    return gs, cam, cfg, n_inst


def run(device="cuda", n=1_000_000, width=1920, height=1080, iters=5, log=print):
    """scripts/bench_1080p.py's measurement on device; returns its JSON
    record."""
    gs, cam, cfg, n_inst = setup(device, n, width, height)
    log("instances", n_inst, "cap", cfg.max_instances)
    fb_ms, f_ms = measure(gs, cam, cfg, iters, [0.017], [0.013], device)
    mpix_s = width * height * iters / (fb_ms * 1e-3) / 1e6
    fwd_mpix_s = width * height * iters / (f_ms * 1e-3) / 1e6
    return {
        "metric": f"fwd+bwd rasterize {width}x{height} @{n / 1e6:g}M gaussians",
        "value": mpix_s,
        "unit": "Mpix/s",
        "instances": n_inst,
        "ms_per_iter": fb_ms / iters,
        "fwd_only_mpix_s": fwd_mpix_s,
        "fwd_only_fps": fwd_mpix_s * 1e6 / (width * height),
        "device": device_label(device),
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("bench_1080p: no CUDA device", file=sys.stderr)
        return 1
    print(json.dumps(run()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
