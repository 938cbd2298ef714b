"""Smoke test of the PyTorch/CUDA port on one GPU.

Run from the root of the repository on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero):
  1. device: require CUDA, print `nvidia-smi` name and power limit;
  2. build: compile every kernel of the render path from csrc/ with nvcc;
  3. kernel vs plain: hold the CUDA forward blend against its plain PyTorch
     version on the same inputs (bench.py's 512x512 @ 100k scene, an odd
     1000x600 @ 20k size with partial edge tiles), and the port's render on
     a small scene against the per-pixel oracle;
  4. main path at full width: scripts/bench_1080p.py's scene (1M Gaussians,
     SH degree 3, seed 0) written as gs.ply, loaded back onto the card and
     served by the port's viewer at 1920x1080: three GET /render and one
     GET /state. The kernel's launch count is reset just before and read
     just after. Then the kernel, its plain version and a whole render are
     timed with CUDA events at that shape, and the kernel's bound is
     computed from this run's data.
The line before the last is the JSON kernels record; the last line is
{"ok": true, "device": {...}}.
"""

import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import urllib.request
import zlib

import numpy as np
import torch

from frosting_tpu_torch import _build
from frosting_tpu_torch.cameras import look_at_camera
from frosting_tpu_torch.raster import RasterConfig, render
from frosting_tpu_torch.raster import blend_cuda
from frosting_tpu_torch.raster.binning import bin_gaussians
from frosting_tpu_torch.raster.blend_torch import blend_forward_torch, blend_work_torch
from frosting_tpu_torch.raster.preprocess import pack_fields, preprocess
from frosting_tpu_torch.raster.reference import render_naive
from frosting_tpu_torch.raster.render import autotune_max_instances, count_instances
from frosting_tpu_torch.scene import gaussians as gauss_lib
from frosting_tpu_torch.utils import viewer

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit): 3.35 TB/s
# HBM3 and 67 TFLOP/s FP32 outside the tensor cores, i.e. 132 SMs x 128 FP32
# lanes x 2 flops x 1.98 GHz. The SFU issues 16 transcendentals per SM per
# clock: 132 x 16 x 1.98e9 = 4.18e12 exp/s.
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
SFU_OPS_S = 132 * 16 * (FP32_FLOP_S / (132 * 128 * 2))
# Per evaluated (instance, pixel) pair the blend needs at least dx, dy, the
# quadratic form (9 flops) and op * exp: 12 FP32 flops and one exp.
FLOPS_PER_PAIR = 12
# Kernel vs plain tolerance: atol/rtol 1e-5; at most 0.1% of pixels may
# differ by a stop-threshold flip (T * (1 - alpha) on the 1e-4 stop, where
# the two sum in another order), each by at most alpha * T <= 1e-2.
ATOL = RTOL = 1e-5
FLIP_SHARE, FLIP_BOUND = 1e-3, 1e-2
MAIN_W, MAIN_H, MAIN_N = 1920, 1080, 1_000_000
ORBITS = ((0.0, 0.3), (2.1, 0.2), (4.2, 0.45))  # (azimuth, elevation)
ORBIT_R = 3.5
DEV = "cuda"


def log(*a):
    print(*a, flush=True)


def smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def bench_scene(n, seed, lo, hi, s_lo, s_hi):
    """bench.py / scripts/bench_1080p.py's scene as float32 numpy arrays."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(lo, hi, (n, 3))
    scales = np.exp(rng.uniform(np.log(s_lo), np.log(s_hi), (n, 3)))
    quats = rng.normal(size=(n, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    opac = rng.uniform(0.3, 0.95, n)
    sh = rng.normal(size=(n, 16, 3)) * 0.2
    sh[:, 0] = (means + 1.0) * 0.7
    return [np.asarray(a, np.float32) for a in (means, scales, quats, opac, sh)]


def on_card(arrays):
    return tuple(torch.from_numpy(a).to(DEV) for a in arrays)


def blend_inputs(gs, cam, cfg):
    proj = preprocess(*gs, cam, cfg)
    binned = bin_gaussians(proj.rect, proj.depths, proj.valid, cfg)
    return pack_fields(proj), binned


def compare(label, fields, binned, cfg):
    """Kernel vs plain version on the same inputs; returns max abs error."""
    before = blend_cuda.blend_forward.launches
    out = blend_cuda.blend_forward(fields, binned, cfg)
    torch.cuda.synchronize()
    if blend_cuda.blend_forward.launches != before + 1:
        raise AssertionError(f"{label}: the kernel's launch count did not rise")
    ref = blend_forward_torch(fields, binned, cfg)
    err = (out - ref).abs()
    off = (err > ATOL + RTOL * ref.abs()).float().mean().item()
    max_err = err.max().item()
    log(f"{label}: instances {int(binned.num_instances)} max_abs_err {max_err:.3e} "
        f"share_off_tol {off:.2e}")
    if not torch.isfinite(out).all():
        raise AssertionError(f"{label}: kernel output not finite")
    if off > FLIP_SHARE or max_err > FLIP_BOUND:
        raise AssertionError(f"{label}: kernel disagrees with the plain version")
    return max_err


def cuda_ms(fn, reps):
    """Median device time of fn over reps runs, after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def decode_png(data):
    """8-bit RGB PNG with filter 0 rows (the port's encoder) -> [H, W, 3]."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = ihdr[:2]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    return rows[:, 1:].reshape(h, w, 3)


def get(base, path):
    with urllib.request.urlopen(base + path, timeout=300) as r:
        return r.status, r.read()


def phase_small_reference():
    """The port's render on the card against the per-pixel oracle."""
    arrays = bench_scene(300, 7, -0.8, 0.8, 0.02, 0.12)
    gs = on_card(arrays)
    cam = look_at_camera(eye=[0.2, -0.3, -2.8], target=[0, 0, 0], device=DEV)
    cfg = RasterConfig(width=96, height=80, max_instances=1 << 16)
    bg = torch.tensor([0.1, 0.2, 0.3], device=DEV)
    with torch.inference_mode():
        out = render(*gs, cam, cfg, bg=bg)
        img_n, t_n = render_naive(preprocess(*gs, cam, cfg), bg, cfg)
    err = max((out.image - img_n).abs().max().item(),
              (out.t_final - t_n).abs().max().item())
    log(f"small reference 96x80 @ 300: max_abs_err vs oracle {err:.3e}")
    if err > FLIP_BOUND or not torch.isfinite(out.image).all():
        raise AssertionError("render disagrees with the per-pixel oracle")


def main():
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the plain version's colour sum is a batched matmul: keep it full FP32
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi()
    log("device:", card, "|", torch.cuda.get_device_name(0),
        "| torch", torch.__version__, "cuda", torch.version.cuda)

    # 2. build
    t0 = time.time()
    logs = _build.build_all([blend_cuda.KERNEL])
    log(f"build: {time.time() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")

    # 3. kernel vs plain version
    max_err = 0.0
    with torch.inference_mode():
        phase_small_reference()
        gs = on_card(bench_scene(100_000, 0, -0.7, 0.7, 0.008, 0.04))
        cam = look_at_camera(eye=[0.0, 0.0, -3.0], target=[0, 0, 0], device=DEV)
        probe = RasterConfig(width=512, height=512, max_instances=1 << 21)
        cap = autotune_max_instances(count_instances(*gs, cam, probe), 128, safety=1.25)
        cfg512 = RasterConfig(width=512, height=512, max_instances=cap)
        fields, binned = blend_inputs(gs, cam, cfg512)
        max_err = max(max_err, compare("512x512 @ 100k", fields, binned, cfg512))
        ms512 = cuda_ms(lambda: blend_cuda.blend_forward(fields, binned, cfg512), 10)
        plain512 = cuda_ms(lambda: blend_forward_torch(fields, binned, cfg512), 3)
        log(f"512x512 @ 100k: kernel {ms512:.4f} ms, plain {plain512:.3f} ms")

        gs = on_card(bench_scene(20_000, 1, -0.7, 0.7, 0.008, 0.04))
        cfg_odd = RasterConfig(width=1000, height=600, max_instances=1 << 21)
        fields, binned = blend_inputs(gs, cam, cfg_odd)
        max_err = max(max_err, compare("1000x600 @ 20k", fields, binned, cfg_odd))
        del gs, fields, binned

    # 4. main path: gs.ply -> load_ply -> viewer at 1920x1080
    arrays = bench_scene(MAIN_N, 0, -0.9, 0.9, 0.003, 0.015)
    means, scales, quats, opac, sh = arrays
    raw = {
        "means3d": means,
        "sh_dc": sh[:, :1],
        "sh_rest": sh[:, 1:],
        "scales_log": np.log(scales),
        "quats_raw": quats,
        "opacities_raw": np.log(opac / (1.0 - opac)),
        "mask": np.ones(len(means), np.float32),
    }
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "gs.ply")
        t0 = time.time()
        gauss_lib.save_ply(gauss_lib.params_from_numpy(raw, device="cpu"), path)
        params = gauss_lib.load_ply(path, device=DEV)
        log(f"gs.ply: {os.path.getsize(path) / 1e6:.1f} MB written and "
            f"loaded in {time.time() - t0:.1f} s")
    with torch.inference_mode():
        model = gauss_lib.activate(params)
        cams = [viewer._orbit_camera(az, el, ORBIT_R, device=DEV) for az, el in ORBITS]
        probe = RasterConfig(width=MAIN_W, height=MAIN_H, max_instances=1 << 24)
        counts = [count_instances(*model, c, probe) for c in cams]
        cap = autotune_max_instances(max(counts), 128, safety=1.25)
        cfg = RasterConfig(width=MAIN_W, height=MAIN_H, chunk=128, max_instances=cap)
        log(f"instances per view {counts}, max_instances {cap}")
        fields, binned = blend_inputs(model, cams[0], cfg)
        max_err = max(max_err, compare("1920x1080 @ 1M", fields, binned, cfg))
        del fields, binned
        torch.cuda.empty_cache()

    blend_cuda.blend_forward.launches = 0
    server = viewer.start(lambda: model, cfg, port=0, host="127.0.0.1", device=DEV)
    try:
        base = "http://127.0.0.1:%d" % server.server_address[1]
        request_ms = []
        for az, el in ORBITS:
            t0 = time.perf_counter()
            status, body = get(base, f"/render?az={az}&el={el}&r={ORBIT_R}")
            request_ms.append((time.perf_counter() - t0) * 1e3)
            if status != 200:
                raise AssertionError(f"/render status {status}")
            w, h = struct.unpack(">II", body[16:24])
            if (w, h) != (MAIN_W, MAIN_H):
                raise AssertionError(f"PNG is {w}x{h}")
            img = decode_png(body)
            if img.std() < 1.0:
                raise AssertionError("rendered image is constant")
        status, body = get(base, "/state")
        state = json.loads(body)
        if status != 200 or state != {"n_gaussians": MAIN_N}:
            raise AssertionError(f"/state: {status} {state}")
    finally:
        server.shutdown()
        server.server_close()
    launches = blend_cuda.blend_forward.launches
    log(f"viewer: 3 renders at {MAIN_W}x{MAIN_H} @ 1M, ms per request "
        f"{[round(t, 1) for t in request_ms]}, kernel launches {launches}")
    if launches < len(ORBITS):
        raise AssertionError("the main path did not go through the kernel")

    with torch.inference_mode():
        for c in cams:
            proj = preprocess(*model, c, cfg)
            if bool(bin_gaussians(proj.rect, proj.depths, proj.valid, cfg).overflow):
                raise AssertionError("instance overflow on the main path")
        fields, binned = blend_inputs(model, cams[0], cfg)
        ms = cuda_ms(lambda: blend_cuda.blend_forward(fields, binned, cfg), 10)
        plain_ms = cuda_ms(lambda: blend_forward_torch(fields, binned, cfg), 3)
        render_ms = cuda_ms(lambda: render(*model, cams[0], cfg), 10)
        # where a render and a request spend their time
        pre_ms = cuda_ms(lambda: preprocess(*model, cams[0], cfg), 10)
        proj = preprocess(*model, cams[0], cfg)
        bin_ms = cuda_ms(
            lambda: bin_gaussians(proj.rect, proj.depths, proj.valid, cfg), 10
        )
        t0 = time.perf_counter()
        viewer.render_png(model, cams[0], cfg)
        png_ms = (time.perf_counter() - t0) * 1e3
        log(f"breakdown: preprocess {pre_ms:.3f} ms, binning {bin_ms:.3f} ms, "
            f"render {render_ms:.3f} ms (device); render + PNG {png_ms:.1f} ms "
            f"(host)")
        pairs = int(blend_work_torch(fields, binned, cfg))
        n_inst = int(binned.inst_gauss.numel())
        bytes_moved = (fields.numel() * 4 + n_inst * 4
                       + binned.tile_ranges.numel() * 4 + 4 * MAIN_H * MAIN_W * 4)
    bound_bytes = bytes_moved / HBM_BYTES_S * 1e3
    bound_ops = max(pairs * FLOPS_PER_PAIR / FP32_FLOP_S, pairs / SFU_OPS_S) * 1e3
    bound_ms = max(bound_bytes, bound_ops)
    log(f"{MAIN_W}x{MAIN_H} @ 1M: {n_inst} instances, {pairs} (instance, pixel) "
        f"pairs evaluated; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, whole "
        f"render {render_ms:.3f} ms; bound {bound_ms:.4f} ms (bytes "
        f"{bound_bytes:.4f}, operations {bound_ops:.4f})")

    record = {
        "name": "blend_forward",
        "route": "cuda",
        "source": "frosting_tpu_torch/csrc/blend_forward.cu",
        "replaces": "frosting_tpu/raster/blend_pallas.py:207",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bound_bytes > bound_ops else "operations",
        "library_ms": None,  # no single PyTorch call computes this blend
    }
    log(card)
    log(json.dumps({"kernels": [record]}))
    log(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
