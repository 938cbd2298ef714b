"""Times the blend kernels of frosting_tpu_torch/csrc beside an earlier
design of them on one CUDA card, on the same inputs: view 0 of
chip_smoke.py's 1920x1080 serving orbit of its 1M-Gaussian scene, and the
train step's own blend inputs after chip_smoke.py's 40-iteration training
run of that scene.

Run from the root of the repository, with the earlier sources unpacked
into a directory that .gitignore lists:

    mkdir -p tmp_base && git archive <commit> frosting_tpu_torch/csrc | tar -x -C tmp_base
    python3 blend_ab.py tmp_base/frosting_tpu_torch/csrc

The earlier blend_forward.cu and blend_backward.cu are built by
frosting_tpu_torch/_build.py with the same nvcc flags (their hash keeps
them apart from the current ones). Their C launch functions take (fields,
inst_gauss, tile_ranges[, tile_order], out[, g_out, grads], six ints,
stream), with tile_order where the source names it. Each pair is timed in
turns (earlier, current, current, earlier), each a median of --reps runs
timed with CUDA events. The line before the last is the card's name and
power limit; the last is a JSON object of the times in ms.
"""

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from frosting_tpu_torch import _build
from frosting_tpu_torch.raster import RasterConfig, blend_cuda
from frosting_tpu_torch.scene import gaussians as gauss_lib
from frosting_tpu_torch.train import optimizer as opt_lib


def earlier_kernels(src_dir):
    """(forward, backward) of the sources in src_dir, with the wrappers'
    signatures; their launches are not counted."""
    current = _build.CSRC
    _build.CSRC = Path(src_dir).resolve()
    try:
        for name, text in _build.build_all(blend_cuda.KERNELS).items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line:
                    cs.log(f"  earlier {name}: {line.strip()}")
        fns = {}
        for name in blend_cuda.KERNELS:
            ordered = "tile_order" in (_build.CSRC / f"{name}.cu").read_text()
            fn = getattr(ctypes.CDLL(str(_build.library_path(name))), f"{name}_launch")
            n_ptr = (4 if name == "blend_forward" else 6) + ordered
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            fns[name] = fn, ordered
    finally:
        _build.CSRC = current

    def launch(name, cfg, binned, *tensors):
        fn, ordered = fns[name]
        head = [binned.inst_gauss, binned.tile_ranges]
        if ordered:
            head.append(blend_cuda.heaviest_first(binned.tile_ranges))
        ptrs = [tensors[0], *head, *tensors[1:]]
        err = fn(*(t.data_ptr() for t in ptrs), cfg.width, cfg.height, cfg.tiles_x,
                 cfg.n_tiles, cfg.tile_w, cfg.tile_h,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"earlier {name} launch failed: CUDA error {err}")

    def forward(fields, binned, cfg):
        out = torch.empty((4, cfg.height, cfg.width), device=fields.device)
        launch("blend_forward", cfg, binned, fields, out)
        return out

    def backward(fields, binned, cfg, out, g_out):
        grads = torch.zeros((binned.inst_gauss.shape[0], 9), device=fields.device)
        launch("blend_backward", cfg, binned, fields, out, g_out, grads)
        return grads

    return forward, backward


def ab(label, earlier, fields, binned, cfg, out, g, reps):
    """{kernel: {"ms": [current x2], "earlier_ms": [earlier x2]}}, after
    checking that the earlier design computes what the current one does."""
    fwd, bwd = earlier
    if not torch.allclose(fwd(fields, binned, cfg), out, atol=cs.FLIP_BOUND):
        raise AssertionError(f"{label}: the earlier forward disagrees")
    calls = {
        "blend_forward": (lambda: blend_cuda.blend_forward(fields, binned, cfg),
                          lambda: fwd(fields, binned, cfg)),
        "blend_backward": (lambda: blend_cuda.blend_backward(fields, binned, cfg, out, g),
                           lambda: bwd(fields, binned, cfg, out, g)),
    }
    result = {}
    for name, (new, old) in calls.items():
        o1, n1, n2, o2 = (cs.cuda_ms(f, reps) for f in (old, new, new, old))
        cs.log(f"{label} {name}: earlier {o1:.4f}, {o2:.4f} ms; current "
               f"{n1:.4f}, {n2:.4f} ms")
        result[name] = {"ms": [n1, n2], "earlier_ms": [o1, o2]}
    return result


def main(argv=None):
    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("earlier", help="directory of the earlier blend_*.cu")
    args.add_argument("--reps", type=int, default=10)
    args = args.parse_args(argv)
    if not torch.cuda.is_available():
        print("blend_ab: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.smi()
    cs.log("device:", card)
    _build.build_all(blend_cuda.KERNELS)
    earlier = earlier_kernels(args.earlier)
    times = {}

    raw = cs.raw_params(cs.bench_scene(cs.MAIN_N, 0, -0.9, 0.9, 0.003, 0.015))
    with torch.inference_mode():
        model = gauss_lib.activate(gauss_lib.params_from_numpy(raw, device=cs.DEV))
        cams, cfg = cs.serving_views(model)
        fields, binned = cs.blend_inputs(model, cams[0], cfg)
        out = blend_cuda.blend_forward(fields, binned, cfg)
        g = torch.randn(out.shape, device=cs.DEV,
                        generator=torch.Generator(device=cs.DEV).manual_seed(0))
        times["serving"] = ab("serving view", earlier, fields, binned, cfg, out, g,
                              args.reps)
        del fields, binned, out, g

    rcfg = RasterConfig(width=cs.MAIN_W, height=cs.MAIN_H, chunk=128,
                        max_instances=1 << 24)
    state, tcams, gt_imgs, tcfg, _ = cs.phase_training(model, rcfg)
    opt = opt_lib.make_gs_optimizer(cs.TRAIN_EXTENT)
    gt0 = torch.from_numpy(gt_imgs[0]).to(cs.DEV)
    # as chip_smoke.py: the last of 6 step runs gives the blend inputs
    _, step_inputs = cs.step_breakdown(state, opt, tcams[0], gt0, rcfg, tcfg, reps=5)
    with torch.inference_mode():
        times["step"] = ab("the step's inputs", earlier, *step_inputs[:2], rcfg,
                           *step_inputs[2:], args.reps)
    cs.log(card)
    cs.log(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
