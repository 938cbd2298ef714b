"""Arithmetic-rate probes by dtype: kernels P1 (a chain of 400 dependent
multiply-adds) and P2 (a chain of 40 dependent exponentials), in float32
and bf16 over [1024, 512].

Port of ``scripts/perf_vpu_dtype.py`` (its Pallas kernels at :64 and :89).
The kernels are ``csrc/perf_vpu_dtype.cu``; on the CPU the wrappers run the
plain PyTorch chains beside them. Run on a CUDA card:

    python -m frosting_tpu_torch.bench.perf_vpu_dtype

It prints one JSON line per probe under the TPU script's names
(``chain_fma_f32``, ``chain_fma_bf16``, ``chain_exp40_f32``,
``chain_exp40_bf16``): ms per launch, from the fastest replay of a CUDA
graph of 100 launches, and the rate. An FMA counts 2 operations; a step of
the exp chain a multiply and an exp (the TPU script counted 400 steps of
2 for the exp chain too, 10x too many). Every launch reads the same input:
unlike the TPU runtime, CUDA memoises nothing.
"""

from __future__ import annotations

import ctypes
import json
import sys

import numpy as np
import torch

from frosting_tpu_torch import _build
from frosting_tpu_torch._build import check_tensor
from frosting_tpu_torch.bench.common import graph_ms

KERNELS = ("perf_vpu_dtype",)
FMA_REPS = 400
EXP_REPS = 40
SHAPE = (1024, 512)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def probe_input(dtype: torch.dtype, device="cuda", shape=SHAPE) -> torch.Tensor:
    """The TPU script's input: normal draws (seed 0) times 1e-3."""
    x = np.random.default_rng(0).normal(size=shape) * 1e-3
    return torch.from_numpy(x.astype(np.float32)).to(device=device, dtype=dtype)


def chain_fma_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version of P1: y = x, then FMA_REPS times y = y * 0.25 + x, in
    x's dtype (0.25 y is exact, so each step rounds once, as an FMA)."""
    y = x
    for _ in range(FMA_REPS):
        y = y * 0.25 + x
    return y


def chain_exp_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version of P2: y = x, then EXP_REPS times y = exp(0.25 y)."""
    y = x
    for _ in range(EXP_REPS):
        y = torch.exp(y * 0.25)
    return y


def fma_flops(numel: int) -> int:
    """Operations of one P1 call: an FMA is 2."""
    return numel * FMA_REPS * 2


def exp_count(numel: int) -> int:
    """Exponentials of one P2 call (each step also multiplies once)."""
    return numel * EXP_REPS


def _launch_chain(kind: str, x: torch.Tensor, out) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"no {kind} kernel for device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x has dtype {x.dtype}, expected float32 or bfloat16")
    check_tensor("x", x, x.dtype, tuple(x.shape), x.device)
    bf16 = x.dtype == torch.bfloat16
    if bf16 and (x.numel() % 2 or x.data_ptr() % 4):
        raise ValueError("a bf16 x must hold whole, 4-byte aligned pairs")
    if out is None:
        out = torch.empty_like(x)
    check_tensor("out", out, x.dtype, tuple(x.shape), x.device)
    n = x.numel() // 2 if bf16 else x.numel()
    _build.launch(
        "perf_vpu_dtype", f"{kind}_{'bf16' if bf16 else 'f32'}_launch",
        (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int),
        (x.data_ptr(), out.data_ptr(), n), x.device,
    )
    return out


def chain_fma(x: torch.Tensor, out=None) -> torch.Tensor:
    """P1 on x (float32 or bf16). CPU tensors take the plain version; CUDA
    tensors launch the kernel on the current stream into out (allocated
    when None), without synchronising, or raise."""
    if x.device.type == "cpu":
        return chain_fma_torch(x)
    out = _launch_chain("chain_fma", x, out)
    chain_fma.launches += 1
    return out


def chain_exp(x: torch.Tensor, out=None) -> torch.Tensor:
    """P2 on x (float32 or bf16); dispatches as chain_fma does."""
    if x.device.type == "cpu":
        return chain_exp_torch(x)
    out = _launch_chain("chain_exp", x, out)
    chain_exp.launches += 1
    return out


# Kernel launches since the count was last reset (CPU calls are not counted).
chain_fma.launches = 0
chain_exp.launches = 0


def run(device="cuda", iters: int = 100, repeats: int = 5, log=print):
    """Time P1 and P2 in both dtypes by CUDA-graph replay; log one JSON line
    per probe and return {name: ms per launch}."""
    times = {}
    for probe, fn, ops in (
        ("chain_fma", chain_fma, fma_flops),
        ("chain_exp40", chain_exp, lambda n: 2 * exp_count(n)),
    ):
        for nm, dt in DTYPES.items():
            x = probe_input(dt, device)
            out = torch.empty_like(x)
            ms = graph_ms(lambda: fn(x, out), iters, repeats)
            name = f"{probe}_{nm}"
            times[name] = ms
            line = {name: ms, "Tops/s": ops(x.numel()) / (ms * 1e-3) / 1e12}
            if probe == "chain_exp40":
                line["Texp/s"] = exp_count(x.numel()) / (ms * 1e-3) / 1e12
            log(json.dumps(line))
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("perf_vpu_dtype: no CUDA device", file=sys.stderr)
        return 1
    _build.build_all(KERNELS)
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
