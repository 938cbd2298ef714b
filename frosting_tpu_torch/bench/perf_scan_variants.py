"""Scan probes: kernels P3 (30 rounds of an inclusive product scan along
rows of 128 and the product of the scanned row, accumulated, over
[512, 128]) and P4 (the scan and its product once), each in the four
variants of the TPU script.

Port of ``scripts/perf_scan_variants.py`` (its Pallas kernels ``timed`` at
:76 and ``once`` at :116). The kernels are ``csrc/perf_scan_variants.cu``;
on the CPU the wrappers run the plain PyTorch versions beside them, which
multiply in the kernels' order (Hillis-Steele scan, halving-tree product,
as ``frosting_tpu/raster/chunk_math.py``), so all agree bitwise. Run on a
CUDA card:

    python -m frosting_tpu_torch.bench.perf_scan_variants

It prints ms per launch of P3 under the TPU script's four names (fastest
replay of a CUDA graph of 100 launches), the floor of an empty launch
timed the same way, and the TPU script's cross-check of P4's
concat/concat and roll/roll variants, here bitwise for both outputs.

The TPU script's input, uniform in [0.9, 1.0), underflows: the product of
a row's 128 scanned values is about 0.95^8256, 0 in float32. So the
probes are also held on ``probe_input(lo=NONZERO_LO)``, where the
products stay near 0.1.
"""

from __future__ import annotations

import ctypes
import json
import sys
from typing import Tuple

import numpy as np
import torch

from frosting_tpu_torch import _build
from frosting_tpu_torch._build import check_tensor
from frosting_tpu_torch.bench.common import graph_ms

KERNELS = ("perf_scan_variants",)
P, K, REPS = 512, 128, 30
NONZERO_LO = 0.9995
# (roll_scan, roll_prod), in the TPU script's order
VARIANTS = {
    "scan_concat+prod_concat": (0, 0),
    "scan_roll+prod_roll": (1, 1),
    "scan_concat+prod_roll": (0, 1),
    "scan_roll+prod_concat": (1, 0),
}


def probe_input(seed: int = 0, lo: float = 0.9, device="cuda") -> torch.Tensor:
    """[P, K] float32 uniform in [lo, 1.0) (the TPU script: seed 0 for the
    timing, seed 1 for the cross-check, lo 0.9)."""
    x = np.random.default_rng(seed).uniform(lo, 1.0, (P, K))
    return torch.from_numpy(x.astype(np.float32)).to(device)


def cumprod_torch(x: torch.Tensor) -> torch.Tensor:
    """Inclusive product along rows by Hillis-Steele: y[i] *= y[i - s] for
    s = 1, 2, 4, ... (chunk_math.cumprod_incl's order)."""
    y = x
    s = 1
    while s < x.shape[1]:
        y = y * torch.nn.functional.pad(y[:, :-s], (s, 0), value=1.0)
        s *= 2
    return y


def tree_prod_torch(x: torch.Tensor) -> torch.Tensor:
    """[rows, 1] product along rows (a power of two) by halving: x[i] *
    x[i + h] (chunk_math.tree_prod's order)."""
    while x.shape[1] > 1:
        h = x.shape[1] // 2
        x = x[:, :h] * x[:, h:]
    return x


def scan_reps_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version of P3: acc [rows, 1] = sum over REPS rounds of
    tree_prod(cumprod(y)), with y = y * 0.999 + 1e-4 after each round."""
    acc = torch.zeros((x.shape[0], 1), dtype=x.dtype, device=x.device)
    y = x
    for _ in range(REPS):
        acc = acc + tree_prod_torch(cumprod_torch(y))
        y = y * 0.999 + 1e-4
    return acc


def scan_once_torch(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of P4: (cumprod(x), tree_prod(cumprod(x)))."""
    incl = cumprod_torch(x)
    return incl, tree_prod_torch(incl)


# products of one Hillis-Steele scan of a row: the sum over s of K - s
SCAN_PRODUCTS = sum(K - (1 << b) for b in range(K.bit_length() - 1))


def reps_flops(rows: int) -> int:
    """FP32 operations one P3 call needs: per round and row the scan's
    products, the tree's K - 1, the update's 2 K and the accumulation's 1."""
    return rows * REPS * (SCAN_PRODUCTS + (K - 1) + 2 * K + 1)


def once_flops(rows: int) -> int:
    """FP32 operations one P4 call needs: one scan and one tree per row."""
    return rows * (SCAN_PRODUCTS + K - 1)


def _variant(variant: str) -> Tuple[int, int]:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: one of {list(VARIANTS)}")
    return VARIANTS[variant]


def _check_x(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no scan kernel for device {x.device}")
    check_tensor("x", x, torch.float32, (None, K), x.device)


def scan_reps(x: torch.Tensor, variant: str = "scan_concat+prod_concat",
              out=None) -> torch.Tensor:
    """P3 on x [rows, 128] float32 -> acc [rows, 1]. CPU tensors take the
    plain version (every variant computes it); CUDA tensors launch the
    kernel on the current stream into out (allocated when None), without
    synchronising, or raise."""
    flags = _variant(variant)
    if x.device.type == "cpu":
        return scan_reps_torch(x)
    _check_x(x)
    if out is None:
        out = torch.empty((x.shape[0], 1), dtype=torch.float32, device=x.device)
    check_tensor("out", out, torch.float32, (x.shape[0], 1), x.device)
    _build.launch(
        "perf_scan_variants", "scan_reps_launch",
        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3,
        (x.data_ptr(), out.data_ptr(), x.shape[0], *flags), x.device,
    )
    scan_reps.launches += 1
    return out


def scan_once(x: torch.Tensor, variant: str = "scan_concat+prod_concat",
              incl=None, prod=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """P4 on x [rows, 128] float32 -> (incl [rows, 128], prod [rows, 1]);
    dispatches as scan_reps does."""
    flags = _variant(variant)
    if x.device.type == "cpu":
        return scan_once_torch(x)
    _check_x(x)
    if incl is None:
        incl = torch.empty_like(x)
    if prod is None:
        prod = torch.empty((x.shape[0], 1), dtype=torch.float32, device=x.device)
    check_tensor("incl", incl, torch.float32, tuple(x.shape), x.device)
    check_tensor("prod", prod, torch.float32, (x.shape[0], 1), x.device)
    _build.launch(
        "perf_scan_variants", "scan_once_launch",
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3,
        (x.data_ptr(), incl.data_ptr(), prod.data_ptr(), x.shape[0], *flags),
        x.device,
    )
    scan_once.launches += 1
    return incl, prod


def empty_launch(device="cuda") -> None:
    """One launch of an empty kernel on the current stream: the floor under
    every launch's time."""
    _build.launch("perf_scan_variants", "empty_launch", (), (), torch.device(device))


# Kernel launches since the count was last reset (CPU calls are not counted).
scan_reps.launches = 0
scan_once.launches = 0


def run(device="cuda", iters: int = 100, repeats: int = 5, log=print):
    """Time P3's four variants and the empty launch by CUDA-graph replay,
    then cross-check P4's concat/concat and roll/roll variants; log the TPU
    script's lines and return {name: ms per launch}."""
    x = probe_input(0, device=device)
    out = torch.empty((P, 1), device=device)
    times = {}
    for name in VARIANTS:
        times[name] = graph_ms(lambda: scan_reps(x, name, out), iters, repeats)
        log(json.dumps({name: times[name]}))
    times["empty_launch"] = graph_ms(lambda: empty_launch(device), iters, repeats)
    log(json.dumps({"empty_launch": times["empty_launch"]}))
    x = probe_input(1, device=device)
    a_i, a_p = scan_once(x, "scan_concat+prod_concat")
    b_i, b_p = scan_once(x, "scan_roll+prod_roll")
    log("incl allclose:", bool(torch.equal(a_i, b_i)))
    log("prod allclose:", bool(torch.equal(a_p, b_p)))
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("perf_scan_variants: no CUDA device", file=sys.stderr)
        return 1
    _build.build_all(KERNELS)
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
