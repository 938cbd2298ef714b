"""Times the scan probes P3 and P4 of frosting_tpu_torch/csrc beside an
earlier design of them, and beside builds of the current source with
other compile-time settings (lanes per row, rows per block), on one CUDA
card, on the TPU script's inputs ([512, 128]).

Run from the root of the repository, with the earlier source in a
directory that .gitignore lists:

    mkdir -p tmp_base && git show <commit>:frosting_tpu_torch/csrc/perf_scan_variants.cu \\
        > tmp_base/perf_scan_variants.cu
    python3 scan_ab.py tmp_base --build SCAN_REPS_LANES=8,SCAN_ONCE_LANES=8

Every source is built by frosting_tpu_torch/_build.py with the same nvcc
flags (each --build adds its -D definitions, e.g. other lanes per row; the
hash keeps every build apart) and loaded by its C launchers, which
take (x, out..., rows, roll_scan, roll_prod, stream) in every design.
Each build is first held bitwise against the plain versions, every
variant, on the TPU input, on NONZERO_LO and on 513 rows. Then each
variant of P3 and of P4, and the empty launch, is timed by graph_ms
(fastest replay of a CUDA graph of 100 launches) in turns: earlier,
current, current, earlier, then each --build once. The line
before the last is the card's name and power limit; the last is a JSON
object of the times in ms.
"""

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np
import torch

from frosting_tpu_torch import _build
from frosting_tpu_torch.bench import perf_scan_variants as ps
from frosting_tpu_torch.bench.common import graph_ms, smi

NAME = ps.KERNELS[0]


def log(*parts):
    print(*parts, flush=True)


class Build:
    """The launchers of one build of perf_scan_variants.cu (launches not
    counted)."""

    def __init__(self, label, src_dir, defines=()):
        self.label = label
        csrc, flags = _build.CSRC, _build.NVCC_FLAGS
        _build.CSRC = Path(src_dir).resolve()
        _build.NVCC_FLAGS = flags + tuple(defines)
        try:
            for line in _build.build_all([NAME]).get(NAME, "").splitlines():
                if "registers" in line or "spill" in line:
                    log(f"  {label}: {line.strip()}")
            lib = ctypes.CDLL(str(_build.library_path(NAME)))
        finally:
            _build.CSRC, _build.NVCC_FLAGS = csrc, flags
        self.fns = {}
        for symbol, n_ptr in (("scan_reps_launch", 2), ("scan_once_launch", 3),
                              ("empty_launch", 0)):
            fn = getattr(lib, symbol)
            fn.argtypes = ([ctypes.c_void_p] * n_ptr
                           + [ctypes.c_int] * (3 if n_ptr else 0) + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            self.fns[symbol] = fn

    def _call(self, symbol, *args):
        err = self.fns[symbol](*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.label} {symbol}: CUDA error {err}")

    def reps(self, x, variant, out):
        self._call("scan_reps_launch", x.data_ptr(), out.data_ptr(), x.shape[0],
                   *ps.VARIANTS[variant])
        return out

    def once(self, x, variant, incl, prod):
        self._call("scan_once_launch", x.data_ptr(), incl.data_ptr(), prod.data_ptr(),
                   x.shape[0], *ps.VARIANTS[variant])
        return incl, prod

    def empty(self):
        self._call("empty_launch")


def hold(build):
    """Raise unless every variant of the build equals the plain versions
    bitwise on the TPU input, on NONZERO_LO and on 513 rows."""
    rng = np.random.default_rng(5)
    odd = torch.from_numpy(rng.uniform(ps.NONZERO_LO, 1.0, (513, ps.K)).astype(np.float32))
    inputs = [ps.probe_input(s, lo=lo) for s in (0, 1) for lo in (0.9, ps.NONZERO_LO)]
    for x in inputs + [odd.cuda()]:
        rows = x.shape[0]
        ref_acc = ps.scan_reps_torch(x)
        ref_incl, ref_prod = ps.scan_once_torch(x)
        for v in ps.VARIANTS:
            acc = build.reps(x, v, torch.full((rows, 1), float("nan"), device=x.device))
            incl, prod = build.once(x, v, torch.full_like(x, float("nan")),
                                    torch.full((rows, 1), float("nan"), device=x.device))
            torch.cuda.synchronize()
            if not (torch.equal(acc, ref_acc) and torch.equal(incl, ref_incl)
                    and torch.equal(prod, ref_prod)):
                raise AssertionError(f"{build.label} {v}: not bitwise equal to the "
                                     f"plain version on {rows} rows")
    log(f"{build.label}: every variant bitwise equal to the plain versions")


def main(argv=None):
    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("earlier", help="directory of the earlier perf_scan_variants.cu")
    args.add_argument("--build", action="append", default=[],
                      help="another build of the current source: comma-separated "
                           "definitions, e.g. SCAN_REPS_LANES=4,SCAN_ONCE_LANES=4")
    args = args.parse_args(argv)
    if not torch.cuda.is_available():
        print("scan_ab: no CUDA device", file=sys.stderr)
        return 1
    card = smi()
    log("device:", card)
    earlier = Build("earlier", args.earlier)
    current = Build("current", _build.CSRC)
    others = [Build(spec, _build.CSRC, tuple(f"-D{d}" for d in spec.split(",")))
              for spec in args.build]
    for b in (earlier, current, *others):
        hold(b)

    x = ps.probe_input(0)
    rows = x.shape[0]
    acc = torch.empty((rows, 1), device=x.device)
    incl, prod = torch.empty_like(x), torch.empty((rows, 1), device=x.device)
    calls = {
        f"P3 {v}": (lambda b, v=v: (lambda: b.reps(x, v, acc))) for v in ps.VARIANTS}
    calls.update({
        f"P4 {v}": (lambda b, v=v: (lambda: b.once(x, v, incl, prod))) for v in ps.VARIANTS})
    calls["empty_launch"] = lambda b: b.empty
    times = {}
    for name, make in calls.items():
        o1, n1, n2, o2 = (graph_ms(make(b)) for b in (earlier, current, current, earlier))
        times[name] = {"earlier": [o1, o2], "current": [n1, n2]}
        times[name].update({b.label: graph_ms(make(b)) for b in others})
        log(f"{name}: " + ", ".join(
            f"{k} " + ("/".join(f"{t * 1e3:.3f}" for t in v) if isinstance(v, list)
                       else f"{v * 1e3:.3f}") + " us" for k, v in times[name].items()))
    log(card)
    log(json.dumps(times))
    return 0


if __name__ == "__main__":
    sys.exit(main())
