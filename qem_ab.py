"""Times the QEM decimator of frosting_tpu_torch/csrc/qem.cpp beside an
earlier source of it, on the host CPU, and holds their outputs equal.

Run from the root of the repository, with the earlier source in a
directory that .gitignore lists:

    mkdir -p tmp_base && git show <commit>:frosting_tpu_torch/csrc/qem.cpp > tmp_base/qem.cpp
    python3 qem_ab.py tmp_base

The mesh is extract_parts.py's: marching tetrahedra of a unit sphere's
distance on a GRID^3 lattice over [-1.3, 1.3]^3 (1.33M vertices at the
default 400), made on the CUDA card where there is one; it is decimated to
1/8 of its vertices, the fraction stage 3's 8.3M-vertex Poisson mesh is
cut by for its 1M budget. Both sources are built with _build.py's g++
flags into a temporary directory and called as meshclean.qem_decimate
calls its library. The decimations run in turns, earlier, current,
current, earlier, one at a time, each timed by the host clock; the outputs
must be equal bit for bit. The line before the last is the host's CPU
model; the last is a JSON object of the seconds.
"""

import argparse
import ctypes
import json
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from frosting_tpu_torch import _build
from frosting_tpu_torch.extract import marching


def build(src: Path, out_dir: Path, tag: str) -> ctypes.CDLL:
    lib = out_dir / f"libqem_{tag}.so"
    subprocess.run(["g++", *_build.GXX_FLAGS, "-o", str(lib), str(src)], check=True)
    return ctypes.CDLL(str(lib))


def decimate(lib: ctypes.CDLL, v: np.ndarray, f: np.ndarray, target: int):
    """meshclean.qem_decimate's call of the library."""
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    lib.qem_decimate.restype = ctypes.c_int
    lib.qem_decimate.argtypes = [ptr, i64, ptr, i64, i64, ptr, ptr, ptr, ptr]
    out_v, out_f = np.empty_like(v), np.empty_like(f)
    nv, nf = i64(0), i64(0)
    if not lib.qem_decimate(v.ctypes.data, len(v), f.ctypes.data, len(f), target,
                            out_v.ctypes.data, ctypes.byref(nv), out_f.ctypes.data,
                            ctypes.byref(nf)):
        raise RuntimeError("qem_decimate failed")
    return out_v[:nv.value], out_f[:nf.value]


def cpu_model() -> str:
    for line in Path("/proc/cpuinfo").read_text().splitlines():
        if line.startswith("model name"):
            return line.split(":", 1)[1].strip()
    return "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("earlier", type=Path, help="a directory holding the earlier qem.cpp")
    p.add_argument("--grid", type=int, default=400)
    args = p.parse_args(argv)
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    lin = torch.linspace(-1.3, 1.3, args.grid, device=dev)
    g = 1.0 - torch.sqrt(lin[:, None, None] ** 2 + lin[None, :, None] ** 2
                         + lin[None, None, :] ** 2)
    v, f = marching.marching_tets(g, 0.0, origin=(-1.3,) * 3,
                                  spacing=(2.6 / (args.grid - 1),) * 3)
    v = np.ascontiguousarray(v.cpu().numpy(), np.float64)
    f = np.ascontiguousarray(f.cpu().numpy(), np.int64)
    target = len(v) // 8
    with tempfile.TemporaryDirectory() as tmp:
        libs = {"earlier": build(args.earlier / "qem.cpp", Path(tmp), "earlier"),
                "current": build(_build.CSRC / "qem.cpp", Path(tmp), "current")}
        times = {"earlier": [], "current": []}
        outs = {}
        for tag in ("earlier", "current", "current", "earlier"):
            t0 = time.perf_counter()
            outs[tag] = decimate(libs[tag], v, f, target)
            times[tag].append(time.perf_counter() - t0)
            print(f"{tag}: {len(v)} -> {len(outs[tag][0])} vertices in "
                  f"{times[tag][-1]:.2f} s", flush=True)
    same = all(np.array_equal(a, b) for a, b in zip(outs["earlier"], outs["current"]))
    if not same:
        raise AssertionError("the two decimators' outputs differ")
    print(cpu_model())
    print(json.dumps({"vertices": len(v), "target": target, "equal": same, "s": times}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
