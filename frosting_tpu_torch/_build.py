"""Builds the sources under ``csrc/`` into shared libraries with a plain C
interface, at first use, loads them with ctypes, and calls the CUDA
sources' C launchers on PyTorch's current stream.

Each ``csrc/<name>.cu`` (a CUDA source, built by ``nvcc``) or
``csrc/<name>.cpp`` (host code, built by ``g++``) becomes
``_build/lib<name>-<hash>.so``, where the hash covers the source, the
compiler flags and, for a CUDA source, every header ``csrc/*.cuh``, so an
edited source or header is rebuilt and an unchanged one is reused.
``build_all`` starts one compiler per source at once and waits for all of
them. Importing this module needs neither compiler nor a GPU; building
and launching do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
GXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda)")


def source_path(name: str) -> Path:
    """csrc/<name>.cu, or csrc/<name>.cpp where there is no CUDA source."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def library_path(name: str) -> Path:
    src = source_path(name)
    digest = hashlib.sha256(src.read_bytes())
    if src.suffix == ".cu":
        for header in sorted(CSRC.glob("*.cuh")):
            digest.update(header.name.encode() + b"\0" + header.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
    else:
        digest.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _compiler(src: Path) -> list:
    if src.suffix == ".cu":
        return [nvcc_path(), *NVCC_FLAGS]
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH")
    return [gxx, *GXX_FLAGS]


def _start(name: str):
    """Start the compiler for csrc/<name>.cu or .cpp into a temporary file;
    returns (process, temporary path, final path)."""
    lib = library_path(name)
    src = source_path(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [*_compiler(src), "-o", tmp, str(src)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, lib


def build_all(names: Iterable[str]) -> Dict[str, str]:
    """Compile every named source that is not built yet, all compiler
    processes started together. Returns {name: compiler output} for those compiled;
    raises RuntimeError naming the source that failed."""
    names = [n for n in names if not library_path(n).exists()]
    if not names:
        return {}
    started = {name: _start(name) for name in names}
    logs: Dict[str, str] = {}
    failed = []
    for name, (proc, tmp, lib) in started.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(
                f"{source_path(name).name} (exit {proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The shared library of csrc/<name>.cu or .cpp, built first if
    needed."""
    with _lock:
        if name not in _loaded:
            build_all([name])
            _loaded[name] = ctypes.CDLL(str(library_path(name)))
        return _loaded[name]


def check_tensor(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless t is a contiguous tensor of dtype on device whose shape
    matches `shape` (None matches any size)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if len(shape) != t.dim() or any(
        s is not None and s != d for s, d in zip(shape, t.shape)
    ):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")


def launch(name: str, symbol: str, argtypes: Sequence, args: Sequence,
           device: torch.device) -> None:
    """Call the C launcher `symbol` of csrc/<name>.cu with args (device
    pointers as ints, then ints) and, last, the current stream of device.
    The launcher neither synchronises nor allocates, so a call can be
    captured in a CUDA graph. Raises on a CUDA error."""
    fn = getattr(load(name), symbol)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{symbol} failed: CUDA error {err}")
