"""Profiling and observability: profiler traces, step timers, a JSONL
metrics log and device memory statistics.

Counterpart of ``frosting_tpu/utils/profiling.py``: ``trace`` and
``annotate`` sit over ``torch.profiler`` and ``record_function`` where the
JAX package used ``jax.profiler``; the trace is written as a Chrome trace
(``trace.json`` in ``log_dir``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed region on the host and, where there is one, the
    GPU; write ``log_dir/trace.json`` (chrome://tracing, Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """Named sub-region inside a trace."""
    with torch.profiler.record_function(name):
        yield


class StepTimer:
    """EMA-smoothed host-clock step timer with derived throughput counters.
    The device runs ahead of the host, so a step's time is only its device
    time where the loop synchronises (as the trainer does at log steps)."""

    def __init__(self, pixels_per_step: int = 0, ema: float = 0.9):
        self.pixels = pixels_per_step
        self.ema = ema
        self._avg: Optional[float] = None
        self._last = time.perf_counter()

    def tick(self) -> Dict[str, float]:
        now = time.perf_counter()
        dt = now - self._last
        self._last = now
        self._avg = dt if self._avg is None else (
            self.ema * self._avg + (1 - self.ema) * dt
        )
        out = {
            "step_ms": self._avg * 1e3,
            "steps_per_s": 1.0 / max(self._avg, 1e-12),
        }
        if self.pixels:
            out["mpix_per_s"] = self.pixels / self._avg / 1e6
        return out


class MetricsLogger:
    """Append-only JSONL metrics sink (the vanilla trainer's TensorBoard
    scalars, gaussian_splatting/train.py:26-30, without the dependency)."""

    def __init__(self, path: Optional[str]):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None

    def log(self, step: int, **metrics):
        if self._f is None:
            return
        rec = {"step": step, "t": time.time()}
        rec.update(
            {
                k: (float(v) if hasattr(v, "__float__") else v)
                for k, v in metrics.items()
            }
        )
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        if self._f:
            self._f.close()


def device_memory_stats(device=0) -> Dict[str, int]:
    """Memory of one CUDA device as PyTorch's caching allocator sees it;
    {} without a CUDA device."""
    if not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", -1),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", -1),
        "bytes_limit": torch.cuda.get_device_properties(device).total_memory,
    }
