"""Stage timers, a metrics registry and profiler traces.

Counterpart of ``ska_sdp_func_python_tpu/utils/profiling.py``: a
:func:`timer` that synchronises the CUDA device around the stage (so the
wall time covers the device's work, not its enqueue), the accumulated
:func:`metrics`, and :func:`profile_trace`, a ``torch.profiler`` trace of a
block written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict

import torch

log = logging.getLogger("ska-sdp-func-python-torch")

__all__ = ["timer", "metrics", "reset_metrics", "profile_trace"]

_METRICS: dict = defaultdict(list)


def _sync() -> None:
    """Wait for the current CUDA device's queued work (where CUDA is in
    use); nothing on the CPU."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def timer(name: str, sync: bool = True, items: int | None = None):
    """Time a stage into the metrics under ``name``; with ``items`` also a
    rate (items/s) under ``name + ".rate"``. ``sync`` synchronises the
    current CUDA device before and after, so the time covers the device's
    work; on the CPU it does nothing."""
    if sync:
        _sync()
    t0 = time.perf_counter()
    yield
    if sync:
        _sync()
    dt = time.perf_counter() - t0
    _METRICS[name].append(dt)
    if items is not None and dt > 0:
        _METRICS[f"{name}.rate"].append(items / dt)
        log.info("%s: %.3f s (%.1f items/s)", name, dt, items / dt)
    else:
        log.info("%s: %.3f s", name, dt)


def metrics() -> dict:
    """Snapshot of the accumulated stage times and rates: count, total,
    mean and last of each."""
    return {
        k: {"count": len(v), "total": sum(v), "mean": sum(v) / len(v), "last": v[-1]}
        for k, v in _METRICS.items()
        if v
    }


def reset_metrics():
    _METRICS.clear()


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Profile a block with ``torch.profiler`` (the CPU, and the CUDA
    device where there is one) and export its Chrome trace as
    ``logdir/trace.json``. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
