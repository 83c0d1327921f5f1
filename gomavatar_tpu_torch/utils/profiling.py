"""Profiling and debug utilities (port of gomavatar_tpu/utils/profiling.py):

  * ``Timer``: a wall-clock section timer with mean / min reporting; a
    section with ``sync=True`` waits for the card's queued work first;
  * ``trace``: ``torch.profiler`` around a block, writing a trace that
    TensorBoard's profile plugin reads;
  * ``debug_mode``: autograd anomaly detection, which names the forward op
    whose backward produced a NaN.

The JAX package's switch to interpreted Pallas kernels has no counterpart:
a CUDA tensor always goes to its kernel, a CPU tensor to the plain version.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class Timer:
    """Accumulating section timer: ``with timer.section("fk"): ...``."""

    def __init__(self):
        self.acc = defaultdict(list)

    @contextlib.contextmanager
    def section(self, name: str, sync: bool = False):
        t0 = time.perf_counter()
        yield
        if sync and torch.cuda.is_available() and torch.cuda.is_initialized():
            # wait for the device work the section queued
            torch.cuda.synchronize()
        self.acc[name].append(time.perf_counter() - t0)

    def report(self) -> dict[str, dict[str, float]]:
        out = {}
        for name, xs in self.acc.items():
            out[name] = {
                "mean_ms": 1000.0 * sum(xs) / len(xs),
                "min_ms": 1000.0 * min(xs),
                "count": len(xs),
            }
        return out

    def reset(self):
        self.acc.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace of a block, the card's activity included when
    there is one, written to ``log_dir`` for TensorBoard:
    ``with profiling.trace('log/trace'): step()``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)
    ) as prof:
        yield prof


@contextlib.contextmanager
def debug_mode(nan_checks: bool = True):
    """Debugging context: autograd anomaly detection (``nan_checks``), which
    raises where a backward produces a NaN and names its forward op."""
    with torch.autograd.set_detect_anomaly(True) if nan_checks else contextlib.nullcontext():
        yield
