"""Profiling and debug utilities (port of gomavatar_tpu/utils/profiling.py):

  * ``span``, ``count``, ``recording``, ``records``: the program's own spans
    and counters (below);
  * ``Timer``: a wall-clock section timer with mean / min reporting; a
    section with ``sync=True`` waits for the card's queued work first; each
    section is also a span;
  * ``trace``: ``torch.profiler`` around a block, writing a trace that
    TensorBoard's profile plugin reads;
  * ``debug_mode``: autograd anomaly detection, which names the forward op
    whose backward produced a NaN.

The JAX package's switch to interpreted Pallas kernels has no counterpart:
a CUDA tensor always goes to its kernel, a CPU tensor to the plain version.

Spans and counters.  The data layer and the programs mark their host work
with ``with span(name, id): ...`` and ``count(name)``.  Recording is off
unless a ``torch.profiler`` session is open or a ``recording()`` block is
(in any thread); when off, ``span`` returns one shared no-op context and
``count`` returns at once, neither reading a clock.  When on, a span keeps
its name, ``time.perf_counter()`` at its start and end, the name of the
enclosing span on the same thread, the thread's id, its ``id`` (the item,
call or iteration it belongs to) and its keyword attributes; a counter
keeps its name, the time and ``n``, which may be a 0-d device tensor that
``records`` reads (so that counting waits for nothing on the device).  Both go into one bounded buffer
(``MAX_RECORDS``, the oldest dropped first), which ``records(since,
until)`` reads by time.  While a profiler session is open a span is also a
``record_function`` range named ``gomavatar.<name>``, so the trace holds the
program's spans on its own clock beside the device's work.  No span sits
inside a function that a ``programs.Program`` captures: it would run once
at the capture and never on a replay.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict, deque
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler

PREFIX = "gomavatar."
MAX_RECORDS = 1 << 16


class Span(NamedTuple):
    name: str
    t0: float
    t1: float
    parent: str | None  # the enclosing span's name on the same thread
    thread: int
    id: object
    attrs: dict | None


class Count(NamedTuple):
    name: str
    t: float
    n: int  # a 0-d tensor until ``records`` reads it


_records: deque = deque(maxlen=MAX_RECORDS)
_forced = 0  # open recording() blocks
_forced_lock = threading.Lock()
_local = threading.local()
_NOOP = contextlib.nullcontext()


def enabled() -> bool:
    """Whether spans and counters are recorded now: inside ``recording()``
    or while a torch.profiler session is open."""
    return bool(_forced) or _autograd_profiler._is_profiler_enabled


def _open_spans() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "id", "attrs", "t0", "parent", "range")

    def __init__(self, name, id, attrs):
        self.name, self.id, self.attrs = name, id, attrs

    def __enter__(self):
        stack = _open_spans()
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        self.range = None
        if _autograd_profiler._is_profiler_enabled:
            self.range = torch.profiler.record_function(PREFIX + self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.range is not None:
            self.range.__exit__(*exc)
        _open_spans().pop()
        _records.append(Span(self.name, self.t0, t1, self.parent, threading.get_ident(), self.id, self.attrs))
        return False


def span(name: str, id=None, **attrs):
    """A span of host work named ``name`` (see the module docstring):
    ``with span("data.decode", pos, workers=4): ...``."""
    return _Span(name, id, attrs or None) if enabled() else _NOOP


def count(name: str, n=1) -> None:
    """Count ``n`` events named ``name`` now, when recording; ``n`` an int
    or a 0-d tensor, read by ``records``."""
    if enabled():
        _records.append(Count(name, time.perf_counter(), n))


@contextlib.contextmanager
def recording():
    """Record spans and counters inside the block, with or without a
    profiler session (for operators and tests)."""
    global _forced
    with _forced_lock:
        _forced += 1
    try:
        yield
    finally:
        with _forced_lock:
            _forced -= 1


def records(since: float = float("-inf"), until: float = float("inf")) -> list:
    """The kept spans that began, and counts taken, in [since, until)
    (``time.perf_counter()``), oldest first; a count of a tensor with its
    value read."""
    out = []
    for r in list(_records):
        if since <= (r.t0 if isinstance(r, Span) else r.t) < until:
            if isinstance(r, Count) and isinstance(r.n, torch.Tensor):
                r = r._replace(n=r.n.item())
            out.append(r)
    return out


class Timer:
    """Accumulating section timer: ``with timer.section("fk"): ...``."""

    def __init__(self):
        self.acc = defaultdict(list)

    @contextlib.contextmanager
    def section(self, name: str, sync: bool = False):
        with span(name):
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
