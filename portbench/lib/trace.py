"""Host spans and the reading of one torch.profiler session.

The harness wraps its calls into each layer of the program in ``span``; the
spans are kept in memory with host clock times, and while a profiler
session is open each also becomes a ``record_function`` range, so the
trace holds them on its own clock.  ``digest`` reduces the session's
chrome trace to what the metric readers take: the device's intervals, the
time per kernel name, the busy time, and the idle gaps with the host span
each fell in."""

from __future__ import annotations

import contextlib
import gzip
import json
import os
import re
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "portbench."
# copies between host and device memory: the feed and the read-back around
# a program, not the program's own work
HOST_COPY = re.compile(r"^Memcpy (HtoD|DtoH)\b")


class Spans:
    def __init__(self):
        self.done: list[tuple[str, float, float]] = []
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self.profiling:
            import torch

            with torch.profiler.record_function(PREFIX + name):
                yield
        else:
            yield
        self.done.append((name, t0, time.perf_counter()))

    def total(self, name: str, since: float = 0.0, until: float = float("inf")) -> tuple[float, int]:
        """(seconds, count) of the spans ``name`` that began in [since, until)."""
        d = [t1 - t0 for n, t0, t1 in self.done if n == name and since <= t0 < until]
        return sum(d), len(d)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def digest(path: str) -> dict:
    """The profiled window (the ``portbench.window`` range) of a chrome
    trace: {"window_s", "busy_s" (the union of every device operation),
    "program_busy_s" (the same without copies between host and device),
    "by_name" {kernel: seconds}, "top_ops", "idle_gaps"}; None when the
    trace holds no device operation."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    dev, spans, window = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat in DEVICE_CATS:
            dev.append((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), name))
        elif name.startswith(PREFIX):
            s = (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), name[len(PREFIX):])
            if s[2] == "window":
                window = s
            else:
                spans.append(s)
    if window is None or not dev:
        return None
    w0, w1 = window[0], window[1]
    clipped = [(max(s, w0), min(e, w1), n) for s, e, n in dev if e > w0 and s < w1]
    if not clipped:
        return None
    by_name: dict[str, float] = {}
    for s, e, n in clipped:
        by_name[n] = by_name.get(n, 0.0) + (e - s) * 1e-6
    merged = _merge([[s, e] for s, e, _ in clipped])
    busy = sum(e - s for s, e in merged) * 1e-6
    program = sum(e - s for s, e in _merge([[s, e] for s, e, n in clipped if not HOST_COPY.match(n)])) * 1e-6
    gaps, prev = [], w0
    for s, e in merged + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)

    def host_at(t):
        inside = [sp for sp in spans if sp[0] <= t < sp[1]]
        return min(inside, key=lambda sp: sp[1] - sp[0])[2] if inside else "outside any span"

    idle: dict[str, float] = {}
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    for s, e in gaps:
        key = host_at(s)
        idle[key] = idle.get(key, 0.0) + (e - s) * 1e-6
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": busy,
        "program_busy_s": program,
        "by_name": by_name,
        "top_ops": [[n, v] for n, v in top_ops],
        "idle_gaps": [[host_at(s), (e - s) * 1e-6] for s, e in longest],
        "idle_by_span": idle,
    }


def profile(out_dir: str):
    """A torch.profiler session over CPU and CUDA activity that writes its
    chrome trace into ``out_dir``/trace.json on exit."""
    import torch

    os.makedirs(out_dir, exist_ok=True)
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
        on_trace_ready=lambda p: p.export_chrome_trace(os.path.join(out_dir, "trace.json")),
    )
