"""Arithmetic the per-layer metric readers share.  Each takes the traced
run (``run.py:run_cell``): the host spans, the profiled stretch's trace
digest, the counts of ``work`` and the units done before and inside the
profiled stretch.  A reader that finds nothing to read returns None."""

from __future__ import annotations

import re

from portbench.lib.work import peak_seconds

# the program's kernel names, as the trace shows them
B1 = ("frame_chunk_kernel", "frame_merge_kernel")
B2_B5 = ("splat_fwd_partials_kernel", "splat_fwd_merge_kernel", "splat_bwd_partials_kernel", "splat_bwd_grads_kernel",
         "mesh_fwd_chunk_kernel", "mesh_fwd_merge_kernel", "mesh_bwd_kernel")


def device_ms_per_unit(run) -> float | None:
    """Device ms per unit (step or frame) of the program's own operations:
    the union of its kernels, copies within the device and fills over the
    profiled stretch, without the copies between host and device that feed
    it and read its result back."""
    d = run["digest"]
    return None if d is None or not run["units_prof"] else 1e3 * d["program_busy_s"] / run["units_prof"]


def mfu_pct(run) -> float | None:
    """The unit's counted FLOPs at the published peak of their precision
    over the program's device time per unit, in %."""
    t = device_ms_per_unit(run)
    return None if t is None or t <= 0 else 100.0 * peak_seconds(run["work"]["flops"]) / (1e-3 * t)


def idle_pct(run) -> float | None:
    d = run["digest"]
    return None if d is None else 100.0 * (1.0 - d["busy_s"] / d["window_s"])


def kernel_seconds_per_unit(run, names) -> float | None:
    """Device seconds per unit of the kernels whose function names are
    ``names``; None when one of them is not in the trace."""
    d = run["digest"]
    if d is None or not run["units_prof"]:
        return None
    total = 0.0
    for n in names:
        pat = re.compile(rf"\b{n}\b")
        hits = [v for k, v in d["by_name"].items() if pat.search(k)]
        if not hits:
            return None
        total += sum(hits)
    return total / run["units_prof"]


def roofline_pct(run, least_key: str, names) -> float | None:
    t = kernel_seconds_per_unit(run, names)
    least = run["work"].get(least_key)
    return None if t is None or least is None or t <= 0 else 100.0 * least / t


def span_ms_per_unit(run, name: str) -> float | None:
    """Mean host ms of the spans ``name`` that began in the window before the profiler."""
    end = run["t_prof"][0] if run["t_prof"][0] is not None else float("inf")
    total, n = run["spans"].total(name, run["t0"], end)
    return None if n == 0 else 1e3 * total / n
