"""Arithmetic shared by the readers of the program's own spans.

``gomavatar_tpu_torch.utils.profiling`` keeps them while a torch.profiler
session is open, which in a traced run is the profiled stretch; they are on
``time.perf_counter()``, the clock of the harness's own spans.  A reader
selects the stretch ``[run["t_prof"][0], run["t_prof"][1])`` and divides by
its units (``run["units_prof"]``).  The stretch begins with the profiler's
own start (seconds on the card, with no unit run), so it is taken from the
first record of the launching thread (the thread of ``program.call``) on;
the decode threads' spans begun during that start are read only by the
busy share, and by the per-item means where no later one began.  Every
function returns None where there is nothing to read: a program that keeps
no records (one older than its spans), a stretch that holds none of the
name.

The records are taken under the profiler, whose own host cost inflates
the launching thread's spans (a graph's replay, the program's host side)
several times over; the readers here are those of work that the profiler
leaves as it is (the data layer's copy, the decode threads)."""

from __future__ import annotations


def units_start(run) -> float | None:
    """When the profiled stretch's first unit began: the first record of
    the launching thread in it."""
    t0, t1 = run["t_prof"]
    if t0 is None or t1 is None or not run["units_prof"]:
        return None
    try:
        from gomavatar_tpu_torch.utils.profiling import Span, records
    except ImportError:
        return None
    recs = records(t0, t1)
    call = next((r for r in recs if isinstance(r, Span) and r.name == "program.call"), None)
    if call is None:
        return None
    return min(r.t0 for r in recs if isinstance(r, Span) and r.thread == call.thread)


def spans(run, name: str, from_profiler: bool = False) -> list | None:
    """The spans ``name`` begun in the stretch from its first unit on (from
    the profiler's opening with ``from_profiler``), or None."""
    start = units_start(run)
    if start is None:
        return None
    from gomavatar_tpu_torch.utils.profiling import Span, records

    since = run["t_prof"][0] if from_profiler else start
    out = [r for r in records(since, run["t_prof"][1]) if isinstance(r, Span) and r.name == name]
    return out or None


def seconds(spans_) -> float:
    return sum(s.t1 - s.t0 for s in spans_)


def ms_per_unit(run, name: str) -> float | None:
    """Host ms per unit in the spans ``name``."""
    s = spans(run, name)
    return None if s is None else 1e3 * seconds(s) / run["units_prof"]


def ms_per_span(run, name: str) -> float | None:
    """The mean host ms of one span ``name`` (one item, for the decode's);
    of those begun during the profiler's start where none began later (a
    decode thread may run one item through a short stretch)."""
    s = spans(run, name) or spans(run, name, from_profiler=True)
    return None if s is None else 1e3 * seconds(s) / len(s)


def busy_pct(run, name: str) -> float | None:
    """The spans ``name`` of a pool of threads (their ``workers``
    attribute) over the pool's time from the first unit to the stretch's
    end, in %.  Spans the pool began during the profiler's start are
    counted from the first unit on; one in flight when the profiler opened
    has no record, so where the stretch allows it the share is taken after
    a lead-in as long as the longest span, by whose end every span in
    flight began after the profiler opened."""
    s = spans(run, name, from_profiler=True)
    if s is None:
        return None
    start = units_start(run)
    t0, end = run["t_prof"]
    workers = max(int((x.attrs or {}).get("workers", 1)) for x in s)
    lead_in = t0 + max(x.t1 - x.t0 for x in s)
    if lead_in < end:
        start = max(start, lead_in)
    busy = sum(max(0.0, min(x.t1, end) - max(x.t0, start)) for x in s)
    return 100.0 * busy / (workers * (end - start))
