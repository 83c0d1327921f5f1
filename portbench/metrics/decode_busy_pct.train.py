"""The decode threads' busy share: span ``data.decode`` seconds over the
``Prefetcher``'s ``workers`` times the profiled stretch from its first unit
on (decodes begun while the profiler started counted from there; after a
lead-in as long as the longest decode where the stretch is longer), in %."""

from portbench.lib import program_records as records


def read(run):
    return records.busy_pct(run, "data.decode")
