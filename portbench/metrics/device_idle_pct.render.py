"""The card's idle share of the profiled stretch: 1 - the union of its
operations' intervals over the stretch, in %."""

from portbench.lib import readers


def read(run):
    return readers.idle_pct(run)
