"""The device's idle share of the profiled frames of the pose mix, in %."""

from portbench.lib import readers


def read(run):
    return readers.idle_pct(run)
