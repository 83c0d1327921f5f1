"""Kernel B1: the least time the frame's splat blend and z-test need on the
H100 over the device time of its two launches, in %."""

from portbench.lib import readers


def read(run):
    return readers.roofline_pct(run, "b1_least_s", readers.B1)
