"""Kernels B2-B5 in the train step at 544^2: the least time its splat
blend, mesh raster and their backward need on the H100 over their device
time, in %."""

from portbench.lib import readers


def read(run):
    return readers.roofline_pct(run, "b2_b5_least_s", readers.B2_B5)
