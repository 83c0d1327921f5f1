"""Device ms per train step: the union of the program's device operations
over the profiled steps, without the copies of the batch from the host and
of the losses back (the data layer's and the loop's)."""

from portbench.lib import readers


def read(run):
    return readers.device_ms_per_unit(run)
