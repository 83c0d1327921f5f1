"""Device ms per novel-view frame: the union of the eval program's device
operations over the profiled frames, without the copies of the inputs
from the host and of the RGB back (``send`` and ``read_back``)."""

from portbench.lib import readers


def read(run):
    return readers.device_ms_per_unit(run)
