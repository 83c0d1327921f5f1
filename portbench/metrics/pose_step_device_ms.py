"""Device ms per pose step: the union of the program's device operations
over the profiled frames, without the copies between host and device (the
frame sent, its one read, the RGB read back), over their pose steps.  Each
frame's one eval render lies in it too (~3 ms of a frame's ~4.9 s)."""

from portbench.lib import readers


def read(run):
    t = readers.device_ms_per_unit(run)
    return None if t is None else t / run["work"]["steps"]
