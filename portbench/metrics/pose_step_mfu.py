"""The pose step's counted FLOPs (``lib/pose_work.py``: B2-B5 by shapes,
VGG's forwards and its backward into the prediction, the MLPs forward and
backward into their inputs) at their precision's published peak over its
device time (``pose_step_device_ms``), in %."""

from portbench.lib import readers


def read(run):
    return readers.mfu_pct(run)
