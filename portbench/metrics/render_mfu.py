"""The eval frame's FLOPs at the published peak of their precision over the
eval program's device ms per frame (``render_device_ms``), in %."""

from portbench.lib import readers


def read(run):
    return readers.mfu_pct(run)
