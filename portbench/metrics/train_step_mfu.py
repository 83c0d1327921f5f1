"""The train step's FLOPs at the published peak of their precision over the
train program's device ms per step (``train_step_device_ms``), in %."""

from portbench.lib import readers


def read(run):
    return readers.mfu_pct(run)
