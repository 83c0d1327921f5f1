"""LPIPS's distance head in the pose step (``csrc/lpips_head.cu``: its
forward, reduce and backward launches): the least time its bytes need on
the H100 (the five VGG16 taps of the prediction and the target at the
frame's size, 10 B an element, ``lib/frame_any_work.py``) over their
device time, in %."""

from portbench.lib import frame_any_work, readers


def read(run):
    return readers.roofline_pct(run, "lpips_head_least_s", frame_any_work.LPIPS_HEAD)
