"""The share of the lanes the kernels sweep that lie past the frame, over
the profiled frames: 1 - ``frame.px`` / ``frame.swept_px`` (the program's
counters, once a frame in ``refine_frame`` and once an eval-program call),
in %.  0 at a frame of whole tiles; 1.47 % at 540^2 (34 x 34 tiles)."""

from portbench.lib import binning_records


def read(run):
    px, swept = binning_records.counts(run, "frame.px"), binning_records.counts(run, "frame.swept_px")
    if px is None or swept is None:
        return None
    return 100.0 * (1.0 - sum(px) / sum(swept))
