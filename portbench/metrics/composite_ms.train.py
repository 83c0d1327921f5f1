"""Host ms of one train item's float64 composite over its background and its
resize (``TrainDataset._composite_resize``, span
``data.composite_resize``), the mean over the profiled stretch."""

from portbench.lib import program_records as records


def read(run):
    return records.ms_per_span(run, "data.composite_resize")
