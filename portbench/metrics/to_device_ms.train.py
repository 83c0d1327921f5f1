"""Host ms per train step in ``to_device`` (pinning the batch and queueing its
copies to the card; span ``data.to_device``), over the profiled stretch."""

from portbench.lib import program_records as records


def read(run):
    return records.ms_per_unit(run, "data.to_device")
