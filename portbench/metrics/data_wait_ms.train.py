"""Host ms per step that the training loop waits for its next item and the
item's copy to the card (span ``data_wait``: ``Prefetcher`` and ``to_device``)."""

from portbench.lib import readers


def read(run):
    return readers.span_ms_per_unit(run, "data_wait")
