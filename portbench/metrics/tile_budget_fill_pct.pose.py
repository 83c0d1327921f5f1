"""The most tiles one splat covered in the profiled frames' pose steps over
the per-splat tile budget (counters ``binning.most_tiles`` and
``binning.budget`` of ``refine_frame``), in %: under 100, nothing was cut."""

from portbench.lib import binning_records


def read(run):
    return binning_records.budget_fill_pct(run)
