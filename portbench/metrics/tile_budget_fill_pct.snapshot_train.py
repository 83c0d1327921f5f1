"""The most tiles one splat covered in the profiled train steps at 544^2
over the per-splat tile budget (counters ``binning.most_tiles`` and
``binning.budget`` of ``Trainer.step``, every ``log_freq`` steps), in %:
under 100, nothing was cut."""

from portbench.lib import binning_records


def read(run):
    return binning_records.budget_fill_pct(run)
