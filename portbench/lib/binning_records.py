"""The program's binning counters over the profiled stretch: since
``gomavatar_tpu_torch``'s ``Trainer.step`` and ``cli/train_pose.py:
refine_frame`` count them (``binning.most_tiles``, the most tiles one splat
covered since the loop's last read; ``binning.budget``, the per-splat
budget in force), at the reads those loops make.  None where neither was
counted in the stretch: a program older than the counters."""

from __future__ import annotations

from portbench.lib import program_records


def counts(run, name: str) -> list | None:
    start = program_records.units_start(run)
    if start is None:
        return None
    from gomavatar_tpu_torch.utils.profiling import Count, records

    out = [r.n for r in records(start, run["t_prof"][1]) if isinstance(r, Count) and r.name == name]
    return out or None


def budget_fill_pct(run) -> float | None:
    """The most tiles one splat covered over the per-splat budget, in %:
    under 100, no splat was cut to its budget."""
    most, budget = counts(run, "binning.most_tiles"), counts(run, "binning.budget")
    if most is None or budget is None:
        return None
    return 100.0 * max(most) / min(budget)
