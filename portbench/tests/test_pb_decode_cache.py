"""The reader of ``decode_cache_hit_pct.train``
(``metrics/decode_cache_hit_pct.train.py``): its share worked out by hand
on planted counts, None where the program keeps no such counter, and a
tiny traced run of the train cell on the CPU that reports it."""

import math

import pytest
import torch

from portbench import run
from portbench.tests import tiny
from portbench.tests.test_pb_runs import SEED

MAIN, WORKER = 1, 2
CACHE = "decode_cache_hit_pct.train"


def _stub_records(monkeypatch, recs):
    from gomavatar_tpu_torch.utils import profiling as P

    def when(r):
        return r.t0 if isinstance(r, P.Span) else r.t

    monkeypatch.setattr(P, "records", lambda since=-math.inf, until=math.inf: [
        r for r in sorted(recs, key=when) if since <= when(r) < until])


def _cache_reader():
    return run.load_file(str(tiny.ROOT / "portbench" / "metrics" / f"{CACHE}.py"), "probe_decode_cache")


def test_decode_cache_hit_share_by_hand(monkeypatch):
    """Stretch [4, 11), its first unit at 10: three hits and one miss from
    there on; a miss before the first unit and a hit at the stretch's end
    are left out, and so are the other counters."""
    from gomavatar_tpu_torch.utils import profiling as P

    _stub_records(monkeypatch, [
        P.Count("data.decode_cache_miss", 9.0, 1),
        P.Span("program.call", 10.0, 10.01, None, MAIN, 1, None),
        P.Count("data.decode_cache_hit", 10.1, 1), P.Count("data.prefetch_take", 10.1, 1),
        P.Count("data.decode_cache_miss", 10.2, 1), P.Count("data.decode_cache_hit", 10.3, 2),
        P.Count("data.decode_cache_hit", 11.0, 1),
    ])
    traced = {"t_prof": [4.0, 11.0], "units_prof": 2, "digest": None}
    assert _cache_reader().read(traced) == pytest.approx(75.0)


@pytest.mark.parametrize("no_counters", ["other_records", "no_records"])
def test_decode_cache_hit_share_is_none_without_its_counters(monkeypatch, no_counters):
    """A program older than the counters keeps other spans and counts (or,
    older still, no records): the reader returns None and raises nothing."""
    from gomavatar_tpu_torch.utils import profiling as P

    if no_counters == "no_records":
        monkeypatch.delattr(P, "records")
    else:
        _stub_records(monkeypatch, [P.Span("program.call", 10.0, 10.01, None, MAIN, 1, None),
                                   P.Span("data.read", 10.1, 10.2, None, WORKER, 3, None),
                                   P.Count("data.prefetch_take", 10.3, 1)])
    traced = {"t_prof": [4.0, 11.0], "units_prof": 2, "digest": None}
    assert _cache_reader().read(traced) is None


def test_tiny_trace_run_reads_the_decode_cache_share(tmp_path):
    """The tiny train cell's traced stretch reaches the second epoch, whose
    items start from the frames the loop's dataset kept: the share is
    reported, above 0 and at most 100 %."""
    spec = tiny.spec("zju377.train", tmp_path)
    spec["mix"]["trace"]["units"] = 4
    torch.set_num_threads(1)
    out = run.run_cell(spec, SEED, 0.3, True, torch.device("cpu"), str(tmp_path / "trace"))
    assert out["correct"], out["compared"]
    assert 0.0 < out["metrics"][CACHE]["value"] <= 100.0
