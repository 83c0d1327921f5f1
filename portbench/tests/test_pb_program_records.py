"""The readers of the program's own spans (``lib/program_records.py``):
their arithmetic on records worked out by hand, ``trace.digest``'s keys on a
chrome trace that holds the program's ``gomavatar.`` ranges, and a tiny
traced run of each cell on the CPU reporting every metric read from the
program's records."""

import json
import math

import pytest
import torch

from portbench import run
from portbench.lib import program_records as records
from portbench.lib import trace as tr
from portbench.tests import tiny
from portbench.tests.test_pb_runs import SEED

MAIN, WORKER = 1, 2


def x(name, ts, dur, cat="user_annotation", tid=MAIN):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7, "tid": tid}


# times in microseconds; the window is [100, 200)
EVENTS = [
    x("portbench.window", 100, 100),
    x("portbench.data_wait", 100, 30),
    x("portbench.train_step", 130, 60),
    x("gomavatar.data.prefetch_wait", 102, 20),
    x("gomavatar.data.to_device", 122, 6),
    x("gomavatar.program.call", 132, 50),
    x("gomavatar.program.load", 134, 6),
    x("gomavatar.program.launch", 140, 30),
    x("gomavatar.data.decode", 95, 100, tid=WORKER),  # a decode thread: left out
    x("kernel_a", 90, 20, cat="kernel", tid=50),  # [90, 110): clipped to [100, 110)
    x("Memcpy HtoD (Pageable -> Device)", 125, 5, cat="gpu_memcpy", tid=50),  # [125, 130)
    x("kernel_b", 150, 40, cat="kernel", tid=50),  # [150, 190)
    x("kernel_c", 160, 10, cat="kernel", tid=51),  # inside kernel_b
    x("aten::mul", 141, 2, cat="cpu_op"),
]


@pytest.fixture
def trace_file(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return str(path)


def test_digest_keys_on_a_hand_made_trace(trace_file):
    """``trace.digest`` on a trace that holds the program's ranges, on the
    launching thread and on a decode thread: its keys and values as worked
    out by hand, the program's ranges counted in none of them."""
    d = tr.digest(trace_file)
    assert set(d) == {"window_s", "busy_s", "program_busy_s", "by_name", "top_ops", "idle_gaps", "idle_by_span"}
    assert d["window_s"] == pytest.approx(100e-6)
    assert d["busy_s"] == pytest.approx(55e-6)  # [100, 110), [125, 130), [150, 190)
    assert d["program_busy_s"] == pytest.approx(50e-6)
    assert d["by_name"] == pytest.approx({"kernel_a": 10e-6, "Memcpy HtoD (Pageable -> Device)": 5e-6,
                                         "kernel_b": 40e-6, "kernel_c": 10e-6})
    assert [k for k, _ in d["top_ops"]] == ["kernel_b", "kernel_a", "kernel_c", "Memcpy HtoD (Pageable -> Device)"]
    assert [(n, pytest.approx(v)) for n, v in d["idle_gaps"]] == [
        ("train_step", 20e-6), ("data_wait", 15e-6), ("outside any span", 10e-6)]
    assert d["idle_by_span"] == pytest.approx({"data_wait": 15e-6, "train_step": 20e-6, "outside any span": 10e-6})


NEW = ("decode_busy_pct.train", "composite_ms.train", "to_device_ms.train")


@pytest.mark.parametrize("cell", ["zju377.novel_view", "zju377.train"])
def test_tiny_trace_run_reads_the_program_records(cell, tmp_path):
    """On the CPU the profiled stretch covers 4 units, so that the train
    loop's reaches the next epoch's decode; the novel view, whose cell
    lists none of them, reports none."""
    spec = tiny.spec(cell, tmp_path)
    spec["mix"]["trace"]["units"] = 4
    torch.set_num_threads(1)
    out = run.run_cell(spec, SEED, 0.3, True, torch.device("cpu"), str(tmp_path / "trace"))
    assert out["correct"], out["compared"]
    if cell == "zju377.novel_view":
        assert not set(NEW) & set(out["metrics"])
        return
    for name in NEW:
        assert name in out["metrics"], name
        assert math.isfinite(out["metrics"][name]["value"]) and out["metrics"][name]["value"] >= 0, name
    assert out["metrics"]["decode_busy_pct.train"]["value"] <= 100.0


def test_readers_find_nothing_in_a_program_without_records(monkeypatch):
    """An older program keeps no records (the parent of the spans): each new
    reader returns None and raises nothing."""
    from gomavatar_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "records")
    traced = {"t_prof": [0.0, 1.0], "units_prof": 3, "units_before": 2, "digest": {}, "spans": None, "t0": 0.0}
    for name in NEW:
        reader = run.load_file(str(tiny.ROOT / "portbench" / "metrics" / f"{name}.py"), "probe_" + name.replace(".", "_"))
        assert reader.read(traced) is None, name


@pytest.mark.parametrize("decodes,want", [
    # begun during the profiler's start and still running at the first unit
    ([(5.0, 11.0), (10.5, 12.0)], 100.0 * (1.0 + 0.5) / (2 * 1.0)),
    # a lead-in as long as the longest decode (6.4 s) starts the share at 10.4
    ([(4.5, 10.9), (10.5, 12.0)], 100.0 * (0.5 + 0.5) / (2 * 0.6)),
    # decodes longer than the stretch: from the first unit on
    ([(4.0, 12.0), (10.5, 12.0)], 100.0 * (1.0 + 0.5) / (2 * 1.0)),
])
def test_decode_busy_share_by_hand(decodes, want, monkeypatch):
    """Profiled stretch [4, 11), its first unit at 10 (the profiler's start
    runs none), two decode threads."""
    from gomavatar_tpu_torch.utils import profiling as P

    recs = [P.Span("program.call", 10.0, 10.01, None, MAIN, 1, None)]
    recs += [P.Span("data.decode", a, b, None, WORKER + k, k, {"workers": 2}) for k, (a, b) in enumerate(decodes)]
    monkeypatch.setattr(P, "records", lambda since=-math.inf, until=math.inf: [
        r for r in sorted(recs, key=lambda r: r.t0) if since <= r.t0 < until])
    traced = {"t_prof": [4.0, 11.0], "units_prof": 1, "digest": None}
    assert records.busy_pct(traced, "data.decode") == pytest.approx(want)
    assert records.ms_per_span(traced, "data.decode") == pytest.approx(1e3 * (12.0 - 10.5))  # begun after the first unit


def test_decode_mean_falls_back_to_the_profilers_start(monkeypatch):
    """No decode began after the first unit: the mean is of those begun
    while the profiler started; the counts are no spans."""
    from gomavatar_tpu_torch.utils import profiling as P

    recs = [P.Count("data.prefetch_take", 9.0, 1), P.Span("data.decode", 5.0, 11.0, None, WORKER, 0, {"workers": 1}),
            P.Span("program.call", 10.0, 10.01, None, MAIN, 1, None), P.Count("data.prefetch_take", 10.0, 1),
            P.Count("data.prefetch_miss", 10.0, 1), P.Count("data.prefetch_take", 10.5, 1)]
    monkeypatch.setattr(P, "records", lambda since=-math.inf, until=math.inf: [
        r for r in recs if since <= getattr(r, "t0", getattr(r, "t", None)) < until])
    traced = {"t_prof": [4.0, 11.0], "units_prof": 2, "digest": None}
    assert records.ms_per_span(traced, "data.decode") == pytest.approx(6e3)
    assert records.ms_per_unit(traced, "data.prefetch_take") is None


def _stub_records(monkeypatch, recs):
    from gomavatar_tpu_torch.utils import profiling as P

    monkeypatch.setattr(P, "records", lambda since=-math.inf, until=math.inf: [
        r for r in sorted(recs, key=lambda r: r.t0) if since <= r.t0 < until])


def test_to_device_per_step_by_hand(monkeypatch):
    """Stretch [4, 11), its first unit at 10: two steps' copies on the
    launching thread, and one begun at the stretch's end, left out."""
    from gomavatar_tpu_torch.utils import profiling as P

    _stub_records(monkeypatch, [
        P.Span("data.to_device", 10.0, 10.02, None, MAIN, None, None),
        P.Span("program.call", 10.02, 10.03, None, MAIN, 1, None),
        P.Span("data.to_device", 10.5, 10.53, None, MAIN, None, None),
        P.Span("program.call", 10.53, 10.54, None, MAIN, 2, None),
        P.Span("data.to_device", 11.0, 11.05, None, MAIN, None, None),
    ])
    traced = {"t_prof": [4.0, 11.0], "units_prof": 2, "digest": None}
    assert records.units_start(traced) == pytest.approx(10.0)
    assert records.ms_per_unit(traced, "data.to_device") == pytest.approx(1e3 * (0.02 + 0.03) / 2)


@pytest.mark.parametrize("recs,t_prof,units", [
    ([], [4.0, 11.0], 2),  # nothing kept
    ([("data.to_device", 10.0, 10.02)], [4.0, 11.0], 2),  # no program call: no launching thread
    ([("program.call", 10.0, 10.01), ("data.to_device", 10.0, 10.02)], [4.0, 11.0], 0),  # no unit
    ([("program.call", 10.0, 10.01), ("data.to_device", 10.0, 10.02)], [None, None], 2),  # no stretch
])
def test_readers_find_nothing_to_read(recs, t_prof, units, monkeypatch):
    from gomavatar_tpu_torch.utils import profiling as P

    _stub_records(monkeypatch, [P.Span(n, a, b, None, MAIN, None, None) for n, a, b in recs])
    traced = {"t_prof": t_prof, "units_prof": units, "digest": None}
    assert records.ms_per_unit(traced, "data.to_device") is None
    assert records.ms_per_span(traced, "data.composite_resize") is None
    assert records.busy_pct(traced, "data.decode") is None
