"""The port's spans and counters (``gomavatar_tpu_torch/utils/profiling.py``)
and where the data layer and the programs record them, on the CPU.

Recording is off unless a torch.profiler session or a ``recording()`` block
is open, and then costs one flag check: no clock, no buffer, no
``record_function``.  When on, spans nest per thread, carry their item's id,
land in one bounded buffer and, under the profiler, in its chrome trace as
``gomavatar.`` ranges."""

import json
import threading
import time
import types

import numpy as np
import pytest
import torch

from gomavatar_tpu_torch.data import dataset as TD
from gomavatar_tpu_torch.data import synthetic as TS
from gomavatar_tpu_torch.programs import Program
from gomavatar_tpu_torch.utils import profiling as P


def kept(since, kind=P.Span, name=None):
    return [r for r in P.records(since) if isinstance(r, kind) and (name is None or r.name == name)]


def names(since, kind=P.Span):
    return [r.name for r in kept(since, kind)]


def test_off_reads_no_clock_and_records_nothing(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("called while recording is off")

    assert not P.enabled()
    before = len(P._records)
    monkeypatch.setattr(P, "time", types.SimpleNamespace(perf_counter=boom))
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert P.span("a", 1) is P.span("b", workers=4)  # one shared no-op
    with P.span("data.decode", 3, workers=4):
        with P.span("inner"):
            pass
    P.count("data.prefetch_take")
    P.count("data.prefetch_miss", 2)
    assert len(P._records) == before


def test_profiler_flag_is_where_recording_looks():
    """``torch.autograd.profiler._is_profiler_enabled`` is the switch: a torch
    upgrade that moves it must fail here, not stop recording silently."""
    import torch.autograd.profiler as AP

    assert AP._is_profiler_enabled is False and not P.enabled()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert AP._is_profiler_enabled is True and P.enabled()
    assert AP._is_profiler_enabled is False and not P.enabled()
    with P.recording():
        assert P.enabled()
        with P.recording():
            assert P.enabled()
        assert P.enabled()
    assert not P.enabled()


def test_recording_nests_spans_per_thread():
    t = time.perf_counter()
    with P.recording():
        with P.span("outer", 7, fn="f"):
            with P.span("inner", 7):
                P.count("ticks", 3)
            other = threading.Thread(target=lambda: P.span("worker", 1).__enter__().__exit__(None, None, None))
            other.start()
            other.join()
        with P.span("after"):
            pass
    spans = {s.name: s for s in kept(t)}
    assert set(spans) == {"outer", "inner", "worker", "after"}
    assert spans["inner"].parent == "outer" and spans["outer"].parent is None
    assert spans["worker"].parent is None and spans["after"].parent is None
    assert spans["outer"].id == spans["inner"].id == 7 and spans["outer"].attrs == {"fn": "f"}
    assert spans["inner"].attrs is None
    assert spans["outer"].thread == spans["inner"].thread == threading.get_ident() != spans["worker"].thread
    assert spans["outer"].t0 <= spans["inner"].t0 <= spans["inner"].t1 <= spans["outer"].t1 <= spans["after"].t0
    (c,) = kept(t, P.Count)
    assert c.name == "ticks" and c.n == 3 and spans["inner"].t0 <= c.t <= spans["inner"].t1
    assert kept(spans["after"].t0) == [spans["after"]]


def test_buffer_keeps_the_newest_within_its_bound():
    t = time.perf_counter()
    with P.recording():
        for i in range(P.MAX_RECORDS + 10):
            P.count("n", i)
    assert len(P._records) == P.MAX_RECORDS
    got = [c.n for c in kept(t, P.Count)]
    assert got == list(range(10, P.MAX_RECORDS + 10))


def test_profiler_session_records_and_traces_the_spans(tmp_path):
    path = tmp_path / "trace.json"
    t = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                on_trace_ready=lambda p: p.export_chrome_trace(str(path))):
        with P.span("program.call", 1):
            with P.span("program.launch", 1):
                torch.ones(4).sum()
    assert names(t) == ["program.launch", "program.call"]
    assert kept(t, name="program.launch")[0].parent == "program.call"
    events = {e["name"]: e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("name", "").startswith(P.PREFIX)}
    assert set(events) == {"gomavatar.program.call", "gomavatar.program.launch"}
    call, launch = events["gomavatar.program.call"], events["gomavatar.program.launch"]
    assert call["tid"] == launch["tid"]
    assert call["ts"] <= launch["ts"] and launch["ts"] + launch["dur"] <= call["ts"] + call["dur"]


class _Stub:
    """Items {"i": i}, each taking ``delay`` seconds; with ``gates`` (an
    event per item) item i's decode starts once ``gates[i]`` is set."""

    def __init__(self, n, delay=0.0, gates=None):
        self.n, self.delay, self.gates = n, delay, gates

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if self.gates is not None:
            assert self.gates[i].wait(10), f"item {i}: no take waited for it"
        time.sleep(self.delay)
        return {"i": i}

    def item(self, i, rng):
        return self[i]


def test_prefetcher_decodes_each_item_once_under_its_position():
    order = [5, 2, 7, 0, 3, 1]
    t = time.perf_counter()
    with P.recording():
        got = [it["i"] for it in TD.Prefetcher(_Stub(8, 0.002), order=order, workers=3, seed=(1, 0))]
    assert got == order
    decode = kept(t, name="data.decode")
    assert sorted(s.id for s in decode) == list(range(len(order)))
    assert all(s.attrs == {"workers": 3} and s.thread != threading.get_ident() for s in decode)
    waits = kept(t, name="data.prefetch_wait")
    assert [s.id for s in waits] == list(range(len(order)))
    assert all(s.thread == threading.get_ident() for s in waits)
    assert sum(c.n for c in kept(t, P.Count) if c.name == "data.prefetch_take") == len(order)


@pytest.mark.parametrize("slow", ["decode", "consumer"])
def test_prefetch_miss_counts_the_takes_that_waited(slow, monkeypatch):
    """Against a slow decode every take waits: each item's decode starts
    only once the consumer waits for it (its gate opened from inside the
    consumer's wait), so no take can find it ready; against a slow
    consumer, which finds each item ready, none does, and the workers are
    held by ``depth`` instead."""
    n = 6
    gates = None
    if slow == "decode":
        gates = [threading.Event() for _ in range(n)]
        consumer, wait = threading.get_ident(), threading.Condition.wait

        def wait_and_open(cv, timeout=None):
            if threading.get_ident() == consumer:
                next((g for g in gates if not g.is_set()), threading.Event()).set()
            return wait(cv, timeout)

        monkeypatch.setattr(threading.Condition, "wait", wait_and_open)
    t = time.perf_counter()
    with P.recording():
        decode_s, workers = (0.02, 1) if slow == "decode" else (0.0, 2)
        items = iter(TD.Prefetcher(_Stub(n, decode_s, gates), workers=workers))
        for k in range(n):
            if slow == "consumer":
                time.sleep(0.03)
            assert next(items)["i"] == k
        assert next(items, None) is None
    counts = {}
    for c in kept(t, P.Count):
        counts[c.name] = counts.get(c.name, 0) + c.n
    assert counts["data.prefetch_take"] == n
    assert counts.get("data.prefetch_miss", 0) == (n if slow == "decode" else 0)
    waits = kept(t, name="data.prefetch_wait")
    assert len(waits) == n
    if slow == "decode":
        assert min(s.t1 - s.t0 for s in waits[1:]) > 0.005
    else:
        assert kept(t, name="data.backpressure")


def test_train_items_record_their_decode_stages(tmp_path):
    data_dir = TS.write_synthetic_dataset(str(tmp_path / "synth"), n_frames=3, img_hw=(32, 32))
    ds = TD.TrainDataset(data_dir, bgcolor=None, target_size=(16, 16))
    t = time.perf_counter()
    with P.recording():
        items = list(TD.Prefetcher(ds, workers=2, seed=(1, 0)))
        batch = TD.to_device(items[0], "cpu")
    by = {}
    for s in kept(t):
        by.setdefault(s.name, []).append(s)
    assert len(by["data.decode"]) == len(by["data.read"]) == len(by["data.composite_resize"]) == 3
    assert all(s.parent == "data.decode" for s in by["data.read"] + by["data.composite_resize"])
    (dev,) = by["data.to_device"]
    assert dev.parent is None and dev.thread == threading.get_ident()
    assert batch["target_rgbs"].shape == (16, 16, 3)


def test_program_records_capture_once_then_load_and_launch():
    def fn(x, scale):
        return {"y": x * scale + 1.0}

    prog = Program(fn)
    xs = [torch.arange(6, dtype=torch.float32) + k for k in range(3)]
    t = time.perf_counter()
    with P.recording():
        outs = [prog(x, 2.0)["y"].clone() for x in xs]
    for x, y in zip(xs, outs):
        torch.testing.assert_close(y, x * 2.0 + 1.0, rtol=0, atol=0)
    spans = kept(t)
    calls = [s for s in spans if s.name == "program.call"]
    assert [s.id for s in calls] == [1, 2, 3] and all(s.attrs == {"fn": fn.__qualname__} for s in calls)
    by_call = {k: sorted(s.name for s in spans if s.id == k and s.name != "program.call") for k in (1, 2, 3)}
    assert by_call == {1: ["program.capture", "program.launch"], 2: ["program.launch", "program.load"],
                       3: ["program.launch", "program.load"]}
    assert all(s.parent == "program.call" for s in spans if s.name != "program.call")
    assert prog.captures == 1 and prog.calls == 3
    # the same calls without recording give the same outputs
    plain = Program(fn)
    for x, y in zip(xs, outs):
        torch.testing.assert_close(plain(x, 2.0)["y"], y, rtol=0, atol=0)


def test_timer_section_is_also_a_span():
    timer = P.Timer()
    t = time.perf_counter()
    with P.recording():
        with timer.section("fk"):
            with P.span("inside"):
                np.zeros(4).sum()
    assert timer.report()["fk"]["count"] == 1
    spans = {s.name: s for s in kept(t)}
    assert set(spans) == {"fk", "inside"} and spans["inside"].parent == "fk"
    assert 1e3 * (spans["fk"].t1 - spans["fk"].t0) >= timer.report()["fk"]["mean_ms"] * 0.999


def test_threads_record_every_span_under_fast_switching():
    """More threads than cores, switching every microsecond: every span and
    count is kept, each nested under its own thread's parent."""
    import sys

    n_threads, n_spans = 16, 500
    t = time.perf_counter()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    # every thread alive at once, so that no two share an id
    together = threading.Barrier(n_threads, timeout=60)
    try:
        def work(k):
            together.wait()
            for i in range(n_spans):
                with P.span("outer", k):
                    with P.span("inner", k):
                        P.count("c")
            together.wait()

        with P.recording():
            threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(switch)
    inner = kept(t, name="inner")
    assert len(inner) == len(kept(t, name="outer")) == n_threads * n_spans
    assert all(s.parent == "outer" for s in inner)
    assert len({s.thread for s in inner}) == n_threads
    for k in range(n_threads):
        assert len({s.thread for s in inner if s.id == k}) == 1
    assert len(kept(t, P.Count)) == n_threads * n_spans


# -- the pose loop and the train step's binning counters --------------------------------


@pytest.fixture(scope="module")
def snapshot(tmp_path_factory):
    """The snapshot_m3c configuration at 80^2 (5 x 5 tiles) on the
    benchmark's tiny avatar: (cell, the program's state, a test frame, a
    trunk)."""
    import torch_snapshot_scene as S

    c = S.cell(tmp_path_factory.mktemp("tracing_snapshot"), size=80)
    cfg = c.program_cfg()
    return c, cfg, c.program_state(cfg), S.pose_frames(c)[0], S.trunk()


def _refine(snapshot, position=None):
    import torch_snapshot_scene as S
    from gomavatar_tpu_torch.cli.train_pose import make_pose_optimizer, refine_frame

    c, cfg, (params, statics, gom_cfg), frame, trunk = snapshot
    optimize = make_pose_optimizer(gom_cfg, cfg["train"]["losses"], cfg["pose"], 2)
    return refine_frame(optimize, params, statics, trunk, S.batch(frame), frame["poses"], position=position)


def _trainer(snapshot, log_freq):
    from gomavatar_tpu_torch.trainer import Trainer

    c, cfg, (params, statics, gom_cfg), frame, trunk = snapshot
    cfg = type(cfg).from_dict(cfg)
    cfg["train"]["log_freq"] = log_freq
    params = {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in params.items()}
    return Trainer(cfg, lpips_params=trunk, device="cpu", state=(params, statics, gom_cfg, 150000, 1))


def _train_batch(snapshot):
    from portbench.reference.data import pose_inputs

    frame = snapshot[3]
    cj = frame["dst_tpose_joints"]
    b = {k: torch.as_tensor(frame[k]) for k in ("K", "E", "bgcolor", "target_rgbs", "target_masks")}
    b.update({k: torch.as_tensor(v) for k, v in pose_inputs(frame["poses"], cj.copy(), cj).items()})
    return b


def test_pose_refinement_records_its_spans_and_counters(snapshot):
    t = time.perf_counter()
    with P.recording():
        r = _refine(snapshot, position=5)
    spans = kept(t)
    refine = [s for s in spans if s.name == "pose.refine"]
    read = [s for s in spans if s.name == "pose.read"]
    assert len(refine) == len(read) == 1
    assert refine[0].id == 5 and refine[0].attrs == {"iters": 2} and read[0].parent == "pose.refine"
    assert refine[0].t0 <= read[0].t0 and read[0].t1 <= refine[0].t1
    calls = [s for s in spans if s.name == "program.call"]
    assert len(calls) == 2 and all(s.parent == "pose.refine" for s in calls)
    counts = {c.name: c.n for c in kept(t, P.Count)}
    budget = snapshot[2][2].max_tiles_per_gaussian
    W, H = snapshot[2][2].img_size
    assert counts == {"pose.steps": 2, "binning.dropped": r.dropped, "binning.most_tiles": r.most_tiles,
                      "binning.budget": budget, "frame.px": W * H, "frame.swept_px": W * H}
    assert r.dropped == 0 and 0 < r.most_tiles < budget


def test_pose_spans_are_profiler_ranges(snapshot, tmp_path):
    path = tmp_path / "trace.json"
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                on_trace_ready=lambda p: p.export_chrome_trace(str(path))):
        _refine(snapshot, position=0)
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("name", "").startswith(P.PREFIX + "pose.")]
    by = {e["name"]: e for e in events}
    assert sorted(e["name"] for e in events) == ["gomavatar.pose.read", "gomavatar.pose.refine"]
    outer, inner = by["gomavatar.pose.refine"], by["gomavatar.pose.read"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def _direct_most_tiles(snapshot, params, batch) -> int:
    """The most tiles one face's union box covers, counted from the plain
    reference's own binning (no budget: each face has an entry per tile
    of its box)."""
    import math

    from portbench.reference import model as RM

    c = snapshot[0]
    rcfg, mesh, _, _, _ = c.reference_state()
    model = rcfg["model"]
    W, H = size = (c.config["frame_size"],) * 2
    with torch.no_grad():
        verts = RM.posed_vertices(params, model, mesh, batch, 150000.0)
        tri = verts[mesh.faces]
        cov = RM.covariances(tri, params["so3"], params["scale"], model["canonical_geometry"]["sigma"])
        mean2d, _, depth, radius, valid = RM.project_gaussians(tri.mean(dim=1), cov, batch["K"], batch["E"], size)
        xy, _, in_front = RM.project_triangles(tri, batch["K"], batch["E"])
        margin = math.sqrt(math.log(1.0 / 1e-4 - 1.0) * model["normal_renderer"]["sigma"]) / (2.0 / min(W, H)) + 1.0
        e_face, _, _, e_valid, *_ = RM.union_bins(mean2d, radius, valid, depth, xy, in_front, size, margin)
    return int(torch.bincount(e_face[e_valid > 0]).max())


def test_train_step_counts_the_binning_at_the_loops_reads(snapshot):
    """Under recording, ``Trainer.step`` counts every ``log_freq`` steps:
    the most tiles of its steps (a device scalar until read; equal to a
    direct count of the first step's frame), their drops, the budget and
    the frame's pixels and swept lanes (equal at 80^2, whole tiles)."""
    from portbench.reference.step import leaves, rebuild

    tr = _trainer(snapshot, log_freq=2)
    batch = _train_batch(snapshot)
    first = rebuild(tr.params, [p.detach().clone() for p in leaves(tr.params)])
    t = time.perf_counter()
    with P.recording():
        most = []
        for _ in range(4):
            _, losses = tr.step(batch)
            most.append(int(losses["bin_most_tiles"]))
    counts = kept(t, P.Count)
    assert [(c.name, type(c.n)) for c in counts] == [("binning.most_tiles", int), ("binning.dropped", int),
                                                      ("binning.budget", int), ("frame.px", int),
                                                      ("frame.swept_px", int)] * 2
    assert {c.n for c in counts if c.name.startswith("frame.")} == {80 * 80}
    assert [c.n for c in counts if c.name == "binning.most_tiles"] == [max(most[:2]), max(most[2:])]
    assert [c.n for c in counts if c.name == "binning.dropped"] == [0, 0]
    assert {c.n for c in counts if c.name == "binning.budget"} == {tr.gom_cfg.max_tiles_per_gaussian}
    assert most[0] == _direct_most_tiles(snapshot, first, batch) > 1


def test_pose_and_train_counters_off_read_no_clock(snapshot, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("called while recording is off")

    tr = _trainer(snapshot, log_freq=1)
    batch = _train_batch(snapshot)
    before = len(P._records)
    monkeypatch.setattr(P, "time", types.SimpleNamespace(perf_counter=boom))
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert not P.enabled()
    _refine(snapshot, position=1)
    tr.step(batch)
    assert len(P._records) == before and tr._binning is None


# -- the frame's counters at a frame that ends mid-tile ---------------------------------


@pytest.fixture(scope="module")
def partial(tmp_path_factory):
    """The snapshot_m3c configuration at 40^2 (3 x 3 tiles, the last column
    and row 8 px wide): (cell, the program's config and state, a test
    frame, a trunk)."""
    import torch_any_size_scene as A
    import torch_snapshot_scene as S

    a = A.AnyCell(tmp_path_factory.mktemp("tracing_partial"), (40, 40))
    cfg, params, statics, gom_cfg = a.program()
    return a.cell, cfg, (params, statics, gom_cfg), a.frames(1)[0], S.trunk()


def _eval_call(snapshot):
    from gomavatar_tpu_torch.models.gom import eval_program

    _, _, (params, statics, gom_cfg), _, _ = snapshot
    b = _train_batch(snapshot)
    return eval_program()(params, statics, gom_cfg, b["K"], b["E"], b["cnl_gtfms"], b["dst_Rs"], b["dst_Ts"],
                          b["dst_posevec"], 150000.0)


def test_frame_counters_at_a_partial_tile_frame(partial, tmp_path):
    """``frame.px`` (W H = 1,600) and ``frame.swept_px`` (9 tiles x 256 =
    2,304), once a frame in ``refine_frame``, at each read of
    ``Trainer.step`` and once per eval-program call, under ``recording()``;
    and under a profiler session, where ``refine_frame``'s are taken inside
    its ``gomavatar.pose.refine`` range."""
    want = {"frame.px": 1600, "frame.swept_px": 2304}

    def frame_counts(t):
        return [(c.name, c.n) for c in kept(t, P.Count) if c.name.startswith("frame.")]

    tr = _trainer(partial, log_freq=1)
    t = time.perf_counter()
    with P.recording():
        _refine(partial, position=0)
    assert frame_counts(t) == list(want.items())
    t = time.perf_counter()
    with P.recording():
        _eval_call(partial)
        tr.step(_train_batch(partial))
    assert frame_counts(t) == list(want.items()) * 2
    path = tmp_path / "trace.json"
    t = time.perf_counter()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU],
                                on_trace_ready=lambda p: p.export_chrome_trace(str(path))):
        _refine(partial, position=1)
    assert frame_counts(t) == list(want.items())
    refine = kept(t, P.Span, "pose.refine")
    assert len(refine) == 1 and all(refine[0].t0 <= c.t <= refine[0].t1 for c in kept(t, P.Count))
    events = [e["name"] for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    assert "gomavatar.pose.refine" in events and "gomavatar.program.call" in events


def test_frame_counters_off_read_no_clock(partial, monkeypatch):
    def boom(*a, **k):
        raise AssertionError("called while recording is off")

    tr = _trainer(partial, log_freq=1)
    batch = _train_batch(partial)
    before = len(P._records)
    monkeypatch.setattr(P, "time", types.SimpleNamespace(perf_counter=boom))
    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert not P.enabled()
    _refine(partial, position=1)
    _eval_call(partial)
    tr.step(batch)
    assert len(P._records) == before
