"""The cell ``snapshot_m3c_540.pose_refine`` through ``run.py``'s whole
path at 40^2 (3 x 3 tiles, the last column and row 8 px wide) on the tiny
avatar, on the program's plain kernels: within the cell's own limits, its
readers of the program's counters reading, the work counted on the
frame's own pixels; and the same runs with the timed path broken
underneath judged not correct."""

import json

import pytest
import torch

from portbench import run
from portbench.tests import tiny
from portbench.tests.test_pb_runs import SEED
from portbench.tests.test_pb_snapshot import POSE_ITERS, altered_image, altered_pose_loss, still_pose

CELL = "snapshot_m3c_540.pose_refine"
SIZE = 40


def spec(tmp_path, size=SIZE):
    s = tiny.spec(CELL, tmp_path, size)
    s["config"]["pose"] = {**s["config"]["pose"], "iters": POSE_ITERS}
    return s


def run_tiny(tmp_path, seconds=0.3, trace=False, size=SIZE):
    torch.set_num_threads(1)
    return run.run_cell(spec(tmp_path, size), SEED, seconds, trace, torch.device("cpu"), str(tmp_path / "trace"))


def test_tiny_run(tmp_path):
    out = run_tiny(tmp_path)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_steps_per_s", "setup_s"}
    assert set(tiny.limits(CELL)) <= set(out["compared"])
    json.dumps(out)


def test_traced_run_reads_the_counters(tmp_path):
    """The budget's fill under 100 % and the lanes past the frame, 1 - 40^2
    / (9 x 256) = 30.6 %; the device's metrics absent on the CPU."""
    out = run_tiny(tmp_path, trace=True)
    assert out["correct"] and "setup_s" not in out["metrics"]
    assert set(out["metrics"]) == {"tile_budget_fill_pct.pose", "edge_lane_pct.pose540"}
    assert 0 < out["metrics"]["tile_budget_fill_pct.pose"]["value"] < 100
    assert out["metrics"]["edge_lane_pct.pose540"]["value"] == pytest.approx(100.0 * (1.0 - 1600 / 2304))


@pytest.mark.parametrize("fault", [still_pose, altered_pose_loss, altered_image])
def test_fault_is_not_correct(fault, tmp_path, monkeypatch):
    fault(monkeypatch)
    assert not run_tiny(tmp_path)["correct"]


def test_work_counts_the_frames_own_pixels(tmp_path):
    """At 32^2 (whole tiles) the pairs are ``work.frame_pairs``'s; at 40^2
    the pixels are the frame's 1,600 and the LPIPS head's least time is
    its five taps' bytes, 10 B an element."""
    from portbench.lib import frame_any_work, work
    from portbench.lib.harness import Cell

    for size in (32, SIZE):
        (tmp_path / str(size)).mkdir()
        s = spec(tmp_path / str(size), size)
        cell = Cell(CELL, s["config"], s["mix"], SEED, torch.device("cpu"), str(tmp_path))
        drv = run.load_file(s["driver"], "portbench_driver_pose_refine_540").Driver(cell)
        drv.size, drv.bg, drv.dev = size, torch.ones(3).numpy(), torch.device("cpu")
        drv.pool = drv.make_frames()
        drv.iters, drv.profiled, drv.kept = POSE_ITERS, [0], {}
        w = drv.work()
        assert w["pairs"]["pixels"] == size * size and w["steps"] == POSE_ITERS
        taps = frame_any_work.vgg_tap_elements(size, size)
        assert w["lpips_head_least_s"] == pytest.approx(POSE_ITERS * 10 * sum(taps) / work.HBM_BYTES_PER_S)
        if size == 32:
            from portbench.lib import pose_work

            cfg, mesh, params, _, _ = cell.reference_state()
            whole = pose_work.frame_work(params, cfg["model"], mesh, drv.pool[:1], (32, 32), POSE_ITERS, drv.dev)
            assert w["pairs"] == whole["pairs"] and w["flops"] == whole["flops"]
    assert frame_any_work.vgg_tap_elements(540, 540) == [64 * 540 ** 2, 128 * 270 ** 2, 256 * 135 ** 2,
                                                         512 * 67 ** 2, 512 * 33 ** 2]
