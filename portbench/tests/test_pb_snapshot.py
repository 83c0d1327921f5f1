"""The PeopleSnapshot cells through ``run.py``'s whole path at 32^2 on the
tiny avatar, on the program's plain kernels: within the cells' own
limits, their readers of the program's counters reading, and the same runs
with the timed path broken underneath judged not correct."""

import json

import pytest
import torch

from portbench import run
from portbench.tests import tiny
from portbench.tests.test_pb_runs import SEED, altered_loss, unchanged_train_state

POSE, TRAIN = "snapshot_m3c.pose_refine", "snapshot_m3c.train"
# pose steps a frame at 32^2 on the CPU (the cell's 300 would take minutes);
# the check compares the mix's first three
POSE_ITERS = 4


def spec(cell, tmp_path):
    s = tiny.spec(cell, tmp_path)
    s["config"]["pose"] = {**s["config"]["pose"], "iters": POSE_ITERS}
    # a read of the losses, and so a count of the binning, every step
    s["config"]["train"] = {**s["config"]["train"], "log_freq": 1}
    return s


def run_tiny(cell, tmp_path, seconds=0.3, trace=False):
    torch.set_num_threads(1)
    return run.run_cell(spec(cell, tmp_path), SEED, seconds, trace, torch.device("cpu"), str(tmp_path / "trace"))


@pytest.mark.parametrize("cell", [POSE, TRAIN])
def test_tiny_run(cell, tmp_path):
    out = run_tiny(cell, tmp_path)
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_steps_per_s", "setup_s"}
    assert set(tiny.limits(cell)) <= set(out["compared"])
    json.dumps(out)


@pytest.mark.parametrize("cell,metric", [(POSE, "tile_budget_fill_pct.pose"),
                                         (TRAIN, "tile_budget_fill_pct.snapshot_train")])
def test_traced_run_reads_the_budget_fill(cell, metric, tmp_path):
    """The counters the program keeps under the profiler reach the cell's
    reader: under 100 %, and the device's metrics absent on the CPU."""
    out = run_tiny(cell, tmp_path, trace=True)
    assert out["correct"] and "setup_s" not in out["metrics"]
    assert set(out["metrics"]) == {metric}
    assert 0 < out["metrics"][metric]["value"] < 100


def still_pose(monkeypatch):
    """The pose left where it starts: every Adam update zero."""
    import gomavatar_tpu_torch.cli.train_pose as TP

    update = TP.PoseAdam.update
    monkeypatch.setattr(TP.PoseAdam, "update",
                        lambda self, g, s: (lambda u, st: ([x * 0 for x in u], st))(*update(self, g, s)))


def altered_pose_loss(monkeypatch):
    import gomavatar_tpu_torch.cli.train_pose as TP

    loss = TP._frame_loss_telemetry
    monkeypatch.setattr(TP, "_frame_loss_telemetry", lambda *a: (lambda v, t: (v * 1.01, t))(*loss(*a)))


def altered_image(monkeypatch):
    import gomavatar_tpu_torch.models.gom as G

    forward = G.eval_forward
    monkeypatch.setattr(G, "eval_forward", lambda *a: (lambda r, m, x: (r + 0.05, m, x))(*forward(*a)))


@pytest.mark.parametrize("cell,fault", [
    (POSE, still_pose), (POSE, altered_pose_loss), (POSE, altered_image),
    (TRAIN, unchanged_train_state), (TRAIN, altered_loss),
])
def test_fault_is_not_correct(cell, fault, tmp_path, monkeypatch):
    fault(monkeypatch)
    assert not run_tiny(cell, tmp_path)["correct"]


def test_pose_reference_loads_nothing_of_the_program():
    from portbench.tests.test_pb_imports import loaded

    mods = loaded("from portbench.reference import pose")
    assert not mods & {"gomavatar_tpu_torch", "gomavatar_tpu", "jax", "jaxlib", "flax"}


def test_pose_reference_computes_with_tf32_off():
    """The pose reference's TF32 switch: off inside its calls unless asked
    for (the control), and as it was after."""
    from portbench.reference import pose as RP

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        with RP.tf32(False):
            assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
