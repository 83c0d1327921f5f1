"""Each mix through ``run.py``'s whole path at 32^2 on a tiny avatar, on the
program's plain kernels: the result's keys, the cell's own limits met;
and the same run with the timed path broken underneath judged not
correct."""

import json
import sys

import pytest
import torch

from portbench import run
from portbench.tests import tiny

CELLS = ("zju377.train", "zju377.novel_view")
SEED = 2**31 + 12345


def run_tiny(cell, tmp_path, seconds=0.3, trace=False):
    torch.set_num_threads(1)
    return run.run_cell(tiny.spec(cell, tmp_path), SEED, seconds, trace, torch.device("cpu"), str(tmp_path / "trace"))


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run(cell, tmp_path):
    out = run_tiny(cell, tmp_path)
    assert list(out) == ["correct", "attempted", "failed", "device", "metrics", "compared"]
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"] and len(out["metrics"]) >= 2
    assert all(c["limit"] is not None for k, c in out["compared"].items() if k in tiny.limits(cell))
    json.dumps(out)


def test_tiny_trace_run(tmp_path, capsys):
    out = run_tiny("zju377.novel_view", tmp_path, trace=True)
    assert out["correct"] and "setup_s" not in out["metrics"]
    assert run.report(out) == 0
    printed = capsys.readouterr()
    assert json.loads(printed.out.splitlines()[-1]) == out
    assert printed.err.splitlines()[-1].startswith("compared ")


PROBE = "gomavatar_tpu.loaded_by_a_reader"


def test_module_loaded_after_the_window_refuses_the_result(tmp_path, capsys, monkeypatch):
    """A per-layer reader, which runs once the window has closed, that loads
    the JAX package: the run prints no result and exits non-zero."""
    reader = tmp_path / "probe.py"
    reader.write_text(f"import sys\n\n\ndef read(run):\n    sys.modules[{PROBE!r}] = sys\n")
    monkeypatch.delitem(sys.modules, PROBE, raising=False)
    spec = tiny.spec("zju377.novel_view", tmp_path)
    spec["per_layer"] = spec["per_layer"] + [{"name": "probe", "unit": "%"}]
    spec["readers"] = {**spec["readers"], "probe": str(reader)}
    torch.set_num_threads(1)
    out = run.run_cell(spec, SEED, 0.3, True, torch.device("cpu"), str(tmp_path / "trace"))
    try:
        assert out["correct"] and "probe" not in out["metrics"]
        assert run.report(out) != 0
    finally:
        sys.modules.pop(PROBE, None)
    printed = capsys.readouterr()
    assert printed.out == "" and "gomavatar_tpu" in printed.err


def unchanged_train_state(monkeypatch):
    import gomavatar_tpu_torch.trainer as T

    monkeypatch.setattr(T, "update_in_place", lambda tx, params, opt_state, grads: None)


def altered_loss(monkeypatch):
    import gomavatar_tpu_torch.trainer as T

    train_loss = T.train_loss
    monkeypatch.setattr(T, "train_loss", lambda *a: (lambda t, l: (t * 1.01, l))(*train_loss(*a)))


def altered_image(monkeypatch):
    import gomavatar_tpu_torch.models.gom as G

    forward = G.eval_forward
    monkeypatch.setattr(G, "eval_forward", lambda *a: (lambda r, m, x: (r + 0.05, m, x))(*forward(*a)))


@pytest.mark.parametrize("cell,fault", [
    ("zju377.train", unchanged_train_state), ("zju377.train", altered_loss),
    ("zju377.novel_view", altered_image),
])
def test_fault_is_not_correct(cell, fault, tmp_path, monkeypatch):
    fault(monkeypatch)
    assert not run_tiny(cell, tmp_path)["correct"]
