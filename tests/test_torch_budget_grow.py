"""The train step's per-splat tile budget follows the state (``trainer.py``,
ROADMAP C5), on the CPU: the growth rule, a gate scene whose splats are
widened between steps (the budget grows before any step drops an entry,
where the static budget drops; the params and Adam state carry over each
rebuild unchanged; ``binning.budget_grow`` is counted), and a run that
never grows is the step of the static budget bit for bit."""

import copy
import dataclasses
import time

import numpy as np
import pytest
import torch

from gomavatar_tpu_torch import trainer as T
from gomavatar_tpu_torch.optim import tree_leaves
from gomavatar_tpu_torch.scene import E2E_TRAIN, gate_model_cfg, gate_scene
from gomavatar_tpu_torch.utils import profiling
from torch_threads import one_torch_thread  # noqa: F401

IMG = (128, 128)
# a static budget of 16 on the 8 x 8 tiles, so that the widened splats pass
# it and the three growths after it within the frame
BUDGET = 16
# each step widens every 25th splat by 5 %: the widest box grows by about
# one tile row or column every other step, as training widens them
WIDEN, EVERY = 1.05, 25
STEPS = 20
DROPS = ("bin_drop_budget", "bin_drop_buffer", "bin_drop_ncmax")


@pytest.mark.parametrize("budget, most, grown", [
    (32, 21, 32), (32, 22, 48), (32, 30, 48), (48, 32, 48), (48, 33, 64), (48, 36, 64), (64, 42, 64),
    (64, 49, 80), (64, 56, 96), (16, 12, 32), (80, 200, 304)])
def test_grown_budget(budget, most, grown):
    """Past 2/3 of the budget, the smallest multiple of 16 at or above 3/2
    of the widest splat; at or under it, the budget."""
    assert T.grown_budget(budget, most) == grown


@pytest.fixture(scope="module")
def scene():
    params, statics, cfg, frame = gate_scene(IMG, device="cpu")
    return params, statics, dataclasses.replace(cfg, max_tiles_per_gaussian=BUDGET), frame


def _trainer(scene):
    params, statics, cfg, _ = scene
    tcfg = {"model": gate_model_cfg(IMG), "train": copy.deepcopy(E2E_TRAIN)}
    tcfg["train"]["log_freq"] = 1
    return T.Trainer(tcfg, lpips_params=None, device="cpu",
                     state=({k: copy.deepcopy(v) for k, v in params.items()}, statics, cfg, 0, 0))


def _batch(frame):
    rng = np.random.default_rng(3)
    H, W = IMG[1], IMG[0]
    b = {k: v.clone() for k, v in frame.items()}
    b["bgcolor"] = torch.zeros(3)
    b["target_rgbs"] = torch.as_tensor(rng.uniform(0, 1, (H, W, 3)).astype(np.float32))
    b["target_masks"] = torch.as_tensor((rng.uniform(0, 1, (H, W)) > 0.5).astype(np.float32))
    return b


def _widening_run(tr, batch, steps, stop_on_drop=False):
    """(budget, widest splat, dropped entries) of each step, every 25th
    splat widened by 5 % after each."""
    faces = torch.arange(0, tr.gom_cfg.num_faces, EVERY)
    out = []
    for _ in range(steps):
        budget = tr.step_cfg.max_tiles_per_gaussian
        _, losses = tr.step(batch)
        out.append((budget, int(losses["bin_most_tiles"]), sum(int(losses[k]) for k in DROPS)))
        if stop_on_drop and out[-1][2]:
            break
        with torch.no_grad():
            tr.params["scale"][faces] *= WIDEN
    return out


def test_budget_grows_before_a_drop(scene, monkeypatch):
    """The widened splats pass the static budget (with growth switched off
    the run drops entries), and the trainer grows it in time: no step drops;
    it grows 16 -> 32 -> 48 -> 64, each time over the same params and
    Adam state (the same tensors, the same values) with a new step
    program, and counts each growth."""
    batch = _batch(scene[3])
    with monkeypatch.context() as m:
        m.setattr(T, "grown_budget", lambda budget, most: budget)
        static = _widening_run(_trainer(scene), batch, STEPS, stop_on_drop=True)
    assert static[-1][2] > 0 and static[-1][1] > BUDGET and {b for b, _, _ in static} == {BUDGET}

    tr = _trainer(scene)
    grows = []
    real = tr._grow

    def grow(budget):
        before = (tr.params, tr.opt_state, [t.clone() for t in tree_leaves(tr.params) + tree_leaves(list(tr.opt_state))],
                  tr._step_fn)
        real(budget)
        assert tr.params is before[0] and tr.opt_state is before[1] and tr._step_fn is not before[3]
        after = tree_leaves(tr.params) + tree_leaves(list(tr.opt_state))
        assert len(after) == len(before[2]) and all(torch.equal(a, b) for a, b in zip(after, before[2]))
        assert tr.step_cfg == dataclasses.replace(tr.gom_cfg, max_tiles_per_gaussian=budget)
        grows.append(budget)

    tr._grow = grow
    t0 = time.perf_counter()
    with profiling.recording():
        run = _widening_run(tr, batch, STEPS)
    recs = profiling.records(t0)
    assert all(d == 0 for _, _, d in run), run
    assert grows == [32, 48, 64], run
    assert max(w for _, w, _ in run) > BUDGET * 2
    assert sum(r.n for r in recs if isinstance(r, profiling.Count) and r.name == "binning.budget_grow") == len(grows)
    # the counted budget is the one in force; the eval's config is left alone
    budgets = [int(r.n) for r in recs if isinstance(r, profiling.Count) and r.name == "binning.budget"]
    assert budgets == [b for b, _, _ in run[1:]] + [tr.step_cfg.max_tiles_per_gaussian]
    assert tr.gom_cfg.max_tiles_per_gaussian == BUDGET


def test_no_growth_is_the_static_budgets_step(scene):
    """On the unwidened scene (the widest splat within 2/3 of its budget)
    the budget never grows, and the params, Adam state and losses are those
    of a trainer that never watches the budget, bit for bit."""
    params, statics, cfg, frame = scene
    cfg = dataclasses.replace(cfg, max_tiles_per_gaussian=64)
    batch = _batch(frame)
    runs = []
    for watch in (True, False):
        tr = _trainer((params, statics, cfg, frame))
        if not watch:
            tr._watch_budget = lambda most: None
        totals = [tr.step(batch)[0].clone() for _ in range(3)]
        runs.append((tr, totals))
    (tr, totals), (ref, ref_totals) = runs
    assert tr.step_cfg is tr.gom_cfg and int(tr._widest_dev) * 3 <= 64 * 2
    assert all(torch.equal(a, b) for a, b in zip(totals, ref_totals))
    for a, b in zip(tree_leaves(tr.params) + tree_leaves(list(tr.opt_state)),
                    tree_leaves(ref.params) + tree_leaves(list(ref.opt_state))):
        assert torch.equal(a, b)
