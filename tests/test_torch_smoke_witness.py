"""chip_smoke.py's checks of 5e (the card's free train trajectory against the
CPU's, with a rounding witness) and 10b's crop (the LPIPS input gradient on
the subject's crop), run here with both devices the CPU: the "card" is then
a second CPU run, which must part from the CPU's by exactly 0, while the
witness (params moved one float32 before every step) and the one-ulp move
of the input must part by more than 0."""

import math

import numpy as np
import pytest
import torch

import chip_smoke as S
from torch_threads import one_torch_thread  # noqa: F401

CPU = ("cpu", "cpu")


@pytest.fixture(scope="module")
def trajectory():
    """3 gate-scene steps subdividing at step 1 (phase 0 one step, phase 1
    one step after the split step), with witnesses moved up and down."""
    return S.phase_trajectory(CPU, steps=3, split=1,
                              witnesses=(("witness", math.inf), ("witness down", -math.inf)))


def test_trajectory_card_parts_by_zero_and_the_witnesses_do_not(trajectory):
    assert [len(v) for v in trajectory["losses"].values()] == [3] * 4
    assert trajectory["losses"]["card"] == trajectory["losses"]["cpu"]
    assert all(np.isfinite(trajectory["losses"]["witness"]))
    assert len(trajectory["phases"]) == 2
    for phase in trajectory["phases"]:
        part = phase["parting"]
        assert part["card"] == 0.0
        assert part["witness"] > 0 and part["witness down"] > 0
        assert all(r in (None, 0.0) for r in phase["per_leaf"]["card"])
        assert any(r for r in phase["per_leaf"]["witness"])
    # the split step has no parting of its own (the phase-1 change starts after it)
    assert trajectory["param_parting_per_step"][1] == {}
    assert trajectory["param_parting_per_step"][0]["card"] == 0.0


def test_nudge_params_moves_every_float_leaf_one_float32():
    from gomavatar_tpu_torch.optim import tree_leaves

    class Holder:
        params = {"a": torch.tensor([1.0, -2.0, 0.0]), "b": [torch.tensor([[3.5]])]}

    h = Holder()
    before = [p.clone() for p in tree_leaves(h.params)]
    S.nudge_params(h, math.inf)
    for x, y in zip(before, tree_leaves(h.params)):
        assert torch.equal(y, torch.nextafter(x, torch.full_like(x, math.inf)))
        assert bool((y > x).all())
    S.nudge_params(h, -math.inf)
    assert all(torch.equal(x, y) for x, y in zip(before, tree_leaves(h.params)))


def _disc(hw, centre, radius):
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    return (((yy - centre[0]) ** 2 + (xx - centre[1]) ** 2) <= radius ** 2).astype(np.float32)


@pytest.mark.parametrize("hw, centre, radius", [((96, 96), (48, 40), 20), ((64, 128), (0, 127), 9),
                                                 ((48, 48), (5, 44), 0)],
                         ids=["inside", "at-a-corner", "one-pixel"])
def test_subject_box_covers_the_mask_in_blocks_of_16_inside_the_frame(hw, centre, radius):
    mask = _disc(hw, centre, radius)
    y0, y1, x0, x1 = S.subject_box(mask)
    assert 0 <= y0 < y1 <= hw[0] and 0 <= x0 < x1 <= hw[1]
    assert all(v % S.CROP_MULTIPLE == 0 for v in (y0, y1, x0, x1))
    ys, xs = np.nonzero(mask)
    assert y0 <= ys.min() and ys.max() < y1 and x0 <= xs.min() and xs.max() < x1
    # padded by CROP_PAD where the frame allows it
    assert y0 <= max(0, ys.min() - S.CROP_PAD) and y1 >= min(hw[0], ys.max() + 1 + S.CROP_PAD)
    assert x0 <= max(0, xs.min() - S.CROP_PAD) and x1 >= min(hw[1], xs.max() + 1 + S.CROP_PAD)


def test_textured_background_has_no_flat_region():
    bg = S.textured_background(64, 96)
    assert bg.shape == (64, 96, 3) and bg.dtype == np.float32
    assert 0.0 < bg.min() and bg.max() < 1.0
    assert np.all(np.diff(bg, axis=0) != 0) and np.all(np.diff(bg, axis=1) != 0)
    assert np.array_equal(bg, S.textured_background(64, 96))


def test_crop_grads_card_parts_by_zero_and_the_ulp_move_does_not():
    from gomavatar_tpu_torch.models.lpips import load_lpips

    hw = (96, 96)
    mask = _disc(hw, (50, 44), 18)
    rng = np.random.default_rng(0)
    subject = rng.uniform(0.2, 0.9, (*hw, 3))
    img = np.clip(subject * mask[..., None] + (1.0 - mask)[..., None] * S.textured_background(*hw), 0.0, 1.0)
    noisy = np.clip(img + rng.normal(0.0, S.CAL_NOISE, img.shape), 0.0, 1.0)
    pred, gt = (np.asarray(2.0 * x - 1.0, np.float32) for x in (img, noisy))
    out = S.crop_grads({"cpu": load_lpips(device="cpu", quiet=True)[0]}, pred, gt, mask, CPU)
    y0, y1, x0, x1 = out["box"]
    assert (y1 - y0) % 16 == 0 and (x1 - x0) % 16 == 0 and (y1 - y0, x1 - x0) != hw
    for name in ("f32", "bf16"):
        r = out[name]
        assert r["card_cpu"] == 0.0 and r["card_exact"] == r["cpu_exact"]
    # a one-ulp move of the input moves the float32 gradient (bfloat16 may
    # round it away), and float32 lies close to the float64 gradient
    assert out["f32"]["card_nudged"] > 0 and out["bf16"]["card_nudged"] >= 0
    assert out["f32"]["cpu_exact"] < 0.05
