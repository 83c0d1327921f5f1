"""Frames whose sides are not multiples of 16 on the port's normal path, on
the CPU (the plain kernel versions).

* At 40 x 40 and 36 x 52 (W x H, non-square to catch a swapped W and H),
  on the ``snapshot_m3c`` configuration over the benchmark's tiny avatar
  with seeded weights, the body running past the frame's right and bottom
  edges: the train frame (image, alpha, soft silhouette), the eval render,
  one train step's loss and gradients, and three pose steps against
  ``portbench/reference/frame_any.py`` and its pose and step wrappers (the
  JAX package's binning takes whole tiles only).  Each comparison fails
  for the reference with its model rounded to bfloat16, and for the
  program with a planted fault: the frame's last column and row taken from
  the canvas's lanes past the frame.
* At 32^2 and 48^2 the program's outputs are the bits it gave before
  frames could end mid-tile (``whole_tile_bits.json``).
* At the recipe's 540^2: the tile grid, the budget and the binning of a
  box past the frame; the train data at 540^2 over 540^2 PNGs, through the
  card's store-and-composite path and the host path, bit for bit a plain
  composite with no resample (``cv2.resize`` to a frame's own size copies
  it); and the drivers at 36 x 52 end to end.
"""

import contextlib
import json
import os

import numpy as np
import pytest
import torch

import torch_any_size_scene as A
import torch_snapshot_scene as S
from gomavatar_tpu_torch.cli.train_pose import make_pose_optimizer, refine_frame
from gomavatar_tpu_torch.models.gom import GoMConfig, eval_program, gom_forward
from gomavatar_tpu_torch.ops import frame_render as FR
from gomavatar_tpu_torch.ops import mesh_raster as MR
from gomavatar_tpu_torch.ops.splat import binning as B
from gomavatar_tpu_torch.trainer import loss_and_grads
from portbench.lib import harness as H
from portbench.reference import frame_any as FA
from portbench.reference import model as RM
from portbench.reference import pose_any as PA
from portbench.reference import step_any as SA
from portbench.reference.step import leaves, rebuild
from torch_threads import one_torch_thread  # noqa: F401

SIZES = [(40, 40), (36, 52)]
ITERATION = A.ITERATION
# The program's plain path against the reference, read at both sizes: the
# frame 0 exactly, the eval render within 7.7e-6, the train step's loss
# within 6.9e-8 (relative) and its worst moving leaf's gradient within
# 1.2e-7 (harness.leaf_gap), the pose steps' losses within 2.5e-7 and each
# leaf's change within 2.3e-7.  The bfloat16 reference reads 1.4e-2,
# 1.8e-2, 6.5e-3, 9.0e-2, 5.0e-3 (losses) at the least; the planted fault
# 0.58, 0.66, 0.70, 0.31, 2.8.
FRAME_ABS = 1e-5
IMAGE_ABS = 1e-4
LOSS_RTOL = 1e-4
GRAD_GAP = 1e-4
CHANGE_GAP = 1e-4


def _bf16(tree):
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_bf16(v) for v in tree]
    return tree.to(torch.bfloat16).to(torch.float32)


@contextlib.contextmanager
def edge_lanes_reach_the_frame():
    """A planted fault: every crop of the canvas takes its last (past the
    frame) column and row in place of the frame's last ones."""
    def crop(x, img_size):
        W, H_ = img_size
        if x.shape[0] == H_ and x.shape[1] == W:
            return x
        rows = list(range(H_ - 1)) + [x.shape[0] - 1]
        cols = list(range(W - 1)) + [x.shape[1] - 1]
        return x[rows][:, cols]

    saved = B.crop_frame, FR.crop_frame, MR.crop_frame
    B.crop_frame = FR.crop_frame = MR.crop_frame = crop
    try:
        yield
    finally:
        B.crop_frame, FR.crop_frame, MR.crop_frame = saved


@pytest.fixture(scope="module", params=SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def scene(request, tmp_path_factory):
    a = A.AnyCell(tmp_path_factory.mktemp("any_size"), request.param)
    frames = a.frames(2)
    return {"a": a, "frames": frames, "program": a.program(), "reference": a.reference(), "trunk": S.trunk(),
            "batch": A.train_batch(frames[0])}


def _program_frame(sc):
    _, params, statics, gom_cfg = sc["program"]
    b = sc["batch"]
    with torch.no_grad():
        rgb, mask, aux = gom_forward(params, statics, gom_cfg, b["K"], b["E"], b["cnl_gtfms"], b["dst_Rs"],
                                     b["dst_Ts"], dst_posevec=b["dst_posevec"], i_iter=ITERATION, train=True,
                                     device="cpu")
    return rgb, mask, aux["normal_mask"]


def _reference_frame(sc, bf16=False):
    rcfg, mesh, rparams, _, _ = sc["reference"]
    with torch.no_grad():
        return FA.frame(_bf16(rparams) if bf16 else rparams, rcfg["model"], mesh, sc["batch"], sc["a"].size,
                        ITERATION)[:3]


def _frame_gap(got, want):
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def test_train_frame_follows_the_reference(scene):
    """Image, alpha and soft silhouette, each (H, W) exactly."""
    W, H_ = scene["a"].size
    got, want = _program_frame(scene), _reference_frame(scene)
    assert [tuple(x.shape) for x in got] == [(H_, W, 3), (H_, W), (H_, W)]
    assert _frame_gap(got, want) <= FRAME_ABS
    assert _frame_gap(_reference_frame(scene, bf16=True), want) > FRAME_ABS
    with edge_lanes_reach_the_frame():
        assert _frame_gap(_program_frame(scene), want) > FRAME_ABS


def _program_image(sc):
    _, params, statics, gom_cfg = sc["program"]
    b = sc["batch"]
    rgb, mask, aux = eval_program()(params, statics, gom_cfg, b["K"], b["E"], b["cnl_gtfms"], b["dst_Rs"],
                                    b["dst_Ts"], b["dst_posevec"], ITERATION)
    assert int(aux["binning"].total_dropped()) == 0
    return RM.over(rgb, mask, b["bgcolor"])


def test_eval_render_follows_the_reference(scene):
    W, H_ = scene["a"].size
    rgb, alpha, _ = _reference_frame(scene)
    want = RM.over(rgb, alpha, scene["batch"]["bgcolor"])
    got = _program_image(scene)
    assert got.shape == (H_, W, 3) and float((got - want).abs().max()) <= IMAGE_ABS
    rgb, alpha, _ = _reference_frame(scene, bf16=True)
    assert float((RM.over(rgb, alpha, scene["batch"]["bgcolor"]) - want).abs().max()) > IMAGE_ABS
    with edge_lanes_reach_the_frame():
        assert float((_program_image(scene) - want).abs().max()) > IMAGE_ABS


def _program_train(sc):
    cfg, params, statics, gom_cfg = sc["program"]
    grads, total, _ = loss_and_grads(params, statics, gom_cfg, cfg["train"]["losses"], sc["trunk"], sc["batch"],
                                     ITERATION)
    return float(total), grads


def _reference_train(sc, bf16=False):
    cfg = sc["program"][0]
    rcfg, mesh, rparams, _, _ = sc["reference"]
    p = _bf16(rparams) if bf16 else rparams
    ls = [x.detach().requires_grad_(True) for x in leaves(p)]
    total, _, _ = SA.train_loss(rebuild(p, ls), rcfg["model"], cfg["train"]["losses"], mesh, sc["trunk"],
                                sc["batch"], sc["a"].size, ITERATION)
    grads = torch.autograd.grad(total, ls, allow_unused=True)
    return float(total.detach()), [torch.zeros_like(x) if g is None else g for x, g in zip(ls, grads)]


def test_train_step_follows_the_reference(scene):
    """The loss and each moving leaf's gradient (the program's leaves in the
    reference's order: both sort the state's keys)."""
    want, want_g = _reference_train(scene)
    keep = H.moving(want_g)

    def gaps(total, grads):
        return abs(total - want) / abs(want), H.leaf_gap(grads, want_g, keep)

    loss, grad = gaps(*_program_train(scene))
    assert loss <= LOSS_RTOL and grad <= GRAD_GAP, (loss, grad)
    loss, grad = gaps(*_reference_train(scene, bf16=True))
    assert loss > LOSS_RTOL or grad > GRAD_GAP, (loss, grad)
    with edge_lanes_reach_the_frame():
        loss, grad = gaps(*_program_train(scene))
    assert loss > LOSS_RTOL or grad > GRAD_GAP, (loss, grad)


POSE_CFG = {"lr": 1e-3, "decay": 2, "iters": 3}
POSE_KEYS = ("K", "E", "cnl_gtfms", "dst_tpose_joints", "bgcolor", "target_rgbs", "target_masks")


def test_pose_steps_follow_the_reference(scene):
    """Three steps of the pose program through refine_frame (lr halving
    after 2) against pose_any.refine: each loss and each leaf's change."""
    cfg, params, statics, gom_cfg = scene["program"]
    rcfg, mesh, rparams, _, _ = scene["reference"]
    losses_cfg = cfg["train"]["losses"]
    frame = scene["frames"][0]
    batch = {k: torch.as_tensor(frame[k]) for k in POSE_KEYS}
    start = A.pose_start(scene["frames"])
    init = [np.zeros(3, np.float32), np.zeros(3, np.float32), start]

    def program():
        optimize = make_pose_optimizer(gom_cfg, losses_cfg, POSE_CFG, 3)
        r = refine_frame(optimize, params, statics, scene["trunk"], batch, start)
        assert r.dropped == 0 and r.finite
        return list(r.losses), [optimize.last[k].numpy() for k in ("Rh", "Th", "poses")]

    def reference(p):
        r = PA.refine(p, rcfg["model"], losses_cfg, POSE_CFG, mesh, scene["trunk"], batch, scene["a"].size,
                      torch.as_tensor(start), 3)
        return r["losses"], [v.numpy() for v in r["last"]]

    want, want_last = reference(rparams)

    def gaps(losses, last):
        loss = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        change = H.leaf_gap([torch.as_tensor(b - a) for a, b in zip(init, last)],
                            [torch.as_tensor(b - a) for a, b in zip(init, want_last)], [True] * 3)
        return loss, change

    loss, change = gaps(*program())
    assert loss <= LOSS_RTOL and change <= CHANGE_GAP, (loss, change)
    loss, change = gaps(*reference(_bf16(rparams)))
    assert loss > LOSS_RTOL or change > CHANGE_GAP, (loss, change)
    with edge_lanes_reach_the_frame():
        loss, change = gaps(*program())
    assert loss > LOSS_RTOL or change > CHANGE_GAP, (loss, change)


# -- whole tiles: the parent's bits ------------------------------------------------------

@pytest.mark.parametrize("size", A.WHOLE_TILE_SIZES)
def test_whole_tile_outputs_are_the_bits_they_were(size, tmp_path):
    """The eval render, the train frame, one train step's loss terms and
    gradients and three pose steps at 32^2 and 48^2, digest for digest what
    the program gave before frames could end mid-tile."""
    want = json.loads(A.BITS.read_text())[str(size)]
    got = A.whole_tile_digests(tmp_path, size)
    assert sorted(got) == sorted(want)
    assert [k for k in want if got[k] != want[k]] == []


# -- the recipe's 540^2 ---------------------------------------------------------------------

def test_540_tiles_budget_and_a_box_past_the_frame():
    """34 x 34 tiles (1,156: the 11-bit tile id holds), the per-splat budget
    63 (544^2 gives 64, 512^2 and below the tuned 32), and a box that runs
    past the frame binned into the last, partial tile."""
    model = S.config(540)["model"]
    assert B.tile_grid((540, 540)) == (34, 34) and 34 * 34 < 2048
    budgets = {s: GoMConfig.from_model_cfg(dict(model, img_size=[s, s]), 1000, 57600).max_tiles_per_gaussian
               for s in (512, 540, 544)}
    assert budgets == {512: 32, 540: 63, 544: 64}
    box = torch.tensor([[530.0, 600.0, 10.0, 12.0], [100.0, 110.0, 535.0, 539.5], [0.0, 5.0, 0.0, 5.0]])
    bins = B.bin_bboxes(box[:, 0], box[:, 1], box[:, 2], box[:, 3], torch.tensor([1.0, 2.0, 3.0]),
                        torch.ones(3, dtype=torch.bool), (540, 540), max_tiles_per_primitive=8)
    assert (bins.num_tiles_x, bins.num_tiles_y) == (34, 34)
    owned = {t: set(bins.entry_gauss[int(s):int(s) + int(c)][bins.entry_valid[int(s):int(s) + int(c)] > 0].tolist())
             for t, (s, c) in enumerate(zip(bins.tile_start, bins.tile_count)) if int(c) > 0}
    assert owned == {33: {0}, 33 * 34 + 6: {1}, 0: {2}}


def _write_540_capture(root: str, n: int = 2) -> str:
    """``n`` frames of a 540^2 capture in prepare_snapshot.py's layout, with
    soft mask edges and the configuration's distortion terms."""
    import pickle

    from PIL import Image

    from gomavatar_tpu_torch.data import synthetic as TS

    out = TS.write_synthetic_dataset(root, n_frames=n, img_hw=(270, 270))  # its PNGs at twice that
    path = os.path.join(out, "cameras.pkl")
    with open(path, "rb") as f:
        cams = pickle.load(f)
    for cam in cams.values():
        cam["distortions"] = np.array(S.config(540)["train_frames"]["distortions"])
    with open(path, "wb") as f:
        pickle.dump(cams, f)
    for name in os.listdir(os.path.join(out, "masks")):
        p = os.path.join(out, "masks", name)
        m = np.array(Image.open(p))
        m = (m if m.ndim == 2 else m[..., 0]).astype(np.float64)
        Image.fromarray(np.clip(m * 0.6 + 40 * (np.indices(m.shape).sum(0) % 3), 0, 255).astype(np.uint8)).save(p)
    return out


@pytest.mark.parametrize("bgcolor", [None, (255.0, 255.0, 255.0)], ids=["random_bg", "white_bg"])
def test_train_data_at_540_is_the_composite_with_no_resample(tmp_path, monkeypatch, bgcolor):
    """``TrainDataset`` at ``img_size`` 540 over 540^2 PNGs: every item of
    the card's store-and-composite path (the CPU as the card type, its
    plain version in the kernel's place) bit for bit the host path's, and
    both the plain composite over the undistorted frame, / 255, with no
    resample; the camera unscaled."""
    from gomavatar_tpu_torch.data import dataset as TD

    root = _write_540_capture(str(tmp_path / "capture"))
    monkeypatch.setattr(TD.TrainDataset, "CARD_TYPES", ("cuda", "cpu"))
    kw = dict(bgcolor=bgcolor, target_size=(540, 540), retain=True)
    card = TD.TrainDataset(root, device="cpu", **kw)
    host = TD.TrainDataset(root, **kw)
    assert card._card_dev == torch.device("cpu") and host._card_dev is None
    for i in range(len(card)):
        got = card.item(i, np.random.default_rng(i))
        want = host.item(i, np.random.default_rng(i))
        assert isinstance(got["target_rgbs"], TD.CardArray)
        for k, v in want.items():
            if k != "frame_name":
                assert np.array_equal(np.asarray(got[k]), v), (i, k)
        img, mask = host._load_raw(host.framelist[i])
        assert img.shape == (540, 540, 3)
        a = (mask if mask.ndim == 2 else mask[..., 0]) / 255.0
        bg = (np.random.default_rng(i).random(3) * 255.0).astype(np.float32) if bgcolor is None else \
            np.asarray(bgcolor, np.float32)
        plain = (a[..., None] * img.astype(np.float32) + (1.0 - a[..., None]) * bg) / 255.0
        assert np.array_equal(want["target_rgbs"], plain.astype(np.float32))
        assert np.array_equal(want["target_masks"], a.astype(np.float32))
        assert np.array_equal(want["K"], host.cameras[host.framelist[i]]["intrinsics"][:3, :3].astype(np.float32))


def test_drivers_run_at_a_partial_tile_frame(tmp_path):
    """cli.train (3 steps), cli.train_pose (3 frames x 2 steps),
    cli.evaluate (--type view, with the refined poses) and cli.animate at
    36 x 52 on the CPU: every image W x H, nothing dropped."""
    import yaml
    from PIL import Image

    from gomavatar_tpu_torch.cli import animate as animate_cli
    from gomavatar_tpu_torch.cli import evaluate as eval_cli
    from gomavatar_tpu_torch.cli import train as train_cli
    from gomavatar_tpu_torch.cli import train_pose as pose_cli
    from gomavatar_tpu_torch.data.synthetic import write_synthetic_dataset

    W, H_ = 36, 52
    data = write_synthetic_dataset(str(tmp_path / "data"), n_frames=3, img_hw=(H_, W))
    cfg = {
        "exp_name": "any_size", "log_dir": str(tmp_path / "log"), "random_bgcolor": False,
        "bgcolor": [0.0, 0.0, 0.0], "img_size": [W, H_],
        "dataset": {"train": {"dataset_path": data},
                    "test_view": {"dataset_path": data, "name": "snapshot", "skip": 1}},
        "model": {"img_size": [W, H_], "subdivide_iters": [100], "normal_renderer": {"name": "mesh"},
                  "shadow_module": {"name": "basic"}},
        "train": {"total_iters": 3, "save_freq": 3, "eval_freq": 100, "log_freq": 1, "tb_freq": 100,
                  "losses": {"lpips": {"coeff": 0.0}, "normal": {"coeff_mask": 1.0, "mask_dilate": True}}},
        "pose": {"iters": 2},
    }
    path = str(tmp_path / "exp.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    tr = train_cli.main(["--cfg", path, "--device", "cpu"])
    assert tr.i_iter == 3 and tr.gom_cfg.img_size == (W, H_)
    save_dir = tmp_path / "log" / "any_size"
    assert "training done at iter 3" in (save_dir / "log.txt").read_text()
    pose = pose_cli.main(["--cfg", path, "--device", "cpu"])
    assert pose["frames"] == 3 and pose["dropped"] == [0, 0, 0]
    res = eval_cli.main(["--cfg", path, "--type", "view", "--device", "cpu", "--pose_path", pose["pose_path"]])
    assert res["dropped"] == 0 and all(np.isfinite(v) for v in res["metrics"].values())
    for d in (save_dir / "eval" / "view", save_dir / "eval" / "test_refine"):
        pngs = sorted(os.listdir(d))
        assert pngs and all(np.asarray(Image.open(d / p)).shape == (H_, W, 3) for p in pngs)
    anim = tmp_path / "anim"
    animate_cli.main(["--synthetic", "2", "--type", "mdm", "--n_frames", "2", "--img", str(W), str(H_),
                      "--out", str(anim), "--device", "cpu"])
    strips = sorted(p for p in os.listdir(anim) if p.endswith(".png"))
    assert strips and all(np.asarray(Image.open(anim / p)).shape[:2] == (H_, 2 * W) for p in strips)
