"""PeopleSnapshot's ``snapshot_m3c`` on the port, on the CPU.

* The tile budgets (``models/gom.py``): at 512^2 and below every field of
  ``GoMConfig`` is what it was and what the JAX package's is, for both
  phases' face counts; above, the per-splat budget grows with the frame.
* ROADMAP C11 pinned: at 544^2, on the trained avatar (the benchmark's
  frozen state) at its packed pose seen from a turn of the camera, JAX's
  train binning at its budget of 32 and the port's at 32 give the same
  bins and drop the same 8 entries; the port's grown budget drops none.
* The pose step against the plain reference (portbench/reference/pose.py)
  and the recipe's train step (no pose-refinement MLP) against
  portbench/reference/step.py, both at 32^2 on seeded random weights.  A
  reference with its model rounded to bfloat16 fails the same checks.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gomavatar_tpu.models.gom import GoMConfig as JaxGoMConfig
from gomavatar_tpu.ops import fused_render as JF
from gomavatar_tpu_torch.cli.train_pose import make_pose_optimizer, refine_frame
from gomavatar_tpu_torch.config import make_cfg
from gomavatar_tpu_torch.convert import TRAINED, load_trained
from gomavatar_tpu_torch.models import gom as TG
from gomavatar_tpu_torch.ops import fused_render as TF
from gomavatar_tpu_torch.trainer import Trainer
from portbench.lib import harness as H
from portbench.lib import scene
from portbench.reference import data as RD
from portbench.reference import pose as RP
from portbench.reference.step import TrainStep, leaves
import torch_snapshot_scene as S
from torch_threads import one_torch_thread  # noqa: F401

BUDGET_FIELDS = ("max_tiles_per_gaussian", "max_tiles_per_face", "buffer_factor", "active_tile_cap",
                 "binning_band0", "binning_band0_train", "train_active_tile_cap")
# phase 0 and phase 1 of the benchmark's avatar (synthetic_body(144, 48)) and of SMPL
FACES = (14400, 57600, 13776, 55104)
SIZES = ((32, 32), (48, 48), (64, 48), (128, 128), (512, 256), (512, 512))
MODEL = make_cfg(str(S.ROOT / "configs" / "exps" / "snapshot_m3c.yaml"))["model"]


def _cfgs(size, faces):
    m = dict(MODEL, img_size=list(size))
    return TG.GoMConfig.from_model_cfg(m, 1000, faces), JaxGoMConfig.from_model_cfg(m, 1000, faces)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("faces", FACES)
def test_budgets_up_to_512_are_the_parents_and_jax(size, faces):
    """Every field equal to JAX's, and the budgets equal to the parent's
    formula (tile_budget_factor bf: max(32, 16 bf), 8 bf, 4 bf, cap 512)."""
    t, j = _cfgs(size, faces)
    assert dataclasses.asdict(t) == {f.name: getattr(j, f.name) for f in dataclasses.fields(t)}
    bf = TG.tile_budget_factor(faces)
    parent = {"max_tiles_per_gaussian": max(32, 16 * bf), "max_tiles_per_face": 8 * bf, "buffer_factor": 4 * bf,
              "active_tile_cap": 512, "binning_band0": 4 * bf, "binning_band0_train": 4 * bf,
              "train_active_tile_cap": None}
    assert {k: getattr(t, k) for k in BUDGET_FIELDS} == parent


@pytest.mark.parametrize("size,phase0,phase1", [((512, 512), 64, 32), ((528, 528), 120, 60), ((544, 544), 127, 64)])
def test_budget_grows_with_the_frame_above_512(size, phase0, phase1):
    """Above 512^2 the per-splat budget is 7/4 of the area ratio times the
    512^2 one, ceil'd (the rest as JAX's), and the split of a phase-0
    config lands on the phase-1 one."""
    c0, j0 = _cfgs(size, 14400)
    c1, j1 = _cfgs(size, 57600)
    assert (c0.max_tiles_per_gaussian, c1.max_tiles_per_gaussian) == (phase0, phase1)
    for t, j in ((c0, j0), (c1, j1)):
        assert {f: getattr(t, f) for f in BUDGET_FIELDS[1:]} == {f: getattr(j, f) for f in BUDGET_FIELDS[1:]}
    model = dict(MODEL, img_size=list(size))
    params, statics, cfg = TG.init_gom(model, _body(), device="cpu")
    _, _, split = TG.subdivide_gom(params, statics, cfg)
    want = TG.GoMConfig.from_model_cfg(model, split.num_vertices, split.num_faces)
    assert {k: getattr(split, k) for k in BUDGET_FIELDS} == {k: getattr(want, k) for k in BUDGET_FIELDS}


def _body():
    from gomavatar_tpu_torch.models.smpl import synthetic_body

    return synthetic_body(n_rings=144, n_seg=48)  # the benchmark avatar's phase 0: 14,400 faces


# -- C11: the trained avatar at 544^2 -----------------------------------------------------

SIZE = 544
YAW = 2.0 * np.pi * 21 / 24  # a view at which a splat's union box spans 6 x 6 tiles


@pytest.fixture(scope="module")
def frame544():
    """The train frame's inputs of frame_union_bins at 544^2 (numpy) and the
    config: the recipe's model at the state's iteration 150,000."""
    params, statics, _, f = load_trained(TRAINED, "cpu")
    params = scene.model_params(params, MODEL)
    cfg = TG.GoMConfig.from_model_cfg(dict(MODEL, img_size=[SIZE, SIZE]), statics.lbs_weights.shape[0],
                                      statics.faces.shape[0])
    K = f["K"].clone()
    K[:2] *= SIZE / 512
    E = torch.as_tensor(scene.yaw(f["E"].numpy(), YAW), dtype=torch.float32)
    with torch.no_grad():
        verts = TG.posed_vertices(params, statics, cfg, f["cnl_gtfms"], f["dst_Rs"], f["dst_Ts"], f["dst_posevec"],
                                  150000.0)
        g = TG.train_geometry(params, statics, cfg, verts, K, E)
    inp = dict(centroids=g["centroids"], cov3d=g["cov"], verts=verts, faces=statics.faces, K=K, E=E)
    return {k: v.numpy() for k, v in inp.items()}, cfg, g["bins"]


def _union(inp, cfg, budget, jax=False):
    W, H = cfg.img_size
    margin = (TG.np_log_blur(cfg.normal_renderer_sigma) ** 0.5) / (2.0 / min(W, H)) + 1.0
    kw = dict(blur_margin_px=margin, max_tiles_per_primitive=budget, buffer_factor=cfg.buffer_factor,
              band0=cfg.binning_band0_train, overflow_cap=max(cfg.num_faces // 8, 2048))
    order = ("centroids", "cov3d", "verts", "faces", "K", "E")
    if jax:
        return JF.frame_union_bins(*(jnp.asarray(inp[k]) for k in order), cfg.img_size, **kw)[4]
    with torch.no_grad():
        return TF.frame_union_bins(*(torch.as_tensor(inp[k]) for k in order), cfg.img_size, **kw)[4]


def test_c11_jax_and_the_port_drop_the_same_entries_at_the_old_budget(frame544):
    inp, cfg, _ = frame544
    j, t = _union(inp, cfg, 32, jax=True), _union(inp, cfg, 32)
    for f in ("entry_gauss", "entry_valid", "entry_splat", "entry_mesh", "tile_start", "tile_count"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)
    for f in j.telemetry._fields:
        assert int(getattr(t.telemetry, f)) == int(getattr(j.telemetry, f)), f
    assert int(j.telemetry.dropped_budget) == 8 and int(j.telemetry.truncated_prims) == 2
    assert int(t.telemetry.dropped_buffer) == 0 and int(t.telemetry.most_tiles) == 36


def test_c11_the_grown_budget_drops_nothing_at_544(frame544):
    """The train path's own binning at the configuration's budget (64):
    nothing dropped, and the entries of 32's binning all kept."""
    inp, cfg, bins = frame544
    assert cfg.max_tiles_per_gaussian == 64 and (SIZE // 16) ** 2 < 2048  # the sort key's 11-bit tile id
    tel = bins.telemetry
    assert int(tel.total_dropped()) == 0 and int(tel.truncated_prims) == 0 and int(tel.most_tiles) == 36
    old = _union(inp, cfg, 32)
    assert int(bins.entry_valid.sum()) == int(old.entry_valid.sum()) + int(old.telemetry.dropped_budget)


# -- the pose step and the train step against the plain reference, 32^2 ---------------------

# float32 through the same equations in another order (the program's plain
# kernel versions, the reference's sweeps), read on four starts of the pose
# step: each loss within 1.9e-5 of the reference's (1e-7 on three of the
# four), each leaf's change (a gap of norms, harness.leaf_gap) within 4e-8;
# the reference with its model rounded to bfloat16 reads 1.7e-3 to 8.1e-3
# and 1.3e-3 to 8.7e-3.  The train step's three steps: 0 and 3.7e-7, the
# bfloat16 reference 2.3e-3 and 3.1e-2.  Both limits 1e-4, between the two.
LOSS_RTOL = 1e-4
CHANGE_GAP = 1e-4


def _bf16(tree):
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_bf16(v) for v in tree]
    return tree.to(torch.bfloat16).to(torch.float32)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    c = S.cell(tmp_path_factory.mktemp("snapshot_tiny"))
    return c, S.pose_frames(c), S.trunk()


def _pose_ref(c, frame, trunk, start, steps, pose_cfg, bf16=False):
    cfg, mesh, params, _, _ = c.reference_state()
    return RP.refine(_bf16(params) if bf16 else params, cfg["model"], cfg["train"]["losses"], pose_cfg, mesh, trunk,
                     S.batch(frame), (c.config["frame_size"],) * 2, torch.as_tensor(start), steps)


def _pose_gaps(losses, last, ref, start):
    loss = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    init = [np.zeros(3, np.float32), np.zeros(3, np.float32), start]
    change = H.leaf_gap([torch.as_tensor(b - a) for a, b in zip(init, last)],
                        [torch.as_tensor(b.numpy() - a) for a, b in zip(init, ref["last"])], [True] * 3)
    return loss, change


def test_pose_step_follows_the_reference(tiny):
    """Three steps of make_pose_optimizer's program through refine_frame
    from truth + noise, lr 1e-3 halving after 2 (so the schedule takes
    part), against reference/pose.py: each loss and each leaf's change."""
    c, frames, trunk = tiny
    pose_cfg = {"lr": 1e-3, "decay": 2, "iters": 3}
    start = (frames[0]["poses"] + scene.rng(7).normal(0.0, 0.03, 72)).astype(np.float32)
    cfg = c.program_cfg()
    params, statics, gom_cfg = c.program_state(cfg)
    assert "pose_refinement" not in params and gom_cfg.pose_refinement is None
    optimize = make_pose_optimizer(gom_cfg, cfg["train"]["losses"], pose_cfg, 3)
    r = refine_frame(optimize, params, statics, trunk, S.batch(frames[0]), start)
    assert r.dropped == 0 and r.finite and r.losses[-1] < r.losses[0]
    ref = _pose_ref(c, frames[0], trunk, start, 3, pose_cfg)
    last = [optimize.last[k].numpy() for k in ("Rh", "Th", "poses")]
    loss, change = _pose_gaps(list(r.losses), last, ref, start)
    assert loss <= LOSS_RTOL and change <= CHANGE_GAP, (loss, change)
    # the best kept: the reference's too (the losses fall, so the last step's)
    np.testing.assert_allclose(r.poses, ref["best"][2].numpy(), rtol=0, atol=1e-6)
    ctl = _pose_ref(c, frames[0], trunk, start, 3, pose_cfg, bf16=True)
    loss, change = _pose_gaps(ctl["losses"], [v.numpy() for v in ctl["last"]], ref, start)
    assert loss > LOSS_RTOL or change > CHANGE_GAP, (loss, change)


def test_recipe_train_step_follows_the_reference(tiny):
    """Trainer.step on the recipe's model (no pose-refinement MLP; the
    reference's posing skips the module it lacks) over a white background,
    three steps from the state at 150,000, against reference/step.py's
    TrainStep: each loss and each leaf's change."""
    c, frames, trunk = tiny
    cfg = c.program_cfg()
    params, statics, gom_cfg = c.program_state(cfg)
    meta = scene.load_state(c.config["state"], "cpu")[0]
    size = (c.config["frame_size"],) * 2
    tr = Trainer(cfg, lpips_params=trunk, device="cpu",
                 state=(params, statics, gom_cfg, int(c.config["iteration"]), int(meta["phase"])))
    init = [p.detach().clone() for p in leaves(tr.params)]
    rcfg, mesh, rparams, _, _ = c.reference_state()
    assert "pose_refinement" not in rparams
    batches = []
    for f in frames + frames[:1]:
        cj = f["dst_tpose_joints"]
        b = {k: torch.as_tensor(f[k]) for k in ("K", "E", "bgcolor")}
        b.update({k: torch.as_tensor(v) for k, v in RD.pose_inputs(f["poses"] * 0.5, cj.copy(), cj).items()})
        b["target_rgbs"], b["target_masks"] = torch.as_tensor(f["target_rgbs"]), torch.as_tensor(f["target_masks"])
        batches.append(b)
    assert all(float(b["bgcolor"].min()) == 1.0 for b in batches)  # white

    def follow(p0):
        step, p, out = TrainStep(rcfg, p0, int(c.config["iteration"])), p0, []
        for b in batches:
            p, total, *_ = step(p, mesh, trunk, b, size)
            out.append(float(total))
        return out, [a - b for a, b in zip(leaves(p), leaves(p0))]

    prog = [float(tr.step(b)[0]) for b in batches]
    change = [a - b for a, b in zip(leaves(tr.params), init)]
    ref, ref_change = follow(rparams)
    keep = [True] * len(change)
    assert max(abs(a - b) / abs(b) for a, b in zip(prog, ref)) <= LOSS_RTOL, (prog, ref)
    assert H.leaf_gap(change, ref_change, keep) <= CHANGE_GAP
    ctl, ctl_change = follow(_bf16(rparams))
    assert (max(abs(a - b) / abs(b) for a, b in zip(ctl, ref)) > LOSS_RTOL
            or H.leaf_gap(ctl_change, ref_change, keep) > CHANGE_GAP)


def test_reference_decode_takes_the_white_background(tmp_path):
    """The reference's decode of a train frame and the program's
    TrainDataset item over white (random_bgcolor off): the same arrays, the
    pixels far from the subject white."""
    from gomavatar_tpu_torch.data.dataset import TrainDataset

    c = S.cell(tmp_path, size=32)
    meta, _, frame0 = scene.load_state(c.config["state"], "cpu")

    def render(E, pose_inputs):
        rgb = torch.full((32, 32, 3), 0.25)
        alpha = torch.zeros((32, 32))
        alpha[8:24, 10:22] = 1.0
        return rgb, alpha

    cams, infos, cj = scene.write_train_frames(str(tmp_path / "frames"), S.SEED, 2, 64, meta, frame0,
                                               c.config["train_frames"]["distortions"], "cpu", render)
    white = np.asarray(c.config["bgcolor"], np.float32)
    ds = TrainDataset(str(tmp_path / "frames"), bgcolor=list(white), target_size=[32, 32])
    for i, name in enumerate(sorted(cams)):
        ref = RD.decode(str(tmp_path / "frames"), name, cams[name], infos[name], cj, (32, 32), white)
        item = ds[i]
        for k in ("bgcolor", "target_rgbs", "target_masks", "K", "E"):
            np.testing.assert_array_equal(np.asarray(item[k]), ref[k], err_msg=k)
        # far from the subject (rows and columns 0-3), the image is the background
        np.testing.assert_allclose(ref["target_rgbs"][:4, :4], 1.0, rtol=0, atol=1e-6)
        assert (ref["target_masks"][:4, :4] == 0).all()
