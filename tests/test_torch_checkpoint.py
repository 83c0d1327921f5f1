"""Checkpoints of gomavatar_tpu_torch on the CPU: a trainer saved in phase 0
and past a subdivision milestone in phase 1, resumed and loaded for eval
into fresh trainers built from the phase-0 mesh, which replay the stored
number of subdivisions first; the restored params, Adam state, iteration
and phase equal the saved ones, and a template of the wrong phase raises."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gomavatar_tpu_torch import checkpoint as ckpt
from gomavatar_tpu_torch.config import default_cfg
from gomavatar_tpu_torch.models.smpl import synthetic_body, synthetic_camera
from gomavatar_tpu_torch.ops.skeleton import body_pose_to_body_RTs, get_canonical_global_tfms
from gomavatar_tpu_torch.optim import tree_leaves
from gomavatar_tpu_torch.trainer import Trainer
from torch_threads import one_torch_thread  # noqa: F401

IMG = (32, 32)
MILESTONE = 2


def _cfg():
    cfg = default_cfg()
    cfg["img_size"] = list(IMG)
    m = cfg["model"]
    m["img_size"] = list(IMG)
    m["subdivide_iters"] = [MILESTONE]
    m["canonical_geometry"]["deform_so3"] = True
    m["canonical_geometry"]["deform_scale"] = True
    m["shadow_module"]["name"] = "basic"
    m["normal_renderer"]["name"] = "mesh"
    m["pose_refinement"]["name"] = "basic"
    m["non_rigid"]["name"] = "basic"
    t = cfg["train"]
    t["lr_decay_steps"] = 4
    t["losses"]["lpips"]["coeff"] = 0.0
    t["losses"]["normal"]["coeff_mask"] = 1.0
    t["losses"]["laplacian"]["coeff_observation"] = 10.0
    return cfg


@pytest.fixture(scope="module")
def info():
    return synthetic_body(n_rings=6, n_seg=6)


@pytest.fixture(scope="module")
def batch(info):
    K, E = synthetic_camera(IMG, distance=3.0, focal=30.0)
    joints = torch.as_tensor(info["canonical_joints"])
    Rs, Ts = body_pose_to_body_RTs(torch.zeros(72), joints)
    target = torch.zeros((IMG[1], IMG[0], 3))
    target[8:24, 12:20] = torch.tensor([0.8, 0.2, 0.2])
    mask = torch.zeros(IMG[::-1])
    mask[8:24, 12:20] = 1.0
    return {"K": torch.as_tensor(K), "E": torch.as_tensor(E), "cnl_gtfms": get_canonical_global_tfms(joints),
            "dst_Rs": Rs, "dst_Ts": Ts, "dst_posevec": torch.full((69,), 1e-2), "bgcolor": torch.zeros(3),
            "target_rgbs": target, "target_masks": mask}


def _snapshot(tr):
    return {"params": [p.clone() for p in tree_leaves(tr.params)], "mu": [m.clone() for m in tr.opt_state.mu],
            "nu": [v.clone() for v in tr.opt_state.nu], "count": tr.opt_state.count,
            "schedule_count": tr.opt_state.schedule_count, "iter": tr.i_iter, "phase": tr.phase}


@pytest.fixture(scope="module")
def run(tmp_path_factory, info, batch):
    """One step, a save in phase 0 (iter_1); two more steps across the
    milestone, a save in phase 1 (iter_3); the trainer, its snapshots and the
    checkpoint directory."""
    d = str(tmp_path_factory.mktemp("ckpt"))
    tr = Trainer(_cfg(), info, device="cpu", seed=0)
    snaps = {}
    tr.step(batch)
    tr.save(d)
    snaps[1] = _snapshot(tr)
    for _ in range(2):
        tr.step(batch)
    tr.save(d)
    snaps[3] = _snapshot(tr)
    return tr, snaps, d


def _assert_state(tr, snap, with_opt=True):
    assert (tr.i_iter, tr.phase) == (snap["iter"], snap["phase"])
    got = tree_leaves(tr.params)
    assert len(got) == len(snap["params"])
    for a, b in zip(got, snap["params"]):
        assert a.device.type == "cpu" and torch.equal(a, b)
    if with_opt:
        assert (tr.opt_state.count, tr.opt_state.schedule_count) == (snap["count"], snap["schedule_count"])
        for a, b in zip(tr.opt_state.mu + tr.opt_state.nu, snap["mu"] + snap["nu"]):
            assert torch.equal(a, b)


def test_saves_record_iter_and_phase(run):
    _, snaps, d = run
    assert ckpt.latest_checkpoint(d) == (os.path.join(d, "iter_3"), 3)
    assert ckpt.read_phase(os.path.join(d, "iter_1")) == 0 and ckpt.read_phase(os.path.join(d, "iter_3")) == 1
    assert snaps[1]["phase"] == 0 and snaps[3]["phase"] == 1
    assert snaps[3]["params"][0].shape[0] == 4 * snaps[1]["params"][0].shape[0]  # the face colors grew x4
    payload = torch.load(os.path.join(d, "iter_3", ckpt.STATE_FILE), weights_only=True)
    assert payload["meta"] == {"iter": 3, "phase": 1}
    assert all(t.device.type == "cpu" for t in tree_leaves(payload["params"]))


def test_resume_replays_the_subdivision_and_restores_the_state(run, info, batch):
    tr, snaps, d = run
    fresh = Trainer(_cfg(), info, device="cpu", seed=1)
    assert fresh.phase == 0
    assert fresh.resume(d)
    _assert_state(fresh, snaps[3])
    assert fresh.gom_cfg == tr.gom_cfg
    # the topology equals the run's; target_edge_length is measured on the
    # mesh the replay subdivides (as the JAX package's resume does), and no
    # loss reads it; the gather tables (DualIndex, NeighborTable) field by field
    for field in fresh.statics._fields:
        if field != "target_edge_length":
            a, b = getattr(fresh.statics, field), getattr(tr.statics, field)
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), field
            else:
                for f in dataclasses.fields(a):
                    assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f"{field}.{f.name}"
    # the next step of the resumed trainer is the next step of the run
    t1, l1 = fresh.step(batch)
    t2, l2 = tr.step(batch)
    assert float(t1) == float(t2) and all(float(l1[k]) == float(l2[k]) for k in l2)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(fresh.params), tree_leaves(tr.params)))


def test_resume_without_a_checkpoint_starts_afresh(info, tmp_path):
    tr = Trainer(_cfg(), info, device="cpu")
    assert not tr.resume(str(tmp_path / "none"))
    assert (tr.i_iter, tr.phase) == (0, 0)


@pytest.mark.parametrize("it", [1, 3, None])
def test_load_for_eval_at_an_iteration(run, info, it):
    _, snaps, d = run
    tr = Trainer(_cfg(), info, device="cpu", seed=1)
    assert tr.load_for_eval(d, it) == (it or 3)
    _assert_state(tr, snaps[it or 3], with_opt=False)


def test_load_for_eval_without_a_checkpoint_raises(info, tmp_path):
    with pytest.raises(FileNotFoundError):
        Trainer(_cfg(), info, device="cpu").load_for_eval(str(tmp_path))


def test_a_template_of_another_phase_raises(run, info):
    _, _, d = run
    tr = Trainer(_cfg(), info, device="cpu")  # phase 0: 4x fewer faces than iter_3
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(os.path.join(d, "iter_3"), tr.params, tr.opt_state)
    params = dict(tr.params)
    params.pop("shadow")
    with pytest.raises(ValueError, match="keys"):
        ckpt.restore_checkpoint(os.path.join(d, "iter_1"), params, tr.opt_state)


def test_latest_checkpoint_takes_the_highest_iteration(tmp_path):
    assert ckpt.latest_checkpoint(str(tmp_path / "missing")) is None
    for name in ("iter_2", "iter_10", "iter_9", "iter_x", "other"):
        os.makedirs(tmp_path / name)
    assert ckpt.latest_checkpoint(str(tmp_path)) == (str(tmp_path / "iter_10"), 10)


def test_save_replaces_a_checkpoint_of_the_same_iteration(run, tmp_path):
    tr = run[0]
    ckpt.save_checkpoint(str(tmp_path), 5, tr.params, tr.opt_state, 0)
    ckpt.save_checkpoint(str(tmp_path), 5, tr.params, tr.opt_state, 1)
    assert os.listdir(tmp_path / "iter_5") == [ckpt.STATE_FILE]
    assert ckpt.read_phase(str(tmp_path / "iter_5")) == 1
    np.testing.assert_array_equal(
        ckpt.restore_checkpoint(str(tmp_path / "iter_5"), tr.params, tr.opt_state)[0]["vertices"].numpy(),
        tr.params["vertices"].numpy())
