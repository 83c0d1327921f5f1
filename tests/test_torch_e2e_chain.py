"""The e2e chain of gomavatar_tpu_torch (``tools/run_e2e.py``) in process on
the CPU at 32^2, at the toy scale of tests/test_e2e_chain.py: 5 train
frames (the MonoHuman split holds one out), subdivision at 3, both kick-ins
at 4, 6 iterations, resume to 8, all five evaluations, the noisy chain
(raw eval, train_pose, refined eval), export, the no-subdivision control and
the report.  Every stage finishes, every metric is finite and nothing is
dropped; the report parses the port's own logs; the export is read by the
JAX package's ``unflatten_params`` and by ``convert.load_trained``."""

import json
import os
import sys

import numpy as np
import pytest
import torch
import yaml

from gomavatar_tpu_torch import convert
from gomavatar_tpu_torch.config import make_cfg
from gomavatar_tpu_torch.data.dataset import TrainDataset
from gomavatar_tpu_torch.models.smpl import synthetic_body
from gomavatar_tpu_torch.tools import make_e2e_report, run_e2e
from gomavatar_tpu_torch.trainer import Trainer
from torch_port_scene import tree_leaves_by_path
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
from tools import export_trained as jax_export  # noqa: E402  (the JAX package's exporter)

S = 32
RINGS, SEGS = 12, 8
STAGES = ["datagen", "train", "resume", "eval view", "eval train", "eval freeview", "eval pose", "eval pose_mdm",
          "eval view_noisy_raw", "train_pose", "eval view_noisy_refined", "export", "control train",
          "control eval view", "report"]


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e_chain")
    data = str(root / "data")
    cfg = {
        "exp_name": "e2e_mini",
        "random_bgcolor": True,
        "bgcolor": [0.0, 0.0, 0.0],
        "img_size": [S, S],
        "dataset": {
            "train": {"dataset_path": os.path.join(data, "train"), "split_for_pose": True},
            "test_view": {"name": "snapshot", "dataset_path": os.path.join(data, "test"), "skip": 2},
            "test_on_train": {"dataset_path": os.path.join(data, "train")},
            "test_freeview": {"dataset_path": os.path.join(data, "train"), "src_type": "zju_mocap"},
            "test_pose": {"dataset_path": os.path.join(data, "train"),
                          "raw_dataset_path": os.path.join(data, "zju_raw"), "skip": 1},
            "test_pose_mdm": {"dataset_path": os.path.join(data, "train"),
                              "pose_path": os.path.join(data, "mdm_poses.npy")},
        },
        "model": {
            "img_size": [S, S],
            "subdivide_iters": [3],
            "canonical_geometry": {"deform_so3": True, "deform_scale": True},
            "normal_renderer": {"name": "mesh"},
            "shadow_module": {"name": "basic"},
            "non_rigid": {"name": "basic", "kick_in_iter": 4, "full_band_iter": 6},
            "pose_refinement": {"name": "basic", "kick_in_iter": 4},
        },
        "pose": {"lr": 0.001, "decay": 5, "iters": 4},
        "train": {
            "total_iters": 6, "save_freq": 3, "eval_freq": 4, "log_freq": 1, "tb_freq": 1000,
            "losses": {
                "lpips": {"coeff": 0.0},
                "laplacian": {"coeff_observation": 10.0},
                "normal": {"coeff_mask": 1.0, "mask_dilate": True, "coeff_consist": 0.1},
                "color_consist": {"coeff": 0.05},
            },
        },
    }
    cfg_path = str(root / "e2e_mini.yaml")
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    art = str(root / "trained.npz")
    out = run_e2e.main([
        "--cfg", cfg_path, "--log_dir", str(root / "log"), "--data", data, "--art", art, "--resume_iters", "8",
        "--freeview_frames", "2", "--pose_frames", "2",
        "--datagen_args", f"--frames 5 --test_frames 4 --rings {RINGS} --segs {SEGS} --mdm_frames 2",
        "--device", "cpu",
    ])
    return out, art, out["save_dir"]


def test_every_stage_finishes(chain):
    out, art, save_dir = chain
    assert list(out["seconds"]) == STAGES
    with open(os.path.join(save_dir, "e2e_stages.json")) as f:
        stages = json.load(f)
    assert list(stages["seconds"]) == STAGES
    assert stages["decode"]["items"] == 4 and stages["decode"]["items_per_s"] > 0
    assert (out["datagen"]["train"], out["datagen"]["test"], out["datagen"]["zju_raw"]) == (5, 4, 2)
    base = len(synthetic_body(n_rings=RINGS, n_seg=SEGS)["faces"])
    assert out["train"] == {"i_iter": 6, "phase": 1, "num_faces": 4 * base}
    assert out["resume"] == {"i_iter": 8, "phase": 1, "num_faces": 4 * base}
    assert (out["control"]["i_iter"], out["control"]["phase"], out["control"]["num_faces"]) == (6, 0, base)
    assert os.path.exists(os.path.join(save_dir, "checkpoints", "iter_8"))
    assert os.path.exists(os.path.join(save_dir, "checkpoints", "pose.pkl"))


def test_every_metric_is_finite_and_nothing_dropped(chain):
    out, _, save_dir = chain
    for tag, r in out["evals"].items():
        assert r["dropped"] == 0, tag
        assert r["frames"] > 0 and os.listdir(r["out_dir"]), tag
        if tag not in ("freeview", "pose_mdm"):
            assert r["metrics"] and all(np.isfinite(v) for v in r["metrics"].values()), (tag, r["metrics"])
    assert out["evals"]["freeview"]["frames"] == 2 and out["evals"]["pose_mdm"]["frames"] == 2
    assert out["evals"]["view_noisy_refined"]["iter"] == 8
    pose = out["pose"]
    assert pose["frames"] == 2 and pose["dropped"] == [0, 0]
    assert all(np.isfinite(v) for stage in pose["metrics"].values() for v in stage.values())
    assert out["control"]["eval"]["dropped"] == 0 and np.isfinite(out["control"]["eval"]["metrics"]["psnr"])
    assert out["report"]["drops"] == 0


def test_report_parses_the_ports_logs(chain):
    out, _, save_dir = chain
    rep = out["report"]
    events = [(kind, it) for kind, it, _ in rep["events"]]
    assert ("subdivide", 3) in events and ("resume", 6) in events and ("subdivide", 0) in events
    iters, ev = make_e2e_report.parse_train_log(os.path.join(save_dir, "log.txt"))
    assert [it for it, *_ in iters] == list(range(1, 9))
    assert any(kind == "eval:test" for kind, *_ in ev) and any(kind == "eval:test_on_train" for kind, *_ in ev)
    assert sorted(rep["final"]) == ["freeview", "pose", "pose_mdm", "train", "view", "view_noisy_raw",
                                    "view_noisy_refined"]
    for tag, d in rep["final"].items():
        assert d["dropped_entries"] == 0, tag
    assert rep["final"]["view"]["psnr"] == round(out["evals"]["view"]["metrics"]["psnr"], 4)
    assert set(rep["pose"]) == {"raw", "zeroed", "refined"} and rep["control"]
    with open(rep["path"]) as f:
        text = f.read()
    assert "on the CPU" in text.splitlines()[0]
    for section in ("## Wall time of each stage", "## Loss / throughput trajectory", "## Periodic eval: test",
                    "## Final eval", "## Subdivision ablation", "## Test-time pose refinement"):
        assert section in text, section
    assert len([line for line in text.splitlines() if line.startswith("| ")]) > 20


def test_export_reads_back_in_both_packages(chain):
    out, art, save_dir = chain
    cfg = make_cfg(os.path.join(save_dir, "e2e_cfg.yaml"))
    ds = TrainDataset(cfg["dataset"]["train"]["dataset_path"], bgcolor=cfg["bgcolor"], target_size=cfg["img_size"])
    trainer = Trainer(cfg, ds.get_canonical_info(), device="cpu")
    assert trainer.load_for_eval(os.path.join(save_dir, "checkpoints")) == 8
    want = {k: v.numpy() for k, v in tree_leaves_by_path(trainer.params)}

    with np.load(art) as npz:
        meta = json.loads(str(npz["meta"]))
        jax_params = jax_export.unflatten_params(npz)
    assert meta["iter"] == 8 and meta["phase"] == 1 and meta["num_faces"] == out["train"]["num_faces"]
    assert meta["body"] == {"n_rings": RINGS, "n_seg": SEGS}
    got = dict(tree_leaves_by_path(jax_params))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    params, statics, gom_cfg, frame = convert.load_trained(art, "cpu")
    assert gom_cfg.num_faces == meta["num_faces"]
    loaded = dict(tree_leaves_by_path(params))
    assert sorted(loaded) == sorted(want)
    for k in want:
        assert loaded[k].dtype == torch.float32
        np.testing.assert_array_equal(loaded[k].numpy(), want[k], err_msg=k)
    item = ds[0]
    for k in convert.FRAME_KEYS:
        np.testing.assert_array_equal(frame[k].numpy(), np.asarray(item[k], np.float32), err_msg=k)
