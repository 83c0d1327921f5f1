"""The drivers of gomavatar_tpu_torch in-process on the CPU (``--device
cpu``) over 48^2 synthetic fixtures, LPIPS off, as tests/test_cli.py sets
up JAX's: train through a subdivision milestone, resume, evaluate every
protocol; the periodic eval's background rule; the fail-fast on a
non-finite loss; no fall-back to the CPU without ``--device cpu``."""

import os

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from gomavatar_tpu_torch.cli import animate as animate_cli
from gomavatar_tpu_torch.cli import evaluate as eval_cli
from gomavatar_tpu_torch.cli import train as train_cli
from gomavatar_tpu_torch.cli import train_pose as pose_cli
from gomavatar_tpu_torch.data.synthetic import (
    write_synthetic_dataset,
    write_synthetic_mdm_poses,
    write_synthetic_zju_raw,
)
from gomavatar_tpu_torch.optim import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401

HW = (48, 48)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli")
    data = write_synthetic_dataset(str(root / "data"), n_frames=3, img_hw=HW)
    # five frames, so that the MonoHuman split's last fifth holds one
    pose_data = write_synthetic_dataset(str(root / "data_pose"), n_frames=5, img_hw=HW)
    raw = write_synthetic_zju_raw(str(root / "zju_raw"), pose_data, n_views=2, img_hw=HW)
    mdm = write_synthetic_mdm_poses(str(root / "mdm.npy"), n_frames=2)
    cfg = {
        "exp_name": "cli_smoke",
        "log_dir": str(root / "log"),
        "random_bgcolor": False,
        "bgcolor": [0.0, 0.0, 0.0],
        "img_size": list(HW),
        "dataset": {
            "train": {"dataset_path": data},
            "test_view": {"dataset_path": data, "name": "snapshot", "skip": 1},
            "test_freeview": {"dataset_path": data, "src_type": "zju_mocap"},
            "test_pose": {"dataset_path": pose_data, "raw_dataset_path": raw, "skip": 1},
            "test_pose_mdm": {"dataset_path": pose_data, "pose_path": mdm},
        },
        "model": {
            "img_size": list(HW),
            "subdivide_iters": [2],
            "canonical_geometry": {"deform_so3": True, "deform_scale": True},
            "normal_renderer": {"name": "mesh"},
            "shadow_module": {"name": "basic"},
        },
        "train": {
            "total_iters": 4,
            "save_freq": 4,
            "eval_freq": 3,
            "log_freq": 1,
            "tb_freq": 2,
            "losses": {
                "lpips": {"coeff": 0.0},
                "laplacian": {"coeff_observation": 10.0},
                "normal": {"coeff_mask": 1.0, "mask_dilate": True, "coeff_consist": 0.1},
                "color_consist": {"coeff": 0.05},
            },
        },
    }
    path = str(root / "exp.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    save_dir = root / "log" / "cli_smoke"
    return {"root": root, "cfg_path": path, "save_dir": save_dir}


@pytest.fixture(scope="module")
def trained(workspace):
    """4 steps through the subdivision at iteration 2, with TB visuals at 2
    and 4 and the periodic eval at 3; then --resume to 6."""
    first = train_cli.main(["--cfg", workspace["cfg_path"], "--device", "cpu"])
    faces = first.gom_cfg.num_faces, first.phase
    second = train_cli.main(["--cfg", workspace["cfg_path"], "--device", "cpu", "--resume", "--max_iters", "6"])
    return faces, second


def test_train_runs_through_the_phase_change(workspace, trained):
    (faces, phase), _ = trained
    save_dir = workspace["save_dir"]
    assert phase == 1 and faces == 4 * 360
    assert {"iter_0", "iter_4"} <= set(os.listdir(save_dir / "checkpoints"))
    log = (save_dir / "log.txt").read_text()
    assert "subdividing at iter 2: 360 -> 1440 faces" in log and "training done at iter 4" in log
    assert "evaluate on test_on_train" in log and "evaluate on test:" in log
    assert any(f.startswith("events") for f in os.listdir(save_dir / "tb"))
    assert (save_dir / "config.yaml").exists()


def test_train_resumes_from_the_last_checkpoint(workspace, trained):
    _, tr = trained
    assert (tr.i_iter, tr.phase, tr.gom_cfg.num_faces) == (6, 1, 1440)
    log = (workspace["save_dir"] / "log.txt").read_text()
    assert "resumed from" in log and "(iter 4, phase 1)" in log and "training done at iter 6" in log
    assert "iter_6" in os.listdir(workspace["save_dir"] / "checkpoints")


@pytest.mark.parametrize("kind,frames,metric", [
    ("view", 3, "metric_view.npy"),
    ("train", 3, "metric_train.npy"),
    ("freeview", 2, None),
    ("pose", 1, "metric_pose.npy"),
    ("pose_mdm", 2, None),
])
def test_evaluate_writes_pngs_and_metrics(workspace, trained, kind, frames, metric):
    res = eval_cli.main(["--cfg", workspace["cfg_path"], "--type", kind, "--device", "cpu", "--n_frames", "2"])
    assert (res["iter"], res["num_faces"], res["frames"], res["dropped"]) == (6, 1440, frames, 0)
    out = workspace["save_dir"] / "eval" / kind
    pngs = sorted(os.listdir(out))
    assert len(pngs) == frames
    assert np.asarray(Image.open(out / pngs[0])).shape == (*HW, 3)
    log = (workspace["save_dir"] / f"log_eval_{kind}.txt").read_text()
    assert "render budgets: zero dropped entries" in log
    if metric is None:
        assert res["metrics"] == {}
    else:
        m = np.load(workspace["save_dir"] / "eval" / metric, allow_pickle=True).item()
        assert all(len(v) == frames for v in m.values())
        assert res["metrics"] and all(np.isfinite(v) for v in res["metrics"].values())
        assert "lpips_uncalibrated" in res["metrics"] and "metrics:" in log


def test_evaluate_renders_refined_poses(workspace, trained, tmp_path):
    """--pose_path: the poses of a pose-refinement run (Rhs, Ths, dst_poses
    per frame) replace the dataset's, through body_pose_to_body_RTs and the
    global transform; a file with fewer frames than the split is refused."""
    import pickle

    rng = np.random.default_rng(0)
    poses = {"Rhs": rng.normal(0, 0.05, (3, 3)), "Ths": rng.normal(0, 0.02, (3, 3)),
             "dst_poses": rng.normal(0, 0.1, (3, 72))}
    path = tmp_path / "pose.pkl"
    with open(path, "wb") as f:
        pickle.dump(poses, f)
    args = ["--cfg", workspace["cfg_path"], "--type", "view", "--device", "cpu", "--pose_path", str(path)]
    refined = eval_cli.main(args + ["--tag", "view_refined"])
    plain = eval_cli.main(["--cfg", workspace["cfg_path"], "--type", "view", "--device", "cpu", "--tag", "view_plain"])
    assert refined["frames"] == 3 and all(np.isfinite(v) for v in refined["metrics"].values())
    assert refined["metrics"]["psnr"] != plain["metrics"]["psnr"]
    assert "using refined poses" in (workspace["save_dir"] / "log_eval_view_refined.txt").read_text()
    with open(path, "wb") as f:
        pickle.dump({k: v[:2] for k, v in poses.items()}, f)
    with pytest.raises(ValueError, match="pose file has 2 frames"):
        eval_cli.main(args + ["--tag", "view_short"])


def test_evaluate_on_composites_over_the_item_bgcolor(monkeypatch):
    """Under random_bgcolor each target is composited over its own random
    background: the periodic eval composites the prediction over the same
    one, so that the metric scores the model and not the background."""
    H = W = 8
    rng = np.random.default_rng(0)
    fg = rng.random((H, W, 3)).astype(np.float32)
    mask = np.zeros((H, W), np.float32)
    mask[2:6, 2:6] = 1.0
    item_bg = np.array([0.9, 0.1, 0.5], np.float32)
    target = fg * mask[..., None] + item_bg * (1.0 - mask[..., None])

    class DS:
        bgcolor = (0.0, 0.0, 0.0)  # static eval bg != the item's bg

        def __len__(self):
            return 1

        def __getitem__(self, i):
            return {"bgcolor": item_bg, "target_rgbs": target}

    class StubTrainer:
        lpips_params = None
        lpips_calibrated = False
        device = torch.device("cpu")

        def forward(self, batch):
            return torch.as_tensor(fg), torch.as_tensor(mask), None

    captured = {}

    class CaptureEvaluator:
        def __init__(self, **kw):
            pass

        def evaluate(self, pred, gt):
            captured["pred"], captured["gt"] = pred, gt

        def summarize(self):
            return {}

    monkeypatch.setattr(train_cli, "Evaluator", CaptureEvaluator)

    class NullTB:
        def summ_scalar(self, *a, **k):
            pass

    train_cli.evaluate_on(StubTrainer(), DS(), NullTB(), "test_on_train", True)
    np.testing.assert_allclose(captured["pred"], captured["gt"], atol=1e-5)


def test_train_twice_under_random_backgrounds_gives_the_same_params(workspace, tmp_path):
    """Each item's random background is drawn from its epoch, rank and
    position, not from the order the decode threads take items in: two
    runs of one config through the phase change end with the same bits."""
    with open(workspace["cfg_path"]) as f:
        cfg = yaml.safe_load(f)
    cfg["random_bgcolor"] = True
    cfg["train"].update(total_iters=3, eval_freq=100, tb_freq=100, save_freq=100)
    runs = []
    for name in ("a", "b"):
        cfg["log_dir"] = str(tmp_path / name)
        path = str(tmp_path / f"{name}.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(cfg, f)
        runs.append(train_cli.main(["--cfg", path, "--device", "cpu"]))
    a, b = (tree_leaves(r.params) for r in runs)
    assert runs[0].phase == runs[1].phase == 1
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_train_fails_fast_on_a_non_finite_loss(workspace, tmp_path, monkeypatch):
    with open(workspace["cfg_path"]) as f:
        cfg = yaml.safe_load(f)
    cfg["log_dir"] = str(tmp_path)
    path = str(tmp_path / "exp.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)

    def nan_step(self, batch):
        self.i_iter += 1
        return torch.tensor(float("nan")), {"rgb": torch.tensor(float("nan"))}

    monkeypatch.setattr(train_cli.Trainer, "step", nan_step)
    with pytest.raises(RuntimeError, match="non-finite training loss at iter 1"):
        train_cli.main(["--cfg", path, "--device", "cpu"])
    assert os.listdir(tmp_path / "cli_smoke" / "checkpoints") == ["iter_0"]  # the last good checkpoint stays


@pytest.mark.parametrize("driver", [train_cli, eval_cli, pose_cli, animate_cli])
def test_drivers_run_on_the_card_unless_asked_for_the_cpu(workspace, driver):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is there")
    args = ["--synthetic", "1"] if driver is animate_cli else ["--cfg", workspace["cfg_path"]]
    with pytest.raises(SystemExit, match="no CUDA device"):
        driver.main(args)
