"""``cli.train --data_parallel`` of gomavatar_tpu_torch on the CPU, over a
48^2 synthetic capture (LPIPS off): the rank-order rule
(``parallel.rank_items``) against the grouping of JAX's driver; the
driver's two gloo ranks (a subprocess, ``--device cpu``) against the
one-process mean-gradient run on the same frame pairs, bit for bit; and
``--data_parallel`` on CUDA refused without its cards; ``cli.animate`` on
two gloo ranks against its one-process scene loop, and its choice of
ranks for n scenes on k cards."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from gomavatar_tpu_torch import checkpoint as ckpt_lib
from gomavatar_tpu_torch.cli import train as train_cli
from gomavatar_tpu_torch.config import make_cfg
from gomavatar_tpu_torch.data.dataset import TrainDataset, to_device
from gomavatar_tpu_torch.data.synthetic import write_synthetic_dataset
from gomavatar_tpu_torch.optim import tree_leaves
from gomavatar_tpu_torch.parallel import make_mean_gradient_step, rank_items
from gomavatar_tpu_torch.trainer import Trainer
from torch_parallel_ranks import IMG
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """A 48^2 capture of 5 frames and an exp yaml of the data-parallel
    config (no subdivision, LPIPS off, cadences past the run)."""
    root = tmp_path_factory.mktemp("torch_dp_cli")
    data = write_synthetic_dataset(str(root / "data"), n_frames=5, img_hw=IMG)
    cfg = {
        "exp_name": "dp",
        "log_dir": str(root / "log"),
        "random_bgcolor": False,
        "bgcolor": [0.0, 0.0, 0.0],
        "img_size": list(IMG),
        "dataset": {"train": {"dataset_path": data}},
        "model": {
            "img_size": list(IMG),
            "canonical_geometry": {"deform_so3": True, "deform_scale": True},
            "normal_renderer": {"name": "mesh"},
            "shadow_module": {"name": "basic"},
        },
        "train": {"total_iters": 3, "save_freq": 100, "eval_freq": 100, "log_freq": 1, "tb_freq": 100,
                  "losses": {"lpips": {"coeff": 0.0}}},
    }
    path = str(root / "exp.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return {"root": root, "cfg_path": path, "save_dir": root / "log" / "dp"}


class _RecordingTrainer:
    """Stands in for JAX's Trainer in its driver: records each step's
    frames."""

    steps: list = []

    def __init__(self, *args, **kwargs):
        self.i_iter = 0

    def resume(self, ckpt_dir):
        return False

    def save(self, ckpt_dir):
        pass

    def step(self, batch):
        type(self).steps.append([item["frame_name"] for item in batch])
        self.i_iter += 1
        return 0.0, {}


def test_rank_items_match_jax_driver_grouping(workspace, monkeypatch):
    """JAX's driver at --data_parallel 2 over 5 frames for 5 steps (three
    epochs: each drops its fifth frame): step g's frame on device r is
    ``rank_items(order, 2, r)[g]`` of that epoch's order."""
    from gomavatar_tpu.cli import train as jax_train_cli

    with open(workspace["cfg_path"]) as f:
        cfg = yaml.safe_load(f)
    cfg["exp_name"] = "dp_jax"  # its own log directory
    path = str(workspace["root"] / "exp_jax.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    monkeypatch.setattr(jax_train_cli, "Trainer", _RecordingTrainer)
    monkeypatch.setattr(_RecordingTrainer, "steps", [])
    monkeypatch.setattr(sys, "argv", ["train", "--cfg", path, "--data_parallel", "2", "--max_iters", "5"])
    jax_train_cli.main()
    got = _RecordingTrainer.steps
    ds = TrainDataset(make_cfg(workspace["cfg_path"])["dataset"]["train"]["dataset_path"])
    rng = np.random.default_rng(0)
    want = []
    while len(want) < 5:
        order = rng.permutation(len(ds))
        per_rank = [rank_items(order, 2, r) for r in range(2)]
        want += [[ds.framelist[per_rank[r][g]] for r in range(2)] for g in range(len(per_rank[0]))]
    assert got == want[:5]
    assert rank_items(range(5), 2, 0) == [0, 2] and rank_items(range(5), 2, 1) == [1, 3]


def test_cli_train_data_parallel(workspace):
    """``cli.train --data_parallel 2 --device cpu`` for 2 steps: exit 0, the
    checkpoints written once (rank 0), the final params bit-equal to the
    one-process mean-gradient run over the same frame pairs."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "gomavatar_tpu_torch.cli.train", "--cfg", workspace["cfg_path"], "--device", "cpu",
         "--data_parallel", "2", "--max_iters", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    save_dir = workspace["save_dir"]
    assert sorted(os.listdir(save_dir / "checkpoints")) == ["iter_0", "iter_2"]
    log = (save_dir / "log.txt").read_text()
    assert log.count("training done at iter 2") == 1 and "data-parallel over 2 ranks" in log

    cfg = make_cfg(workspace["cfg_path"])
    ds = train_cli.train_dataset(cfg)
    ref = Trainer(cfg, ds.get_canonical_info(), device="cpu", seed=0)
    order = np.random.default_rng(0).permutation(len(ds))
    per_rank = [rank_items(order, 2, r) for r in range(2)]
    step = make_mean_gradient_step(ref.gom_cfg, ref.loss_cfg, ref.tx)
    params, opt_state = ref.params, ref.opt_state
    for g in range(2):
        batches = [to_device(ds[per_rank[r][g]], "cpu") for r in range(2)]
        params, opt_state, _, _ = step(params, opt_state, ref.statics, None, batches, float(g))
    saved = ckpt_lib.restore_checkpoint(str(save_dir / "checkpoints" / "iter_2"), ref.params, ref.opt_state)
    assert saved[2] == 2
    for a, b in zip(tree_leaves(saved[0]), tree_leaves(params)):
        assert torch.equal(a, b)


def test_cli_train_data_parallel_needs_the_cards(workspace, monkeypatch):
    """--data_parallel N on CUDA needs N cards, and no card at all is an
    error, never a fall-back to the CPU."""
    argv = ["--cfg", workspace["cfg_path"], "--data_parallel", "2"]
    with pytest.raises(SystemExit, match="no CUDA device found"):
        train_cli.main(argv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="--data_parallel 2 needs 2 CUDA devices, 1 found"):
        train_cli.main(argv)


def test_animate_on_two_ranks_equals_the_scene_loop(tmp_path):
    """``cli.animate``'s multi-rank path (two gloo ranks, as k cards would
    run it) against its one-process scene loop: the same strips, byte for
    byte, written once."""
    from PIL import Image

    from gomavatar_tpu_torch.cli import animate as anim_cli
    from gomavatar_tpu_torch.parallel import spawn

    def argv(out):
        return ["--synthetic", "4", "--type", "mdm", "--n_frames", "2", "--img", "48", "48", "--out", str(out),
                "--device", "cpu"]

    ranks = spawn(anim_cli.animate_rank, ["cpu", "cpu"], argv(tmp_path / "ranks"))
    assert ranks[1] is None and (ranks[0]["frames"], ranks[0]["scenes"]) == (2, 4)
    one = anim_cli.main(argv(tmp_path / "one"))
    assert (one["frames"], one["scenes"]) == (2, 4)
    for t in range(2):
        a = np.asarray(Image.open(tmp_path / "ranks" / f"frame_{t:04d}.png"))
        b = np.asarray(Image.open(tmp_path / "one" / f"frame_{t:04d}.png"))
        assert a.shape == (48, 4 * 48, 3) and np.array_equal(a, b), t
        assert all(a[:, 48 * s:48 * (s + 1)].mean() > 1.0 for s in range(4))


@pytest.mark.parametrize("n, cards, want", [(3, 2, 1), (5, 4, 1), (4, 2, 2), (6, 4, 3), (2, 8, 2), (4, 1, 1)])
def test_animate_scene_ranks(monkeypatch, n, cards, want):
    """``cli.animate`` renders n scenes on the largest divisor of n that
    fits on the cards, and keeps the one-card loop (1 rank) where only 1
    does: 3 scenes on 2 cards, or 5 on 4, run in one process."""
    from gomavatar_tpu_torch.cli import animate as anim_cli

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert anim_cli.scene_ranks(n, torch.device("cuda")) == want
    assert anim_cli.scene_ranks(n, torch.device("cpu")) == 1
