"""The ``snapshot_m3c`` configuration (portbench/configs/snapshot_m3c.json)
at a small frame on the benchmark's tiny avatar (portbench/tests/tiny.py,
its weights drawn from a seed): the program's state and the plain
reference's from the same files, and test frames made as the pose mix
makes them (the reference's renders over the white background)."""

import json
from pathlib import Path

import numpy as np
import torch

from portbench.lib import harness as H
from portbench.lib import scene
from portbench.tests import tiny

ROOT = Path(__file__).resolve().parents[1]
SEED = 2**31 + 99
BATCH_KEYS = ("K", "E", "cnl_gtfms", "dst_tpose_joints", "bgcolor", "target_rgbs", "target_masks")


def config(size: int) -> dict:
    conf = json.loads((ROOT / "portbench" / "configs" / "snapshot_m3c.json").read_text())
    conf["frame_size"] = size
    conf["model"]["img_size"] = [size, size]
    return conf


def cell(tmp_path: Path, size: int = 32) -> H.Cell:
    """The configuration at ``size``^2 with the tiny avatar as its state, on
    the CPU; its mix is the pose mix's."""
    conf = config(size)
    state = tmp_path / "tiny_state.npz"
    if not state.exists():
        tiny.write_state(state, conf["model"])
    conf["state"] = str(state)
    mix = json.loads((ROOT / "portbench" / "traffic" / "pose_refine.json").read_text())
    mix["pool"] = 2
    return H.Cell("snapshot_m3c.tests", conf, mix, SEED, torch.device("cpu"), str(tmp_path))


def pose_frames(c: H.Cell) -> list:
    """The pose mix's frames of ``c`` (numpy; the true pose under "poses")."""
    from portbench.drivers.pose_refine import Driver

    d = Driver(c)
    d.size = c.config["frame_size"]
    d.bg = np.asarray(c.config["bgcolor"], np.float32) / 255.0
    return d.make_frames()


def batch(frame: dict) -> dict:
    return {k: torch.as_tensor(frame[k]) for k in BATCH_KEYS}


def trunk(device="cpu"):
    return scene.draw_trunk(SEED, device, "portbench/inputs/lpips_vgg_heads.npz")
