"""The small gate scene: the synthetic body at a reduced ring count, posed
and framed like the bench's gate scene of the JAX package (bench.py
``_regression_gate``), with untrained weights drawn from a seed.

The model config is the trained avatar's (``meta["model_cfg"]`` of
``artifacts/e2e_trained.npz``) with ``img_size`` overridden, so every module
of the eval forward is on and no config module is needed.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from gomavatar_tpu_torch import prng
from gomavatar_tpu_torch.config import default_cfg
from gomavatar_tpu_torch.convert import TRAINED, trained_meta
from gomavatar_tpu_torch.models.gom import init_gom
from gomavatar_tpu_torch.models.smpl import synthetic_body, synthetic_camera
from gomavatar_tpu_torch.ops.skeleton import body_pose_to_body_RTs, get_canonical_global_tfms


# The train section of configs/exps/e2e_synthetic.yaml (the trained
# avatar's experiment), written out so that no yaml reader is needed, and
# merged over the defaults as make_cfg merges the file.
E2E_TRAIN = default_cfg()["train"].merge({
    "losses": {
        "laplacian": {"coeff_observation": 10.0},
        "normal": {"mask_dilate": True, "kernel_size": 7, "coeff_mask": 1.0, "coeff_consist": 0.1},
        "color_consist": {"coeff": 0.05},
    },
    "lr": {
        "appearance": 0.0005,
        "canonical_geometry": 0.0005,
        "canonical_geometry_xyz": 0.0005,
        "non_rigid": 0.0005,
        "pose_refinement": 5.0e-05,
        "shadow": 0.0005,
    },
    "lr_update_exp": True,
    "lr_decay_steps": 2000,
    "log_freq": 50,
    "tb_freq": 1000,
    "eval_freq": 1000,
    "save_freq": 1000,
    "total_iters": 6000,
})


def trained_train_cfg(path=TRAINED) -> dict:
    """The config a Trainer of the trained avatar runs: its model config
    (with subdivide_iters) and :data:`E2E_TRAIN`."""
    return {"model": trained_meta(path)["model_cfg"], "train": copy.deepcopy(E2E_TRAIN)}


def gate_model_cfg(img_size=(64, 64), path=TRAINED) -> dict:
    model_cfg = dict(trained_meta(path)["model_cfg"])
    model_cfg["img_size"] = list(img_size)
    return model_cfg


def gate_frame(info: dict, img_size=(64, 64), device="cuda") -> dict:
    """Camera at distance 2.4 with focal 1.15 * H, pose[12] = 0.3 and
    dst_posevec = pose[3:] + 0.01."""
    K, E = synthetic_camera(img_size, distance=2.4, focal=1.15 * img_size[1])
    joints = torch.as_tensor(info["canonical_joints"], device=device)
    pose = np.zeros(72, np.float32)
    pose[12] = 0.3
    Rs, Ts = body_pose_to_body_RTs(torch.as_tensor(pose, device=device), joints)
    return {
        "K": torch.as_tensor(K, device=device),
        "E": torch.as_tensor(E, device=device),
        "cnl_gtfms": get_canonical_global_tfms(joints),
        "dst_Rs": Rs,
        "dst_Ts": Ts,
        "dst_posevec": torch.as_tensor(pose[3:] + 1e-2, device=device),
    }


def gate_scene(img_size=(64, 64), rings=(16, 18), device="cuda", seed=0):
    """(params, statics, gom_cfg, frame) of the gate scene, weights drawn
    from ``prng.key(seed)``."""
    info = synthetic_body(n_rings=rings[0], n_seg=rings[1])
    params, statics, gom_cfg = init_gom(gate_model_cfg(img_size), info, device=device, key=prng.key(seed))
    return params, statics, gom_cfg, gate_frame(info, img_size, device)
