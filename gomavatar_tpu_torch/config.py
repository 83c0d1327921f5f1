"""Config: a nested attribute dict with a recursive merge, and the yaml
overlay of an experiment file over the defaults (port of
gomavatar_tpu/config.py).

``yaml`` is imported only by :func:`make_cfg` when it reads a file and by
``Config.dump``, so the package imports without PyYAML.
"""

from __future__ import annotations

import copy
import os
from typing import Any


class Config(dict):
    """dict with attribute access and recursive merge."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    @staticmethod
    def from_dict(d: dict) -> "Config":
        out = Config()
        for k, v in d.items():
            out[k] = Config.from_dict(v) if isinstance(v, dict) else v
        return out

    def merge(self, other: dict) -> "Config":
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), dict):
                self[k].merge(v)
            else:
                self[k] = Config.from_dict(v) if isinstance(v, dict) else v
        return self

    def dump(self) -> str:
        """The config as yaml text, keys in insertion order."""
        import yaml

        def plain(d):
            return {k: plain(v) if isinstance(v, dict) else v for k, v in d.items()}

        return yaml.safe_dump(plain(self), sort_keys=False)


# The reference's default configuration (same keys, same defaults).
DEFAULTS: dict = {
    "exp_name": "default",
    "bgcolor": [255.0, 255.0, 255.0],
    "random_bgcolor": True,
    "img_size": [512, 512],
    "log_dir": "log",
    "dataset": {
        "train": {
            "dataset_path": "",
            "batch_size": 1,
            "num_workers": 1,
            "skip": 1,
            "maxframes": -1,
            "split_for_pose": False,
            "crop_size": [-1, -1],
            "prefetch": False,
            # route host decode through the fused C++ pipeline
            # (native/gom_host.cpp); falls back to cv2 if the library
            # is unavailable
            "use_native": False,
        },
        "test_view": {
            "name": "zju-mocap",
            "dataset_path": "",
            "raw_dataset_path": "",
            "batch_size": 1,
            "num_workers": 1,
            "skip": 1,
            "maxframes": -1,
            "exclude_view": 0,
        },
        "test_pose": {"dataset_path": "", "raw_dataset_path": "", "batch_size": 1, "num_workers": 1, "skip": 1},
        "test_pose_mdm": {"dataset_path": "", "pose_path": "", "batch_size": 1, "num_workers": 1, "format": "mdm"},
        "test_on_train": {"dataset_path": "", "batch_size": 1, "num_workers": 1},
        "test_freeview": {"dataset_path": "", "batch_size": 1, "num_workers": 1, "src_type": "zju_mocap", "frame_idx": 0, "total_frames": 100},
    },
    "model": {
        "img_size": [512, 512],
        "subdivide_iters": [],
        "eval_mode": False,
        "use_smplx": False,
        "appearance": {"face_color": True, "color_init": 0.5},
        "canonical_geometry": {
            "radius_scale": 1.0,
            "deform_scale": False,
            "deform_so3": False,
            "sigma": 0.001,
        },
        "lbs_weights": {"refine": False},
        "renderer": {"name": "gaussian"},
        "pose_refinement": {
            "name": "none",
            "embedding_size": 69,
            "total_bones": 24,
            "mlp_width": 256,
            "mlp_depth": 4,
            "refine_root": False,
            "refine_t": False,
            "kick_in_iter": 100000,
        },
        "non_rigid": {
            "name": "none",
            "condition_code_size": 69,
            "mlp_width": 128,
            "mlp_depth": 6,
            "skips": [4],
            "multires": 6,
            "i_embed": 0,
            "kick_in_iter": 150000,
            "full_band_iter": 200000,
        },
        "normal_renderer": {"name": "none", "soft_mask": True, "sigma": 1e-5},
        "shadow_module": {
            "name": "none",
            "condition_code_size": 162,
            "mlp_width": 128,
            "mlp_depth": 3,
            "skips": [4],
            "multires": 6,
            "i_embed": 0,
        },
    },
    "pose": {"lr": 1e-3, "decay": 100, "iters": 300},
    "train": {
        "optim": "adam",
        "lr": {
            "lbs_weights": 0.0,
            "appearance": 0.005,
            "canonical_geometry": 0.005,
            "canonical_geometry_xyz": 0.005,
            "non_rigid": 0.005,
            "pose_refinement": 0.0005,
            "shadow": 0.005,
        },
        "losses": {
            "rgb": {"coeff": 1.0},
            "mask": {"coeff": 5.0},
            "lpips": {"coeff": 1.0},
            "laplacian": {"coeff_canonical": 0.0, "coeff_observation": 0.0},
            "normal": {"coeff_consist": 0.0, "mask_dilate": False, "kernel_size": 7, "coeff_mask": 0.0},
            "color_consist": {"coeff": 0.0},
        },
        "total_iters": 30000,
        "lr_update_exp": True,
        "lr_decay_steps": 100000,
        "log_freq": 10,
        "tb_freq": 100,
        "save_freq": 1000,
        "eval_freq": 50000,
        # yaw-balanced frame sampling (utils/sampling.py; the reference's
        # make_weights_for_pose_balance is dead code, train_util.py:71-96)
        "pose_balanced_sampling": False,
    },
}


def default_cfg() -> Config:
    return Config.from_dict(copy.deepcopy(DEFAULTS))


def make_cfg(path: str | None = None) -> Config:
    """The defaults with the experiment yaml at ``path`` merged over them;
    ``save_dir`` is log_dir/exp_name."""
    cfg = default_cfg()
    if path is not None:
        import yaml

        with open(path) as f:
            overlay = yaml.safe_load(f) or {}
        cfg.merge(overlay)
    cfg["save_dir"] = os.path.join(cfg.get("log_dir", "log"), cfg["exp_name"])
    return cfg
