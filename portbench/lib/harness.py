"""What every cell's run shares: its context, the program's configuration,
the reference's state, the comparisons and the result line."""

from __future__ import annotations

import gc
import json
import statistics
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from portbench.lib import scene
from portbench.lib.trace import Spans

ROOT = Path(__file__).resolve().parents[1]
# the span in which a driver's set-up makes the benchmark's own inputs: not
# the program's set-up, so not counted in ``setup_s``
INPUTS = "make_inputs"


@dataclass
class Cell:
    """One run of one cell: its names, files, seed and device."""

    workload: str
    config: dict
    mix: dict
    seed: int
    device: torch.device
    tmp: str
    spans: Spans = field(default_factory=Spans)

    def recipe(self) -> dict:
        """The configuration file's frozen sections (the yaml over the
        recipe's schema, at the cell's frame size)."""
        size = self.config["frame_size"]
        out = {k: json.loads(json.dumps(self.config[k])) for k in ("model", "train", "pose")}
        out.update(img_size=[size, size], random_bgcolor=self.config["random_bgcolor"],
                   bgcolor=self.config["bgcolor"])
        return out

    def program_cfg(self):
        """The program's configuration: its schema under the recipe."""
        from gomavatar_tpu_torch.config import default_cfg

        return default_cfg().merge(self.recipe())

    def program_state(self, cfg):
        """(params, statics, gom_cfg) of the state through the program's own
        loader, the modules the configuration's model leaves out not loaded."""
        from gomavatar_tpu_torch.convert import load_trained
        from gomavatar_tpu_torch.models.gom import GoMConfig

        params, statics, _, _ = load_trained(ROOT.parent / self.config["state"], device=self.device)
        params = scene.model_params(params, cfg["model"])
        gom_cfg = GoMConfig.from_model_cfg(cfg["model"], statics.lbs_weights.shape[0], statics.faces.shape[0])
        return params, statics, gom_cfg

    def reference_state(self):
        """(cfg dict, mesh, params, meta, frame0) for the plain reference, from the files alone."""
        from portbench.reference.mesh import build_mesh

        meta, params, frame0 = scene.load_state(self.config["state"], self.device)
        cfg = self.recipe()
        params = scene.model_params(params, cfg["model"])
        return cfg, build_mesh(meta["body"], meta["phase"], self.device), params, meta, frame0


def free_program():
    """Return the memory of the program's dropped state before the
    reference runs on the card."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def reset_peak(device: torch.device):
    """Start the peak of device memory anew: the benchmark's own use of the
    card in set-up (the reference's renders of the inputs) is not the
    program's."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def tf32(on: bool):
    """TF32 in float32 matmuls and convolutions on or off."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def norm(x) -> float:
    return float(torch.linalg.norm(x.double().flatten()))


def leaf_gap(prog: list, ref: list, keep: list[bool]) -> float:
    """The worst kept leaf's | |prog| - |ref| | over the larger of |ref| and
    the median kept leaf's |ref|."""
    pn = [norm(p) for p in prog]
    rn = [norm(r) for r in ref]
    kept = [i for i, k in enumerate(keep) if k]
    med = statistics.median([rn[i] for i in kept])
    return max(abs(pn[i] - rn[i]) / max(rn[i], med, 1e-30) for i in kept)


def moving(ref_grads: list) -> list[bool]:
    """Leaves whose reference gradient is not nought to rounding: at least a
    thousandth of the median leaf's norm."""
    n = [norm(g) for g in ref_grads]
    med = statistics.median(n)
    return [v >= 1e-3 * med for v in n]


def image_gaps(prog: np.ndarray, ref: np.ndarray) -> dict:
    """The mean absolute difference of two images and the share of their
    values that differ by more than 1e-2.  (The widest difference is not
    compared: a few edge pixels, where rounding flips a z-buffer winner or
    a transmittance cut, differ by up to 0.2 in sound runs.)"""
    d = np.abs(np.asarray(prog, np.float64) - np.asarray(ref, np.float64))
    return {"mean": float(d.mean()), "off_1e-2": float((d > 1e-2).mean())}


def judge(numbers: dict, limits: dict) -> bool:
    """Every number with a limit within it; a number that is not finite fails."""
    ok = True
    for k, v in numbers.items():
        if k in limits and not (np.isfinite(v) and v <= limits[k]):
            ok = False
    return ok and all(np.isfinite(v) for v in numbers.values())


def device_info(device: torch.device) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
