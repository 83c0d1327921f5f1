"""The program's outputs on the ``snapshot_m3c`` configuration at a small
frame on the benchmark's tiny avatar (``torch_snapshot_scene``), on the
CPU: the eval render, the train frame, one train step's loss and gradients
and three pose steps, as numpy arrays by name; and their digests.

``whole_tile_bits.json`` holds the digests of these outputs at 32^2 and
48^2 as the program gave them before frames could end mid-tile, on one
torch thread; ``test_torch_any_size.py`` holds the program to them.
Rewrite it (``python tests/torch_any_size_scene.py``) only after a
deliberate change of what the program computes at whole-tile sizes."""

from __future__ import annotations

import hashlib
import json
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
BITS = HERE / "whole_tile_bits.json"
WHOLE_TILE_SIZES = (32, 48)
ITERATION = 150000.0


def train_batch(frame: dict) -> dict:
    """The train step's inputs of a pose-mix frame, at 0.9 of its pose (so
    the image terms have something to pull)."""
    from portbench.reference import data as RD

    cj = frame["dst_tpose_joints"]
    b = {k: torch.as_tensor(frame[k]) for k in ("K", "E", "bgcolor", "target_rgbs", "target_masks")}
    b.update({k: torch.as_tensor(v) for k, v in RD.pose_inputs(frame["poses"] * 0.9, cj.copy(), cj).items()})
    return b


def program_outputs(c, frames: list, trunk, start: np.ndarray) -> dict:
    """{name: numpy array} of the program on ``c``'s configuration: the eval
    render of ``frames[0]`` at its pose (``eval.*``), its train frame
    (``frame.*``: the image, alpha, soft silhouette and normal map), one
    train step's loss terms and each leaf's gradient (``train.*``) and three
    pose steps from ``start`` (``pose.*``: each loss and the leaves after)."""
    from gomavatar_tpu_torch.cli.train_pose import make_pose_optimizer, refine_frame
    from gomavatar_tpu_torch.models.gom import eval_program, gom_forward
    from gomavatar_tpu_torch.trainer import loss_and_grads

    cfg = c.program_cfg()
    params, statics, gom_cfg = c.program_state(cfg)
    b = train_batch(frames[0])
    frame = (b["K"], b["E"], b["cnl_gtfms"], b["dst_Rs"], b["dst_Ts"], b["dst_posevec"])
    out = {}
    rgb, mask, _ = eval_program()(params, statics, gom_cfg, *frame, ITERATION)
    out.update({"eval.rgb": rgb, "eval.mask": mask})
    with torch.no_grad():
        rgb, mask, aux = gom_forward(params, statics, gom_cfg, *frame[:5], dst_posevec=frame[5], i_iter=ITERATION,
                                     train=True, device="cpu")
    out.update({"frame.rgb": rgb, "frame.alpha": mask, "frame.soft": aux["normal_mask"], "frame.normal": aux["normal"]})
    grads, total, losses = loss_and_grads(params, statics, gom_cfg, cfg["train"]["losses"], trunk, b, ITERATION)
    out["train.total"] = total
    out.update({f"train.loss.{k}": v for k, v in losses.items()})
    out.update({f"train.grad.{i}": g for i, g in enumerate(grads)})
    pose_cfg = {"lr": 1e-3, "decay": 2, "iters": 3}
    optimize = make_pose_optimizer(gom_cfg, cfg["train"]["losses"], pose_cfg, 3)
    batch = {k: torch.as_tensor(frames[0][k]) for k in
             ("K", "E", "cnl_gtfms", "dst_tpose_joints", "bgcolor", "target_rgbs", "target_masks")}
    r = refine_frame(optimize, params, statics, trunk, batch, start)
    out["pose.losses"] = r.losses
    out.update({f"pose.last.{k}": v for k, v in optimize.last.items()})
    return {k: np.ascontiguousarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in out.items()}


# -- partial-tile frames: the program and the plain reference of any W x H ------------

class AnyCell:
    """``torch_snapshot_scene``'s cell with the frame (W, H): the program's
    state and config, the reference's state, and pose-mix frames made by
    ``reference/frame_any.py`` (its renders over the white background at a
    pose drawn for (seed, i)).  The camera has the state's focal length at
    the short side and its centre at (0.9 W, 0.7 H): the body runs past the
    frame's right and bottom edges, through the partial tiles."""

    def __init__(self, tmp: Path, size):
        import torch_snapshot_scene as S

        self.size = (int(size[0]), int(size[1]))
        self.cell = S.cell(tmp, max(self.size))
        self.cell.config["model"]["img_size"] = list(self.size)
        self.cell.recipe = self._recipe(self.cell.recipe)
        self.seed = S.SEED

    def _recipe(self, base):
        def recipe():
            out = base()
            out["img_size"] = list(self.size)
            return out

        return recipe

    def program(self):
        cfg = self.cell.program_cfg()
        return (cfg,) + self.cell.program_state(cfg)

    def reference(self):
        """(cfg, mesh, params, meta, frame0) of the plain reference."""
        return self.cell.reference_state()

    def K(self, frame0) -> np.ndarray:
        from portbench.lib import scene

        W, H = self.size
        K = scene.scaled_K(frame0["K"], min(W, H))
        K[0, 2], K[1, 2] = 0.9 * W, 0.7 * H
        return K.astype(np.float32)

    def frames(self, n: int = 2) -> list:
        """``n`` pose-mix frames as numpy, the true pose under "poses"."""
        from portbench.lib import scene
        from portbench.reference import frame_any as FA
        from portbench.reference import model as RM
        from portbench.reference.data import pose_inputs

        cfg, mesh, params, meta, frame0 = self.reference()
        cj = scene.joints(meta)
        K = self.K(frame0)
        bg = np.ones(3, np.float32)
        out = []
        for i in range(n):
            p = scene.pose(scene.rng(self.seed, 8, i))
            E = scene.yaw(frame0["E"], 2.0 * np.pi * i / max(n, 4)).astype(np.float32)
            inputs = pose_inputs(p, cj.copy(), cj)
            b = {"K": torch.as_tensor(K), "E": torch.as_tensor(E), **{k: torch.as_tensor(v) for k, v in inputs.items()}}
            with torch.no_grad():
                rgb, alpha, *_ = FA.frame(params, cfg["model"], mesh, b, self.size, 1e7)
                img = RM.over(rgb, alpha, torch.as_tensor(bg)).clamp(0.0, 1.0)
            out.append({"K": K, "E": E, "cnl_gtfms": inputs["cnl_gtfms"], "dst_tpose_joints": cj, "bgcolor": bg,
                        "target_rgbs": img.numpy(), "target_masks": alpha.clamp(0.0, 1.0).numpy(), "poses": p})
        return out


def digest(a: np.ndarray) -> str:
    """The array's dtype, shape and bytes, hashed."""
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:24]


def pose_start(frames: list) -> np.ndarray:
    from portbench.lib import scene

    return (frames[0]["poses"] + scene.rng(7).normal(0.0, 0.03, 72)).astype(np.float32)


def whole_tile_digests(tmp: Path, size: int) -> dict:
    import torch_snapshot_scene as S

    c = S.cell(tmp, size)
    frames = S.pose_frames(c)
    return {k: digest(v) for k, v in program_outputs(c, frames, S.trunk(), pose_start(frames)).items()}


def main() -> None:
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE.parent))
    torch.set_num_threads(1)
    out = {}
    for size in WHOLE_TILE_SIZES:
        with tempfile.TemporaryDirectory() as tmp:
            out[str(size)] = whole_tile_digests(Path(tmp), size)
    BITS.write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")


if __name__ == "__main__":
    main()
