"""Test-time pose refinement (port of gomavatar_tpu/cli/train_pose.py), the
PeopleSnapshot protocol.

    python -m gomavatar_tpu_torch.cli.train_pose --cfg configs/exps/snapshot_f3c.yaml \
        [--max_frames N] [--dataset_path DIR] [--device cpu]

Per test frame, Adam optimizes (Rh, Th, the 72-d pose) against rgb L1 +
mask L1 + VGG-LPIPS with the model frozen, for ``pose.iters`` steps at
``pose.lr`` halved every ``pose.decay`` steps, and keeps the pose of the best
loss.  Each step is one ``gom_forward(train=True)`` (kernels B2 and B4) and
its backward (B3 and B5) differentiated into the pose only.  No step waits
for the device: the losses and the best pose stay there, and the host reads
them once per frame (``refine_frame``, the per-frame body of ``main``).
Under recording (``utils.profiling``) each frame is a span ``pose.refine``
(its position, ``iters``) around its steps and its read ``pose.read``, and
counts ``pose.steps``, ``binning.dropped`` (the entries dropped over its
steps), ``binning.most_tiles`` (the most tiles one splat covered),
``binning.budget`` (the per-splat budget) and the frame's ``frame.px`` and
``frame.swept_px`` (``binning.count_frame``).  The frames are then evaluated
with the dataset's poses (``raw``), the refined body pose without the
global transform (``zeroed``) and with it (``refined``), by
``gom_forward(train=False)`` (kernel B1) and the Anim-NeRF evaluator; the
refined poses go to ``checkpoints/pose.pkl``.
On the card the pose step and the eval frame each run as one captured
program (``programs.py``), replayed.  It runs on the card unless ``--device
cpu``; ``main`` returns a summary.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle
import time
from typing import NamedTuple

import numpy as np
import torch
from PIL import Image

from gomavatar_tpu_torch.cli.train import check_device, setup_logging
from gomavatar_tpu_torch.config import make_cfg
from gomavatar_tpu_torch.data.dataset import TrainDataset, to_device
from gomavatar_tpu_torch.eval_lib import EvaluatorSnapshot, to_8b_image
from gomavatar_tpu_torch.losses import unpack
from gomavatar_tpu_torch.models import lpips as lpips_lib
from gomavatar_tpu_torch.models.gom import eval_program, gom_forward
from gomavatar_tpu_torch.ops.mesh_ops import abs_l1
from gomavatar_tpu_torch.ops.skeleton import body_pose_to_body_RTs
from gomavatar_tpu_torch.ops.splat.binning import CHUNK, count_frame
from gomavatar_tpu_torch.ops.splat.tiled_jnp import NCMAX
from gomavatar_tpu_torch.optim import AdamState, adam_directions, init_state, tree_leaves, tree_unflatten
from gomavatar_tpu_torch.programs import Program
from gomavatar_tpu_torch.trainer import Trainer
from gomavatar_tpu_torch.utils.profiling import count, enabled, span

POSE_KEYS = ("Rh", "Th", "poses")


def frame_loss(pose_vars: dict, params: dict, statics, gom_cfg, loss_cfg: dict, lpips_params, batch: dict,
               i_iter=1e7):
    """(loss, dropped) of one frame at the pose (Rh, Th, poses), through
    the train renderer: rgb L1 + mask L1 + VGG-LPIPS, each times its
    coefficient, with the L1 terms through ``abs_l1`` (background pixels
    match their target exactly).  ``dropped``: the entries the binning
    dropped or the train kernels' chunk cap cut, a device scalar."""
    loss, tel = _frame_loss_telemetry(pose_vars, params, statics, gom_cfg, loss_cfg, lpips_params, batch, i_iter)
    return loss, _dropped(tel)


def _dropped(tel) -> torch.Tensor:
    return tel.total_dropped() + torch.clamp_min(tel.max_tile_entries - NCMAX * CHUNK, 0)


def _frame_loss_telemetry(pose_vars: dict, params: dict, statics, gom_cfg, loss_cfg: dict, lpips_params,
                          batch: dict, i_iter):
    """(loss, the binning telemetry) of :func:`frame_loss`."""
    Rh, Th, poses = (pose_vars[k] for k in POSE_KEYS)
    dst_Rs, dst_Ts = body_pose_to_body_RTs(poses, batch["dst_tpose_joints"])
    rgb, mask, aux = gom_forward(
        params, statics, gom_cfg, batch["K"], batch["E"], batch["cnl_gtfms"], dst_Rs, dst_Ts,
        dst_posevec=poses[3:] + 1e-2, i_iter=i_iter, global_R=Rh, global_T=Th, train=True, device=poses.device,
    )
    rgb_u = unpack(rgb, mask, batch["bgcolor"])
    loss = torch.mean(abs_l1(rgb_u - batch["target_rgbs"])) * loss_cfg["rgb"]["coeff"]
    loss = loss + torch.mean(abs_l1(mask - batch["target_masks"])) * loss_cfg["mask"]["coeff"]
    if lpips_params is not None and loss_cfg["lpips"]["coeff"] > 0:
        loss = loss + loss_cfg["lpips"]["coeff"] * lpips_lib.lpips(
            lpips_params, 2 * rgb_u - 1, 2 * batch["target_rgbs"] - 1
        )
    return loss, aux["binning"]


class PoseAdam:
    """``optax.adam`` under the step schedule ``lr * 0.5 ** (t // decay)``,
    where t counts the updates before this one: Adam(0.9, 0.999, 1e-8) with
    eps outside the square root, the step size a float32 product as optax
    forms it, from the device count."""

    def __init__(self, pose_cfg: dict):
        self.lr = float(np.float32(pose_cfg["lr"]))
        self.decay = int(pose_cfg["decay"])

    def init(self, leaves: list) -> AdamState:
        return init_state(leaves)

    def step_size(self, count: torch.Tensor) -> torch.Tensor:
        """-lr * 0.5 ** (count // decay), a float32 device scalar."""
        return -(torch.pow(0.5, torch.div(count, self.decay, rounding_mode="floor").to(torch.float32)) * self.lr)

    def update(self, grads: list, state: AdamState):
        """(updates, new state) for the leaves' gradients."""
        directions, count, mu, nu = adam_directions(grads, state)
        return torch._foreach_mul(directions, self.step_size(state.count)), AdamState(count, mu, nu, count)


class PoseCarry(NamedTuple):
    """The pose loop's state between steps, on the device: the variables
    (Rh, Th, poses), their Adam state, the best variables and loss so far,
    every step's loss and dropped entries at the step's index (as
    ``lax.scan`` stacks them), and the most tiles one splat covered in any
    step."""

    leaves: list
    opt: AdamState
    best: list
    best_loss: torch.Tensor
    losses: torch.Tensor
    dropped: torch.Tensor
    most_tiles: torch.Tensor


def init_pose_carry(tx: PoseAdam, init_poses: torch.Tensor, n_iters: int) -> PoseCarry:
    """The carry before a frame's first step, on the device of
    ``init_poses``: Rh = Th = 0, the poses, fresh Adam state, no best loss
    yet, ``n_iters`` rows of losses and dropped entries, no tile covered."""
    device = init_poses.device
    zeros = torch.zeros(3, dtype=torch.float32, device=device)
    leaves = [zeros, zeros.clone(), init_poses.detach().to(torch.float32)]
    return PoseCarry(
        leaves, tx.init(leaves), [t.clone() for t in leaves],
        torch.full((), float("inf"), dtype=torch.float32, device=device),
        torch.zeros((n_iters,), dtype=torch.float32, device=device),
        torch.zeros((n_iters,), dtype=torch.int32, device=device),
        torch.zeros((), dtype=torch.int32, device=device),
    )


def make_pose_step(gom_cfg, loss_cfg: dict, tx: PoseAdam):
    """One pose step as its program runs it: (params, statics, lpips_params,
    batch, carry, i_iter) -> carry, the new carry written into the one it
    was given.  The model and the LPIPS trunk are frozen inputs: the
    gradient is taken in the pose only.  The best variables are replaced only
    on a strict decrease of the loss."""

    def step(params, statics, lpips_params, batch, carry: PoseCarry, i_iter):
        params = tree_unflatten(params, [p.detach() for p in tree_leaves(params)])
        if lpips_params is not None:
            lpips_params = tree_unflatten(lpips_params, [p.detach() for p in tree_leaves(lpips_params)])
        cur = [v.detach().requires_grad_(True) for v in carry.leaves]
        loss, tel = _frame_loss_telemetry(dict(zip(POSE_KEYS, cur)), params, statics, gom_cfg, loss_cfg,
                                          lpips_params, batch, i_iter)
        drop = _dropped(tel)
        grads = torch.autograd.grad(loss, cur)
        updates, opt = tx.update(list(grads), carry.opt)
        with torch.no_grad():
            loss = loss.detach()
            improved = loss < carry.best_loss
            # this step's row of the stacked losses: its index is Adam's count
            # before the update
            row = torch.arange(carry.losses.shape[0], device=loss.device) == carry.opt.count
            new = PoseCarry(
                torch._foreach_add([c.detach() for c in cur], updates), opt,
                [torch.where(improved, c.detach(), b) for c, b in zip(cur, carry.best)],
                torch.where(improved, loss, carry.best_loss),
                torch.where(row, loss, carry.losses),
                torch.where(row, drop.to(carry.dropped.dtype), carry.dropped),
                torch.maximum(carry.most_tiles, tel.most_tiles),
            )
            torch._foreach_copy_(tree_leaves(list(carry)), tree_leaves(list(new)))
        return carry

    return step


class PoseOptimizer:
    """``optimize(params, statics, lpips_params, batch, init_poses)`` ->
    (best {Rh, Th, poses}, best loss, the loss of every step, the dropped
    entries of every step), all on the device of ``init_poses``: n_iters
    Adam steps from Rh = Th = 0, keeping the variables at which the loss was
    lowest (replaced only on a strict decrease).  The model and the LPIPS
    trunk are frozen: the gradient is taken in the pose only.  After a call
    ``most_tiles`` holds the most tiles one splat covered in its steps (a
    device scalar) and ``last`` the variables after its last update.

    The step is one program (``program``, ``programs.py``), the
    counterpart of the JAX package's jitted ``lax.scan``: on CUDA tensors
    one CUDA graph, captured at the first frame and replayed ``n_iters``
    times per frame, with no read of the host; on CPU tensors the same step
    eagerly.  The results are copies: the next frame reuses the buffers."""

    def __init__(self, gom_cfg, loss_cfg: dict, pose_cfg: dict, n_iters: int):
        self.gom_cfg, self.n_iters = gom_cfg, n_iters
        self.tx = PoseAdam(pose_cfg)
        self.program = Program(make_pose_step(gom_cfg, loss_cfg, self.tx))
        self.most_tiles = self.last = None
        self._trunk = (None, None)  # (the LPIPS params last given, them laid out)

    def __call__(self, params, statics, lpips_params, batch, init_poses):
        if lpips_params is not None:
            # the trunk's weights laid out for its device once per params given
            if self._trunk[0] is not lpips_params:
                self._trunk = (lpips_params, lpips_lib.laid_out(lpips_params))
            lpips_params = self._trunk[1]
        args = (params, statics, lpips_params, batch, init_pose_carry(self.tx, init_poses, self.n_iters), 1e7)
        for _ in range(self.n_iters):
            carry = self.program(*args)
            args = self.program.last_args  # the buffers: the next step copies nothing
        # the buffers are the next frame's: hand out copies
        self.most_tiles = carry.most_tiles.clone()
        self.last = dict(zip(POSE_KEYS, (v.clone() for v in carry.leaves)))
        return (dict(zip(POSE_KEYS, (b.clone() for b in carry.best))), carry.best_loss.clone(),
                carry.losses.clone(), carry.dropped.clone())


def make_pose_optimizer(gom_cfg, loss_cfg: dict, pose_cfg: dict, n_iters: int) -> PoseOptimizer:
    """The pose optimizer of ``n_iters`` steps a frame (:class:`PoseOptimizer`)."""
    return PoseOptimizer(gom_cfg, loss_cfg, pose_cfg, n_iters)


class RefinedPose(NamedTuple):
    """One test frame's refinement as the host reads it."""

    Rh: np.ndarray
    Th: np.ndarray
    poses: np.ndarray
    losses: np.ndarray  # every step's loss
    best_loss: float
    dropped: int  # entries dropped over the frame's steps
    most_tiles: int  # the most tiles one splat covered in them

    @property
    def first_loss(self) -> float:
        return float(self.losses[0])

    @property
    def finite(self) -> bool:
        return bool(np.isfinite(self.losses).all())


def refine_frame(optimize: PoseOptimizer, params, statics, lpips_params, batch: dict, init_pose,
                 position=None) -> RefinedPose:
    """Refine one test frame's pose from ``init_pose`` (72-d) with
    ``optimize`` and read the result on the host, the frame's one read;
    ``position`` (the frame's place in its loop) names its span."""
    n = optimize.n_iters
    with span("pose.refine", position, iters=n):
        init = torch.as_tensor(init_pose, dtype=torch.float32, device=params["vertices"].device)
        best_vars, best_loss, losses, drops = optimize(params, statics, lpips_params, batch, init)
        with span("pose.read", position):
            read = torch.cat([losses, best_loss[None], drops.sum()[None].float(), optimize.most_tiles[None].float(),
                              best_vars["Rh"], best_vars["Th"], best_vars["poses"]]).cpu().numpy()
        out = RefinedPose(read[n + 3:n + 6], read[n + 6:n + 9], read[n + 9:], read[:n], float(read[n]),
                          int(read[n + 1]), int(read[n + 2]))
        if enabled():
            count("pose.steps", n)
            count("binning.dropped", out.dropped)
            count("binning.most_tiles", out.most_tiles)
            count("binning.budget", optimize.gom_cfg.max_tiles_per_gaussian)
            count_frame(optimize.gom_cfg.img_size)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Refine the test poses of a trained avatar (gomavatar_tpu_torch).")
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--max_frames", type=int, default=None)
    ap.add_argument(
        "--dataset_path", default=None,
        help="override the test split directory, e.g. with a split whose poses carry noise "
        "(gomavatar_tpu_torch.tools.make_e2e_data --pose_noise), so that refinement has inaccurate poses to "
        "recover",
    )
    ap.add_argument("--device", default="cuda", help="torch device: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = check_device(args.device)

    cfg = make_cfg(args.cfg)
    setup_logging(cfg["save_dir"], "log_pose.txt")
    d = cfg["dataset"]["test_view"]
    dataset = TrainDataset(
        args.dataset_path or d["dataset_path"], bgcolor=cfg["bgcolor"], skip=d.get("skip", 1),
        target_size=cfg["img_size"],
    )
    trainer = Trainer(cfg, dataset.get_canonical_info(), device=device)
    trainer.load_for_eval(os.path.join(cfg["save_dir"], "checkpoints"))

    lpips_params = None
    if cfg["train"]["losses"]["lpips"]["coeff"] > 0:
        lpips_params = lpips_lib.load_lpips("vgg", device=device)[0]

    n_pose_iters = int(cfg["pose"]["iters"])
    optimize = make_pose_optimizer(trainer.gom_cfg, cfg["train"]["losses"], cfg["pose"], n_pose_iters)

    n = len(dataset) if args.max_frames is None else min(len(dataset), args.max_frames)
    bg = torch.as_tensor(np.asarray(cfg["bgcolor"], np.float32) / 255.0, device=device)
    out_dir = os.path.join(cfg["save_dir"], "eval", "test_refine")
    os.makedirs(out_dir, exist_ok=True)

    render = eval_program()

    def evaluate(tag, Rhs, Ths, poses_all):
        evaluator = EvaluatorSnapshot(device=device)
        for i in range(n):
            item = dataset[i]
            batch = to_device(item, device)
            dst_Rs, dst_Ts = body_pose_to_body_RTs(torch.as_tensor(poses_all[i], device=device),
                                                   batch["dst_tpose_joints"])
            rgb, mask, _ = render(trainer.params, trainer.statics, trainer.gom_cfg, batch["K"], batch["E"],
                                  batch["cnl_gtfms"], dst_Rs, dst_Ts, poses_all[i][3:] + 1e-2, 1e7, Rhs[i], Ths[i])
            pred = unpack(rgb, mask, bg, clamp=True).cpu().numpy()
            evaluator.evaluate(pred, np.asarray(item["target_rgbs"]))
            Image.fromarray(to_8b_image(pred)).save(os.path.join(out_dir, item["frame_name"] + f"_{tag}.png"))
        means = evaluator.summarize()
        logging.info("eval [%s]: %s", tag, {k: round(v, 4) for k, v in means.items()})
        return means

    metrics = {}
    raw_poses = np.stack([np.asarray(dataset[i]["dst_poses"], np.float32) for i in range(n)])
    zeros3 = np.zeros((n, 3), np.float32)
    metrics["raw"] = evaluate("raw", zeros3, zeros3, raw_poses)

    Rhs = np.zeros((n, 3), np.float32)
    Ths = np.zeros((n, 3), np.float32)
    best_poses = raw_poses.copy()
    first_losses, best_losses, dropped = [], [], []
    t0 = time.perf_counter()
    for i in range(n):
        batch = to_device(dataset[i], device)
        r = refine_frame(optimize, trainer.params, trainer.statics, lpips_params, batch, raw_poses[i], position=i)
        Rhs[i], Ths[i], best_poses[i] = r.Rh, r.Th, r.poses
        first_losses.append(r.first_loss)
        best_losses.append(r.best_loss)
        dropped.append(r.dropped)
        logging.info("frame %d: loss %.4f -> best %.4f", i, r.first_loss, r.best_loss)
        if r.dropped:
            logging.warning("frame %d: the binning dropped %d entries over the refinement", i, r.dropped)
    seconds = time.perf_counter() - t0

    metrics["zeroed"] = evaluate("zeroed", zeros3, zeros3, best_poses)
    metrics["refined"] = evaluate("refined", Rhs, Ths, best_poses)

    ckpt_path = os.path.join(cfg["save_dir"], "checkpoints", "pose.pkl")
    with open(ckpt_path, "wb") as f:
        pickle.dump({"Rhs": Rhs, "Ths": Ths, "dst_poses": best_poses}, f)
    logging.info("saved refined poses to %s", ckpt_path)
    return {"frames": n, "iters": n_pose_iters, "first_loss": first_losses, "best_loss": best_losses,
            "dropped": dropped, "seconds": seconds, "metrics": metrics, "pose_path": ckpt_path, "out_dir": out_dir}


if __name__ == "__main__":
    main()
