"""Evaluation driver (port of gomavatar_tpu/cli/evaluate.py):
``--type {view, pose, train, freeview, pose_mdm}`` dispatch, checkpoint load
with the subdivision replay, per-frame render and metrics, PNG dumps.

    python -m gomavatar_tpu_torch.cli.evaluate --cfg configs/exps/zju-mocap_377.yaml \
        --type view [--iter N] [--frame_idx I] [--n_frames N] [--pose_path P] [--device cpu]

It runs on the card unless ``--device cpu``.  ``main`` returns a summary:
the checkpoint's iteration, the face count, the frames rendered, their
seconds, the entries the binning dropped and the metrics.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import pickle
import time

import numpy as np
import torch
from PIL import Image

from gomavatar_tpu_torch.cli.train import check_device, setup_logging
from gomavatar_tpu_torch.config import make_cfg
from gomavatar_tpu_torch.data.dataset import (
    FreeviewDataset,
    NewPoseDataset,
    TrainDataset,
    ZJUTestDataset,
    to_device,
)
from gomavatar_tpu_torch.eval_lib import Evaluator, EvaluatorSnapshot, to_8b_image
from gomavatar_tpu_torch.losses import unpack
from gomavatar_tpu_torch.ops.skeleton import body_pose_to_body_RTs
from gomavatar_tpu_torch.optim import tree_leaves
from gomavatar_tpu_torch.trainer import Trainer


def model_size_mb(params) -> float:
    """Total parameter bytes, in MB."""
    return sum(x.numel() * x.element_size() for x in tree_leaves(params)) / 1e6


class RenderBudgetCheck:
    """Loud per-frame check of the static binning budgets at eval.

    The budgets (max_tiles_per_gaussian, the entry-buffer cap, the
    active-tile cap, the kernel's per-tile chunk cap) can silently crop a
    close-up render; the train path reports the counters beside the losses,
    and this does the same for eval frames."""

    def __init__(self):
        self.frames_dropped = 0
        self.total_dropped = 0

    def check(self, aux: dict, frame_name: str) -> int:
        tel = aux.get("binning")
        if tel is None:
            return 0
        overflow = int(aux.get("tile_overflow", 0))
        dropped = int(tel.total_dropped()) + overflow
        if dropped:
            self.frames_dropped += 1
            self.total_dropped += dropped
            logging.warning(
                "RENDER BUDGET OVERFLOW on %s: %d entries dropped (budget=%d buffer=%d tile_overflow=%d) — the image "
                "is silently missing content; raise model.max_tiles_per_gaussian / model.active_tile_cap",
                frame_name, dropped, int(tel.dropped_budget), int(tel.dropped_buffer), overflow,
            )
        return dropped

    def summarize(self):
        if self.frames_dropped:
            logging.warning("render budget overflow on %d frames (%d entries total)", self.frames_dropped,
                            self.total_dropped)
        else:
            logging.info("render budgets: zero dropped entries on all frames")


def load_refined_poses(path: str):
    """Read a pose-refinement output (checkpoints/pose.pkl: Rhs, Ths,
    dst_poses) for re-evaluation."""
    with open(path, "rb") as f:
        d = pickle.load(f)
    return (
        np.asarray(d["Rhs"], np.float32),
        np.asarray(d["Ths"], np.float32),
        np.asarray(d["dst_poses"], np.float32),
    )


def build_dataset(cfg, args):
    """(dataset, protocol) of ``args.type``; protocol None: no ground truth."""
    t = args.type
    if t == "view":
        d = cfg["dataset"]["test_view"]
        if d.get("name", "zju-mocap") == "snapshot":
            return TrainDataset(
                args.dataset_path or d["dataset_path"], bgcolor=cfg["bgcolor"], skip=d.get("skip", 1),
                target_size=cfg["img_size"],
            ), "snapshot"
        return ZJUTestDataset(
            d["raw_dataset_path"], d["dataset_path"], test_type="view", bgcolor=cfg["bgcolor"],
            exclude_view=d.get("exclude_view", 0), skip=d.get("skip", 30),
        ), "zju"
    if t == "pose":
        d = cfg["dataset"]["test_pose"]
        return ZJUTestDataset(
            d["raw_dataset_path"], d["dataset_path"], test_type="pose", bgcolor=cfg["bgcolor"],
            skip=d.get("skip", 30),
        ), "zju"
    if t == "train":
        d = cfg["dataset"]["train"]
        return TrainDataset(
            d["dataset_path"], bgcolor=cfg["bgcolor"], skip=d.get("skip", 1), target_size=cfg["img_size"],
        ), "zju"
    if t == "freeview":
        d = cfg["dataset"]["test_freeview"]
        return FreeviewDataset(
            d["dataset_path"], frame_idx=args.frame_idx, total_frames=args.n_frames, bgcolor=cfg["bgcolor"],
            src_type=d.get("src_type", "zju_mocap"), target_size=cfg["img_size"],
        ), None
    if t == "pose_mdm":
        d = cfg["dataset"]["test_pose_mdm"]
        return NewPoseDataset(
            d["dataset_path"], args.pose_path or d["pose_path"], bgcolor=cfg["bgcolor"],
            img_size=tuple(cfg["img_size"]),
        ), None
    raise ValueError(args.type)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Evaluate a trained avatar (gomavatar_tpu_torch).")
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--type", default="view", choices=["view", "pose", "train", "freeview", "pose_mdm"])
    ap.add_argument("--iter", type=int, default=None)
    ap.add_argument("--frame_idx", type=int, default=0)
    ap.add_argument("--n_frames", type=int, default=100)
    ap.add_argument("--pose_path", default=None)
    ap.add_argument("--bgcolor", type=float, nargs=3, default=None)
    ap.add_argument("--dataset_path", default=None,
                    help="override the eval split directory (snapshot view protocol only), e.g. to evaluate the "
                    "noisy-pose test split raw and refined")
    ap.add_argument("--tag", default=None,
                    help="output name (log, eval dir, metric file) instead of --type, so that several evals of "
                    "one type do not overwrite each other")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = check_device(args.device)
    tag = args.tag or args.type

    cfg = make_cfg(args.cfg)
    cfg["model"]["eval_mode"] = True
    if args.bgcolor is not None:
        cfg["bgcolor"] = list(args.bgcolor)
    setup_logging(cfg["save_dir"], filename=f"log_eval_{tag}.txt")

    dataset, protocol = build_dataset(cfg, args)
    trainer = Trainer(cfg, dataset.get_canonical_info(), device=device)
    it = trainer.load_for_eval(os.path.join(cfg["save_dir"], "checkpoints"), args.iter)
    logging.info("loaded iter %d; model size %.2f MB", it, model_size_mb(trainer.params))

    # the novel-pose protocols switch the pose refiner off
    if args.type in ("pose", "pose_mdm") and "pose_refinement" in trainer.params:
        trainer.gom_cfg = dataclasses.replace(trainer.gom_cfg, pose_refinement=None)

    evaluator = None
    if protocol == "zju":
        evaluator = Evaluator(device=device)
    elif protocol == "snapshot":
        evaluator = EvaluatorSnapshot(device=device)

    # refined poses of a pose-refinement run (--pose_path checkpoints/pose.pkl)
    refined = None
    if args.pose_path is not None and args.type != "pose_mdm":
        refined = load_refined_poses(args.pose_path)
        if refined[0].shape[0] < len(dataset):
            raise ValueError(f"pose file has {refined[0].shape[0]} frames, dataset {len(dataset)}")
        logging.info("using refined poses from %s", args.pose_path)

    out_dir = os.path.join(cfg["save_dir"], "eval", tag)
    os.makedirs(out_dir, exist_ok=True)
    bg = torch.as_tensor(np.asarray(cfg["bgcolor"], np.float32) / 255.0, device=device)
    budget = RenderBudgetCheck()

    t0 = time.perf_counter()
    for i in range(len(dataset)):
        item = dataset[i]
        batch = to_device(item, device)
        if refined is not None:
            Rhs, Ths, poses = refined
            batch["dst_Rs"], batch["dst_Ts"] = body_pose_to_body_RTs(
                torch.as_tensor(poses[i], device=device), batch["dst_tpose_joints"]
            )
            batch["dst_posevec"] = torch.as_tensor(poses[i][3:] + 1e-2, device=device)
            batch["global_R"] = torch.as_tensor(Rhs[i], device=device)
            batch["global_T"] = torch.as_tensor(Ths[i], device=device)
        rgb, mask, aux = trainer.forward(batch)
        pred = unpack(rgb, mask, bg, clamp=True).cpu().numpy()
        budget.check(aux, item["frame_name"])
        Image.fromarray(to_8b_image(pred)).save(os.path.join(out_dir, item["frame_name"] + ".png"))
        if evaluator is not None:
            evaluator.evaluate(pred, np.asarray(item["target_rgbs"]))
        if i % 10 == 0:
            logging.info("rendered %d/%d", i, len(dataset))
    seconds = time.perf_counter() - t0
    logging.info("rendered %d frames in %.3f s (%.2f frames/s, PNG writes and metrics included)", len(dataset),
                 seconds, len(dataset) / max(seconds, 1e-9))

    budget.summarize()
    means = {}
    if evaluator is not None:
        means = evaluator.summarize(os.path.join(cfg["save_dir"], "eval", f"metric_{tag}.npy"))
        logging.info("metrics: %s", {k: round(v, 4) for k, v in means.items()})
    return {"iter": it, "num_faces": trainer.gom_cfg.num_faces, "frames": len(dataset), "seconds": seconds,
            "dropped": budget.total_dropped, "metrics": means, "out_dir": out_dir}


if __name__ == "__main__":
    main()
