"""Test-time pose refinement at a frame of any size, such as PeopleSnapshot's
540^2 (34 x 34 tiles, the last column and row 12 px wide): the loop, the
set-up and the check of ``pose_refine.py``, with the plain reference of
any W x H (``reference/frame_any.py``, ``reference/pose_any.py``: ceil'd
tiles, the canvas cropped to the frame) for the pool's frames, the check,
and the work counts (``lib/frame_any_work.py``: the frame's own pixels, and
the LPIPS head's bytes at its five taps)."""

from __future__ import annotations

import numpy as np
import torch

from portbench.drivers import pose_refine
from portbench.drivers.pose_refine import BATCH_KEYS
from portbench.lib import frame_any_work, pose_work, scene
from portbench.lib import harness as H


class Driver(pose_refine.Driver):
    def make_frames(self) -> list:
        """The pool's frames as numpy: their inputs, the true pose and the
        reference's render over the background, at the frame's size."""
        from portbench.reference import frame_any as FA
        from portbench.reference import model as RM
        from portbench.reference.data import pose_inputs

        c, mix = self.cell, self.cell.mix
        cfg, mesh, params, meta, frame0 = c.reference_state()
        n = int(mix["pool"])
        first = int(scene.rng(c.seed, 6).integers(n))
        cj = scene.joints(meta)
        K = scene.scaled_K(frame0["K"], self.size).astype(np.float32)
        bg = torch.as_tensor(self.bg, device=self.dev)
        frames = []
        for i in range(n):
            p = scene.pose(scene.rng(c.seed, 8, i))
            E = scene.yaw(frame0["E"], 2.0 * np.pi * ((first + i) % n) / n).astype(np.float32)
            inputs = pose_inputs(p, cj.copy(), cj)
            b = {"K": torch.as_tensor(K, device=self.dev), "E": torch.as_tensor(E, device=self.dev),
                 **{k: torch.as_tensor(v, device=self.dev) for k, v in inputs.items()}}
            with torch.no_grad():
                rgb, alpha, *_ = FA.frame(params, cfg["model"], mesh, b, (self.size,) * 2, pose_work.FULL_BAND)
                img = RM.over(rgb, alpha, bg).clamp(0.0, 1.0)
            frames.append({"K": K, "E": E, "cnl_gtfms": inputs["cnl_gtfms"], "dst_tpose_joints": cj,
                           "bgcolor": self.bg, "target_rgbs": img.cpu().numpy(),
                           "target_masks": alpha.clamp(0.0, 1.0).cpu().numpy(), "poses": p})
        return frames

    def check(self, control: bool = False) -> dict:
        """The numbers compared, as ``pose_refine.Driver.check`` takes them,
        against ``reference/pose_any.py``."""
        from portbench.reference import pose_any as RP

        c = self.cell
        cfg, mesh, params, _, _ = c.reference_state()
        size = (self.size,) * 2
        steps = int(c.mix["check_steps"])

        def batch(visit):
            item = self.pool[visit % len(self.pool)]
            return {k: torch.as_tensor(item[k], device=self.dev) for k in BATCH_KEYS}

        start = torch.as_tensor(self.check_start, device=self.dev)
        args = (params, cfg["model"], cfg["train"]["losses"], cfg["pose"], mesh, self.trunk, batch(0), size, start,
                steps)
        ref = RP.refine(*args)
        if control:
            ctl = RP.refine(*args, on_tf32=True)
            losses, last = ctl["losses"], [v.cpu().numpy() for v in ctl["last"]]
        else:
            losses, last = self.check_losses, self.check_last
        init = [np.zeros(3, np.float32), np.zeros(3, np.float32), self.check_start]
        change = [torch.as_tensor(b - a) for a, b in zip(init, last)]
        ref_change = [torch.as_tensor(b.cpu().numpy() - a) for a, b in zip(init, ref["last"])]
        gaps = {"mean": 0.0, "off_1e-2": 0.0}
        for visit, (img, r) in sorted(self.kept.items()):
            pose = [torch.as_tensor(a, device=self.dev) for a in (r.Rh, r.Th, r.poses)]
            want = RP.image_at(pose, params, cfg["model"], mesh, batch(visit), size).cpu().numpy()
            got = RP.image_at(pose, params, cfg["model"], mesh, batch(visit), size, on_tf32=True).cpu().numpy() \
                if control else img
            g = H.image_gaps(got, want)
            gaps = {k: max(gaps[k], g[k]) for k in gaps}
        rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
        return {
            "loss1_rel": rel[0],
            "loss_rel": max(rel),
            "change3_leaf_gap": H.leaf_gap(change, ref_change, [True] * len(change)),
            "image_mean_abs": gaps["mean"],
            "image_off_1e-2": gaps["off_1e-2"],
        }

    def work(self) -> dict:
        """Per frame, on the frame's own pixels: the pose step's FLOPs by
        precision, the least time of B2-B5 and of the LPIPS head, times the
        frame's steps (``frame_any_work.py``), on the profiled frames (on
        the kept ones where none was profiled)."""
        c = self.cell
        cfg, mesh, params, _, _ = c.reference_state()
        frames = [self.pool[v % len(self.pool)] for v in (self.profiled or sorted(self.kept))]
        return frame_any_work.frame_work(params, cfg["model"], mesh, frames, (self.size,) * 2, self.iters, self.dev)
