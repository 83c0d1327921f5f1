"""Test-time pose refinement in a closed loop, one frame in flight, as
``cli/train_pose.py:main`` takes each test frame: the frame to the card
with the program's ``to_device``, ``refine_frame`` (``iters`` replays of
the captured pose step and the frame's one host read), then the refined
frame through the eval program, its RGB composited over the background
read back on the host.

The test frames (``pool`` of them, cycled) are the plain reference's
renders of the state, over the configuration's background, at a pose drawn
for (seed, i) and view i of a turn of ``pool`` (the first drawn from the
seed).  Each visit starts, as ``main`` does, from Rh = Th = 0 and the
frame's pose plus N(0, ``start_noise``) rad on each of its 72 values, drawn
for (seed, visit).

Set-up makes the frames (the benchmark's inputs, not counted in
``setup_s``), loads the state through the program's loader, refines the
first frame ``check_steps`` steps with a pose optimizer of that many steps
(the steps the check compares), and runs one whole frame, which captures
the pose and eval programs.  The check: the plain reference follows those
steps from the same start on the same frame (the first step's loss, each
loss, and each leaf's change over them), and renders ``sample``
seeded frames of the window's first ``sample_span`` (the last one where
fewer were run) at the pose the program refined."""

from __future__ import annotations

import numpy as np
import torch

from portbench.lib import harness as H
from portbench.lib import pose_work, scene

BATCH_KEYS = ("K", "E", "cnl_gtfms", "dst_tpose_joints", "bgcolor", "target_rgbs", "target_masks")


class Driver:
    unit = "frame"

    def __init__(self, cell: H.Cell):
        self.cell = cell
        self.dev = cell.device

    # -- set-up ------------------------------------------------------------------

    def setup(self):
        from gomavatar_tpu_torch.cli.train_pose import make_pose_optimizer, refine_frame
        from gomavatar_tpu_torch.models.gom import eval_program

        c, mix = self.cell, self.cell.mix
        self.size = c.config["frame_size"]
        self.bg = np.asarray(c.config["bgcolor"], np.float32) / 255.0
        with c.spans.span(H.INPUTS):
            self.pool = self.make_frames()
            H.reset_peak(self.dev)
        cfg = c.program_cfg()
        self.params, self.statics, self.gom_cfg = c.program_state(cfg)
        self.trunk = scene.draw_trunk(c.seed, self.dev, mix["lpips_heads"])
        self.losses_cfg, self.pose_cfg = cfg["train"]["losses"], cfg["pose"]
        self.iters = int(self.pose_cfg["iters"])
        self.refine_frame = refine_frame
        self.optimize = make_pose_optimizer(self.gom_cfg, self.losses_cfg, self.pose_cfg, self.iters)
        self.render = eval_program()
        r = scene.rng(c.seed, 10)
        self.sample = set(int(v) for v in r.choice(int(mix["sample_span"]), int(mix["sample"]), replace=False))
        self.fail = torch.zeros((), dtype=torch.int64, device=self.dev)

        # the steps the check compares, on the first frame: their losses and
        # the variables after them
        steps = int(mix["check_steps"])
        self.check_start = self.start(0)
        check = make_pose_optimizer(self.gom_cfg, self.losses_cfg, self.pose_cfg, steps)
        first = refine_frame(check, self.params, self.statics, self.trunk, self.send(0), self.check_start)
        self.check_losses = [float(v) for v in first.losses]
        self.check_last = [check.last[k].cpu().numpy() for k in ("Rh", "Th", "poses")]
        self.visits, self.kept, self.profiled = 0, {}, []
        self.frame(-1)  # a whole frame: the pose and eval programs captured
        self.visits, self.kept = 0, {}
        self.fail.zero_()

    def make_frames(self) -> list:
        """The pool's frames as numpy: their inputs, the true pose and the
        reference's render over the background."""
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
                rgb, alpha, *_ = RM.frame(params, cfg["model"], mesh, b, (self.size,) * 2, pose_work.FULL_BAND)
                img = RM.over(rgb, alpha, bg).clamp(0.0, 1.0)
            frames.append({"K": K, "E": E, "cnl_gtfms": inputs["cnl_gtfms"], "dst_tpose_joints": cj,
                           "bgcolor": self.bg, "target_rgbs": img.cpu().numpy(),
                           "target_masks": alpha.clamp(0.0, 1.0).cpu().numpy(), "poses": p})
        return frames

    def start(self, visit: int) -> np.ndarray:
        """Visit ``visit``'s start: its frame's pose plus the seeded noise."""
        c = self.cell
        noise = scene.rng(c.seed, 9, visit).normal(0.0, float(c.mix["start_noise"]), 72)
        return (self.pool[visit % len(self.pool)]["poses"] + noise).astype(np.float32)

    def send(self, visit: int) -> dict:
        from gomavatar_tpu_torch.data.dataset import to_device

        item = self.pool[visit % len(self.pool)]
        return to_device({k: item[k] for k in BATCH_KEYS}, self.dev)

    # -- the loop --------------------------------------------------------------------

    def frame(self, visit: int):
        from gomavatar_tpu_torch.losses import unpack
        from gomavatar_tpu_torch.ops.skeleton import body_pose_to_body_RTs

        sp = self.cell.spans
        v = max(visit, 0)
        if sp.profiling:
            self.profiled.append(v)
        with sp.span("send"):
            batch = self.send(v)
        with sp.span("refine"):
            r = self.refine_frame(self.optimize, self.params, self.statics, self.trunk, batch, self.start(v),
                                  position=visit)
        with sp.span("render"):
            poses = torch.as_tensor(r.poses, device=self.dev)
            Rh, Th = torch.as_tensor(r.Rh, device=self.dev), torch.as_tensor(r.Th, device=self.dev)
            dst_Rs, dst_Ts = body_pose_to_body_RTs(poses, batch["dst_tpose_joints"])
            rgb, mask, aux = self.render(self.params, self.statics, self.gom_cfg, batch["K"], batch["E"],
                                         batch["cnl_gtfms"], dst_Rs, dst_Ts, poses[3:] + 1e-2, pose_work.FULL_BAND,
                                         Rh, Th)
            tel = aux["binning"]
            self.fail += ((tel.dropped_budget + tel.dropped_buffer + aux["tile_overflow"]) > 0).to(torch.int64)
            pred = unpack(rgb, mask, batch["bgcolor"], clamp=True)
        with sp.span("read_back"):
            img = pred.cpu().numpy()
        if r.dropped > 0 or not r.finite:
            self.fail += 1
        self.last = (v, img, r)
        if visit in self.sample:
            self.kept[visit] = (img, r)
        self.visits += 1

    def run_unit(self):
        self.frame(self.visits)

    def drain(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def counts(self) -> tuple[int, int]:
        return self.visits, int(self.fail)

    def e2e(self, window_s: float, units: int) -> dict:
        return {"train_steps_per_s": units * self.iters / window_s}

    # -- the check -----------------------------------------------------------------

    def release(self):
        """Free the program's state; keep what the check reads."""
        if self.last[0] not in self.kept and len(self.kept) < len(self.sample):
            self.kept[self.last[0]] = self.last[1:]
        self.params = self.statics = self.render = self.optimize = None
        H.free_program()

    def check(self, control: bool = False) -> dict:
        """The numbers compared: the program's (or with ``control`` the
        reference in TF32 put in its place) against the plain reference."""
        from portbench.reference import pose as RP

        c = self.cell
        cfg, mesh, params, _, _ = c.reference_state()
        size = (self.size,) * 2
        steps = int(c.mix["check_steps"])

        def batch(visit):
            item = self.pool[visit % len(self.pool)]
            return {k: torch.as_tensor(item[k], device=self.dev) for k in BATCH_KEYS}

        b0 = batch(0)
        start = torch.as_tensor(self.check_start, device=self.dev)
        args = (params, cfg["model"], cfg["train"]["losses"], cfg["pose"], mesh, self.trunk, b0, size, start, steps)
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

    # -- work counts -----------------------------------------------------------------

    def work(self) -> dict:
        """Per frame: the pose step's FLOPs by precision and the least time
        of B2-B5, times the frame's steps (pose_work.py), on the profiled
        frames (on the kept ones where none was profiled)."""
        c = self.cell
        cfg, mesh, params, _, _ = c.reference_state()
        frames = [self.pool[v % len(self.pool)] for v in (self.profiled or sorted(self.kept))]
        return pose_work.frame_work(params, cfg["model"], mesh, frames, (self.size,) * 2, self.iters, self.dev)
