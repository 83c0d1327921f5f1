"""The training loop as ``cli/train.py:train`` runs it, its body driven here
so that it stops on the clock: per epoch a seeded order of the frames, the
program's ``Prefetcher`` (its decode threads) over ``TrainDataset``,
``to_device``, ``Trainer.step`` (one replay of the captured step), and every
``log_freq`` steps the loop's one host read of the losses.  Its
TensorBoard, checkpoint and eval cadences are off.

Set-up writes the frames under TMPDIR (the plain reference's renders of
the state at each frame's pose and view; the benchmark's inputs, not
counted in ``setup_s``), loads the state through the
program's loader, and takes the first ``setup_steps`` steps through the
loop's own feed and call (the first one captures the step).  The plain
reference follows the first ``reference_steps`` of them from the same
state, on the same files."""

from __future__ import annotations

import numpy as np
import torch

from portbench.lib import harness as H
from portbench.lib import scene, work

BATCH_KEYS = ("bgcolor", "K", "E", "target_rgbs", "target_masks", "dst_Rs", "dst_Ts", "cnl_gtfms", "dst_posevec")


class Driver:
    unit = "step"

    def __init__(self, cell: H.Cell):
        self.cell = cell
        self.dev = cell.device

    # -- set-up ------------------------------------------------------------------

    def setup(self):
        from gomavatar_tpu_torch.cli.train import train_dataset
        from gomavatar_tpu_torch.trainer import Trainer

        from portbench.reference import model as RM

        c, mix = self.cell, self.cell.mix
        fr = c.config["train_frames"]
        size = c.config["frame_size"]
        with c.spans.span(H.INPUTS):
            rcfg, mesh, rparams, meta, self.frame0 = c.reference_state()
            K = torch.as_tensor(scene.scaled_K(self.frame0["K"], size), dtype=torch.float32, device=self.dev)

            @torch.no_grad()
            def render(E, pose_inputs):
                b = {"K": K, "E": torch.as_tensor(E, device=self.dev),
                     **{k: torch.as_tensor(v, device=self.dev) for k, v in pose_inputs.items()}}
                rgb, alpha, *_ = RM.frame(rparams, rcfg["model"], mesh, b, (size, size), float(c.config["iteration"]))
                return rgb, alpha

            self.cameras, self.infos, self.cj = scene.write_train_frames(
                c.tmp, c.seed, fr["count"], fr["png_size"], meta, self.frame0, fr.get("distortions"), self.dev, render)
            del rparams, mesh
            H.reset_peak(self.dev)
        cfg = c.program_cfg()
        cfg["dataset"]["train"]["dataset_path"] = c.tmp
        self.dataset = train_dataset(cfg)
        self.trunk = scene.draw_trunk(c.seed, self.dev, mix["lpips_heads"])
        params, statics, gom_cfg = c.program_state(cfg)
        self.trainer = Trainer(cfg, lpips_params=self.trunk, device=self.dev,
                               state=(params, statics, gom_cfg, int(c.config["iteration"]), int(meta["phase"])))
        self.log_freq = int(cfg["train"]["log_freq"])
        self.order_rng = scene.rng(c.seed, 1)
        self.epoch = 0
        self.items = iter(())
        self.fail = torch.zeros((), dtype=torch.int64, device=self.dev)
        self.steps = 0

        from gomavatar_tpu_torch.optim import tree_leaves

        self.init = [p.detach().clone() for p in tree_leaves(self.trainer.params)]
        self.seen = []  # (epoch, position, frame name, the program's batch) of the reference's steps
        self.prog_loss = []
        n_ref = int(mix["reference_steps"])
        for k in range(int(mix["setup_steps"])):
            total, _ = self.step(keep=k < n_ref)
            if k < n_ref:
                self.prog_loss.append(float(total))
            if k == 0:
                self.grad1 = [m.detach() / (1.0 - 0.9) for m in self.trainer.opt_state.mu]
            if k == n_ref - 1:
                self.after = [p.detach().clone() for p in tree_leaves(self.trainer.params)]
        self.drain()
        self.steps = 0
        self.fail.zero_()

    # -- the loop --------------------------------------------------------------------

    def next_item(self):
        from gomavatar_tpu_torch.data.dataset import Prefetcher
        from gomavatar_tpu_torch.parallel import rank_items

        for _ in range(2):
            try:
                return next(self.items)
            except StopIteration:
                order = self.order_rng.permutation(len(self.dataset))
                self.epoch += 1
                self.pos = -1
                self.items = iter(Prefetcher(self.dataset, order=rank_items(order, 1, 0), seed=(self.epoch, 0)))
        raise RuntimeError("the train split is empty")

    def step(self, keep: bool = False):
        from gomavatar_tpu_torch.data.dataset import to_device

        sp = self.cell.spans
        with sp.span("data_wait"):
            item = self.next_item()
            self.pos += 1
            batch = to_device(item, self.dev)
        if keep:
            self.seen.append((self.epoch, self.pos, item["frame_name"], {k: np.asarray(item[k]) for k in BATCH_KEYS}))
        with sp.span("train_step"):
            total, losses = self.trainer.step(batch)
            dropped = losses["bin_drop_budget"] + losses["bin_drop_buffer"] + losses["bin_drop_ncmax"]
            self.fail += ((dropped > 0) | ~torch.isfinite(total)).to(torch.int64)
        self.steps += 1
        if self.trainer.i_iter % self.log_freq == 0:
            with sp.span("log_read"):
                torch.stack([total.float()] + [v.float() for v in losses.values()]).tolist()
        return total, losses

    def run_unit(self):
        self.step()

    def drain(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def counts(self) -> tuple[int, int]:
        return self.steps, int(self.fail)

    def e2e(self, window_s: float, units: int) -> dict:
        return {"train_steps_per_s": units / window_s}

    # -- the check -----------------------------------------------------------------

    def release(self):
        """Free the program's state; keep what the check reads."""
        self.trainer = None
        self.items = None
        H.free_program()

    def check(self, control: bool = False) -> dict:
        """The numbers compared: the program's (or with ``control`` the
        reference in TF32 put in its place) against the plain reference."""
        from portbench.reference import data as D
        from portbench.reference.step import TrainStep, leaves

        c = self.cell
        cfg, mesh, params0, _, _ = c.reference_state()
        size = (c.config["frame_size"],) * 2
        batches, batch_gap = [], 0.0
        for epoch, pos, name, prog in self.seen:
            bg = D.background(epoch, pos) if c.config["random_bgcolor"] else np.asarray(c.config["bgcolor"], np.float32)
            ref = D.decode(c.tmp, name, self.cameras[name], self.infos[name], self.cj, size, bg)
            batch_gap = max([batch_gap] + [float(np.max(np.abs(ref[k].astype(np.float64) - prog[k])))
                                           for k in BATCH_KEYS])
            batches.append({k: torch.as_tensor(ref[k], device=self.dev) for k in BATCH_KEYS})

        def follow(tf32: bool):
            H.tf32(tf32)
            try:
                stepper = TrainStep(cfg, params0, int(c.config["iteration"]))
                params, losses = params0, []
                for k, batch in enumerate(batches):
                    params, total, _, grads, _ = stepper(params, mesh, self.trunk, batch, size)
                    losses.append(float(total))
                    if k == 0:
                        g1 = grads
                return losses, g1, [a - b for a, b in zip(leaves(params), leaves(params0))]
            finally:
                H.tf32(False)

        ref_loss, ref_g1, ref_change = follow(False)
        if control:
            loss, g1, change = follow(True)
        else:
            loss, g1 = self.prog_loss, self.grad1
            change = [a - b for a, b in zip(self.after, self.init)]
        keep = H.moving(ref_g1)
        return {
            "batch_max_abs": 0.0 if control else batch_gap,
            "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(loss, ref_loss)),
            "grad1_leaf_gap": H.leaf_gap(g1, ref_g1, keep),
            "change3_leaf_gap": H.leaf_gap(change, ref_change, keep),
        }

    # -- work counts -----------------------------------------------------------------

    def work(self) -> dict:
        """Per step: FLOPs by precision, and the least time of B2-B5 on the
        reference's frames."""
        from portbench.reference import model as RM

        c = self.cell
        cfg, mesh, params, _, _ = c.reference_state()
        size = (c.config["frame_size"],) * 2
        W, Hh = size
        pairs = [work.frame_pairs(RM, params, cfg["model"], mesh, {k: torch.as_tensor(v, device=self.dev)
                                                                    for k, v in b.items()}, size,
                                  float(c.config["iteration"])) for *_, b in self.seen]
        mean = {k: float(np.mean([p[k] for p in pairs])) for k in pairs[0]}
        n_verts = params["vertices"].shape[0]
        flops = {"bf16": 3 * work.vgg16_flops(Hh, W), "fp32": 3 * work.render_ops(mean, soft=True)}
        if "shadow" in params:
            flops["bf16"] += 3 * work.mlp_flops(W * Hh, params["shadow"])
        if "non_rigid" in params:
            flops["fp32"] += 3 * work.mlp_flops(n_verts, params["non_rigid"])
        if "pose_refinement" in params:
            flops["fp32"] += 3 * work.mlp_flops(1, params["pose_refinement"])
        least = work.least_seconds(3 * work.render_ops(mean, soft=True), work.render_bytes(mean, backward=True))
        return {"flops": flops, "b2_b5_least_s": least, "pairs": mean}
