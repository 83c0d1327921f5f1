"""Novel views and poses in a closed loop: each frame's camera and pose go
to the card with the program's ``to_device``, through the eval program
(``models/gom.py:eval_program``, one replay of the captured frame), and
its RGB, composited over the background as ``cli/evaluate.py`` takes it,
comes back to host memory before the next frame is sent.

Frame i is view (start + i) of a turn of ``views_per_turn`` (start drawn
from the seed) at a pose drawn for (seed, i mod ``pool``); the ``pool``
frames' inputs are made in set-up.  The check renders a seeded sample of
the window's frames and its last one with the plain reference."""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.lib import harness as H
from portbench.lib import scene, work

FRAME_KEYS = ("K", "E", "cnl_gtfms", "dst_Rs", "dst_Ts", "dst_posevec")


class Driver:
    unit = "frame"

    def __init__(self, cell: H.Cell):
        self.cell = cell
        self.dev = cell.device

    def frame_inputs(self, i: int) -> dict:
        return self.pool[i % len(self.pool)]

    def setup(self):
        from gomavatar_tpu_torch.models.gom import eval_program

        c, mix = self.cell, self.cell.mix
        with c.spans.span(H.INPUTS):
            meta, _, frame0 = scene.load_state(c.config["state"], "cpu")
            views = int(mix["views_per_turn"])
            start = int(scene.rng(c.seed, 6).integers(views))
            self.pool = [scene.view_frame(c.seed, i, views, start, meta, frame0, c.config["frame_size"])
                         for i in range(int(mix["pool"]))]
        cfg = c.program_cfg()
        self.params, self.statics, self.gom_cfg = c.program_state(cfg)
        self.i_iter = float(c.config["iteration"])
        self.bg = torch.as_tensor(np.asarray(c.config["bgcolor"], np.float32) / 255.0, device=self.dev)
        self.render = eval_program()
        r = scene.rng(c.seed, 7)
        self.sample = set(int(v) for v in r.choice(int(mix["sample_span"]), int(mix["sample"]), replace=False))
        self.kept: dict[int, np.ndarray] = {}
        self.fail = torch.zeros((), dtype=torch.int64, device=self.dev)
        self.frames, self.latency = 0, []
        self.frame(-1)  # warm-up and capture, on a frame of the pool
        self.frames, self.latency, self.kept = 0, [], {}
        self.fail.zero_()

    def frame(self, i: int):
        from gomavatar_tpu_torch.data.dataset import to_device
        from gomavatar_tpu_torch.losses import unpack

        sp = self.cell.spans
        t0 = time.perf_counter()
        item = self.frame_inputs(i)
        with sp.span("send"):
            b = to_device({k: item[k] for k in FRAME_KEYS}, self.dev)
        with sp.span("render"):
            rgb, mask, aux = self.render(self.params, self.statics, self.gom_cfg, b["K"], b["E"], b["cnl_gtfms"],
                                         b["dst_Rs"], b["dst_Ts"], b["dst_posevec"], self.i_iter, None, None)
            tel = aux["binning"]
            self.fail += ((tel.dropped_budget + tel.dropped_buffer + aux["tile_overflow"]) > 0).to(torch.int64)
            pred = unpack(rgb, mask, self.bg, clamp=True)
        with sp.span("read_back"):
            img = pred.cpu().numpy()
        self.latency.append(time.perf_counter() - t0)
        if i in self.sample:
            self.kept[i] = img
        self.last = (i, img)
        self.frames += 1

    def run_unit(self):
        self.frame(self.frames)

    def drain(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def counts(self) -> tuple[int, int]:
        return self.frames, int(self.fail)

    def e2e(self, window_s: float, units: int) -> dict:
        return {"render_frames_per_s": units / window_s,
                "render_ms_p95": 1e3 * float(np.percentile(np.asarray(self.latency), 95))}

    def release(self):
        self.kept[self.last[0]] = self.last[1]
        self.params = self.statics = self.render = None
        H.free_program()

    def reference_frames(self):
        """(index, reference inputs on the device) of the frames the check renders."""
        for i in sorted(self.kept):
            yield i, {k: torch.as_tensor(v, device=self.dev) for k, v in self.frame_inputs(i).items()
                      if k in FRAME_KEYS}

    def check(self, control: bool = False) -> dict:
        from portbench.reference import model as RM

        c = self.cell
        cfg, mesh, params, _, _ = c.reference_state()
        size = (c.config["frame_size"],) * 2
        gaps = {"mean": 0.0, "off_1e-2": 0.0}
        for i, batch in self.reference_frames():
            imgs = []
            for tf in ([False, True] if control else [False]):
                H.tf32(tf)
                try:
                    with torch.no_grad():
                        rgb, alpha, *_ = RM.frame(params, cfg["model"], mesh, batch, size, self.i_iter)
                    imgs.append(RM.over(rgb, alpha, self.bg).clamp(0.0, 1.0).cpu().numpy())
                finally:
                    H.tf32(False)
            g = H.image_gaps(imgs[1] if control else self.kept[i], imgs[0])
            gaps = {k: max(gaps[k], g[k]) for k in gaps}
        return {"image_mean_abs": gaps["mean"], "image_off_1e-2": gaps["off_1e-2"]}

    def work(self) -> dict:
        from portbench.reference import model as RM

        c = self.cell
        cfg, mesh, params, _, _ = c.reference_state()
        size = (c.config["frame_size"],) * 2
        pairs = [work.frame_pairs(RM, params, cfg["model"], mesh, b, size, self.i_iter)
                 for _, b in self.reference_frames()]
        mean = {k: float(np.mean([p[k] for p in pairs])) for k in pairs[0]}
        flops = {"bf16": 0.0, "fp32": work.render_ops(mean, soft=False)}
        if "shadow" in params:
            flops["bf16"] += work.mlp_flops(mean["faces"] + 1, params["shadow"])
        if "non_rigid" in params:
            flops["fp32"] += work.mlp_flops(params["vertices"].shape[0], params["non_rigid"])
        if "pose_refinement" in params:
            flops["fp32"] += work.mlp_flops(1, params["pose_refinement"])
        least = work.least_seconds(work.render_ops(mean, soft=False), work.render_bytes(mean, backward=False))
        return {"flops": flops, "b1_least_s": least, "pairs": mean}
