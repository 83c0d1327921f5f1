"""What a step of the pose program needs, counted as ``work.py`` counts the
train step's: its FLOPs by precision and the least time of its splat and
mesh kernels (B2-B5), from shapes and from the reference's own binning of
the frame at its true pose, each byte once.

A pose step runs the train renderer forward and backward (B2-B5, three
times the forward's operations, as the train step), VGG's forward on the
prediction and the target and its backward into the prediction (three
forwards, as the train step), and the MLPs forward and backward into
their inputs only (two forwards; the train step also takes their weights'
gradients).  A unit of the pose mix is a frame of ``steps`` pose steps."""

from __future__ import annotations

import numpy as np
import torch

from portbench.lib import work

# the pose program's iteration: every module at its full band
FULL_BAND = 1e7
FRAME_KEYS = ("K", "E", "cnl_gtfms")


def step_flops(params: dict, pairs: dict, img_size) -> dict:
    """FLOPs of one pose step by precision."""
    W, H = img_size
    flops = {"bf16": 3 * work.vgg16_flops(H, W), "fp32": 3 * work.render_ops(pairs, soft=True)}
    if "shadow" in params:
        flops["bf16"] += 2 * work.mlp_flops(W * H, params["shadow"])
    if "non_rigid" in params:
        flops["fp32"] += 2 * work.mlp_flops(params["vertices"].shape[0], params["non_rigid"])
    if "pose_refinement" in params:
        flops["fp32"] += 2 * work.mlp_flops(1, params["pose_refinement"])
    return flops


def frame_work(params: dict, model: dict, mesh, frames: list, img_size, steps: int, device) -> dict:
    """Per frame of ``steps`` pose steps, from the mean pairs of ``frames``
    (the pose mix's frames, at their true poses): {"flops", "b2_b5_least_s",
    "step_flops", "steps", "pairs"}."""
    from portbench.reference import model as RM
    from portbench.reference.data import pose_inputs

    pairs = []
    for f in frames:
        b = {k: torch.as_tensor(f[k], device=device) for k in FRAME_KEYS}
        cj = np.asarray(f["dst_tpose_joints"], np.float32)
        b.update({k: torch.as_tensor(v, device=device) for k, v in pose_inputs(f["poses"], cj.copy(), cj).items()})
        pairs.append(work.frame_pairs(RM, params, model, mesh, b, img_size, FULL_BAND))
    mean = {k: float(np.mean([p[k] for p in pairs])) for k in pairs[0]}
    one = step_flops(params, mean, img_size)
    least = work.least_seconds(3 * work.render_ops(mean, soft=True), work.render_bytes(mean, backward=True))
    return {"flops": {k: steps * v for k, v in one.items()}, "b2_b5_least_s": steps * least, "step_flops": one,
            "steps": steps, "pairs": mean}
