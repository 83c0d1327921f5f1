"""The pose step of test-time refinement in plain PyTorch, float32 with
TF32 off.

As the program states it (gomavatar_tpu_torch/cli/train_pose.py,
``frame_loss``, ``PoseAdam`` and ``make_pose_step``, at commit ebbc068):
the only leaves are the global rotation ``Rh`` and translation ``Th`` (3
each) and the 72-d pose; the model and the LPIPS trunk are frozen.  The
loss is rgb L1 + mask L1 + VGG-LPIPS, each times its coefficient, of the
frame at the pose through ``model.py``'s posing and render (``frame``
with the global transform applied to the posed vertices between the two),
the forward kinematics written out below.  Adam(0.9, 0.999, 1e-8), eps
outside the square root, at the step size ``lr * 0.5 ** (t // decay)``
with t the updates before this one; the variables of the lowest loss are
kept, replaced only on a strict decrease.

Departures from upstream GoMAvatar's ``train_pose.py:227-284``:
  * the render is ``model.py``'s tile sweeps over a binning without a
    budget, not PyTorch3D's rasterizer (as the train step, ``step.py``);
  * the LPIPS trunk is VGG16 with its convolutions in bfloat16 and its
    weights drawn from the seed (``step.py:lpips``), not the pretrained
    float32 network;
  * the L1 terms take the gradient +1 at 0 (``step.py:l1``), where
    ``torch.abs`` takes 0: background pixels that match their target
    exactly;
  * the modules run at their full band (the program's iteration 1e7);
  * only the steps the check compares are taken, not the protocol's 300.
"""

from __future__ import annotations

import contextlib

import torch

from portbench.reference import model as M
from portbench.reference.step import adam_directions, l1, lpips

POSE_KEYS = ("Rh", "Th", "poses")
FULL_BAND = 1e7


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 in float32 matmuls and convolutions ``on`` inside the block (off
    is what this module computes in; on is the control), as it was after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def body_pose_to_body_RTs(poses, tpose_joints):
    """(J, 3, 3) local rotations and (J, 3) offsets of a 72-d pose: the root
    keeps its T-pose position, each child its offset from its parent."""
    R = M.so3_exp(poses.reshape(-1, 3))
    parent = torch.tensor(M.SMPL_PARENT[:R.shape[0]], device=poses.device)
    T = torch.cat([tpose_joints[:1], (tpose_joints - tpose_joints[parent])[1:]])
    return R, T


def posed_render(pose_vars: list, params, model, mesh, batch, img_size):
    """(rgb, alpha, soft silhouette, the most entries of a tile) of the
    frame at (Rh, Th, poses): ``model.frame`` with the global transform
    applied to the posed vertices."""
    Rh, Th, poses = pose_vars
    dst_Rs, dst_Ts = body_pose_to_body_RTs(poses, batch["dst_tpose_joints"])
    frame = {"dst_Rs": dst_Rs, "dst_Ts": dst_Ts, "cnl_gtfms": batch["cnl_gtfms"], "dst_posevec": poses[3:] + 1e-2}
    verts = M.posed_vertices(params, model, mesh, frame, FULL_BAND) @ M.so3_exp(Rh).T + Th
    return M.render(params, model, mesh, batch["K"], batch["E"], verts, img_size)


@torch.no_grad()
def image_at(pose_vars: list, params, model, mesh, batch, img_size, on_tf32: bool = False):
    """The frame at (Rh, Th, poses) over the batch's background, in [0, 1]."""
    with tf32(on_tf32):
        rgb, alpha, _, _ = posed_render(pose_vars, params, model, mesh, batch, img_size)
        return M.over(rgb, alpha, batch["bgcolor"]).clamp(0.0, 1.0)


def pose_loss(pose_vars: list, params, model, losses_cfg, mesh, trunk, batch, img_size):
    """(loss, the most entries of a tile) of the frame at (Rh, Th, poses)."""
    rgb, alpha, _, most = posed_render(pose_vars, params, model, mesh, batch, img_size)
    pred = M.over(rgb, alpha, batch["bgcolor"])
    gt = batch["target_rgbs"]
    loss = torch.mean(l1(pred - gt)) * losses_cfg["rgb"]["coeff"]
    loss = loss + torch.mean(l1(alpha - batch["target_masks"])) * losses_cfg["mask"]["coeff"]
    if trunk is not None and losses_cfg["lpips"]["coeff"] > 0:
        loss = loss + losses_cfg["lpips"]["coeff"] * lpips(trunk, 2.0 * pred - 1.0, 2.0 * gt - 1.0)
    return loss, most


def refine(params, model, losses_cfg, pose_cfg, mesh, trunk, batch, img_size, init_pose, steps: int,
           on_tf32: bool = False) -> dict:
    """``steps`` pose steps from Rh = Th = 0 and ``init_pose`` (TF32 off,
    or on with ``on_tf32``, the control): {"losses": each step's loss,
    "best": [Rh, Th, poses] of the lowest, "best_loss", "last": the
    variables after the last update, "grad1": the first step's gradients,
    "most": the most entries of a tile in any step}."""
    with tf32(on_tf32):
        return _refine(params, model, losses_cfg, pose_cfg, mesh, trunk, batch, img_size, init_pose, steps)


def _refine(params, model, losses_cfg, pose_cfg, mesh, trunk, batch, img_size, init_pose, steps):
    zeros = torch.zeros(3, dtype=torch.float32, device=init_pose.device)
    cur = [zeros, zeros.clone(), init_pose.detach().to(torch.float32)]
    state = {"count": 0, "mu": [torch.zeros_like(v) for v in cur], "nu": [torch.zeros_like(v) for v in cur]}
    lr, decay = float(pose_cfg["lr"]), int(pose_cfg["decay"])
    out = {"losses": [], "best": [v.clone() for v in cur], "best_loss": float("inf"), "grad1": None, "most": 0}
    for t in range(steps):
        leaves = [v.detach().requires_grad_(True) for v in cur]
        loss, most = pose_loss(leaves, params, model, losses_cfg, mesh, trunk, batch, img_size)
        grads = torch.autograd.grad(loss, leaves)
        dirs, state = adam_directions(list(grads), state)
        size = torch.tensor(-lr * 0.5 ** (t // decay), dtype=torch.float32, device=init_pose.device)
        value = float(loss.detach())
        out["losses"].append(value)
        out["most"] = max(out["most"], most)
        if t == 0:
            out["grad1"] = [g.detach() for g in grads]
        if value < out["best_loss"]:
            out["best_loss"], out["best"] = value, [v.detach().clone() for v in leaves]
        with torch.no_grad():
            cur = [v.detach() + d * size for v, d in zip(leaves, dirs)]
    out["last"] = cur
    return out
