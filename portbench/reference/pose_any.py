"""The pose step of test-time refinement at any W x H in plain PyTorch,
float32 with TF32 off: ``pose.py``'s loss and steps over ``frame_any.py``'s
frame, whose canvas is cropped to the frame before the shading MLP, the
losses and LPIPS.

Departures from upstream GoMAvatar's ``train_pose.py:227-284``, as
``pose.py`` lists them:
  * the render is the plain tile sweeps over a binning without a budget
    (here on the ceil'd tiles of the frame, cropped), not PyTorch3D's
    rasterizer;
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

import torch

from portbench.reference import frame_any as FA
from portbench.reference import model as M
from portbench.reference.pose import FULL_BAND, body_pose_to_body_RTs, tf32
from portbench.reference.step import adam_directions, l1, lpips


def posed_render(pose_vars: list, params, model, mesh, batch, img_size):
    """(rgb, alpha, soft silhouette, the most entries of a tile) of the
    frame at (Rh, Th, poses), the global transform applied to the posed
    vertices."""
    Rh, Th, poses = pose_vars
    dst_Rs, dst_Ts = body_pose_to_body_RTs(poses, batch["dst_tpose_joints"])
    frame = {"dst_Rs": dst_Rs, "dst_Ts": dst_Ts, "cnl_gtfms": batch["cnl_gtfms"], "dst_posevec": poses[3:] + 1e-2}
    verts = M.posed_vertices(params, model, mesh, frame, FULL_BAND) @ M.so3_exp(Rh).T + Th
    return FA.render(params, model, mesh, batch["K"], batch["E"], verts, img_size)


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
    """``steps`` pose steps from Rh = Th = 0 and ``init_pose``, as
    ``pose.refine`` takes them: {"losses", "best", "best_loss", "last",
    "grad1", "most"}."""
    with tf32(on_tf32):
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
