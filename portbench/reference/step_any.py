"""The recipe's train loss at any W x H in plain PyTorch: ``step.py``'s loss
terms over ``frame_any.py``'s frame, whose canvas is cropped to the frame
before the shading MLP, the losses and LPIPS.  The terms, their
coefficients and the L1's gradient at 0 are ``step.train_loss``'s."""

from __future__ import annotations

import torch

from portbench.reference import frame_any as FA
from portbench.reference import model as M
from portbench.reference.step import l1, lpips


def train_loss(params, model, losses_cfg, mesh, trunk, batch, img_size, i_iter):
    """(total, {term: value}, the most entries of a tile) of one frame."""
    rgb, alpha, soft, verts_obs, most = FA.frame(params, model, mesh, batch, img_size, i_iter)
    pred = M.over(rgb, alpha, batch["bgcolor"])
    gt, gt_mask = batch["target_rgbs"], batch["target_masks"]
    terms = {"rgb": (torch.mean(l1(pred - gt)), losses_cfg["rgb"]["coeff"]),
             "mask": (torch.mean(l1(alpha - gt_mask)), losses_cfg["mask"]["coeff"])}
    if losses_cfg["lpips"]["coeff"] > 0:
        terms["lpips"] = (lpips(trunk, 2.0 * pred - 1.0, 2.0 * gt - 1.0), losses_cfg["lpips"]["coeff"])
    lap = losses_cfg["laplacian"]
    for name, verts in (("canonical", params["vertices"]), ("observation", verts_obs)):
        if lap[f"coeff_{name}"] > 0:
            e = mesh.edges
            nbr = torch.zeros_like(verts).index_add(0, e[:, 0], verts[e[:, 1]]).index_add(0, e[:, 1], verts[e[:, 0]])
            d = (nbr - mesh.degree[:, None] * verts) / torch.clamp_min(mesh.degree, 1.0)[:, None]
            terms[f"laplacian_{name}"] = (torch.mean(torch.sum(d * d, dim=-1)), lap[f"coeff_{name}"])
    nrm = losses_cfg["normal"]
    if nrm["coeff_mask"] > 0:
        target = M.dilate(gt_mask, nrm.get("kernel_size", 7)) if nrm.get("mask_dilate", False) else gt_mask
        terms["normal_mask"] = (torch.mean(l1(soft - target)), nrm["coeff_mask"])
    if nrm["coeff_consist"] > 0:
        q = verts_obs[mesh.quads]
        e = q[:, 1] - q[:, 0]
        n0 = torch.cross(e, q[:, 2] - q[:, 0], dim=-1)
        n1 = -torch.cross(e, q[:, 3] - q[:, 0], dim=-1)
        cos = torch.sum(n0 * n1, -1) / (torch.linalg.norm(n0, dim=-1) * torch.linalg.norm(n1, dim=-1) + 1e-12)
        terms["normal_consist"] = (torch.mean(1.0 - cos), nrm["coeff_consist"])
    if losses_cfg["color_consist"]["coeff"] > 0:
        c = params["appearance"]["colors"]
        terms["color_consist"] = (torch.mean(l1(c[mesh.pairs[:, 0]] - c[mesh.pairs[:, 1]])),
                                  losses_cfg["color_consist"]["coeff"])
    total = torch.zeros((), device=pred.device)
    for value, coeff in terms.values():
        total = total + value * coeff
    return total, {k: v for k, (v, _) in terms.items()}, most
