"""The training loss (port of gomavatar_tpu/losses.py): ``compute_loss`` over
the train forward's outputs.

Terms, each scaled by its coefficient in ``cfg["train"]["losses"]``:
  rgb L1 + mask L1 + VGG-LPIPS
  + uniform mesh Laplacian (canonical and/or observation mesh)
  + L1 of the soft silhouette vs the max-pool-dilated GT mask
  + mesh normal consistency
  + color consistency across edge-adjacent faces
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gomavatar_tpu_torch.models.lpips import lpips as lpips_fn
from gomavatar_tpu_torch.ops.mesh_ops import (
    abs_l1,
    color_consistency_loss,
    normal_consistency_loss,
    uniform_laplacian_loss_nbr,
)


def dilate_mask(mask: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Max-pool dilation of an (H, W) mask, stride 1, SAME padding, done
    separably (rows, then columns)."""
    pad = kernel_size // 2
    out = F.max_pool2d(mask[None, None], (kernel_size, 1), stride=1, padding=(pad, 0))
    return F.max_pool2d(out, (1, kernel_size), stride=1, padding=(0, pad))[0, 0]


def compute_loss(
    rgb_pred: torch.Tensor,  # (H, W, 3)
    mask_pred: torch.Tensor,  # (H, W)
    aux: dict,
    rgb_gt: torch.Tensor,
    mask_gt: torch.Tensor,
    statics,
    loss_cfg: dict,
    lpips_params=None,
):
    """Returns (total loss, dict of the unscaled per-term losses)."""
    losses = {}
    total = torch.zeros((), dtype=torch.float32, device=rgb_pred.device)

    def add(name, value, coeff):
        nonlocal total
        losses[name] = value
        total = total + value * coeff

    add("rgb", torch.mean(abs_l1(rgb_pred - rgb_gt)), loss_cfg["rgb"]["coeff"])
    add("mask", torch.mean(abs_l1(mask_pred - mask_gt)), loss_cfg["mask"]["coeff"])
    if lpips_params is not None and loss_cfg["lpips"]["coeff"] > 0:
        add("lpips", lpips_fn(lpips_params, 2.0 * rgb_pred - 1.0, 2.0 * rgb_gt - 1.0), loss_cfg["lpips"]["coeff"])

    lap = loss_cfg["laplacian"]
    for name, verts_key in (("canonical", "verts_cnl"), ("observation", "verts_obs")):
        coeff = lap[f"coeff_{name}"]
        if coeff > 0:
            add(f"laplacian_{name}", uniform_laplacian_loss_nbr(aux[verts_key], statics.nbr_table, statics.vertex_degree),
                coeff)

    nrm = loss_cfg["normal"]
    if nrm["coeff_mask"] > 0:
        gt = dilate_mask(mask_gt, nrm.get("kernel_size", 7)) if nrm.get("mask_dilate", False) else mask_gt
        add("normal_mask", torch.mean(abs_l1(aux["normal_mask"] - gt)), nrm["coeff_mask"])
    if nrm["coeff_consist"] > 0:
        add("normal_consist", normal_consistency_loss(aux["verts_obs"], statics.nc_quads, statics.dual_nc), nrm["coeff_consist"])

    cc = loss_cfg["color_consist"]
    if cc["coeff"] > 0:
        add("color_consist", color_consistency_loss(aux["colors"], statics.face_connectivity, statics.dual_conn), cc["coeff"])
    return total, losses


def unpack(rgb: torch.Tensor, mask: torch.Tensor, bgcolor: torch.Tensor, clamp: bool = False) -> torch.Tensor:
    """Composite the rendered rgb over a background color:
    rgb * mask + bg * (1 - mask), clamped to [0, 1] if asked."""
    out = rgb * mask[..., None] + bgcolor[None, None, :] * (1.0 - mask)[..., None]
    return torch.clamp(out, 0.0, 1.0) if clamp else out
