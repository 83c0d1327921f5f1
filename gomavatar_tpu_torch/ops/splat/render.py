"""Differentiable Gaussian splat renderer: project -> tile-bin -> composite
(port of gomavatar_tpu/ops/splat/render.py).

``implementation``:
  * 'auto'      -- by device: CUDA tensors go through kernels B2/B3, CPU
                   tensors through their plain PyTorch version;
  * 'reference' -- the brute-force per-pixel oracle (tests only).
"""

from __future__ import annotations

import torch

from gomavatar_tpu_torch.ops.mesh_ops import gather_rows, gather_vjp
from gomavatar_tpu_torch.ops.splat import binning as _binning
from gomavatar_tpu_torch.ops.splat.pallas_kernel import composite_tiles, pack_gaussian_channels
from gomavatar_tpu_torch.ops.splat.projection import project_gaussians
from gomavatar_tpu_torch.ops.splat.reference import render_reference


def cap_active_tiles(tile_count: torch.Tensor, active_cap: int | None) -> torch.Tensor:
    """Counts with every non-empty tile beyond the first ``active_cap``
    emptied: such tiles render empty with zero gradients (the binning
    telemetry counts their entries as dropped)."""
    if active_cap is None:
        return tile_count
    rank = torch.cumsum((tile_count > 0).to(torch.int32), 0) - 1
    return torch.where(rank < active_cap, tile_count, torch.zeros_like(tile_count))


def entry_rows(per_prim: torch.Tensor, bins) -> torch.Tensor:
    """(Dp, C) rows of ``per_prim`` (N, C) by ``bins.entry_gauss``: their
    transpose (each primitive's sum of its entries' gradients) is a gather
    over ``bins.entry_dual`` where the binning has one, else an
    ``index_add``."""
    if bins.entry_dual is None:
        return gather_rows(per_prim, bins.entry_gauss)
    return gather_vjp(per_prim, bins.entry_gauss, bins.entry_dual)


def gaussian_entries(proj, colors: torch.Tensor, opacity: torch.Tensor, bins) -> torch.Tensor:
    """The (NCH_pad, Dp) entry matrix of kernels B2/B3: the per-gaussian
    channels gathered per entry (:func:`entry_rows`), the opacity row gated
    by the entry's splat flag, so a union binning keeps the splat pass
    inside its own radius boxes."""
    op_eff = torch.where(proj.valid, opacity, torch.zeros_like(opacity))
    entries = entry_rows(pack_gaussian_channels(proj.mean2d, proj.conic, op_eff, colors), bins).T
    return torch.cat([entries[:5], entries[5:6] * bins.entry_splat, entries[6:]])


def render_gaussians(
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    colors: torch.Tensor,
    opacity: torch.Tensor,
    K: torch.Tensor,
    E: torch.Tensor,
    img_size: tuple[int, int],
    bg_color: torch.Tensor | None = None,
    implementation: str = "auto",
    max_tiles_per_gaussian: int = 32,
    buffer_factor: int = 8,
    bins=None,
    active_cap: int | None = None,
):
    """Render gaussians (means3d (N, 3), cov3d (N, 3, 3), colors (N, C),
    opacity (N,)) with K (3, 3) and world->camera E (4, 4) into
    (img (H, W, C), alpha (H, W)); ``bg_color`` (C,) is composited against
    the residual transmittance.  ``bins`` (a TileBinning) replaces the
    binning of the radius boxes."""
    proj = project_gaussians(means3d, cov3d, K, E, img_size)

    if implementation == "reference":
        img, alpha = render_reference(proj, colors, torch.where(proj.valid, opacity, torch.zeros_like(opacity)), img_size)
    elif implementation == "auto":
        if bins is None:
            with torch.no_grad():
                bins = _binning.bin_gaussians(
                    proj.mean2d, proj.radius, proj.depth, proj.valid, img_size,
                    max_tiles_per_gaussian=max_tiles_per_gaussian, buffer_factor=buffer_factor,
                )
        img, alpha = composite_tiles(
            gaussian_entries(proj, colors, opacity, bins), bins.entry_valid, bins.tile_start,
            cap_active_tiles(bins.tile_count, active_cap),
            colors.shape[-1], bins.num_tiles_x, bins.num_tiles_y,
        )
        img, alpha = _binning.crop_frame(img, img_size), _binning.crop_frame(alpha, img_size)
    else:
        raise ValueError(f"unknown implementation: {implementation}")

    if bg_color is not None:
        img = img + bg_color[None, None, :] * (1.0 - alpha)[..., None]
    return img, alpha
