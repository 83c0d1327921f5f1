"""Brute-force per-pixel splat renderer, the golden oracle of the tests (port
of gomavatar_tpu/ops/splat/reference.py).

It materialises the full (pixels x gaussians) alpha matrix, so it is only
usable at test sizes.  Semantics of the CUDA ``diff_gaussian_rasterization``
forward: depth-ordered front-to-back compositing, alpha clamped to 0.99,
contributions below 1/255 skipped, and a pixel stops taking contributions
once its transmittance would fall below 1e-4.  The constants are shared with
every splat kernel of the package.
"""

from __future__ import annotations

import torch

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4


def composite_alpha(mean2d, conic, opacity, px, py, radius=None, tile=16):
    """Alpha of each gaussian at each pixel: (P pixels, N gaussians).  With
    ``radius``, contributions are cut at tile granularity outside each
    gaussian's radius box, as the tile-binned renderers cut them."""
    dx = px[:, None] - mean2d[None, :, 0]
    dy = py[:, None] - mean2d[None, :, 1]
    power = (
        -0.5 * (conic[None, :, 0] * dx * dx + conic[None, :, 2] * dy * dy)
        - conic[None, :, 1] * dx * dy
    )
    zero = torch.zeros((), dtype=power.dtype, device=power.device)
    alpha = torch.clamp_max(opacity[None, :] * torch.exp(power), ALPHA_MAX)
    alpha = torch.where(power > 0.0, zero, alpha)
    alpha = torch.where(alpha < ALPHA_MIN, zero, alpha)
    if radius is not None:
        ptx = torch.floor(px / tile)[:, None]
        pty = torch.floor(py / tile)[:, None]
        tx0 = torch.floor((mean2d[None, :, 0] - radius[None, :]) / tile)
        tx1 = torch.floor((mean2d[None, :, 0] + radius[None, :]) / tile)
        ty0 = torch.floor((mean2d[None, :, 1] - radius[None, :]) / tile)
        ty1 = torch.floor((mean2d[None, :, 1] + radius[None, :]) / tile)
        covered = (ptx >= tx0) & (ptx <= tx1) & (pty >= ty0) & (pty <= ty1)
        alpha = torch.where(covered, alpha, zero)
    return alpha


def render_reference(proj, colors: torch.Tensor, opacity: torch.Tensor, img_size: tuple[int, int]):
    """(H, W, C) image and (H, W) alpha by brute force; ``proj`` is a
    ProjectedGaussians, colors (N, C), opacity (N,), img_size (W, H)."""
    from gomavatar_tpu_torch.ops.splat.binning import depth_sort_bits

    W, H = img_size
    # depth order with the binning's quantised key, invalid gaussians last,
    # so that ties break as in the tiled renderers
    depth_key = torch.where(proj.valid, depth_sort_bits(proj.depth), torch.full_like(proj.depth, 0xFFFFFFFF, dtype=torch.int64))
    order = torch.argsort(depth_key, stable=True)
    mean2d = proj.mean2d[order]
    conic = proj.conic[order]
    cols = colors[order]
    op = torch.where(proj.valid, opacity, torch.zeros_like(opacity))[order]
    radius = proj.radius[order]

    dev = mean2d.device
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=dev), torch.arange(W, dtype=torch.float32, device=dev),
        indexing="ij",
    )
    alpha = composite_alpha(mean2d, conic, op, xs.reshape(-1), ys.reshape(-1), radius=radius)  # (P, N)
    # a gaussian whose blend would push T below 1e-4 is dropped, as is all
    # behind it: drop every entry whose INCLUSIVE transmittance is below
    log1m = torch.log1p(-alpha)
    cum = torch.cumsum(log1m, dim=1)
    T_incl = torch.exp(cum)
    T_excl = torch.exp(cum - log1m)
    w = torch.where(T_incl < T_EPS, torch.zeros_like(alpha), T_excl * alpha)
    img = w @ cols
    acc = torch.sum(w, dim=1)
    return img.reshape(H, W, -1), acc.reshape(H, W)
