"""Tiled splat compositing in plain PyTorch: the plain version of kernels B2
(forward) and B3 (backward), differentiated by autograd (port of
gomavatar_tpu/ops/splat/tiled_jnp.py).

Same tile/chunk structure and math as the kernels: per tile, a loop over
128-entry chunks of its segment; per chunk, alpha (entries x pixels), the
log-space cumulative transmittance, and the blend weights
w = T_excl * alpha, zero once the inclusive transmittance is below 1e-4.
The loop runs over the non-empty tiles together and stops at the longest
segment (at most ``max_chunks``), which gives the reference's result: its
later chunks are masked to zero.
"""

from __future__ import annotations

import torch

from gomavatar_tpu_torch.ops.splat.binning import CHUNK, TILE
from gomavatar_tpu_torch.ops.splat.reference import ALPHA_MAX, ALPHA_MIN, T_EPS

P = TILE * TILE
NCMAX = 64  # max CHUNK-sized chunks a tile ingests


def chunk_alpha(mean2d, conic, opacity, px, py):
    """Alpha of (n, CHUNK) entries at (n, P) pixels: (n, CHUNK, P)."""
    dx = px[:, None, :] - mean2d[..., 0:1]
    dy = py[:, None, :] - mean2d[..., 1:2]
    power = (
        -0.5 * (conic[..., 0:1] * dx * dx + conic[..., 2:3] * dy * dy)
        - conic[..., 1:2] * dx * dy
    )
    zero = torch.zeros((), dtype=power.dtype, device=power.device)
    alpha = torch.clamp_max(opacity[..., None] * torch.exp(power), ALPHA_MAX)
    alpha = torch.where(power > 0.0, zero, alpha)
    return torch.where(alpha < ALPHA_MIN, zero, alpha)


def tile_pixels(tiles: torch.Tensor, num_tiles_x: int):
    """Image pixel coordinates (n, P) of tiles, row-major within the tile."""
    lin = torch.arange(P, device=tiles.device)
    px = (tiles % num_tiles_x * TILE)[:, None] + lin % TILE
    py = (torch.div(tiles, num_tiles_x, rounding_mode="floor") * TILE)[:, None] + torch.div(
        lin, TILE, rounding_mode="floor"
    )
    return px.to(torch.float32), py.to(torch.float32)


def composite_tiles_plain(
    entry_mean2d: torch.Tensor,  # (Dp, 2)
    entry_conic: torch.Tensor,  # (Dp, 3)
    entry_color: torch.Tensor,  # (Dp, C)
    entry_opacity: torch.Tensor,  # (Dp,) already gated by the entry's flags
    tile_start: torch.Tensor,  # (T,)
    tile_count: torch.Tensor,  # (T,)
    num_tiles_x: int,
    num_tiles_y: int,
    max_chunks: int = NCMAX,
):
    """Composite all tiles: (color (T, C, P), alpha (T, 1, P)) per tile."""
    T = num_tiles_x * num_tiles_y
    C = entry_color.shape[-1]
    Dp = entry_mean2d.shape[0]
    dev = entry_mean2d.device
    f32 = dict(dtype=torch.float32, device=dev)
    color_t = torch.zeros((T, C, P), **f32)
    alpha_t = torch.zeros((T, 1, P), **f32)
    tiles = torch.nonzero(tile_count > 0).flatten()
    if tiles.numel() == 0:
        return color_t, alpha_t
    start = tile_start[tiles].long()
    count = tile_count[tiles].long()
    nchunks = torch.clamp_max(torch.div(count + CHUNK - 1, CHUNK, rounding_mode="floor"), max_chunks)
    kmax = int(nchunks.max())
    px, py = tile_pixels(tiles, num_tiles_x)
    lane = torch.arange(CHUNK, device=dev)

    n = tiles.shape[0]
    log_T = torch.zeros((n, P), **f32)
    color_acc = torch.zeros((n, C, P), **f32)
    alpha_acc = torch.zeros((n, P), **f32)
    for k in range(kmax):
        offs = torch.clamp_max(start + k * CHUNK, Dp - CHUNK)
        in_range = (k * CHUNK < count).to(torch.float32)[:, None]
        idx = offs[:, None] + lane  # (n, CHUNK)
        alpha = chunk_alpha(entry_mean2d[idx], entry_conic[idx], entry_opacity[idx] * in_range, px, py)
        log1m = torch.log1p(-alpha)
        cum = torch.cumsum(log1m, dim=1) + log_T[:, None, :]
        T_incl = torch.exp(cum)
        T_excl = torch.exp(cum - log1m)
        w = torch.where(T_incl < T_EPS, torch.zeros_like(alpha), T_excl * alpha)  # (n, CHUNK, P)
        color_acc = color_acc + torch.einsum("nec,nep->ncp", entry_color[idx], w)
        alpha_acc = alpha_acc + torch.sum(w, dim=1)
        log_T = cum[:, -1]
    color_t = color_t.index_copy(0, tiles, color_acc)
    alpha_t = alpha_t.index_copy(0, tiles, alpha_acc[:, None, :])
    return color_t, alpha_t
