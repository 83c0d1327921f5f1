"""Differentiable mesh rasterization: the hard normal pass and the soft
silhouette (port of gomavatar_tpu/ops/mesh_raster.py).

Semantics, as in the reference:
  * the pixel normal is the SUM of the winning face's three vertex normals
    (flat per face, no barycentric gradient);
  * the z-buffer uses 2D (not perspective-corrected) barycentric depth, and
    the first entry in depth-sorted order at the minimum depth wins;
  * the soft silhouette is 1 - prod(1 - sigmoid(-signed d^2 / sigma)) over
    every face binned to the pixel's tile, with d the distance to the
    triangle's boundary in pixels and the sign negative inside;
  * pixel centres sit at integer coordinates of ``fx X/Z + cx - 0.5``, as
    in the splat renderer.

``rasterize_mesh`` gathers the per-entry channels and hands them to
``mesh_raster_pallas.mesh_composite``: CUDA tensors go through kernels B4
(forward) and B5 (backward), CPU tensors through
:func:`mesh_composite_plain`, the plain PyTorch version differentiated by
autograd.  Normals get gradients from the hard pass, vertex positions from
the soft pass.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gomavatar_tpu_torch.ops.mesh_ops import gather_rows, gather_vjp
from gomavatar_tpu_torch.ops.splat.binning import CHUNK, bin_bboxes, crop_frame
from gomavatar_tpu_torch.ops.splat.tiled_jnp import NCMAX, P, tile_pixels
from gomavatar_tpu_torch.ops.transforms import mm

_Z_NEAR = 1e-5
_BIG = 1e10
NCH = 16  # entry rows: x0 y0 x1 y1 x2 y2 | z0 z1 z2 | nsum xyz | valid | pad
_ONE_MINUS = 1.0 - 1e-7
# the kernels skip a tile's later soft chunks once every pixel's sum of
# log(1 - p) is at or below this
_LOG_SAT = -18.0


class MeshRasterOut(NamedTuple):
    normal: torch.Tensor  # (H, W, 3) summed-vertex-normal map (0 where no hit)
    mask: torch.Tensor  # (H, W) hard coverage in {0, 1}
    soft_mask: torch.Tensor | None  # (H, W) sigmoid-blended silhouette


def project_mesh(verts: torch.Tensor, K: torch.Tensor, E: torch.Tensor):
    """World vertices -> (pixel xy (N, 2), camera z (N,))."""
    cam = mm(verts, E[:3, :3].T) + E[:3, 3]
    z = cam[..., 2]
    z_safe = torch.where(z > _Z_NEAR, z, torch.ones_like(z))
    x = K[0, 0] * cam[..., 0] / z_safe + K[0, 2] - 0.5
    y = K[1, 1] * cam[..., 1] / z_safe + K[1, 2] - 0.5
    return torch.stack([x, y], dim=-1), z


def project_faces(verts: torch.Tensor, faces: torch.Tensor, K: torch.Tensor, E: torch.Tensor, dual_faces=None):
    """(pixel xy (F, 3, 2), camera z (F, 3), in front (F,) bool) of each
    face's vertices; a face is in front when all three lie past the near
    plane.  ``dual_faces`` (the DualIndex of ``faces`` over the vertices)
    transposes the one vertex gather by a gather."""
    xy, z = project_mesh(verts, K, E)
    if dual_faces is None:
        tris_xy, tris_z = gather_rows(xy, faces), gather_rows(z, faces)
    else:
        trip = gather_vjp(torch.cat([xy, z[:, None]], dim=-1), faces, dual_faces)  # (F, 3, 3)
        tris_xy, tris_z = trip[..., :2], trip[..., 2]
    return tris_xy, tris_z, torch.all(tris_z > _Z_NEAR, dim=-1)


def np_log_blur(blur_sigma: float) -> float:
    """blur_radius = log(1/1e-4 - 1) * sigma (in NDC^2)."""
    return math.log(1.0 / 1e-4 - 1.0) * blur_sigma


def _point_tri_sq_dist(px, py, x0, y0, x1, y1, x2, y2):
    """Unsigned squared distance from pixels to the triangle boundary (the
    minimum over its three edge segments); operands broadcast together."""

    def seg(ax, ay, bx, by):
        abx = bx - ax
        aby = by - ay
        denom = abx * abx + aby * aby
        t = ((px - ax) * abx + (py - ay) * aby) / torch.clamp_min(denom, 1e-12)
        # minimum/maximum split the gradient at ties, as the reference's clip does
        t = torch.minimum(torch.maximum(t, torch.zeros_like(t)), torch.ones_like(t))
        dx = px - (ax + t * abx)
        dy = py - (ay + t * aby)
        return dx * dx + dy * dy

    d01 = seg(x0, y0, x1, y1)
    d12 = seg(x1, y1, x2, y2)
    d20 = seg(x2, y2, x0, y0)
    return torch.minimum(d01, torch.minimum(d12, d20))


def _chunk_terms(entries, start, count, k, px, py, sigma_px2, soft):
    """Chunk k of each tile's segment against its pixels, in the plain
    arithmetic: (entries (NCH, n, 1, CHUNK), z of each covered, valid,
    non-degenerate pair and _BIG elsewhere (n, P, CHUNK), log(1 - p) of each
    valid pair and 0 elsewhere (n, P, CHUNK), or None without ``soft``)."""
    offs = torch.clamp_max(start + k * CHUNK, entries.shape[1] - CHUNK)
    in_range = (k * CHUNK < count).to(torch.float32)[:, None, None]
    e = entries[:, offs[:, None] + torch.arange(CHUNK, device=entries.device)][:, :, None, :]
    x0, y0, x1, y1, x2, y2 = e[0], e[1], e[2], e[3], e[4], e[5]
    ev = e[12] * in_range
    # edge functions -> barycentrics
    denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
    denom_bad = torch.abs(denom) < 1e-12
    denom_safe = torch.where(denom_bad, torch.ones_like(denom), denom)
    w0 = ((y1 - y2) * (px - x2) + (x2 - x1) * (py - y2)) / denom_safe
    w1 = ((y2 - y0) * (px - x2) + (x0 - x2) * (py - y2)) / denom_safe
    w2 = 1.0 - w0 - w1  # (n, P, CHUNK)
    inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
    ok = inside & (ev > 0) & ~denom_bad
    z_px = w0 * e[6] + w1 * e[7] + w2 * e[8]
    z_cand = torch.where(ok, z_px, torch.full_like(z_px, _BIG))
    if not soft:
        return e, z_cand, None
    d2 = _point_tri_sq_dist(px, py, x0, y0, x1, y1, x2, y2)
    signed = torch.where(inside, -d2, d2)
    prob = torch.sigmoid(-signed / sigma_px2)
    prob = torch.where(ev > 0, prob, torch.zeros((), dtype=prob.dtype, device=prob.device))
    return e, z_cand, torch.log1p(-torch.minimum(prob, torch.full_like(prob, _ONE_MINUS)))


def _first_at_min(z_cand):
    """(the chunk's minimum z per pixel (n, P), the first lane that holds it)."""
    z_chunk = torch.amin(z_cand, dim=-1)
    lane = torch.arange(z_cand.shape[-1], device=z_cand.device)
    return z_chunk, torch.amin(torch.where(z_cand <= z_chunk[..., None], lane, 2 * CHUNK), dim=-1)


def mesh_composite_plain(
    entries: torch.Tensor,  # (NCH, Dp)
    tile_start: torch.Tensor,  # (T,)
    tile_count: torch.Tensor,  # (T,)
    num_tiles_x: int,
    num_tiles_y: int,
    soft: bool,
    sigma_px2: float,
    max_chunks: int = NCMAX,
):
    """Plain PyTorch B4: (hard (T, 4, P) = [normal xyz, hit], soft (T, 1, P)),
    differentiable by autograd.  The loop runs over the non-empty tiles
    together, chunk by chunk, up to the longest segment (at most
    ``max_chunks``); it has no saturation skip."""
    T = num_tiles_x * num_tiles_y
    dev = entries.device
    f32 = dict(dtype=torch.float32, device=dev)
    hard_t = torch.zeros((T, 4, P), **f32)
    soft_t = torch.zeros((T, 1, P), **f32)
    tiles = torch.nonzero(tile_count > 0).flatten()
    if tiles.numel() == 0:
        return hard_t, soft_t
    start = tile_start[tiles].long()
    count = tile_count[tiles].long()
    kmax = int(torch.clamp_max(torch.div(count + CHUNK - 1, CHUNK, rounding_mode="floor"), max_chunks).max())
    px, py = tile_pixels(tiles, num_tiles_x)
    px, py = px[:, :, None], py[:, :, None]  # (n, P, 1)

    n = tiles.shape[0]
    best_z = torch.full((n, P), _BIG, **f32)
    best_n = torch.zeros((n, 3, P), **f32)
    log_om = torch.zeros((n, P), **f32)
    for k in range(kmax):
        e, z_cand, log1m = _chunk_terms(entries, start, count, k, px, py, sigma_px2, soft)
        # hard pass: the first lane at the chunk minimum, kept on a strict <
        z_chunk, first = _first_at_min(z_cand)
        nsum = e[9:12, :, 0, :].permute(1, 0, 2)  # (n, 3, CHUNK)
        n_chunk = torch.gather(nsum, 2, first[:, None, :].expand(n, 3, P))
        better = z_chunk < best_z
        best_n = torch.where(better[:, None, :], n_chunk, best_n)
        best_z = torch.where(better, z_chunk, best_z)
        if soft:
            log_om = log_om + torch.sum(log1m, dim=-1)

    hit = (best_z < _BIG).to(torch.float32)
    hard = torch.cat([best_n * hit[:, None, :], hit[:, None, :]], dim=1)
    hard_t = hard_t.index_copy(0, tiles, hard)
    if soft:
        soft_t = soft_t.index_copy(0, tiles, (1.0 - torch.exp(log_om))[:, None, :])
    return hard_t, soft_t


@torch.no_grad()
def mesh_residuals_plain(entries, tile_start, tile_count, num_tiles_x: int, soft: bool, sigma_px2: float,
                         max_chunks: int = NCMAX):
    """Plain version of the residuals kernel B4 saves for B5: (win (T, P)
    int32, the entry index of each pixel's z-buffer winner or -1; S (T, P),
    the sum of log(1 - p) over the live soft chunks; live (T,) int32, the
    number of live soft chunks).  A tile's chunk k < min(count / CHUNK,
    max_chunks) is live while some pixel of the tile has S > ``_LOG_SAT``
    at its start, as in the kernels."""
    T, dev = tile_start.shape[0], entries.device
    win_t = torch.full((T, P), -1, dtype=torch.int32, device=dev)
    s_t = torch.zeros((T, P), dtype=torch.float32, device=dev)
    live_t = torch.zeros((T,), dtype=torch.int32, device=dev)
    tiles = torch.nonzero(tile_count > 0).flatten()
    if tiles.numel() == 0:
        return win_t, s_t, live_t
    start, count = tile_start[tiles].long(), tile_count[tiles].long()
    nchunks = torch.clamp_max(torch.div(count, CHUNK, rounding_mode="floor"), max_chunks)
    px, py = tile_pixels(tiles, num_tiles_x)
    px, py = px[:, :, None], py[:, :, None]
    best_z = torch.full(px.shape[:2], _BIG, dtype=torch.float32, device=dev)
    win = torch.full(px.shape[:2], -1, dtype=torch.int64, device=dev)
    log_om = torch.zeros_like(best_z)
    live = torch.zeros_like(start)
    for k in range(int(nchunks.max())):
        _, z_cand, log1m = _chunk_terms(entries, start, nchunks * CHUNK, k, px, py, sigma_px2, soft)
        z_chunk, first = _first_at_min(z_cand)
        better = z_chunk < best_z
        win = torch.where(better, (start + k * CHUNK)[:, None] + first, win)
        best_z = torch.where(better, z_chunk, best_z)
        if soft:
            do_soft = (k < nchunks) & (log_om.amax(dim=1) > _LOG_SAT)
            live = torch.where(do_soft, k + 1, live)
            log_om = log_om + torch.where(do_soft[:, None], log1m.sum(dim=-1), torch.zeros_like(log_om))
    return (win_t.index_copy(0, tiles, win.to(torch.int32)), s_t.index_copy(0, tiles, log_om),
            live_t.index_copy(0, tiles, live.to(torch.int32)))


def _swept_tiles(tile_start, tile_count, max_chunks):
    """(non-empty tiles, their first slot, their swept chunk counts)."""
    tiles = torch.nonzero(tile_count > 0).flatten()
    start, count = tile_start[tiles].long(), tile_count[tiles].long()
    nchunks = torch.clamp_max(torch.div(count, CHUNK, rounding_mode="floor"), max_chunks)
    return tiles, torch.div(start, CHUNK, rounding_mode="floor"), nchunks


@torch.no_grad()
def mesh_chunk_partials_plain(entries, tile_start, tile_count, num_tiles_x: int, soft: bool, sigma_px2: float,
                              max_chunks: int = NCMAX):
    """Plain version of kernel B4a: every chunk a tile sweeps, taken alone.
    Returns (z, i, s), each (Dp / CHUNK, P): the depth of the chunk's first
    eligible entry at its minimum z (_BIG where none), that entry's index
    (int32, -1 where none), and the chunk's sum of log(1 - p) over its
    valid entries (0 without ``soft``), on the slots a tile sweeps; the
    other slots hold _BIG, -1 and 0."""
    n_slots, dev = entries.shape[1] // CHUNK, entries.device
    z = torch.full((n_slots + 1, P), _BIG, dtype=torch.float32, device=dev)  # the last row takes the rest
    idx = torch.full((n_slots + 1, P), -1, dtype=torch.int32, device=dev)
    s = torch.zeros((n_slots + 1, P), dtype=torch.float32, device=dev)
    tiles, s0, nchunks = _swept_tiles(tile_start, tile_count, max_chunks)
    if tiles.numel():
        px, py = tile_pixels(tiles, num_tiles_x)
        px, py = px[:, :, None], py[:, :, None]
        for k in range(int(nchunks.max())):
            _, z_cand, log1m = _chunk_terms(entries, s0 * CHUNK, nchunks * CHUNK, k, px, py, sigma_px2, soft)
            z_chunk, first = _first_at_min(z_cand)
            slot = torch.where(k < nchunks, s0 + k, n_slots)
            z.index_copy_(0, slot, z_chunk)
            idx.index_copy_(0, slot, torch.where(z_chunk < _BIG, (s0 + k)[:, None] * CHUNK + first, -1).to(torch.int32))
            if soft:
                s.index_copy_(0, slot, log1m.sum(dim=-1))
    return z[:n_slots], idx[:n_slots], s[:n_slots]


@torch.no_grad()
def mesh_merge_plain(entries, tile_start, tile_count, partials, soft: bool, max_chunks: int = NCMAX):
    """Plain version of kernel B4b: each tile's chunk partials (z, i, s) of
    :func:`mesh_chunk_partials_plain`, merged in chunk order.  A chunk's soft
    partial is added while some pixel of the tile has S > ``_LOG_SAT`` at
    its start; the winner is the first chunk's at the minimum z (strict <
    in chunk order).  Returns (hard (T, 4, P), soft (T, 1, P), win (T, P)
    int32, S (T, P), live (T,) int32)."""
    z_part, i_part, s_part = partials
    T, dev = tile_start.shape[0], entries.device
    win_t = torch.full((T, P), -1, dtype=torch.int32, device=dev)
    s_t = torch.zeros((T, P), dtype=torch.float32, device=dev)
    live_t = torch.zeros((T,), dtype=torch.int32, device=dev)
    tiles, s0, nchunks = _swept_tiles(tile_start, tile_count, max_chunks)
    if tiles.numel():
        best_z = torch.full((tiles.numel(), P), _BIG, dtype=torch.float32, device=dev)
        win = torch.full_like(best_z, -1, dtype=torch.int32)
        log_om = torch.zeros_like(best_z)
        live = torch.zeros_like(s0)
        for k in range(int(nchunks.max())):
            in_seg = k < nchunks
            slot = torch.where(in_seg, s0 + k, 0)
            better = in_seg[:, None] & (z_part[slot] < best_z)
            win = torch.where(better, i_part[slot], win)
            best_z = torch.where(better, z_part[slot], best_z)
            if soft:
                do_soft = in_seg & (log_om.amax(dim=1) > _LOG_SAT)
                live = torch.where(do_soft, k + 1, live)
                log_om = log_om + torch.where(do_soft[:, None], s_part[slot], torch.zeros_like(log_om))
        win_t.index_copy_(0, tiles, win)
        s_t.index_copy_(0, tiles, log_om)
        live_t.index_copy_(0, tiles, live.to(torch.int32))
    hit = (win_t >= 0).to(torch.float32)
    normal = entries[9:12, win_t.clamp_min(0).long()].permute(1, 0, 2) * hit[:, None]
    soft_t = (1.0 - torch.exp(s_t))[:, None] if soft else torch.zeros_like(s_t)[:, None]
    return torch.cat([normal, hit[:, None]], dim=1), soft_t, win_t, s_t, live_t


def mesh_split_plain(entries, tile_start, tile_count, num_tiles_x: int, soft: bool, sigma_px2: float,
                     max_chunks: int = NCMAX):
    """Kernel B4 as its two launches compute it, in plain PyTorch: the chunk
    partials (B4a), then their merge in chunk order (B4b).  Returns (hard,
    soft, win, S, live) as :func:`mesh_merge_plain`."""
    partials = mesh_chunk_partials_plain(entries, tile_start, tile_count, num_tiles_x, soft, sigma_px2, max_chunks)
    return mesh_merge_plain(entries, tile_start, tile_count, partials, soft, max_chunks)


def rasterize_mesh(
    verts: torch.Tensor,
    vertex_normals: torch.Tensor,
    faces: torch.Tensor,
    K: torch.Tensor,
    E: torch.Tensor,
    img_size: tuple[int, int],
    soft_mask: bool = True,
    sigma: float = 1e-4,
    blur_sigma: float = 1e-5,
    max_tiles_per_face: int = 16,
    buffer_factor: int = 8,
    bins=None,
    dual_faces=None,
    active_cap: int | None = None,
) -> MeshRasterOut:
    """Rasterize the mesh: verts (N, 3) in world space, vertex_normals (N, 3)
    already rotated into camera space, faces (F, 3), img_size (W, H) of any
    size (the tiles' canvas is cropped to it).  ``soft_mask`` adds the
    sigmoid silhouette (training only); ``sigma`` is its temperature in
    NDC^2 and ``blur_sigma`` sets the blur radius, log(1/1e-4 - 1) *
    blur_sigma in NDC^2.  ``bins`` (a TileBinning) replaces the binning of
    the triangle boxes; ``dual_faces`` (the DualIndex of ``faces`` over the
    vertices) transposes the vertex gathers by gathers."""
    from gomavatar_tpu_torch.ops.mesh_raster_pallas import mesh_composite
    from gomavatar_tpu_torch.ops.splat.render import cap_active_tiles

    W, H = img_size
    tris_xy, tris_z, in_front = project_faces(verts, faces, K, E, dual_faces)

    if bins is None:
        # NDC spans 2 over the short side
        ndc_per_px = 2.0 / min(W, H)
        margin = (np_log_blur(blur_sigma) ** 0.5) / ndc_per_px + 1.0 if soft_mask else 1.0
        with torch.no_grad():
            bins = bin_bboxes(
                torch.amin(tris_xy[..., 0], dim=1) - margin,
                torch.amax(tris_xy[..., 0], dim=1) + margin,
                torch.amin(tris_xy[..., 1], dim=1) - margin,
                torch.amax(tris_xy[..., 1], dim=1) + margin,
                torch.amin(tris_z, dim=-1), in_front, img_size,
                max_tiles_per_primitive=max_tiles_per_face,
                buffer_factor=buffer_factor,
            )

    entries, ent_valid = mesh_entries(tris_xy, tris_z, in_front, vertex_normals, faces, bins, dual_faces)
    normal, mask, soft = (crop_frame(x, img_size) for x in mesh_composite(
        entries, ent_valid, bins.tile_start, cap_active_tiles(bins.tile_count, active_cap),
        bins.num_tiles_x, bins.num_tiles_y, soft_mask, soft_sigma_px2(sigma, img_size),
    ))
    return MeshRasterOut(normal=normal, mask=mask, soft_mask=soft if soft_mask else None)


def soft_sigma_px2(sigma: float, img_size: tuple[int, int]) -> float:
    """The soft silhouette's sigmoid temperature in px^2 (``sigma`` is in
    NDC^2, and NDC spans 2 over the short side)."""
    ndc_per_px = 2.0 / min(img_size)
    return float(sigma) / (ndc_per_px * ndc_per_px)


def mesh_entries(tris_xy, tris_z, in_front, vertex_normals, faces, bins, dual_faces=None):
    """(entries (16, Dp), entry validity (Dp,)) of kernels B4/B5: per entry
    the face's three pixel-space vertices, their depths, the summed vertex
    normal and the validity row, which holds the entry's mesh flag (keeping
    the mesh pass inside its own boxes under a union binning) times the
    face's in-front flag.  The entry gather is ``splat.render.entry_rows``;
    ``dual_faces`` as in :func:`project_faces`."""
    from gomavatar_tpu_torch.ops.splat.render import entry_rows

    nsum = (gather_rows(vertex_normals, faces) if dual_faces is None
            else gather_vjp(vertex_normals, faces, dual_faces)).sum(dim=1)
    F = faces.shape[0]
    per_face = torch.cat(
        [tris_xy.reshape(-1, 6), tris_z, nsum,
         torch.ones((F, 1), dtype=tris_xy.dtype, device=tris_xy.device),  # row 12: validity
         torch.zeros((F, NCH - 13), dtype=tris_xy.dtype, device=tris_xy.device)],
        dim=-1,
    )
    ent_valid = bins.entry_mesh * in_front[bins.entry_gauss].to(torch.float32)
    entries = entry_rows(per_face, bins).T
    return torch.cat([entries[:12], entries[12:13] * ent_valid, entries[13:]]), ent_valid
