"""Shared union-box tile binning of the train path (port of
gomavatar_tpu/ops/fused_render.py).

Every splat is pinned to a mesh face, so the splat blend and the mesh passes
sweep the same primitives over the same tiles.  :func:`frame_union_bins`
bins once by the union of the splat radius box and the triangle box (with
the soft silhouette's blur margin) and records per-entry pass flags, which
keep each pass to its own box (see ``binning.TileBinning``).
"""

from __future__ import annotations

import torch

from gomavatar_tpu_torch.ops.mesh_raster import project_faces
from gomavatar_tpu_torch.ops.splat.binning import bin_bboxes
from gomavatar_tpu_torch.ops.splat.projection import project_gaussians


def frame_union_bins(
    centroids,
    cov3d,
    verts,
    faces,
    K,
    E,
    img_size,
    blur_margin_px: float = 0.0,
    max_tiles_per_primitive: int = 16,
    buffer_factor: int = 4,
    dual_faces=None,
    band0=None,
    overflow_cap=None,
):
    """One union-box binning serving the splat blend and the mesh passes;
    ``dual_faces`` as in ``mesh_raster.project_faces``.  Returns (proj,
    tris_xy, tris_z, in_front, bins)."""
    proj = project_gaussians(centroids, cov3d, K, E, img_size)
    tris_xy, tris_z, in_front = project_faces(verts, faces, K, E, dual_faces)

    r = torch.where(proj.valid, proj.radius, torch.zeros_like(proj.radius))
    m = blur_margin_px
    sx0, sx1 = proj.mean2d[:, 0] - r, proj.mean2d[:, 0] + r
    sy0, sy1 = proj.mean2d[:, 1] - r, proj.mean2d[:, 1] + r
    mx0 = torch.amin(tris_xy[..., 0], dim=1) - m
    mx1 = torch.amax(tris_xy[..., 0], dim=1) + m
    my0 = torch.amin(tris_xy[..., 1], dim=1) - m
    my1 = torch.amax(tris_xy[..., 1], dim=1) + m
    any_valid = proj.valid | in_front

    bins = bin_bboxes(
        torch.minimum(sx0, mx0), torch.maximum(sx1, mx1),
        torch.minimum(sy0, my0), torch.maximum(sy1, my1),
        proj.depth, any_valid, img_size,
        max_tiles_per_primitive=max_tiles_per_primitive,
        buffer_factor=buffer_factor,
        flag_boxes=(
            (sx0, sx1, sy0, sy1, proj.valid),
            (mx0, mx1, my0, my1, in_front),
        ),
        band0=band0,
        overflow_cap=overflow_cap,
    )
    return proj, tris_xy, tris_z, in_front, bins
