"""The avatar's frame at any W x H in plain PyTorch, float32: ``model.py``'s
frame on a whole-tile canvas, cropped to the frame.

What does not depend on the frame's size is ``model.py``'s own (posing,
the per-face geometry, the EWA projection, the binning, the sweeps).  What
this module adds, for a side that is not a multiple of 16:

  * the tiles are ceil(W / 16) x ceil(H / 16): ``model.union_bins`` bins on
    the whole-tile canvas, so a box that runs past the frame is clamped
    into the last, partial tile, as it is into the last tile of a
    whole-tile frame;
  * the sweeps cover the canvas, and its rows and columns past the frame
    are cut off before anything reads them: the shading MLP, the losses
    and LPIPS see the W x H frame alone;
  * every scalar derived from the frame's size comes from the true W and
    H: the EWA projection's clamp 1.3 (0.5 W / fx) and its cull, the NDC
    pixel scale 2 / min(W, H), the soft silhouette's blur margin and its
    temperature.

At a whole-tile size it is ``model.render`` operation for operation.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import model as M
from portbench.reference.model import (  # noqa: F401  (the names work.frame_pairs reads)
    CHUNK, NCMAX, P, T_EPS, TILE, chunk_alpha, covariances, posed_vertices, project_gaussians, project_triangles,
    tile_pixels,
)


def canvas(img_size) -> tuple[int, int]:
    """(Wc, Hc): the whole tiles that cover a (W, H) frame, in pixels."""
    W, H = img_size
    return TILE * -(-int(W) // TILE), TILE * -(-int(H) // TILE)


def crop(x, img_size):
    """The (H, W, ...) frame of a (Hc, Wc, ...) canvas."""
    W, H = img_size
    return x[:H, :W]


def blur_margin(model, img_size) -> float:
    """The soft silhouette's blur radius in pixels, plus one: NDC spans 2
    over the frame's short side."""
    W, H = img_size
    return math.sqrt(math.log(1.0 / 1e-4 - 1.0) * model["normal_renderer"]["sigma"]) / (2.0 / min(W, H)) + 1.0


@torch.no_grad()
def union_bins(mean2d, radius, valid, depth, xy, in_front, img_size, margin):
    """``model.union_bins`` on the canvas of a (W, H) frame: its TX and TY
    are ceil(W / 16) and ceil(H / 16)."""
    return M.union_bins(mean2d, radius, valid, depth, xy, in_front, canvas(img_size), margin)


def render(params, model, mesh, K, E, verts_obs, img_size):
    """(rgb (H, W, 3) before the background, alpha (H, W), soft silhouette
    (H, W), the most entries of a tile) of one frame of ``img_size`` = (W,
    H)."""
    W, H = img_size
    faces = mesh.faces
    tri = verts_obs[faces]
    cov = covariances(tri, params["so3"], params["scale"], model["canonical_geometry"]["sigma"])
    cross = torch.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], dim=-1)
    vn = torch.sum(cross[mesh.vf_inc] * mesh.vf_valid[..., None], dim=1)
    vn = vn / (torch.linalg.norm(vn, dim=-1, keepdim=True) + 1e-12)
    nsum = (vn @ E[:3, :3].T)[faces].sum(dim=1)
    mean2d, conic, depth, radius, valid = project_gaussians(tri.mean(dim=1), cov, K, E, img_size)
    xy, z, in_front = project_triangles(tri, K, E)
    e_face, e_splat, e_mesh, _, start, count, TX, TY, most = union_bins(
        mean2d, radius, valid, depth, xy, in_front, img_size, blur_margin(model, img_size))
    opacity = valid.to(torch.float32)[e_face] * e_splat
    color_t, alpha_t = M.composite(mean2d[e_face], conic[e_face], params["appearance"]["colors"][e_face], opacity,
                                   start, count, TX, TY)
    per_face = torch.cat([xy.reshape(-1, 6), z, nsum], dim=-1)[e_face].T
    ent_valid = e_mesh * in_front.to(torch.float32)[e_face]
    sigma_px2 = 1e-4 / (2.0 / min(W, H)) ** 2
    hard_t, soft_t = M.raster(torch.cat([per_face, ent_valid[None]]), start, count, TX, TY, sigma_px2)
    albedo = crop(M.untile(color_t, TX, TY), img_size)
    alpha = crop(M.untile(alpha_t, TX, TY), img_size)
    normal = crop(M.untile(hard_t[:, :3], TX, TY), img_size)
    rgb = albedo
    sh = model.get("shadow_module", {})
    if sh.get("name", "none") != "none":
        rgb = albedo * M.shading(params["shadow"], sh, normal.reshape(-1, 3)).reshape(H, W, 1)
    return rgb, alpha, crop(M.untile(soft_t, TX, TY), img_size), most


def frame(params, model, mesh, batch, img_size, i_iter):
    """(rgb, alpha, soft silhouette, observation vertices, the most entries
    of a tile) of ``batch``'s camera and pose."""
    verts_obs = posed_vertices(params, model, mesh, batch, i_iter)
    rgb, alpha, soft, most = render(params, model, mesh, batch["K"], batch["E"], verts_obs, img_size)
    return rgb, alpha, soft, verts_obs, most
