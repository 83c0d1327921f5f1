"""What a pose step needs at a frame of any W x H, counted as ``pose_work.py``
counts it at whole tiles, on the frame's own pixels: the kernels sweep the
whole-tile canvas, but only the W x H pixels of the frame are work.

* B2-B5: the live (pixel, splat) pairs and the swept (pixel, face) pairs of
  the reference's own binning (``reference/frame_any.py``: ceil'd tiles)
  of the frame at its true pose, each pixel past the frame left out; the
  bytes with the frame's W H output pixels.
* LPIPS's distance head (``csrc/lpips_head.cu``, three launches a pose
  step): the bytes of the five VGG16 taps of the prediction and the target
  at the frame's size, 10 B an element (the forward reads both images'
  bfloat16 taps, 4 B; the backward reads them again and writes the
  prediction's gradient, 6 B), at the HBM's published bandwidth.  At 540^2
  the taps are 540^2, 270^2, 135^2, 67^2 and 33^2.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.lib import pose_work, work

# the VGG16 convolutions whose ReLU outputs LPIPS taps (0-based, counting
# convolutions only): the last of each block
VGG_TAPS = (1, 3, 6, 9, 12)
HEAD_BYTES_PER_ELEMENT = 10
LPIPS_HEAD = ("lpips_head_fwd_kernel", "lpips_head_reduce_kernel", "lpips_head_bwd_kernel")


def vgg_tap_elements(h: int, w: int) -> list[int]:
    """C h w of each of the five taps of a VGG16 trunk on an h x w image
    (each 2 x 2 max pool floors an odd side)."""
    out, conv = [], 0
    for c in work.VGG:
        if c == "M":
            h, w = h // 2, w // 2
            continue
        if conv in VGG_TAPS:
            out.append(c * h * w)
        conv += 1
    return out


def lpips_head_least_seconds(img_size) -> float:
    """The least time of one pose step's three head launches on the H100:
    their bytes at the HBM's bandwidth."""
    W, H = img_size
    return HEAD_BYTES_PER_ELEMENT * sum(vgg_tap_elements(H, W)) / work.HBM_BYTES_PER_S


@torch.no_grad()
def frame_pairs(params, model, mesh, batch, img_size, i_iter) -> dict:
    """``work.frame_pairs`` of a W x H frame over ``frame_any``'s binning,
    the pairs at pixels past the frame left out: {"splat", "mesh", "faces",
    "entries", "pixels"}."""
    from portbench.reference import frame_any as FA

    W, H = img_size
    verts = FA.posed_vertices(params, model, mesh, batch, i_iter)
    tri = verts[mesh.faces]
    cov = FA.covariances(tri, params["so3"], params["scale"], model["canonical_geometry"]["sigma"])
    mean2d, conic, depth, radius, valid = FA.project_gaussians(tri.mean(dim=1), cov, batch["K"], batch["E"], img_size)
    xy, _, in_front = FA.project_triangles(tri, batch["K"], batch["E"])
    e_face, e_splat, e_mesh, e_valid, start, count, TX, TY, _ = FA.union_bins(
        mean2d, radius, valid, depth, xy, in_front, img_size, FA.blur_margin(model, img_size))
    op = valid.float()[e_face] * e_splat
    tiles = torch.nonzero(count > 0).flatten()
    px, py = FA.tile_pixels(tiles, TX)
    in_frame = (px < W) & (py < H)  # (tiles, P)
    lane = torch.arange(FA.CHUNK, device=verts.device)
    log_T = torch.zeros((len(tiles), FA.P), device=verts.device)
    live = torch.zeros((), dtype=torch.float64, device=verts.device)
    for k in range(int((count[tiles] // FA.CHUNK).clamp_max(FA.NCMAX).max())):
        idx = torch.clamp_max(start[tiles] + k * FA.CHUNK, len(e_face) - FA.CHUNK)[:, None] + lane
        in_range = (k * FA.CHUNK < count[tiles]).float()[:, None]
        f = e_face[idx]
        alpha = FA.chunk_alpha(mean2d[f], conic[f], op[idx] * in_range, px, py)
        log1m = torch.log1p(-alpha)
        cum = torch.cumsum(log1m, dim=1) + log_T[:, None, :]
        live += ((alpha > 0) & (torch.exp(cum) >= FA.T_EPS) & in_frame[:, None, :]).sum()
        log_T = cum[:, -1]
    # each entry's tile, and the tile's pixels in the frame
    tile_of = torch.repeat_interleave(torch.arange(TX * TY, device=verts.device), count)
    tx, ty = tile_of % TX, torch.div(tile_of, TX, rounding_mode="floor")
    lanes = (torch.clamp_max(W - tx * FA.TILE, FA.TILE) * torch.clamp_max(H - ty * FA.TILE, FA.TILE)).double()
    n = len(tile_of)
    mesh_pairs = float(((e_mesh * in_front.float()[e_face])[:n].double() * lanes).sum())
    return {"splat": float(live), "mesh": mesh_pairs, "faces": int(mesh.faces.shape[0]),
            "entries": float(e_valid.sum()), "pixels": W * H}


def frame_work(params: dict, model: dict, mesh, frames: list, img_size, steps: int, device) -> dict:
    """``pose_work.frame_work``'s counts per frame of ``steps`` pose steps at
    a W x H frame, from the mean pairs of ``frames`` on the frame's pixels,
    with the LPIPS head's least time: {"flops", "b2_b5_least_s",
    "lpips_head_least_s", "step_flops", "steps", "pairs"}."""
    from portbench.reference.data import pose_inputs

    pairs = []
    for f in frames:
        b = {k: torch.as_tensor(f[k], device=device) for k in pose_work.FRAME_KEYS}
        cj = np.asarray(f["dst_tpose_joints"], np.float32)
        b.update({k: torch.as_tensor(v, device=device) for k, v in pose_inputs(f["poses"], cj.copy(), cj).items()})
        pairs.append(frame_pairs(params, model, mesh, b, img_size, pose_work.FULL_BAND))
    mean = {k: float(np.mean([p[k] for p in pairs])) for k in pairs[0]}
    one = pose_work.step_flops(params, mean, img_size)
    least = work.least_seconds(3 * work.render_ops(mean, soft=True), work.render_bytes(mean, backward=True))
    return {"flops": {k: steps * v for k, v in one.items()}, "b2_b5_least_s": steps * least,
            "lpips_head_least_s": steps * lpips_head_least_seconds(img_size), "step_flops": one, "steps": steps,
            "pairs": mean}
