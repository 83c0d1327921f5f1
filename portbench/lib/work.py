"""What the algorithm needs, counted from shapes and from one frame's data:
the FLOPs of a step or frame by precision (for the MFU) and the operations
and bytes of the splat and mesh kernels (for their rooflines).

Peaks are NVIDIA's published H100 SXM figures, dense: 989 TFLOP/s in
bfloat16, 67 TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM.

Operations per pair are those of the plain reference's equations
(``reference/model.py``), one per add, multiply, divide, compare, select,
exp, log or sigmoid:
  * a live (pixel, splat) pair, one that adds to the pixel (alpha >= 1/255
    while the pixel's transmittance is above 1e-4): the alpha (dx, dy, the
    conic's quadratic form, the exp, the opacity, the clamp and two cuts:
    16) and the blend (log1p, the running sum, two exps, the weight, the
    cut, three colour and one alpha accumulations: 15): 31;
  * a swept (pixel, face) pair of the z-buffer, every face binned to the
    pixel's tile by its triangle box: the barycentrics (w0, w1: 12, w2: 2),
    the inside test (5), the depth (5), the candidate select and the
    minimum (2): 26;
  * the soft silhouette of such a pair (train path): three segment
    distances (14 each), their minimum (2), the sign (2), the scaled
    sigmoid (5) and log(1 - p) with its clamp and sum (4): 55.
A backward counts twice its forward.  Bytes: each face's inputs read once
(the splat's mean, conic, opacity and colour: 9 floats; the triangle's
pixel corners, depths and summed normal: 12), each (face, tile) pair's face
index once, each output pixel written once (colour, alpha, normal, hit and
silhouette: 9 floats), and in a backward each cotangent pixel read once
and each face's gradient written once.
"""

from __future__ import annotations

import math

import torch

PEAK = {"bf16": 989e12, "fp32": 67e12}
HBM_BYTES_PER_S = 3.35e12
OPS_SPLAT, OPS_ZTEST, OPS_SOFT = 31, 26, 55
VGG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]


def vgg16_flops(h: int, w: int) -> float:
    total, c_in = 0.0, 3
    for c in VGG:
        if c == "M":
            h, w = h // 2, w // 2
            continue
        total += 2.0 * 9 * c_in * c * h * w
        c_in = c
    return total


def mlp_flops(rows: int, params: dict) -> float:
    """2 * rows * (weights) of an MLP given as its params (``w`` (in, out))."""
    mats = [layer["w"] for layer in params["layers"]] + [params["head"]["w"]]
    return 2.0 * rows * sum(m.shape[0] * m.shape[1] for m in mats)


@torch.no_grad()
def frame_pairs(reference_model, params, model, mesh, batch, img_size, i_iter):
    """{"splat": live (pixel, splat) pairs, "mesh": swept (pixel, face)
    pairs, "faces", "entries": (face, tile) pairs} of one frame."""
    M = reference_model
    verts = M.posed_vertices(params, model, mesh, batch, i_iter)
    W, H = img_size
    tri = verts[mesh.faces]
    cov = M.covariances(tri, params["so3"], params["scale"], model["canonical_geometry"]["sigma"])
    mean2d, conic, depth, radius, valid = M.project_gaussians(tri.mean(dim=1), cov, batch["K"], batch["E"], img_size)
    xy, z, in_front = M.project_triangles(tri, batch["K"], batch["E"])
    margin = math.sqrt(math.log(1.0 / 1e-4 - 1.0) * model["normal_renderer"]["sigma"]) / (2.0 / min(W, H)) + 1.0
    e_face, e_splat, e_mesh, e_valid, start, count, TX, TY, _ = M.union_bins(
        mean2d, radius, valid, depth, xy, in_front, img_size, margin)
    op = valid.float()[e_face] * e_splat
    tiles = torch.nonzero(count > 0).flatten()
    px, py = M.tile_pixels(tiles, TX)
    lane = torch.arange(M.CHUNK, device=verts.device)
    log_T = torch.zeros((len(tiles), M.P), device=verts.device)
    live = torch.zeros((), dtype=torch.float64, device=verts.device)
    for k in range(int((count[tiles] // M.CHUNK).clamp_max(M.NCMAX).max())):
        idx = torch.clamp_max(start[tiles] + k * M.CHUNK, len(e_face) - M.CHUNK)[:, None] + lane
        in_range = (k * M.CHUNK < count[tiles]).float()[:, None]
        f = e_face[idx]
        alpha = M.chunk_alpha(mean2d[f], conic[f], op[idx] * in_range, px, py)
        log1m = torch.log1p(-alpha)
        cum = torch.cumsum(log1m, dim=1) + log_T[:, None, :]
        live += ((alpha > 0) & (torch.exp(cum) >= M.T_EPS)).sum()
        log_T = cum[:, -1]
    mesh_pairs = float((e_mesh * in_front.float()[e_face]).sum()) * M.P
    return {"splat": float(live), "mesh": mesh_pairs, "faces": int(mesh.faces.shape[0]),
            "entries": float(e_valid.sum()), "pixels": W * H}


def render_ops(pairs: dict, soft: bool) -> float:
    return pairs["splat"] * OPS_SPLAT + pairs["mesh"] * (OPS_ZTEST + (OPS_SOFT if soft else 0))


def render_bytes(pairs: dict, backward: bool) -> float:
    face_in = pairs["faces"] * 21 * 4
    fwd = face_in + pairs["entries"] * 4 + pairs["pixels"] * 9 * 4
    return fwd + (face_in + pairs["entries"] * 4 + pairs["pixels"] * 9 * 4 if backward else 0.0)


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK["fp32"], nbytes / HBM_BYTES_PER_S)


def peak_seconds(flops: dict) -> float:
    """The time of ``flops`` {precision: count} at the published peaks."""
    return sum(v / PEAK[k] for k, v in flops.items())
