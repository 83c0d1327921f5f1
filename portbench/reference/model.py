"""The avatar's frame in plain PyTorch: posing, geometry, one union tile
binning, the splat blend, the mesh raster with its soft silhouette, and the
shading MLP; differentiable by autograd.

The equations follow GoMAvatar as the program states them; the plain
sweeps are frozen copies, at commit a92d513, of the program's plain kernel
versions, ``composite_tiles_plain`` (gomavatar_tpu_torch/ops/splat/
tiled_jnp.py:49) and ``mesh_composite_plain`` (ops/mesh_raster.py:137) with
their helpers, and of ``project_gaussians`` (ops/splat/projection.py:28),
``steiner_transform`` (ops/steiner.py:19) and ``so3_exp``
(ops/transforms.py:35).  The binning is written here: every (face, tile)
pair of the union of the face's splat box and triangle box, sorted per tile
by the 21-bit depth key and the face index, with no budget (a step where
the program's budgets drop an entry counts as failed).  Index transposes
are autograd's ``index_add``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

TILE = 16
CHUNK = 128
P = TILE * TILE
NCMAX = 64
ALPHA_MAX, ALPHA_MIN, T_EPS = 0.99, 1.0 / 255.0, 1e-4
SMPL_PARENT = (0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21)
_BIG = 1e10
_ONE_MINUS = 1.0 - 1e-7


# -- rotations, skeleton, MLPs ----------------------------------------------------

def hat(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1), torch.stack([-y, x, o], -1)], -2)


def so3_exp(rvec):
    """Rodrigues with a Taylor switch below theta^2 = 1e-8."""
    theta_sq = torch.sum(rvec * rvec, dim=-1)
    small = theta_sq < 1e-8
    one = torch.ones_like(theta_sq)
    theta = torch.sqrt(torch.where(small, one, theta_sq))
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / torch.where(small, one, theta_sq))
    K = hat(rvec)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * torch.matmul(K, K)


def rigid(R, t):
    """(..., 4, 4) from R (..., 3, 3) and t (..., 3)."""
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def skinning_transforms(cnl_gtfms, dst_Rs, dst_Ts):
    """Per-bone G_dst inv(G_cnl): (24, 3, 3), (24, 3)."""
    local = rigid(dst_Rs, dst_Ts)
    chain = [local[0]]
    for i in range(1, local.shape[0]):
        chain.append(chain[SMPL_PARENT[i]] @ local[i])
    R_inv = cnl_gtfms[:, :3, :3].transpose(-1, -2)
    t_inv = -torch.einsum("jab,jb->ja", R_inv, cnl_gtfms[:, :3, 3])
    f = torch.stack(chain) @ rigid(R_inv, t_inv)
    return f[:, :3, :3], f[:, :3, 3]


def mlp(p, x, skips=(), skip_input=None):
    h = x
    for i, layer in enumerate(p["layers"]):
        if i in skips and i > 0 and skip_input is not None:
            h = torch.cat([h, skip_input], dim=-1)
        h = torch.relu(h @ layer["w"] + layer["b"])
    return h @ p["head"]["w"] + p["head"]["b"]


def encode(x, multires, weights=None, include_input=False):
    """[x?, w_k sin(2^k x), w_k cos(2^k x)]_k."""
    parts = [x] if include_input else []
    for k in range(multires):
        s, c = torch.sin(x * 2.0**k), torch.cos(x * 2.0**k)
        parts += [s, c] if weights is None else [weights[k] * s, weights[k] * c]
    return torch.cat(parts, dim=-1)


def band_weights(multires, i_iter, kick_in, full_band, device):
    """The Hann ramp of the non-rigid encoding's bands at ``i_iter``."""
    t = max(float(np.float32(i_iter)) - kick_in, 0.0)
    alpha = torch.full((), multires * t / (full_band - kick_in), dtype=torch.float32, device=device)
    j = torch.arange(multires, dtype=torch.float32, device=device)
    return (1.0 - torch.cos(math.pi * torch.clamp(alpha - j, 0.0, 1.0))) / 2.0


def shading(params, cfg, normals):
    """The shadow MLP in bfloat16 on the encoded normals (float32), the
    sigmoid in float32, x2."""
    pe = encode(normals, cfg["multires"], include_input=True).to(torch.bfloat16)
    p16 = {"layers": [{k: v.to(torch.bfloat16) for k, v in layer.items()} for layer in params["layers"]],
           "head": {k: v.to(torch.bfloat16) for k, v in params["head"].items()}}
    skips = tuple(s for s in cfg["skips"] if s < cfg["mlp_depth"])
    return torch.sigmoid(mlp(p16, pe, skips, pe).float()) * 2.0


def posed_vertices(params, model, mesh, frame, i_iter):
    """Observation-space vertices: pose refinement, non-rigid offsets and
    LBS, each from its kick-in iteration."""
    dst_Rs, posevec = frame["dst_Rs"], frame["dst_posevec"]
    pr = model.get("pose_refinement", {})
    if pr.get("name", "none") != "none" and i_iter >= pr["kick_in_iter"]:
        delta = so3_exp(mlp(params["pose_refinement"], posevec).reshape(-1, 3))
        if not pr["refine_root"]:
            delta = torch.cat([torch.eye(3, device=delta.device)[None], delta])
        dst_Rs = dst_Rs @ delta
    verts = params["vertices"]
    nr = model.get("non_rigid", {})
    if nr.get("name", "none") != "none" and i_iter >= nr["kick_in_iter"]:
        w = band_weights(nr["multires"], i_iter, nr["kick_in_iter"], nr["full_band_iter"], verts.device)
        pe = encode(verts, nr["multires"], w)
        h = torch.cat([posevec[None, :].expand(verts.shape[0], -1), pe], dim=-1)
        verts = verts + mlp(params["non_rigid"], h, tuple(nr["skips"]), pe)[:, :3]
    gR, gT = skinning_transforms(frame["cnl_gtfms"], dst_Rs, frame["dst_Ts"])
    R = (mesh.lbs_weights @ gR.reshape(-1, 9)).reshape(-1, 3, 3)
    return torch.einsum("nij,nj->ni", R, verts) + mesh.lbs_weights @ gT


# -- per-face geometry ------------------------------------------------------------

def steiner(tri, sigma):
    c = tri.mean(dim=-2)
    f1 = 0.5 * (tri[..., 2, :] - c)
    f2 = (1.0 / (2.0 * 1.7320508075688772)) * (tri[..., 1, :] - tri[..., 0, :])
    t0 = (0.5 * torch.atan2(2.0 * torch.sum(f1 * f2, -1), torch.sum(f1 * f1, -1) - torch.sum(f2 * f2, -1)))[..., None]
    a0 = f1 * torch.cos(t0) + f2 * torch.sin(t0)
    a1 = -f1 * torch.sin(t0) + f2 * torch.cos(t0)
    n = torch.cross(a0, a1, dim=-1)
    n = n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-20) * sigma
    return torch.stack([a0 * 2.0, a1 * 2.0, n], dim=-1)


def covariances(tri, so3, scale, sigma):
    M = steiner(tri, sigma) @ (so3_exp(so3) * scale[..., None, :])
    return M @ M.transpose(-1, -2)


def project_gaussians(means, cov, K, E, img_size, znear=0.2, blur=0.3):
    """(mean2d, conic, depth, radius, valid) of the EWA projection."""
    W, H = img_size
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    R = E[:3, :3]
    t = means @ R.T + E[:3, 3]
    tz = t[..., 2]
    in_front = tz > znear
    tz_s = torch.where(in_front, tz, torch.ones_like(tz))
    txz = torch.clamp(t[..., 0] / tz_s, -1.3 * (0.5 * W / fx), 1.3 * (0.5 * W / fx))
    tyz = torch.clamp(t[..., 1] / tz_s, -1.3 * (0.5 * H / fy), 1.3 * (0.5 * H / fy))
    M = R @ cov @ R.T
    a1, c1, b2, c2 = fx / tz_s, -fx * txz / tz_s, fy / tz_s, -fy * tyz / tz_s
    M00, M01, M02, M11, M12, M22 = M[:, 0, 0], M[:, 0, 1], M[:, 0, 2], M[:, 1, 1], M[:, 1, 2], M[:, 2, 2]
    a = a1 * a1 * M00 + 2.0 * a1 * c1 * M02 + c1 * c1 * M22 + blur
    b = a1 * b2 * M01 + a1 * c2 * M02 + c1 * b2 * M12 + c1 * c2 * M22
    c = b2 * b2 * M11 + 2.0 * b2 * c2 * M12 + c2 * c2 * M22 + blur
    det = a * c - b * b
    inv = det > 0.0
    det_s = torch.where(inv, det, torch.ones_like(det))
    conic = torch.stack([c / det_s, -b / det_s, a / det_s], dim=-1)
    mid = 0.5 * (a + c)
    radius = torch.ceil(3.0 * torch.sqrt(mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))))
    mean2d = torch.stack([fx * t[..., 0] / tz_s + cx - 0.5, fy * t[..., 1] / tz_s + cy - 0.5], dim=-1)
    on = ((mean2d[:, 0] + radius >= 0) & (mean2d[:, 0] - radius <= W - 1)
          & (mean2d[:, 1] + radius >= 0) & (mean2d[:, 1] - radius <= H - 1))
    valid = in_front & inv & on
    return mean2d, conic, tz, torch.where(valid, radius, torch.zeros_like(radius)), valid


def project_triangles(tri, K, E):
    """Pixel xy (F, 3, 2), camera z (F, 3), in front (F,)."""
    cam = tri @ E[:3, :3].T + E[:3, 3]
    z = cam[..., 2]
    zs = torch.where(z > 1e-5, z, torch.ones_like(z))
    xy = torch.stack([K[0, 0] * cam[..., 0] / zs + K[0, 2] - 0.5, K[1, 1] * cam[..., 1] / zs + K[1, 2] - 0.5], -1)
    return xy, z, torch.all(z > 1e-5, dim=-1)


# -- binning --------------------------------------------------------------------

def depth_key(depth):
    """21-bit monotone key of a positive float32 depth."""
    bits = torch.clamp_min(depth.to(torch.float32), 0.0).contiguous().view(torch.int32)
    return (bits.to(torch.int64) & 0xFFFFFFFF) >> 11


@torch.no_grad()
def union_bins(mean2d, radius, valid, depth, xy, in_front, img_size, margin):
    """Every (face, tile) pair of the union of each face's splat box and
    its triangle box grown by ``margin`` px, sorted per tile by (depth key,
    face), each tile's segment padded to a multiple of CHUNK.  Returns
    (entry face (Dp,), splat flag, mesh flag, entry valid, tile start (T,),
    tile count (T,), TX, TY, the most entries of a tile)."""
    W, H = img_size
    TX, TY = W // TILE, H // TILE
    dev = mean2d.device

    def tiles(v, n):
        return torch.clamp(torch.floor(v / TILE), 0, n - 1).to(torch.int64)

    r = torch.where(valid, radius, torch.zeros_like(radius))
    sbox = (mean2d[:, 0] - r, mean2d[:, 0] + r, mean2d[:, 1] - r, mean2d[:, 1] + r)
    mbox = (xy[..., 0].amin(1) - margin, xy[..., 0].amax(1) + margin,
            xy[..., 1].amin(1) - margin, xy[..., 1].amax(1) + margin)
    ubox = (torch.minimum(sbox[0], mbox[0]), torch.maximum(sbox[1], mbox[1]),
            torch.minimum(sbox[2], mbox[2]), torch.maximum(sbox[3], mbox[3]))
    x0, x1, y0, y1 = tiles(ubox[0], TX), tiles(ubox[1], TX), tiles(ubox[2], TY), tiles(ubox[3], TY)
    bw = x1 - x0 + 1
    n = torch.where(valid | in_front, bw * (y1 - y0 + 1), torch.zeros_like(bw))
    face = torch.repeat_interleave(torch.arange(len(n), device=dev), n)
    j = torch.arange(len(face), device=dev) - torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    tx, ty = x0[face] + j % bw[face], y0[face] + torch.div(j, bw[face], rounding_mode="floor")

    def inside(box, ok):
        bx0, bx1, by0, by1 = tiles(box[0], TX), tiles(box[1], TX), tiles(box[2], TY), tiles(box[3], TY)
        return ((tx >= bx0[face]) & (tx <= bx1[face]) & (ty >= by0[face]) & (ty <= by1[face]) & ok[face]).float()

    splat, mesh = inside(sbox, valid), inside(mbox, in_front)
    tile = ty * TX + tx
    order = torch.argsort((((tile << 21) | depth_key(depth)[face]) << 20) | face)
    face, tile, splat, mesh = face[order], tile[order], splat[order], mesh[order]
    count = torch.bincount(tile, minlength=TX * TY)
    padded = (count + CHUNK - 1) // CHUNK * CHUNK
    start = torch.cumsum(padded, 0) - padded
    first = torch.cumsum(count, 0) - count
    dest = start[tile] + torch.arange(len(tile), device=dev) - first[tile]
    Dp = max(int(padded.sum()), CHUNK)
    e_face = torch.zeros(Dp, dtype=torch.int64, device=dev).index_copy(0, dest, face)
    e_splat = torch.zeros(Dp, device=dev).index_copy(0, dest, splat)
    e_mesh = torch.zeros(Dp, device=dev).index_copy(0, dest, mesh)
    e_valid = torch.zeros(Dp, device=dev).index_fill(0, dest, 1.0)
    return e_face, e_splat, e_mesh, e_valid, start, padded, TX, TY, int(count.max())


# -- the plain sweeps --------------------------------------------------------------

def tile_pixels(tiles, TX):
    lin = torch.arange(P, device=tiles.device)
    px = (tiles % TX * TILE)[:, None] + lin % TILE
    py = (torch.div(tiles, TX, rounding_mode="floor") * TILE)[:, None] + torch.div(lin, TILE, rounding_mode="floor")
    return px.to(torch.float32), py.to(torch.float32)


def chunk_alpha(mean2d, conic, opacity, px, py):
    dx = px[:, None, :] - mean2d[..., 0:1]
    dy = py[:, None, :] - mean2d[..., 1:2]
    power = -0.5 * (conic[..., 0:1] * dx * dx + conic[..., 2:3] * dy * dy) - conic[..., 1:2] * dx * dy
    zero = torch.zeros((), dtype=power.dtype, device=power.device)
    alpha = torch.clamp_max(opacity[..., None] * torch.exp(power), ALPHA_MAX)
    alpha = torch.where(power > 0.0, zero, alpha)
    return torch.where(alpha < ALPHA_MIN, zero, alpha)


def composite(mean2d, conic, color, opacity, start, count, TX, TY):
    """Front-to-back blend per tile, chunk by chunk: (color (T, C, P), alpha (T, P))."""
    T, C, Dp, dev = TX * TY, color.shape[-1], mean2d.shape[0], mean2d.device
    color_t = torch.zeros((T, C, P), device=dev)
    alpha_t = torch.zeros((T, P), device=dev)
    tiles = torch.nonzero(count > 0).flatten()
    if tiles.numel() == 0:
        return color_t, alpha_t
    st, cnt = start[tiles], count[tiles]
    kmax = int(torch.clamp_max(torch.div(cnt + CHUNK - 1, CHUNK, rounding_mode="floor"), NCMAX).max())
    px, py = tile_pixels(tiles, TX)
    lane = torch.arange(CHUNK, device=dev)
    n = tiles.shape[0]
    log_T = torch.zeros((n, P), device=dev)
    acc_c = torch.zeros((n, C, P), device=dev)
    acc_a = torch.zeros((n, P), device=dev)
    for k in range(kmax):
        idx = torch.clamp_max(st + k * CHUNK, Dp - CHUNK)[:, None] + lane
        in_range = (k * CHUNK < cnt).to(torch.float32)[:, None]
        alpha = chunk_alpha(mean2d[idx], conic[idx], opacity[idx] * in_range, px, py)
        log1m = torch.log1p(-alpha)
        cum = torch.cumsum(log1m, dim=1) + log_T[:, None, :]
        w = torch.where(torch.exp(cum) < T_EPS, torch.zeros_like(alpha), torch.exp(cum - log1m) * alpha)
        acc_c = acc_c + torch.einsum("nec,nep->ncp", color[idx], w)
        acc_a = acc_a + torch.sum(w, dim=1)
        log_T = cum[:, -1]
    return color_t.index_copy(0, tiles, acc_c), alpha_t.index_copy(0, tiles, acc_a)


def _tri_sq_dist(px, py, x0, y0, x1, y1, x2, y2):
    def seg(ax, ay, bx, by):
        abx, aby = bx - ax, by - ay
        t = ((px - ax) * abx + (py - ay) * aby) / torch.clamp_min(abx * abx + aby * aby, 1e-12)
        t = torch.minimum(torch.maximum(t, torch.zeros_like(t)), torch.ones_like(t))
        dx, dy = px - (ax + t * abx), py - (ay + t * aby)
        return dx * dx + dy * dy

    return torch.minimum(seg(x0, y0, x1, y1), torch.minimum(seg(x1, y1, x2, y2), seg(x2, y2, x0, y0)))


def raster(entries, start, count, TX, TY, sigma_px2):
    """Z-buffer of the summed normals and the soft silhouette per tile:
    (hard (T, 4, P) = [normal, hit], soft (T, P)); ``entries`` (13, Dp)
    = x0 y0 x1 y1 x2 y2 | z0 z1 z2 | nsum xyz | valid."""
    T, Dp, dev = TX * TY, entries.shape[1], entries.device
    hard_t = torch.zeros((T, 4, P), device=dev)
    soft_t = torch.zeros((T, P), device=dev)
    tiles = torch.nonzero(count > 0).flatten()
    if tiles.numel() == 0:
        return hard_t, soft_t
    st, cnt = start[tiles], count[tiles]
    kmax = int(torch.clamp_max(torch.div(cnt + CHUNK - 1, CHUNK, rounding_mode="floor"), NCMAX).max())
    px, py = tile_pixels(tiles, TX)
    px, py = px[:, :, None], py[:, :, None]
    n = tiles.shape[0]
    best_z = torch.full((n, P), _BIG, device=dev)
    best_n = torch.zeros((n, 3, P), device=dev)
    log_om = torch.zeros((n, P), device=dev)
    lane = torch.arange(CHUNK, device=dev)
    for k in range(kmax):
        offs = torch.clamp_max(st + k * CHUNK, Dp - CHUNK)
        in_range = (k * CHUNK < cnt).to(torch.float32)[:, None, None]
        e = entries[:, offs[:, None] + lane][:, :, None, :]
        x0, y0, x1, y1, x2, y2 = e[0], e[1], e[2], e[3], e[4], e[5]
        ev = e[12] * in_range
        denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
        bad = torch.abs(denom) < 1e-12
        denom = torch.where(bad, torch.ones_like(denom), denom)
        w0 = ((y1 - y2) * (px - x2) + (x2 - x1) * (py - y2)) / denom
        w1 = ((y2 - y0) * (px - x2) + (x0 - x2) * (py - y2)) / denom
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        z_px = w0 * e[6] + w1 * e[7] + w2 * e[8]
        z_cand = torch.where(inside & (ev > 0) & ~bad, z_px, torch.full_like(z_px, _BIG))
        z_chunk = torch.amin(z_cand, dim=-1)
        first = torch.amin(torch.where(z_cand <= z_chunk[..., None], lane, 2 * CHUNK), dim=-1)
        n_chunk = torch.gather(e[9:12, :, 0, :].permute(1, 0, 2), 2, first[:, None, :].expand(n, 3, P))
        better = z_chunk < best_z
        best_n = torch.where(better[:, None, :], n_chunk, best_n)
        best_z = torch.where(better, z_chunk, best_z)
        d2 = _tri_sq_dist(px, py, x0, y0, x1, y1, x2, y2)
        prob = torch.sigmoid(-torch.where(inside, -d2, d2) / sigma_px2)
        prob = torch.where(ev > 0, prob, torch.zeros((), device=dev))
        log_om = log_om + torch.sum(torch.log1p(-torch.minimum(prob, torch.full_like(prob, _ONE_MINUS))), dim=-1)
    hit = (best_z < _BIG).to(torch.float32)
    hard = torch.cat([best_n * hit[:, None, :], hit[:, None, :]], dim=1)
    return hard_t.index_copy(0, tiles, hard), soft_t.index_copy(0, tiles, 1.0 - torch.exp(log_om))


def untile(x_t, TX, TY):
    """(T, C, P) or (T, P) per-tile values -> (H, W, C) or (H, W)."""
    if x_t.dim() == 2:
        return x_t.reshape(TY, TX, TILE, TILE).permute(0, 2, 1, 3).reshape(TY * TILE, TX * TILE)
    C = x_t.shape[1]
    return x_t.reshape(TY, TX, C, TILE, TILE).permute(0, 3, 1, 4, 2).reshape(TY * TILE, TX * TILE, C)


# -- the frame ----------------------------------------------------------------------

def render(params, model, mesh, K, E, verts_obs, img_size):
    """(rgb (H, W, 3) before the background, alpha (H, W), soft silhouette
    (H, W), the most entries of a tile) of one frame."""
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
    blur_sigma = model["normal_renderer"]["sigma"]
    margin = math.sqrt(math.log(1.0 / 1e-4 - 1.0) * blur_sigma) / (2.0 / min(W, H)) + 1.0
    e_face, e_splat, e_mesh, _, start, count, TX, TY, most = union_bins(
        mean2d, radius, valid, depth, xy, in_front, img_size, margin)
    opacity = valid.to(torch.float32)[e_face] * e_splat
    color_t, alpha_t = composite(mean2d[e_face], conic[e_face], params["appearance"]["colors"][e_face], opacity,
                                 start, count, TX, TY)
    per_face = torch.cat([xy.reshape(-1, 6), z, nsum], dim=-1)[e_face].T
    ent_valid = e_mesh * in_front.to(torch.float32)[e_face]
    sigma_px2 = 1e-4 / (2.0 / min(W, H)) ** 2
    hard_t, soft_t = raster(torch.cat([per_face, ent_valid[None]]), start, count, TX, TY, sigma_px2)
    albedo, alpha = untile(color_t, TX, TY), untile(alpha_t, TX, TY)
    normal = untile(hard_t[:, :3], TX, TY)
    rgb = albedo
    sh = model.get("shadow_module", {})
    if sh.get("name", "none") != "none":
        rgb = albedo * shading(params["shadow"], sh, normal.reshape(-1, 3)).reshape(H, W, 1)
    return rgb, alpha, untile(soft_t, TX, TY), most


def frame(params, model, mesh, batch, img_size, i_iter):
    """(rgb, alpha, soft silhouette, observation vertices, the most entries
    of a tile) of ``batch``'s camera and pose."""
    verts_obs = posed_vertices(params, model, mesh, batch, i_iter)
    rgb, alpha, soft, most = render(params, model, mesh, batch["K"], batch["E"], verts_obs, img_size)
    return rgb, alpha, soft, verts_obs, most


def over(rgb, alpha, bg):
    return rgb * alpha[..., None] + bg[None, None, :] * (1.0 - alpha)[..., None]


def dilate(mask, k):
    pad = k // 2
    out = F.max_pool2d(mask[None, None], (k, 1), stride=1, padding=(pad, 0))
    return F.max_pool2d(out, (1, k), stride=1, padding=(0, pad))[0, 0]
