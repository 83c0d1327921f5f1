"""Structure-of-arrays per-face geometry for the fused frame renderer (port
of gomavatar_tpu/ops/geometry.py).

One pass over (F,)-shaped component tensors computes everything kernel B1
needs per face: the Steiner-frame covariance and its EWA screen projection
(mean, conic, radius), the triangle's barycentric and depth planes, the
summed camera-space vertex normal, the per-pass bounding boxes and valid
flags, and the splat depth.  Formulas and their order of operations follow
the reference line by line.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_SQRT3 = 1.7320508075688772
_Z_NEAR_MESH = 1e-5

# Channel layout of the entry table (rows of the (24, D) matrix kernel B1
# reads).  Raw screen-space quantities; the kernel derives TILE-LOCAL
# polynomial coefficients from them per chunk, because image-absolute
# coefficients lose ~1e-4 of the small power/barycentric values to
# cancellation of O(100)-magnitude terms.
#   0 mean_x, 1 mean_y, 2-4 conic (a, b, c), 5 opacity, 6-8 color RGB,
#   9-12 barycentric plane slopes (w0x w0y w1x w1y), 13-14 anchor vertex
#   (x2 y2), 15-17 depth plane (zx zy z2), 18 mesh-valid,
#   19-21 summed vertex normal (camera space),
#   22 per-face shading (written by the caller, 0 otherwise), 23 pad
NCH = 24


class FrameGeometry(NamedTuple):
    table: torch.Tensor  # (F, NCH) per-face channel table (see layout above)
    # per-pass bboxes in pixels: splat = 3-sigma radius box, mesh = triangle
    # box + blur margin
    sx0: torch.Tensor
    sx1: torch.Tensor
    sy0: torch.Tensor
    sy1: torch.Tensor
    mx0: torch.Tensor
    mx1: torch.Tensor
    my0: torch.Tensor
    my1: torch.Tensor
    valid_splat: torch.Tensor  # (F,) bool
    valid_mesh: torch.Tensor  # (F,) bool
    depth: torch.Tensor  # (F,) camera z of the splat center

    @property
    def union_box(self):
        inf = torch.full((), float("inf"), dtype=self.sx0.dtype, device=self.sx0.device)
        zero = torch.zeros_like(inf)
        sx0 = torch.where(self.valid_splat, self.sx0, inf)
        sx1 = torch.where(self.valid_splat, self.sx1, -inf)
        sy0 = torch.where(self.valid_splat, self.sy0, inf)
        sy1 = torch.where(self.valid_splat, self.sy1, -inf)
        mx0 = torch.where(self.valid_mesh, self.mx0, inf)
        mx1 = torch.where(self.valid_mesh, self.mx1, -inf)
        my0 = torch.where(self.valid_mesh, self.my0, inf)
        my1 = torch.where(self.valid_mesh, self.my1, -inf)
        anyv = self.valid  # invalid primitives get a finite dummy box
        return (
            torch.where(anyv, torch.minimum(sx0, mx0), zero),
            torch.where(anyv, torch.maximum(sx1, mx1), zero),
            torch.where(anyv, torch.minimum(sy0, my0), zero),
            torch.where(anyv, torch.maximum(sy1, my1), zero),
        )

    @property
    def valid(self):
        return self.valid_splat | self.valid_mesh


def _so3_exp_soa(wx, wy, wz):
    """Rodrigues on (F,) components; same Taylor switch as transforms.so3_exp."""
    th2 = wx * wx + wy * wy + wz * wz
    small = th2 < 1e-8
    one = torch.ones_like(th2)
    th = torch.sqrt(torch.where(small, one, th2))
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / torch.where(small, one, th2))
    R00 = 1.0 + B * (-wz * wz - wy * wy)
    R01 = -A * wz + B * wx * wy
    R02 = A * wy + B * wx * wz
    R10 = A * wz + B * wx * wy
    R11 = 1.0 + B * (-wz * wz - wx * wx)
    R12 = -A * wx + B * wy * wz
    R20 = -A * wy + B * wx * wz
    R21 = A * wx + B * wy * wz
    R22 = 1.0 + B * (-wy * wy - wx * wx)
    return (R00, R01, R02, R10, R11, R12, R20, R21, R22)


def frame_geometry(
    verts_obs: torch.Tensor,  # (V, 3) observation-space vertices
    faces: torch.Tensor,  # (F, 3) int64
    so3_params: torch.Tensor,  # (F, 3)
    scale_params: torch.Tensor,  # (F, 3)
    colors: torch.Tensor,  # (F, 3)
    vf_incidence: torch.Tensor,  # (V, maxdeg) static vertex->face incidence
    vf_valid: torch.Tensor,  # (V, maxdeg)
    K: torch.Tensor,
    E: torch.Tensor,
    img_size: tuple[int, int],
    sigma: float,
    blur_margin_px: float,
    znear: float = 0.2,
    blur: float = 0.3,
) -> FrameGeometry:
    W, H = img_size
    F = faces.shape[0]

    # ---- the one dynamic gather: triangle vertices, then SoA components
    tri9 = verts_obs[faces].reshape(F, 9).T  # (9, F)
    ax, ay, az, bx, by, bz, cx, cy, cz = (tri9[i] for i in range(9))

    # ---- centroid (splat mean)
    gx = (ax + bx + cx) / 3.0
    gy = (ay + by + cy) / 3.0
    gz = (az + bz + cz) / 3.0

    # ---- Steiner frame
    f1x, f1y, f1z = 0.5 * (cx - gx), 0.5 * (cy - gy), 0.5 * (cz - gz)
    s = 1.0 / (2.0 * _SQRT3)
    f2x, f2y, f2z = s * (bx - ax), s * (by - ay), s * (bz - az)
    cross_term = 2.0 * (f1x * f2x + f1y * f2y + f1z * f2z)
    diff_term = (f1x * f1x + f1y * f1y + f1z * f1z) - (f2x * f2x + f2y * f2y + f2z * f2z)
    t0 = 0.5 * torch.arctan2(cross_term, diff_term)
    ct, st = torch.cos(t0), torch.sin(t0)
    a0x, a0y, a0z = f1x * ct + f2x * st, f1y * ct + f2y * st, f1z * ct + f2z * st
    a1x, a1y, a1z = -f1x * st + f2x * ct, -f1y * st + f2y * ct, -f1z * st + f2z * ct
    nx = a0y * a1z - a0z * a1y
    ny = a0z * a1x - a0x * a1z
    nz = a0x * a1y - a0y * a1x
    nn = torch.sqrt(nx * nx + ny * ny + nz * nz) + 1e-20
    nsc = sigma / nn
    nx, ny, nz = nx * nsc, ny * nsc, nz * nsc
    # Steiner transform columns: (2*axis0, 2*axis1, normal)
    T00, T01, T02 = 2.0 * a0x, 2.0 * a1x, nx
    T10, T11, T12 = 2.0 * a0y, 2.0 * a1y, ny
    T20, T21, T22 = 2.0 * a0z, 2.0 * a1z, nz

    # ---- learnable local rotation/scale; M = T @ (R diag(s)); cov = M M^T
    R00, R01, R02, R10, R11, R12, R20, R21, R22 = _so3_exp_soa(
        so3_params[:, 0], so3_params[:, 1], so3_params[:, 2]
    )
    s0, s1, s2 = scale_params[:, 0], scale_params[:, 1], scale_params[:, 2]
    RS00, RS01, RS02 = R00 * s0, R01 * s1, R02 * s2
    RS10, RS11, RS12 = R10 * s0, R11 * s1, R12 * s2
    RS20, RS21, RS22 = R20 * s0, R21 * s1, R22 * s2
    M00 = T00 * RS00 + T01 * RS10 + T02 * RS20
    M01 = T00 * RS01 + T01 * RS11 + T02 * RS21
    M02 = T00 * RS02 + T01 * RS12 + T02 * RS22
    M10 = T10 * RS00 + T11 * RS10 + T12 * RS20
    M11 = T10 * RS01 + T11 * RS11 + T12 * RS21
    M12 = T10 * RS02 + T11 * RS12 + T12 * RS22
    M20 = T20 * RS00 + T21 * RS10 + T22 * RS20
    M21 = T20 * RS01 + T21 * RS11 + T22 * RS21
    M22 = T20 * RS02 + T21 * RS12 + T22 * RS22
    C00 = M00 * M00 + M01 * M01 + M02 * M02
    C01 = M00 * M10 + M01 * M11 + M02 * M12
    C02 = M00 * M20 + M01 * M21 + M02 * M22
    C11 = M10 * M10 + M11 * M11 + M12 * M12
    C12 = M10 * M20 + M11 * M21 + M12 * M22
    C22 = M20 * M20 + M21 * M21 + M22 * M22

    # ---- camera-space congruence V = Rc C Rc^T (symmetric, 6 comps)
    Rc = E[:3, :3]
    tvec = E[:3, 3]
    r00, r01, r02 = Rc[0, 0], Rc[0, 1], Rc[0, 2]
    r10, r11, r12 = Rc[1, 0], Rc[1, 1], Rc[1, 2]
    r20, r21, r22 = Rc[2, 0], Rc[2, 1], Rc[2, 2]
    RC00 = r00 * C00 + r01 * C01 + r02 * C02
    RC01 = r00 * C01 + r01 * C11 + r02 * C12
    RC02 = r00 * C02 + r01 * C12 + r02 * C22
    RC10 = r10 * C00 + r11 * C01 + r12 * C02
    RC11 = r10 * C01 + r11 * C11 + r12 * C12
    RC12 = r10 * C02 + r11 * C12 + r12 * C22
    RC20 = r20 * C00 + r21 * C01 + r22 * C02
    RC21 = r20 * C01 + r21 * C11 + r22 * C12
    RC22 = r20 * C02 + r21 * C12 + r22 * C22
    V00 = RC00 * r00 + RC01 * r01 + RC02 * r02
    V01 = RC00 * r10 + RC01 * r11 + RC02 * r12
    V02 = RC00 * r20 + RC01 * r21 + RC02 * r22
    V11 = RC10 * r10 + RC11 * r11 + RC12 * r12
    V12 = RC10 * r20 + RC11 * r21 + RC12 * r22
    V22 = RC20 * r20 + RC21 * r21 + RC22 * r22

    # ---- EWA projection (CUDA preprocess semantics)
    fx, fy = K[0, 0], K[1, 1]
    cxx, cyy = K[0, 2], K[1, 2]
    tx = r00 * gx + r01 * gy + r02 * gz + tvec[0]
    ty = r10 * gx + r11 * gy + r12 * gz + tvec[1]
    tz = r20 * gx + r21 * gy + r22 * gz + tvec[2]
    in_front_splat = tz > znear
    tz_safe = torch.where(in_front_splat, tz, torch.ones_like(tz))
    tanfovx = 0.5 * W / fx
    tanfovy = 0.5 * H / fy
    txz = torch.clamp(tx / tz_safe, -1.3 * tanfovx, 1.3 * tanfovx)
    tyz = torch.clamp(ty / tz_safe, -1.3 * tanfovy, 1.3 * tanfovy)
    a1 = fx / tz_safe
    c1 = -fx * txz / tz_safe
    b2 = fy / tz_safe
    c2 = -fy * tyz / tz_safe
    cov_a = a1 * a1 * V00 + 2.0 * a1 * c1 * V02 + c1 * c1 * V22 + blur
    cov_b = a1 * b2 * V01 + a1 * c2 * V02 + c1 * b2 * V12 + c1 * c2 * V22
    cov_c = b2 * b2 * V11 + 2.0 * b2 * c2 * V12 + c2 * c2 * V22 + blur
    det = cov_a * cov_c - cov_b * cov_b
    invertible = det > 0.0
    det_safe = torch.where(invertible, det, torch.ones_like(det))
    con_a = cov_c / det_safe
    con_b = -cov_b / det_safe
    con_c = cov_a / det_safe
    mid = 0.5 * (cov_a + cov_c)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))
    # pixel centre convention of the reference: fx*X/Z + cx - 0.5
    mx = fx * tx / tz_safe + cxx - 0.5
    my = fy * ty / tz_safe + cyy - 0.5
    on_screen = (
        (mx + radius >= 0)
        & (mx - radius <= W - 1)
        & (my + radius >= 0)
        & (my - radius <= H - 1)
    )
    splat_valid = in_front_splat & invertible & on_screen
    radius = torch.where(splat_valid, radius, torch.zeros_like(radius))

    # ---- triangle screen projection
    def _proj(vx, vy, vz):
        zc_ = r20 * vx + r21 * vy + r22 * vz + tvec[2]
        xc_ = r00 * vx + r01 * vy + r02 * vz + tvec[0]
        yc_ = r10 * vx + r11 * vy + r12 * vz + tvec[1]
        z_safe = torch.where(zc_ > _Z_NEAR_MESH, zc_, torch.ones_like(zc_))
        return (
            fx * xc_ / z_safe + cxx - 0.5,
            fy * yc_ / z_safe + cyy - 0.5,
            zc_,
        )

    x0, y0, z0 = _proj(ax, ay, az)
    x1, y1, z1 = _proj(bx, by, bz)
    x2, y2, z2 = _proj(cx, cy, cz)
    in_front_mesh = (z0 > _Z_NEAR_MESH) & (z1 > _Z_NEAR_MESH) & (z2 > _Z_NEAR_MESH)
    denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2)
    # row 18 is taken BEFORE the window cull below, as in the reference; a
    # culled face is never binned, so the row is not read for it
    mvalid = (in_front_mesh & (torch.abs(denom) >= 1e-12)).to(torch.float32)

    # barycentric PLANE coefficients (per-face constants) anchored at vertex
    # 2: w0(p) = w0x*(px-x2) + w0y*(py-y2), z(p) = zx*(px-x2) + zy*(py-y2) + z2
    inv_denom = 1.0 / torch.where(torch.abs(denom) >= 1e-12, denom, torch.ones_like(denom))
    w0x = (y1 - y2) * inv_denom
    w0y = (x2 - x1) * inv_denom
    w1x = (y2 - y0) * inv_denom
    w1y = (x0 - x2) * inv_denom
    zx = w0x * (z0 - z2) + w1x * (z1 - z2)
    zy = w0y * (z0 - z2) + w1y * (z1 - z2)

    # ---- summed vertex normals (the reference's `ones`-barycentric phong
    # quirk): unnormalized face crosses -> incident sum per vertex ->
    # normalize -> sum the 3 corners, then rotate to camera space
    crx = (by - ay) * (cz - az) - (bz - az) * (cy - ay)
    cry = (bz - az) * (cx - ax) - (bx - ax) * (cz - az)
    crz = (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)
    crosses = torch.stack([crx, cry, crz], dim=-1)  # (F, 3)
    acc = torch.sum(crosses[vf_incidence] * vf_valid[..., None], dim=1)  # (V, 3)
    vn = acc / (torch.linalg.norm(acc, dim=-1, keepdim=True) + 1e-12)
    nsum = vn[faces[:, 0]] + vn[faces[:, 1]] + vn[faces[:, 2]]  # (F, 3)
    nsum_cam = torch.matmul(nsum, Rc.T)

    # ---- per-pass bounding boxes
    m = blur_margin_px
    tb_x0 = torch.minimum(torch.minimum(x0, x1), x2)
    tb_x1 = torch.maximum(torch.maximum(x0, x1), x2)
    tb_y0 = torch.minimum(torch.minimum(y0, y1), y2)
    tb_y1 = torch.maximum(torch.maximum(y0, y1), y2)

    # window cull of mesh faces, like the splat pass's on_screen: binning
    # would otherwise clamp off-window boxes onto the boundary tiles
    mesh_on = (
        (tb_x1 + m >= 0)
        & (tb_x0 - m <= W - 1)
        & (tb_y1 + m >= 0)
        & (tb_y0 - m <= H - 1)
    )
    in_front_mesh = in_front_mesh & mesh_on

    opacity = splat_valid.to(torch.float32)  # GoM opacity is fixed 1.0
    zeros = torch.zeros_like(mx)
    table = torch.stack(
        [
            mx, my, con_a, con_b, con_c,
            opacity,
            colors[:, 0], colors[:, 1], colors[:, 2],
            w0x, w0y, w1x, w1y, x2, y2,
            zx, zy, z2,
            mvalid,
            nsum_cam[:, 0], nsum_cam[:, 1], nsum_cam[:, 2],
            zeros, zeros,
        ],
        dim=-1,
    )  # (F, NCH)

    return FrameGeometry(
        table=table,
        sx0=mx - radius, sx1=mx + radius, sy0=my - radius, sy1=my + radius,
        mx0=tb_x0 - m, mx1=tb_x1 + m, my0=tb_y0 - m, my1=tb_y1 + m,
        valid_splat=splat_valid, valid_mesh=in_front_mesh,
        depth=tz,
    )
