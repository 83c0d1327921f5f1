"""EWA projection of 3D Gaussians to screen space (port of
gomavatar_tpu/ops/splat/projection.py): frustum cull, project the means,
push the 3D covariance through the perspective Jacobian, add the 0.3 px
low-pass, invert to conics, and compute the 3-sigma tile-coverage radii.
Differentiable by autograd.

K is a 3x3 pixel-unit intrinsics matrix and E a 4x4 world->camera matrix;
``mean2d`` has pixel centres at integer coordinates, x = fx X/Z + cx - 0.5.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gomavatar_tpu_torch.ops.transforms import mm


class ProjectedGaussians(NamedTuple):
    mean2d: torch.Tensor  # (N, 2) pixel coords
    conic: torch.Tensor  # (N, 3) packed inverse 2D covariance (a, b, c)
    depth: torch.Tensor  # (N,) camera-space z
    radius: torch.Tensor  # (N,) conservative pixel radius (0 for culled)
    valid: torch.Tensor  # (N,) bool


def project_gaussians(
    means3d: torch.Tensor,
    cov3d: torch.Tensor,
    K: torch.Tensor,
    E: torch.Tensor,
    img_size: tuple[int, int],
    znear: float = 0.2,
    blur: float = 0.3,
) -> ProjectedGaussians:
    """Project (N, 3) means and (N, 3, 3) covariances with K (3, 3) and E
    (4, 4) into an image of ``img_size`` = (W, H)."""
    W, H = img_size
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]

    R = E[:3, :3]
    tvec = E[:3, 3]
    t = mm(means3d, R.T) + tvec  # (N, 3) camera space
    tz = t[..., 2]

    in_front = tz > znear
    tz_safe = torch.where(in_front, tz, torch.ones_like(tz))

    # clamp the frustum coordinates like the CUDA preprocess does, bounding
    # the Jacobian of gaussians far outside the view cone
    limx = 1.3 * (0.5 * W / fx)
    limy = 1.3 * (0.5 * H / fy)
    txz = torch.clamp(t[..., 0] / tz_safe, -limx, limx)
    tyz = torch.clamp(t[..., 1] / tz_safe, -limy, limy)

    # R cov R^T as one (N, 9) @ (9, 9) product with kron(R, R)^T
    N = cov3d.shape[0]
    kron = torch.einsum("ij,lk->jkil", R, R).reshape(9, 9)
    M = torch.matmul(cov3d.reshape(N, 9), kron).reshape(N, 3, 3)

    # the perspective Jacobian J = [[fx/tz, 0, -fx txz/tz], [0, fy/tz, -fy tyz/tz]]
    a1 = fx / tz_safe
    c1 = -fx * txz / tz_safe
    b2 = fy / tz_safe
    c2 = -fy * tyz / tz_safe
    M00, M01, M02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    M11, M12, M22 = M[..., 1, 1], M[..., 1, 2], M[..., 2, 2]
    a = a1 * a1 * M00 + 2.0 * a1 * c1 * M02 + c1 * c1 * M22 + blur
    b = a1 * b2 * M01 + a1 * c2 * M02 + c1 * b2 * M12 + c1 * c2 * M22
    c = b2 * b2 * M11 + 2.0 * b2 * c2 * M12 + c2 * c2 * M22 + blur

    det = a * c - b * b
    invertible = det > 0.0
    det_safe = torch.where(invertible, det, torch.ones_like(det))
    conic = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)

    # conservative radius: 3 sigma of the major eigenvalue
    mid = 0.5 * (a + c)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam))

    mean2d = torch.stack(
        [fx * t[..., 0] / tz_safe + cx - 0.5, fy * t[..., 1] / tz_safe + cy - 0.5], dim=-1
    )

    # cull gaussians fully outside the image
    on_screen = (
        (mean2d[..., 0] + radius >= 0)
        & (mean2d[..., 0] - radius <= W - 1)
        & (mean2d[..., 1] + radius >= 0)
        & (mean2d[..., 1] - radius <= H - 1)
    )
    valid = in_front & invertible & on_screen
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    return ProjectedGaussians(mean2d=mean2d, conic=conic, depth=tz, radius=radius, valid=valid)
