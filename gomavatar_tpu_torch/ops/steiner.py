"""Steiner-ellipse frame of a triangle -> 3D Gaussian covariance (port of
gomavatar_tpu/ops/steiner.py).

The 3x3 transform of a face has the columns (2*axis0, 2*axis1,
sigma*normal), where axis0/axis1 are the semi-axes of the triangle's Steiner
circumellipse; the per-face covariance is ``M M^T`` with ``M = T R S``.
"""

from __future__ import annotations

import torch

from gomavatar_tpu_torch.ops.mesh_ops import gather_rows
from gomavatar_tpu_torch.ops.transforms import so3_exp

_SQRT3 = 1.7320508075688772


def steiner_transform(triangles: torch.Tensor, sigma: float = 0.001) -> torch.Tensor:
    """triangles (..., 3, 3) (three vertices, xyz) -> (..., 3, 3) transform."""
    centroid = triangles.mean(dim=-2)
    f1 = 0.5 * (triangles[..., 2, :] - centroid)
    f2 = (1.0 / (2.0 * _SQRT3)) * (triangles[..., 1, :] - triangles[..., 0, :])

    cross_term = 2.0 * torch.sum(f1 * f2, dim=-1)
    diff_term = torch.sum(f1 * f1, dim=-1) - torch.sum(f2 * f2, dim=-1)
    t0 = (0.5 * torch.atan2(cross_term, diff_term))[..., None]

    cos_t0 = torch.cos(t0)
    sin_t0 = torch.sin(t0)
    axis0 = f1 * cos_t0 + f2 * sin_t0
    axis1 = -f1 * sin_t0 + f2 * cos_t0  # the conjugate diameter at t0 + pi/2

    normal = torch.cross(axis0, axis1, dim=-1)
    normal = normal / (torch.linalg.norm(normal, dim=-1, keepdim=True) + 1e-20) * sigma
    return torch.stack([axis0 * 2.0, axis1 * 2.0, normal], dim=-1)


def face_covariances(
    vertices: torch.Tensor,
    faces: torch.Tensor,
    so3_params: torch.Tensor,
    scale_params: torch.Tensor,
    sigma: float = 0.001,
) -> torch.Tensor:
    """Per-face covariance (F, 3, 3): cov = T (R S S^T R^T) T^T with T the
    Steiner frame of the face and (R, S) its learnable rotation and scale."""
    return face_covariances_tri(gather_rows(vertices, faces), so3_params, scale_params, sigma)


def face_covariances_tri(
    tris: torch.Tensor,
    so3_params: torch.Tensor,
    scale_params: torch.Tensor,
    sigma: float = 0.001,
) -> torch.Tensor:
    """:func:`face_covariances` on gathered triangles (F, 3, 3)."""
    T = steiner_transform(tris, sigma)
    RS = so3_exp(so3_params) * scale_params[..., None, :]  # R @ diag(s)
    M = _mm3(T, RS)
    return _mm3(M, M.transpose(-1, -2))


def _mm3(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched (..., 3, 3) @ (..., 3, 3), summed in the reference's order."""
    rows = []
    for i in range(3):
        cols = [
            A[..., i, 0] * B[..., 0, j] + A[..., i, 1] * B[..., 1, j] + A[..., i, 2] * B[..., 2, j]
            for j in range(3)
        ]
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)
