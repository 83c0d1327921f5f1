"""Auxiliary losses and point-cloud ops (port of
gomavatar_tpu/ops/aux_losses.py): total variation, 2D/3D Chamfer, the
``knn_points`` surface and local PCA frames.  The training loss does not
use them (its Laplacian is the mesh one, losses.py); they complete the
reference's surface.
"""

from __future__ import annotations

import torch


def tv_loss(img: torch.Tensor) -> torch.Tensor:
    """Total variation of (..., H, W, C) images: the mean squared forward
    differences along H and along W, summed, times 2."""
    dh = img[..., 1:, :, :] - img[..., :-1, :, :]
    dw = img[..., :, 1:, :] - img[..., :, :-1, :]
    return 2.0 * (torch.mean(dh**2) + torch.mean(dw**2))


def pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(N, D), (M, D) -> (N, M) squared distances, by the expansion
    |a|^2 - 2 a.b + |b|^2 clamped at 0."""
    aa = torch.sum(a * a, dim=-1, keepdim=True)
    bb = torch.sum(b * b, dim=-1, keepdim=True)
    return torch.clamp_min(aa - 2.0 * (a @ b.T) + bb.T, 0.0)


def chamfer_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetric Chamfer distance between two point sets (2D or 3D)."""
    d = pairwise_sq_dists(a, b)
    return torch.mean(torch.amin(d, dim=1)) + torch.mean(torch.amin(d, dim=0))


def knn_points(query: torch.Tensor, points: torch.Tensor, k: int):
    """The k nearest neighbours of each query point, nearest first:
    (squared distances (N, k), indices (N, k))."""
    neg_d, idx = torch.topk(-pairwise_sq_dists(query, points), k, dim=-1)
    return -neg_d, idx


def estimate_pointcloud_local_coord_frames(points: torch.Tensor, k: int = 8):
    """Per-point PCA of the k-NN neighbourhood: (eigenvalues (N, 3)
    ascending, eigenvectors (N, 3, 3) as columns) of its covariance."""
    _, idx = knn_points(points, points, k)
    nbrs = points[idx]  # (N, k, 3)
    centered = nbrs - nbrs.mean(dim=1, keepdim=True)
    cov = torch.einsum("nki,nkj->nij", centered, centered) / k
    eigvals, eigvecs = torch.linalg.eigh(cov)
    return eigvals, eigvecs
