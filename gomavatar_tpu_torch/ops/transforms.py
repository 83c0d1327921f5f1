"""Rotation / rigid-transform primitives (port of gomavatar_tpu/ops/transforms.py).

Float32 matmuls run in full float32: the package turns TF32 off
(``gomavatar_tpu_torch/__init__.py``), which is what the reference's
``precision="highest"`` asks of XLA.
"""

from __future__ import annotations

import torch

_SMALL_ANGLE = 1e-8


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def einsum_hi(eq: str, *operands: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, *operands)


def hat(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric (cross-product) matrix of ``v``: (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    rows = [
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def so3_exp(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3): Rodrigues with a
    Taylor switch below theta^2 = 1e-8 (the masked sqrt keeps gradients
    finite at theta == 0)."""
    theta_sq = torch.sum(rvec * rvec, dim=-1)
    small = theta_sq < _SMALL_ANGLE
    one = torch.ones_like(theta_sq)
    theta = torch.sqrt(torch.where(small, one, theta_sq))
    sin_over = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    one_minus_cos_over = torch.where(
        small,
        0.5 - theta_sq / 24.0,
        (1.0 - torch.cos(theta)) / torch.where(small, one, theta_sq),
    )
    K = hat(rvec)
    KK = mm(K, K)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    return eye + sin_over[..., None, None] * K + one_minus_cos_over[..., None, None] * KK


def construct_G(R: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Pack rotation (..., 3, 3) + translation (..., 3) into (..., 4, 4)."""
    batch = R.shape[:-2]
    G = torch.zeros(batch + (4, 4), dtype=R.dtype, device=R.device)
    G[..., :3, :3] = R
    G[..., :3, 3] = T
    G[..., 3, 3].fill_(1.0)  # a fill on the device: a Python scalar assigned would be copied from the host
    return G


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3), principal branch
    (the angle's cosine clipped to 1e-7 inside [-1, 1])."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7))
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    scale = torch.where(theta < 1e-4, 0.5 + theta * theta / 12.0,
                        theta / (2.0 * torch.clamp_min(torch.sin(theta), 1e-8)))
    return w * scale[..., None]


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) [w, x, y, z], normalised here -> rotation matrix
    (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
    ]
    return torch.stack(rows, dim=-2)
