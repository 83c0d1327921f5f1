"""Camera math: projections, NDC, global-transform folding, freeview orbits
(port of gomavatar_tpu/ops/camera.py).

The projections are torch functions on row-major ``(N, 3)`` points; the
host-side helpers that the datasets call once per frame (extrinsics folding,
orbits) are numpy, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from gomavatar_tpu_torch.ops.transforms import mm


# ---------------------------------------------------------------------------
# projections (torch, (N, 3) points)
# ---------------------------------------------------------------------------

def cam_T_world(xyzs_world: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
    """World -> camera: (N, 3), E (4, 4) -> (N, 3)."""
    return mm(xyzs_world, E[:3, :3].T) + E[:3, 3]


def img_T_cam(xyzs_cam: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Camera -> pixel coordinates: (N, 3), K (3, 3) -> (N, 2)."""
    xys = mm(xyzs_cam, K.T)
    return xys[..., :2] / xys[..., 2:3]


def img_T_world(xyzs_world: torch.Tensor, K: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
    return img_T_cam(cam_T_world(xyzs_world, E), K)


def ndc_T_world(xyzs_world: torch.Tensor, K: torch.Tensor, E: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """World -> the reference mesh rasterizer's NDC convention: normalised
    by the short side, x and y flipped, camera-space z kept."""
    xyzs_cam = cam_T_world(xyzs_world, E)
    xys = img_T_cam(xyzs_cam, K)
    if H < W:
        xs = -((xys[..., 0] / H) * 2.0 - (W / H))
        ys = -((xys[..., 1] / H) * 2.0 - 1.0)
    else:
        xs = -((xys[..., 0] / W) * 2.0 - 1.0)
        ys = -((xys[..., 1] / W) * 2.0 - (H / W))
    return torch.stack([xs, ys, xyzs_cam[..., 2]], dim=-1)


def focal2fov(focal, pixels):
    """Focal length -> field of view."""
    return 2.0 * np.arctan(pixels / (2.0 * focal))


# ---------------------------------------------------------------------------
# host-side camera helpers (numpy; dataset time)
# ---------------------------------------------------------------------------

def _np_rodrigues(rvec: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.eye(3, dtype=np.float64)
    r = rvec.reshape(3) / theta
    K = np.array([[0, -r[2], r[1]], [r[2], 0, -r[0]], [-r[1], r[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def apply_global_tfm_to_camera(E, Rh, Th, return_global_tfms: bool = False):
    """Fold the SMPL global rotation and translation (Rh, Th) into the
    camera extrinsics, so that the body sits at the origin."""
    global_tfms = np.eye(4)
    global_rot = _np_rodrigues(np.asarray(Rh, dtype=np.float64)).T
    global_tfms[:3, :3] = global_rot
    global_tfms[:3, 3] = -global_rot @ np.asarray(Th, dtype=np.float64)
    E_new = np.asarray(E, dtype=np.float64) @ np.linalg.inv(global_tfms)
    if return_global_tfms:
        return E_new, global_tfms
    return E_new


def get_camrot(campos, lookat=None, up=None, inv_camera: bool = False) -> np.ndarray:
    """Look-at rotation."""
    campos = np.asarray(campos, dtype=np.float64)
    lookat = np.zeros(3) if lookat is None else np.asarray(lookat, dtype=np.float64)
    if up is None:
        up = np.array([0.0, 1.0, 0.0])
        if inv_camera:
            up = up * np.array([1.0, -1.0, 1.0])
    up = np.asarray(up, dtype=np.float64)
    forward = lookat - campos
    forward = forward / np.linalg.norm(forward)
    right = np.cross(up, forward)
    right = right / np.linalg.norm(right)
    up = np.cross(forward, right)
    up = up / np.linalg.norm(up)
    return np.stack([right, up, forward], axis=0)


def _update_extrinsics(extrinsics, angle, trans=None, rotate_axis="y") -> np.ndarray:
    """Rotate a camera about a world axis, keeping it aimed at the subject."""
    E = np.asarray(extrinsics, dtype=np.float64)
    inv_E = np.linalg.inv(E)
    camrot = inv_E[:3, :3]
    campos = inv_E[:3, 3].copy()
    if trans is not None:
        campos -= trans
    if camrot.T[1, 1] < 0.0:
        angle = -angle
    grot_vec = np.zeros(3)
    grot_vec[{"x": 0, "y": 1, "z": 2}[rotate_axis]] = angle
    grot_mtx = _np_rodrigues(grot_vec)
    rot_campos = grot_mtx @ campos
    rot_camrot = grot_mtx @ camrot
    if trans is not None:
        rot_campos = rot_campos + trans
    new_E = np.eye(4)
    new_E[:3, :3] = rot_camrot.T
    new_E[:3, 3] = -rot_camrot.T @ rot_campos
    return new_E


def rotate_camera_by_frame_idx(
    extrinsics, frame_idx, trans=None, rotate_axis="y", period=196, inv_angle=False
) -> np.ndarray:
    """Freeview orbit camera for frame ``frame_idx`` of ``period``."""
    angle = 2.0 * np.pi * (frame_idx / period)
    if inv_angle:
        angle = -angle
    return _update_extrinsics(extrinsics, angle, trans, rotate_axis)
