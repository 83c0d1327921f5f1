"""A train frame as the recipe decodes it, from the files the benchmark
wrote: the image and mask read with PIL, undistorted with the camera's
coefficients where it has them, the image composited over the item's
background, resized to the frame size (Lanczos for the image, linear for
the mask), and the camera and pose turned into the step's inputs.
The background under ``random_bgcolor`` is ``rng((epoch, 0, position))``'s
first three uniforms times 255, the recipe's per-position draw."""

from __future__ import annotations

import os

import cv2
import numpy as np
from PIL import Image

SMPL_PARENT = np.array([0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21])


def rodrigues(rvec):
    theta = np.linalg.norm(rvec)
    if theta < 1e-10:
        return np.eye(3, dtype=np.float32)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)).astype(np.float32)


def fold_global(E, Rh, Th):
    """The extrinsics with the body's global rotation and translation folded in."""
    theta = np.linalg.norm(np.asarray(Rh, np.float64))
    if theta < 1e-12:
        R = np.eye(3)
    else:
        k = np.asarray(Rh, np.float64) / theta
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        R = np.eye(3) + np.sin(theta) * Kx + (1 - np.cos(theta)) * (Kx @ Kx)
    G = np.eye(4)
    G[:3, :3] = R.T
    G[:3, 3] = -R.T @ np.asarray(Th, np.float64)
    return np.asarray(E, np.float64) @ np.linalg.inv(G)


def pose_inputs(poses, tpose_joints, canonical_joints) -> dict:
    """dst_Rs, dst_Ts, cnl_gtfms, dst_posevec of a 72-d pose."""
    j = np.asarray(poses, np.float32).reshape(-1, 3)
    Rs = np.stack([rodrigues(j[i]) for i in range(len(j))]).astype(np.float32)
    Ts = tpose_joints - tpose_joints[SMPL_PARENT[:len(j)]]
    Ts[0] = tpose_joints[0]
    G = np.tile(np.eye(4, dtype=np.float32), (len(canonical_joints), 1, 1))
    G[:, :3, 3] = canonical_joints
    return {"dst_Rs": Rs, "dst_Ts": Ts.astype(np.float32), "cnl_gtfms": G,
            "dst_posevec": np.asarray(poses, np.float32).reshape(-1)[3:] + 1e-2}


def background(epoch: int, position: int) -> np.ndarray:
    return (np.random.default_rng((epoch, 0, position)).random(3) * 255.0).astype(np.float32)


def decode(root: str, name: str, camera: dict, mesh_info: dict, canonical_joints, target_size, bgcolor) -> dict:
    """The float32 inputs of a train step for frame ``name``."""
    img = np.array(Image.open(os.path.join(root, "images", name + ".png")))
    alpha = np.array(Image.open(os.path.join(root, "masks", name + ".png")))
    if alpha.ndim == 2:
        alpha = alpha[..., None].repeat(3, axis=-1)
    if "distortions" in camera:
        img = cv2.undistort(img, camera["intrinsics"], camera["distortions"])
        alpha = cv2.undistort(alpha, camera["intrinsics"], camera["distortions"])
    orig_h, orig_w = img.shape[:2]
    alpha = alpha / 255.0
    img = alpha * img.astype(np.float32) + (1.0 - alpha) * bgcolor[None, None, :]
    w, h = target_size
    img = cv2.resize(img, (w, h), interpolation=cv2.INTER_LANCZOS4)
    alpha = cv2.resize(alpha, (w, h), interpolation=cv2.INTER_LINEAR)
    K = camera["intrinsics"][:3, :3].copy()
    K[:1] *= w / orig_w
    K[1:2] *= h / orig_h
    out = {"bgcolor": bgcolor / 255.0, "K": K.astype(np.float32),
           "E": fold_global(camera["extrinsics"], mesh_info["Rh"], mesh_info["Th"]).astype(np.float32),
           "target_rgbs": (img / 255.0).astype(np.float32), "target_masks": alpha[..., 0].astype(np.float32)}
    out.update(pose_inputs(mesh_info["poses"], mesh_info["tpose_joints"].astype(np.float32), canonical_joints))
    return out
