"""Training-frame sampling (port of gomavatar_tpu/utils/sampling.py).

``make_weights_for_pose_balance``: yaw-balanced frame sampling weights.
Frames are bucketed by the camera yaw of their extrinsics and weighted
inversely by bucket occupancy, so that every body orientation is sampled
evenly.
"""

from __future__ import annotations

import numpy as np


def make_weights_for_pose_balance(Es: np.ndarray, nbins: int = 8) -> np.ndarray:
    """Es: (N, 4, 4) per-frame extrinsics (with the SMPL global transform
    folded in, so yaw reflects body orientation relative to the camera).
    Returns (N,) sampling weights summing to N."""
    # camera forward axis in world frame
    fwd = np.einsum("nij,j->ni", Es[:, :3, :3].transpose(0, 2, 1), np.array([0.0, 0.0, 1.0]))
    yaw = np.arctan2(fwd[:, 0], fwd[:, 2])
    bins = np.clip(((yaw + np.pi) / (2 * np.pi) * nbins).astype(int), 0, nbins - 1)
    counts = np.bincount(bins, minlength=nbins).astype(np.float64)
    w = 1.0 / np.maximum(counts[bins], 1.0)
    return (w / w.sum() * len(w)).astype(np.float32)


def balanced_order(Es: np.ndarray, n_draws: int, rng: np.random.Generator, nbins: int = 8):
    """Sample a frame visit order using pose-balanced weights."""
    w = make_weights_for_pose_balance(Es, nbins)
    p = w / w.sum()
    return rng.choice(len(w), size=n_draws, p=p)
