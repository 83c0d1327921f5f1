"""LBS-weight volume priors of the HumanNeRF lineage (port of
gomavatar_tpu/ops/lbs_volume.py): a 32^3 Gaussian-bone volume over the
canonical bbox and an SMPL-kNN point variant.  The GoM pipeline takes its
skinning weights from the SMPL vertices and never reads them; they are part
of the reference's public surface.  Batched einsums over all bones at once.

Host side (numpy): they run once, at dataset construction.
"""

from __future__ import annotations

import numpy as np

from gomavatar_tpu_torch.ops.skeleton import SMPL_PARENT, SMPLX_PARENT

# body-prior standard deviations (reference body_util.py:113-115; the
# volume functions use 2x these)
BONE_STDS = np.array([0.03, 0.06, 0.03], np.float32)
HEAD_STDS = np.array([0.06, 0.06, 0.06], np.float32)
JOINT_STDS = np.array([0.02, 0.02, 0.02], np.float32)
# torso bones are slimmed 1.5x on the two cross-bone axes (body_util.py:465-467)
TORSO_JOINTS = np.array([0, 3, 6, 9, 13, 14], np.int32)
HEAD_JOINT = 15
_CALIBRATED_BONE = np.array([0.0, 1.0, 0.0], np.float32)  # rest bone direction


def _rotation_between(v1: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """Batched rotation matrices aligning v1[i] to v2[i] (Rodrigues form,
    reference body_util.py:171-205) — vectorized, no per-row Python loop."""
    v1 = v1 / np.clip(np.linalg.norm(v1, axis=-1, keepdims=True), 1e-5, None)
    v2 = v2 / np.clip(np.linalg.norm(v2, axis=-1, keepdims=True), 1e-5, None)
    n = np.cross(v1, v2)
    cos = np.sum(v1 * v2, axis=-1)[:, None, None]
    z = np.zeros(n.shape[0], n.dtype)
    K = np.stack(
        [z, -n[:, 2], n[:, 1], n[:, 2], z, -n[:, 0], -n[:, 1], n[:, 0], z],
        axis=-1,
    ).reshape(-1, 3, 3)
    return np.eye(3, dtype=n.dtype) + K + (K @ K) / (1.0 + cos)


def gaussian_bone_volumes(
    tpose_joints: np.ndarray,
    bbox_min_xyz: np.ndarray,
    bbox_max_xyz: np.ndarray,
    grid_size: int = 32,
    use_smplx: bool = False,
) -> np.ndarray:
    """(J+1, G, G, G) Gaussian-bone weight volume + background channel
    (reference ``approx_gaussian_bone_volumes``, body_util.py:427-509).

    Joint j's channel sums a Gaussian along every bone whose PARENT is j;
    childless joints get an isotropic joint (or head) Gaussian.  The last
    channel is the clipped background residual; channels are normalized
    with the reference's 0.001 clamp."""
    parent = np.asarray(SMPLX_PARENT if use_smplx else SMPL_PARENT)
    J = tpose_joints.shape[0]
    tj = tpose_joints.astype(np.float32)

    # --- per-bone Gaussians (bone b spans parent[b] -> b), batched
    bones = np.arange(1, J, dtype=np.int32)  # bone 0 has no parent edge
    bones = bones[parent[bones] >= 0]
    starts, ends = tj[parent[bones]], tj[bones]
    centers = 0.5 * (starts + ends)
    R = _rotation_between(
        np.broadcast_to(_CALIBRATED_BONE, (bones.shape[0], 3)), ends - starts
    )
    inv_stds = np.broadcast_to(1.0 / (2.0 * BONE_STDS), (bones.shape[0], 3)).copy()
    torso = np.isin(parent[bones], TORSO_JOINTS)
    inv_stds[torso, 0] /= 1.5
    inv_stds[torso, 2] /= 1.5
    owner = parent[bones]  # channel each bone accumulates into

    # --- childless joints: isotropic Gaussians.  (Root self-parent
    # convention: our parent[0] == 0 where the reference uses -1 — bone 0
    # is not a real edge, so child flags come from bones 1.. only.)
    has_child = np.zeros(J, bool)
    has_child[parent[bones]] = True
    leaves = np.nonzero(~has_child)[0].astype(np.int32)
    leaf_stds = np.where(
        (leaves == HEAD_JOINT)[:, None], 2.0 * HEAD_STDS, 2.0 * JOINT_STDS
    )
    centers = np.concatenate([centers, tj[leaves]])
    R = np.concatenate([R, np.broadcast_to(np.eye(3, dtype=np.float32),
                                           (leaves.shape[0], 3, 3))])
    inv_stds = np.concatenate([inv_stds, 1.0 / leaf_stds])
    owner = np.concatenate([owner, leaves])

    # SIGMA = R S S R^T with S = diag(1/std); one einsum for all gaussians
    S2 = inv_stds[:, None, :] ** 2 * np.eye(3, dtype=np.float32)
    SIGMA = np.einsum("bij,bjk,blk->bil", R, S2, R)

    # grid in the reference's (z, y, x)-major layout
    axes = [
        np.linspace(bbox_min_xyz[i], bbox_max_xyz[i], grid_size).astype(np.float32)
        for i in range(3)
    ]
    zg, yg, xg = np.meshgrid(axes[2], axes[1], axes[0], indexing="ij")
    grid = np.stack([xg, yg, zg], axis=-1).reshape(-1, 3)  # (G^3, 3)

    d = grid[None] - centers[:, None]  # (B, G^3, 3)
    dist = np.einsum("bni,bij,bnj->bn", d, SIGMA, d)
    vol = np.exp(-dist).astype(np.float32)  # (B, G^3)

    g = np.zeros((J, grid.shape[0]), np.float32)
    np.add.at(g, owner, vol)
    g = g.reshape(J, grid_size, grid_size, grid_size)

    bg = 1.0 - np.clip(np.sum(g, axis=0, keepdims=True), 0.0, 1.0)
    g = np.concatenate([g, bg], axis=0)
    return g / np.clip(np.sum(g, axis=0, keepdims=True), 0.001, None)


def lbs_weights_knn(
    vertex: np.ndarray,
    weights_init: np.ndarray,
    xyzs: np.ndarray,
    K: int = 1,
    sigma: float = 0.2,
) -> np.ndarray:
    """(J+1, N) SMPL-kNN weight prior (reference
    ``approx_gaussian_bone_volumes_smpl``, body_util.py:512-550): each query
    point takes the distance-weighted mean of its K nearest SMPL vertices'
    skinning weights, plus the background residual channel."""
    pts = xyzs.T.astype(np.float32)  # (N, 3); reference takes (3, N)
    d2 = np.sum((pts[:, None] - vertex[None]) ** 2, axis=-1)  # (N, V)
    idx = np.argpartition(d2, K - 1, axis=-1)[:, :K]  # (N, K) unordered top-K
    dk = np.take_along_axis(d2, idx, axis=-1)
    prob = np.exp(-0.5 * dk / (sigma * sigma))  # (N, K)
    wk = weights_init[idx]  # (N, K, J)
    g = np.einsum("nk,nkj->jn", prob, wk).astype(np.float32) / K  # (J, N)
    bg = 1.0 - np.clip(np.sum(g, axis=0, keepdims=True), 0.0, 1.0)
    g = np.concatenate([g, bg], axis=0)
    return g / np.clip(np.sum(g, axis=0, keepdims=True), 0.001, None)
