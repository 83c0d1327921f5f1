"""SMPL kinematic chain: pose -> bone transforms, forward kinematics, LBS
(port of gomavatar_tpu/ops/skeleton.py).

Points are row-major ``(N, 3)`` and skinning weights ``(N, J)``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gomavatar_tpu_torch.ops.transforms import construct_G, einsum_hi, mm, so3_exp

# Kinematic parent tables; index 0 is the root and PARENT[0] is unused.
SMPL_PARENT = np.array(
    [0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17, 18, 19, 20, 21],
    dtype=np.int32,
)

# 55-joint SMPL-X chain: body (22) + jaw/eyes (22-24) + 15 finger joints per
# hand rooted at the wrists (20/21).
SMPLX_PARENT = np.array(
    [
        0, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
        18, 19,                      # body
        15, 15, 15,                  # jaw, left eye, right eye
        20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,  # left hand
        21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53,  # right hand
    ],
    dtype=np.int32,
)

NUM_SMPL_JOINTS = 24


def _parent_table(use_smplx: bool) -> np.ndarray:
    return SMPLX_PARENT if use_smplx else SMPL_PARENT


@functools.lru_cache(maxsize=None)
def _parent_index(use_smplx: bool, J: int, device: torch.device) -> torch.Tensor:
    """The parent table's first ``J`` entries on ``device``, copied there
    once: a copy from pageable host memory waits for the device's queue,
    and the pose-refinement loop calls :func:`body_pose_to_body_RTs` every
    step."""
    return torch.as_tensor(_parent_table(use_smplx)[:J], dtype=torch.long, device=device)


def body_pose_to_body_RTs(
    jangles: torch.Tensor, tpose_joints: torch.Tensor, use_smplx: bool = False
):
    """(J*3,) or (J, 3) axis-angle pose + (J, 3) T-pose joints -> local
    rotations (J, 3, 3) and translations (J, 3); the root keeps its absolute
    position, children are offsets from their parent."""
    jangles = jangles.reshape(-1, 3)
    J = jangles.shape[0]
    Rs = so3_exp(jangles)
    Ts = tpose_joints - tpose_joints[_parent_index(use_smplx, J, tpose_joints.device)]
    Ts[0] = tpose_joints[0]
    return Rs, Ts


def get_canonical_global_tfms(canonical_joints: torch.Tensor, use_smplx: bool = False) -> torch.Tensor:
    """Canonical joints (J, 3) -> (J, 4, 4) global transforms of the zero
    pose: identity rotations, translations to the joint positions."""
    J = canonical_joints.shape[0]
    eye = torch.eye(3, dtype=canonical_joints.dtype, device=canonical_joints.device)
    return construct_G(eye.expand(J, 3, 3), canonical_joints)


def fk_chain(local_Gs: torch.Tensor, use_smplx: bool = False) -> torch.Tensor:
    """Compose local per-joint 4x4s (..., J, 4, 4) down the kinematic tree."""
    parent = _parent_table(use_smplx)
    J = local_Gs.shape[-3]
    out = [local_Gs[..., 0, :, :]]
    for i in range(1, J):
        out.append(mm(out[parent[i]], local_Gs[..., i, :, :]))
    return torch.stack(out, dim=-3)


def get_global_RTs(
    cnl_gtfms: torch.Tensor,
    dst_Rs: torch.Tensor,
    dst_Ts: torch.Tensor,
    use_smplx: bool = False,
):
    """Per-bone skinning transforms G_dst @ inv(G_cnl): (..., J, 3, 3) and
    (..., J, 3).  The canonical inverse is the closed-form rigid inverse."""
    dst_gtfms = fk_chain(construct_G(dst_Rs, dst_Ts), use_smplx=use_smplx)
    R_cnl = cnl_gtfms[..., :3, :3]
    t_cnl = cnl_gtfms[..., :3, 3]
    R_cnl_inv = torch.swapaxes(R_cnl, -1, -2)
    t_cnl_inv = -einsum_hi("...ij,...j->...i", R_cnl_inv, t_cnl)
    f_mtx = mm(dst_gtfms, construct_G(R_cnl_inv, t_cnl_inv))
    return f_mtx[..., :3, :3], f_mtx[..., :3, 3]


def apply_lbs(
    xyzs: torch.Tensor,
    global_Rs: torch.Tensor,
    global_Ts: torch.Tensor,
    lbs_weights: torch.Tensor,
) -> torch.Tensor:
    """Linear blend skinning of (N, 3) canonical points with (N, J) weights:
    blend the J bone transforms per point, then apply one 3x3 per point."""
    R_blend = mm(lbs_weights, global_Rs.reshape(global_Rs.shape[0], 9)).reshape(-1, 3, 3)
    T_blend = mm(lbs_weights, global_Ts)
    return einsum_hi("nij,nj->ni", R_blend, xyzs) + T_blend


def get_joints_from_pose(dst_poses: torch.Tensor, tpose_joints: torch.Tensor, use_smplx: bool = False) -> torch.Tensor:
    """Posed joint positions (J, 3) of a 72-d pose: FK of the pose's bone
    transforms, read off the translation column."""
    Rs, Ts = body_pose_to_body_RTs(dst_poses, tpose_joints, use_smplx=use_smplx)
    Gs = fk_chain(construct_G(Rs, Ts), use_smplx=use_smplx)
    return Gs[..., :3, 3]
