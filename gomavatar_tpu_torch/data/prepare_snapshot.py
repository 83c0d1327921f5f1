"""PeopleSnapshot preprocessing (port of
gomavatar_tpu/data/prepare_snapshot.py): video + hdf5 masks + refined poses
-> training artifacts.

Decode the subject mp4, undistort + half-res, take poses from the
InstantAvatar-refined ``anim_nerf_{split}.npz`` (betas / global_orient /
body_pose / transl), apply the pelvis correction
``Th += J0 - R(Rh) J0``, and write the same artifact set as the ZJU
preprocessor.  Train/test split by frame range in the scene yaml.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import yaml

from gomavatar_tpu_torch.models.smpl import SMPL
from gomavatar_tpu_torch.ops.mesh_ops import unique_edges


def _rodrigues(r):
    theta = np.linalg.norm(r)
    if theta < 1e-12:
        return np.eye(3)
    k = r / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def decode_video(path):
    import cv2

    cap = cv2.VideoCapture(path)
    frames = []
    ok, frame = cap.read()
    while ok:
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        ok, frame = cap.read()
    cap.release()
    return frames


def prepare_snapshot(cfg: dict, smpl_model_path: str):
    """Write the artifacts of one subject's split; returns the output
    directory."""
    import cv2

    subject = cfg["dataset"]["subject"]
    start_frame = cfg["start_frame"]
    end_frame = cfg["end_frame"]
    skip = cfg.get("skip", 1)
    subject_dir = os.path.join(cfg["dataset"]["snapshot_path"], subject)
    pose_npz = os.path.join(
        cfg["dataset"]["pose_path"], subject, "poses", f"anim_nerf_{cfg['split']}.npz"
    )

    with open(os.path.join(subject_dir, "camera.pkl"), "rb") as f:
        u = pickle._Unpickler(f)
        u.encoding = "latin1"
        camera = u.load()
    K = np.zeros((3, 3))
    K[0, 0], K[1, 1] = camera["camera_f"]
    K[:2, 2] = camera["camera_c"]
    K[2, 2] = 1
    D = camera["camera_k"]
    E = np.eye(4)

    out = cfg["output"]
    output_path = os.path.join(out["dir"], out.get("name", subject))
    os.makedirs(os.path.join(output_path, "images"), exist_ok=True)
    os.makedirs(os.path.join(output_path, "masks"), exist_ok=True)

    imgs = decode_video(os.path.join(subject_dir, subject + ".mp4"))
    import h5py

    with h5py.File(os.path.join(subject_dir, "masks.hdf5"), "r") as f:
        masks = np.asarray(f["masks"]).astype(np.uint8)

    smpl = SMPL(smpl_model_path)
    npz = dict(np.load(pose_npz))
    betas = npz["betas"][0]
    global_orient = npz["global_orient"]
    body_pose = npz["body_pose"]
    transl = npz["transl"]

    cameras, mesh_infos = {}, {}
    for idx in range(start_frame, end_frame + 1, skip):
        i = (idx - start_frame) // skip
        out_name = f"frame_{i:06d}"

        img = cv2.undistort(imgs[idx], K, D)
        img = cv2.resize(img, dsize=None, fx=0.5, fy=0.5)
        mask = cv2.undistort(masks[idx], K, D)
        mask = cv2.resize(mask, dsize=None, fx=0.5, fy=0.5)
        cv2.imwrite(os.path.join(output_path, "images", out_name + ".png"),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        cv2.imwrite(os.path.join(output_path, "masks", out_name + ".png"),
                    (mask * 255).astype(np.uint8))

        poses = np.concatenate([np.zeros(3, body_pose.dtype), body_pose[i]])
        Rh = global_orient[i]
        _, tpose_joints = smpl(np.zeros_like(poses), betas)
        _, joints = smpl(poses, betas)
        # pelvis correction: anim_nerf's transl is about the pelvis, ours
        # rotates about the origin
        Th = transl[i] + tpose_joints[0] - _rodrigues(Rh) @ tpose_joints[0]

        mesh_infos[out_name] = {
            "Rh": Rh,
            "Th": Th,
            "poses": poses,
            "joints": joints,
            "tpose_joints": tpose_joints,
        }
        K_half = K.copy()
        K_half[:2] *= 0.5
        cameras[out_name] = {"intrinsics": K_half, "extrinsics": E, "distortions": D}

    with open(os.path.join(output_path, "cameras.pkl"), "wb") as f:
        pickle.dump(cameras, f)
    with open(os.path.join(output_path, "mesh_infos.pkl"), "wb") as f:
        pickle.dump(mesh_infos, f)

    v, template_joints, weights = smpl(np.zeros(72), betas, return_weights=True)
    edges, _ = unique_edges(smpl.faces)
    with open(os.path.join(output_path, "canonical_joints.pkl"), "wb") as f:
        pickle.dump(
            {
                "vertex": v,
                "joints": template_joints,
                "weights": weights,
                "edges": edges,
                "faces": smpl.faces,
            },
            f,
        )
    return output_path


def main(argv=None):
    ap = argparse.ArgumentParser(description="Prepare a PeopleSnapshot subject (gomavatar_tpu_torch).")
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--smpl_model", required=True)
    args = ap.parse_args(argv)
    with open(args.cfg) as f:
        cfg = yaml.safe_load(f)
    return prepare_snapshot(cfg, args.smpl_model)


if __name__ == "__main__":
    main()
