"""Synthetic fixture writers (port of the dataset writers of
gomavatar_tpu/data/synthetic.py).

``write_synthetic_dataset`` writes a small but format-complete preprocessed
directory (images/, masks/, cameras.pkl, mesh_infos.pkl,
canonical_joints.pkl) from the procedural body of models/smpl.py, so that
the datasets and the drivers run end to end without the licensed SMPL asset
or a real capture; ``write_synthetic_zju_raw`` a raw-ZJU-format capture for
``ZJUTestDataset``; ``write_synthetic_mdm_poses`` an MDM motion file for
``NewPoseDataset``; ``write_synthetic_smpl_pkl``, ``write_synthetic_zju_capture``
and ``write_synthetic_snapshot_capture`` a random SMPL weight file and the raw
captures the preprocessors read.  For the same arguments their files are
byte-equal to the JAX package's writers'.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
from PIL import Image

from gomavatar_tpu_torch.models.smpl import synthetic_body


def write_synthetic_dataset(
    out_dir: str,
    n_frames: int = 4,
    img_hw: tuple[int, int] = (96, 96),
    seed: int = 0,
) -> str:
    """Create a synthetic preprocessed dir; returns its path.

    Images are flat-colored silhouettes of the (rigid) synthetic body seen
    from a fixed camera; poses wave one arm joint so frames differ.
    """
    rng = np.random.default_rng(seed)
    info = synthetic_body(n_rings=12, n_seg=10)
    H, W = img_hw

    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "masks"), exist_ok=True)

    # full-res camera: datasets will halve K and the images they load are
    # written at 2x so the half-res pipeline lands on (H, W)
    focal = 2 * H * 0.9
    K = np.array([[focal, 0, W], [0, focal, H], [0, 0, 1]], np.float64)
    E = np.eye(4)
    E[2, 3] = 3.0

    cameras, mesh_infos = {}, {}
    for i in range(n_frames):
        name = f"frame_{i:06d}"
        pose = np.zeros(72, np.float32)
        pose[3 * 10] = 0.2 * np.sin(i)  # animate a joint
        Rh = np.array([0.0, 0.05 * i, 0.0], np.float32)
        Th = np.array([0.01 * i, 0.0, 0.0], np.float32)

        # rasterize a crude silhouette on the host (bbox of projected verts)
        pts = info["canonical_vertex"] @ E[:3, :3].T + E[:3, 3]
        uv = (pts[:, :2] / pts[:, 2:3]) @ np.diag([focal, focal]) + np.array([W, H])
        img = np.zeros((2 * H, 2 * W, 3), np.uint8)
        mask = np.zeros((2 * H, 2 * W), np.uint8)
        u = np.clip(uv[:, 0].astype(int), 0, 2 * W - 1)
        v = np.clip(uv[:, 1].astype(int), 0, 2 * H - 1)
        mask[v, u] = 255
        # dilate the point splat into a blob
        import cv2

        mask = cv2.dilate(mask, np.ones((9, 9), np.uint8))
        img[mask > 0] = (rng.random(3) * 128 + 96).astype(np.uint8)

        Image.fromarray(img).save(os.path.join(out_dir, "images", name + ".png"))
        Image.fromarray(np.stack([mask] * 3, -1)).save(
            os.path.join(out_dir, "masks", name + ".png")
        )
        cameras[name] = {"intrinsics": K, "extrinsics": E}
        mesh_infos[name] = {
            "Rh": Rh,
            "Th": Th,
            "poses": pose,
            "joints": info["canonical_joints"],
            "tpose_joints": info["canonical_joints"],
        }

    with open(os.path.join(out_dir, "cameras.pkl"), "wb") as f:
        pickle.dump(cameras, f)
    with open(os.path.join(out_dir, "mesh_infos.pkl"), "wb") as f:
        pickle.dump(mesh_infos, f)
    with open(os.path.join(out_dir, "canonical_joints.pkl"), "wb") as f:
        pickle.dump(
            {
                "vertex": info["canonical_vertex"],
                "joints": info["canonical_joints"],
                "weights": info["canonical_lbs_weights"],
                "faces": info["faces"],
                "edges": None,
            },
            f,
        )
    return out_dir


def write_synthetic_zju_raw(
    out_dir: str,
    preprocessed_dir: str,
    n_views: int = 3,
    img_hw: tuple[int, int] = (96, 96),
):
    """Create a miniature raw-ZJU-format capture (annots.npy cameras,
    Camera_B*/ jpgs, mask/ + mask_cihp/ pngs) matching an existing synthetic
    preprocessed dir, so ``ZJUTestDataset`` is testable end-to-end."""
    H, W = img_hw
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(preprocessed_dir, "mesh_infos.pkl"), "rb") as f:
        mesh_infos = pickle.load(f)
    frames = sorted(mesh_infos.keys())

    focal = 2 * H * 0.9
    Ks, Rs, Ts, Ds, ims = [], [], [], [], []
    for v in range(n_views):
        angle = 2 * np.pi * v / max(n_views, 1) * 0.1
        R = np.array(
            [[np.cos(angle), 0, np.sin(angle)], [0, 1, 0], [-np.sin(angle), 0, np.cos(angle)]]
        )
        Ks.append(np.array([[focal, 0, W], [0, focal, H], [0, 0, 1.0]]))
        Rs.append(R)
        Ts.append(np.array([[0.0], [0.0], [3000.0], [1.0]]))  # mm, annots convention
        Ds.append(np.zeros((5, 1)))

    for i, name in enumerate(frames):
        row = {"ims": [f"Camera_B{v + 1}/{i:06d}.jpg" for v in range(n_views)]}
        ims.append(row)
        for v in range(n_views):
            cam_dir = os.path.join(out_dir, f"Camera_B{v + 1}")
            os.makedirs(cam_dir, exist_ok=True)
            img = np.full((2 * H, 2 * W, 3), 32, np.uint8)
            img[H // 2 : 3 * H // 2, W // 2 : 3 * W // 2] = 180
            Image.fromarray(img).save(os.path.join(cam_dir, f"{i:06d}.jpg"))
            for mdir in ("mask", "mask_cihp"):
                md = os.path.join(out_dir, mdir, f"Camera_B{v + 1}")
                os.makedirs(md, exist_ok=True)
                m = np.zeros((2 * H, 2 * W), np.uint8)
                m[H // 2 : 3 * H // 2, W // 2 : 3 * W // 2] = 255
                Image.fromarray(m).save(os.path.join(md, f"{i:06d}.png"))

    annots = {"cams": {"K": Ks, "R": Rs, "T": Ts, "D": Ds}, "ims": ims}
    np.save(os.path.join(out_dir, "annots.npy"), annots)
    return out_dir


def write_synthetic_mdm_poses(path: str, n_frames: int = 5):
    """Write an MDM-format motion file (thetas_ori (24, 3, T) +
    root_translation (3, T)) for NewPoseDataset tests."""
    rng = np.random.default_rng(0)
    thetas = rng.normal(scale=0.1, size=(24, 3, n_frames))
    root = rng.normal(scale=0.2, size=(3, n_frames))
    np.save(path, {"thetas_ori": thetas, "root_translation": root})
    return path


def write_synthetic_smpl_pkl(path: str, seed: int = 0, n_verts: int = 6890, n_faces: int = 13776):
    """A random SMPL-shaped weight file in the layout of the SMPL v1.0 pkl:
    sparse J_regressor, (N, 3, 10) shapedirs, (N, 3, 207) posedirs,
    kintree_table (the licensed asset is not shipped)."""
    from scipy import sparse

    from gomavatar_tpu_torch.ops.skeleton import SMPL_PARENT

    rng = np.random.default_rng(seed)
    N = n_verts
    kintree = np.zeros((2, 24), np.int64)
    kintree[1] = np.arange(24)
    kintree[0, 1:] = SMPL_PARENT[1:]
    J_reg = np.zeros((24, N))
    for j in range(24):
        idx = rng.choice(N, size=6, replace=False)
        J_reg[j, idx] = 1.0 / 6.0
    w = rng.random((N, 24))
    w = w / w.sum(axis=1, keepdims=True)
    data = {
        "v_template": rng.normal(size=(N, 3)) * 0.3,
        "shapedirs": rng.normal(size=(N, 3, 10)) * 0.01,
        "posedirs": rng.normal(size=(N, 3, 207)) * 0.01,
        "J_regressor": sparse.csr_matrix(J_reg),
        "weights": w,
        "f": rng.integers(0, N, size=(n_faces, 3)).astype(np.int64),
        "kintree_table": kintree,
    }
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return path


def write_synthetic_zju_capture(
    out_dir: str,
    subject: str = "377",
    n_frames: int = 3,
    n_views: int = 2,
    img_hw: tuple[int, int] = (64, 64),
    seed: int = 0,
):
    """A miniature raw ZJU-MoCap capture in the layout ``prepare_zju``
    reads: CoreView_<subject>/{annots.npy, new_params/<i>.npy,
    Camera_B*/<i>.jpg, mask{,_cihp}/Camera_B*/<i>.png}.  Returns the root."""
    rng = np.random.default_rng(seed)
    H, W = img_hw
    subject_dir = os.path.join(out_dir, f"CoreView_{subject}")
    params_dir = os.path.join(subject_dir, "new_params")
    os.makedirs(params_dir, exist_ok=True)

    focal = H * 0.9
    Ks, Rs, Ts, Ds, ims = [], [], [], [], []
    for v in range(n_views):
        a = 0.15 * v
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        Ks.append(np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1.0]]))
        Rs.append(R)
        Ts.append(np.array([[0.0], [0.0], [3000.0], [1.0]]))  # mm
        Ds.append(np.zeros((5, 1)))

    for i in range(n_frames):
        ims.append({"ims": [f"Camera_B{v + 1}/{i:06d}.jpg" for v in range(n_views)]})
        np.save(
            os.path.join(params_dir, f"{i}.npy"),
            {
                "shapes": rng.normal(size=(1, 10)) * 0.1,
                "poses": rng.normal(size=(1, 72)) * 0.1,
                "Rh": rng.normal(size=(1, 3)) * 0.2,
                "Th": rng.normal(size=(1, 3)) * 0.2,
            },
        )
        for v in range(n_views):
            cam_dir = os.path.join(subject_dir, f"Camera_B{v + 1}")
            os.makedirs(cam_dir, exist_ok=True)
            img = np.full((H, W, 3), 32, np.uint8)
            img[H // 4 : 3 * H // 4, W // 4 : 3 * W // 4] = 170
            Image.fromarray(img).save(os.path.join(cam_dir, f"{i:06d}.jpg"))
            for mdir in ("mask", "mask_cihp"):
                md = os.path.join(subject_dir, mdir, f"Camera_B{v + 1}")
                os.makedirs(md, exist_ok=True)
                m = np.zeros((H, W), np.uint8)
                m[H // 4 : 3 * H // 4, W // 4 : 3 * W // 4] = 255
                Image.fromarray(m).save(os.path.join(md, f"{i:06d}.png"))

    np.save(os.path.join(subject_dir, "annots.npy"), {"cams": {"K": Ks, "R": Rs, "T": Ts, "D": Ds}, "ims": ims})
    return out_dir


def write_synthetic_snapshot_capture(
    out_dir: str,
    subject: str = "female-3-casual",
    n_frames: int = 4,
    img_hw: tuple[int, int] = (64, 64),
    seed: int = 0,
):
    """A miniature raw PeopleSnapshot capture in the layout
    ``prepare_snapshot`` reads: <subject>/{<subject>.mp4, masks.hdf5,
    camera.pkl} and poses/<subject>/poses/anim_nerf_{train,test}.npz.
    Returns (snapshot_root, pose_root)."""
    import cv2
    import h5py

    rng = np.random.default_rng(seed)
    H, W = img_hw
    subject_dir = os.path.join(out_dir, subject)
    os.makedirs(subject_dir, exist_ok=True)

    vw = cv2.VideoWriter(os.path.join(subject_dir, subject + ".mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10, (W, H))
    if not vw.isOpened():
        raise RuntimeError("cv2 mp4 encoder unavailable")
    masks = np.zeros((n_frames, H, W), np.uint8)
    for i in range(n_frames):
        img = np.full((H, W, 3), 24, np.uint8)
        img[H // 4 : 3 * H // 4, W // 4 : 3 * W // 4] = 150 + 10 * i
        vw.write(img)
        masks[i, H // 4 : 3 * H // 4, W // 4 : 3 * W // 4] = 1
    vw.release()
    with h5py.File(os.path.join(subject_dir, "masks.hdf5"), "w") as f:
        f.create_dataset("masks", data=masks)

    with open(os.path.join(subject_dir, "camera.pkl"), "wb") as f:
        pickle.dump(
            {"camera_f": np.array([H * 0.9, H * 0.9]), "camera_c": np.array([W / 2, H / 2]),
             "camera_k": np.zeros(5)},
            f,
        )

    pose_root = os.path.join(out_dir, "poses")
    pose_dir = os.path.join(pose_root, subject, "poses")
    os.makedirs(pose_dir, exist_ok=True)
    for split in ("train", "test"):
        np.savez(
            os.path.join(pose_dir, f"anim_nerf_{split}.npz"),
            betas=rng.normal(size=(1, 10)) * 0.1,
            global_orient=rng.normal(size=(n_frames, 3)) * 0.2,
            body_pose=rng.normal(size=(n_frames, 69)) * 0.1,
            transl=rng.normal(size=(n_frames, 3)) * 0.1,
        )
    return out_dir, pose_root
