"""ZJU-MoCap preprocessing (port of gomavatar_tpu/data/prepare_zju.py): raw
capture -> the training artifacts, the same artifact set as the JAX
package's — images/*.png, masks/*.png (mask OR mask_cihp), cameras.pkl,
mesh_infos.pkl (per-frame Rh/Th/poses/joints/tpose_joints from two SMPL
evaluations), canonical_joints.pkl (zero-pose SMPL at average betas with
faces/edges/weights) — so outputs interchange with the reference's.

Usage:
    python -m gomavatar_tpu_torch.data.prepare_zju --cfg scene.yaml \
        --smpl_model /path/to/SMPL_NEUTRAL.pkl
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np
import yaml
from PIL import Image

from gomavatar_tpu_torch.models.smpl import SMPL
from gomavatar_tpu_torch.ops.mesh_ops import unique_edges


def load_image(path):
    return np.array(Image.open(path))


def save_image(arr, path):
    Image.fromarray(np.asarray(arr, np.uint8)).save(path)


def get_mask(subject_dir, img_name):
    """mask OR mask_cihp, binarized to 0/255."""
    m1 = load_image(os.path.join(subject_dir, "mask", img_name[:-4] + ".png"))
    m2 = load_image(os.path.join(subject_dir, "mask_cihp", img_name[:-4] + ".png"))
    if m1.ndim == 3:
        m1 = m1[..., 0]
    if m2.ndim == 3:
        m2 = m2[..., 0]
    mask = ((m1 != 0) | (m2 != 0)).astype(np.uint8) * 255
    return mask


def prepare_zju(cfg: dict, smpl_model_path: str):
    """Write the artifacts of one subject's training view; returns the
    output directory."""
    subject = str(cfg["dataset"]["subject"])
    max_frames = cfg.get("max_frames", -1)
    select_view = cfg.get("training_view", 0)
    subject_dir = os.path.join(cfg["dataset"]["zju_mocap_path"], f"CoreView_{subject}")
    smpl_params_dir = os.path.join(subject_dir, "new_params")

    annots = np.load(os.path.join(subject_dir, "annots.npy"), allow_pickle=True).item()
    cams = annots["cams"]
    K = np.array(cams["K"])[select_view].astype(np.float32)
    D = np.array(cams["D"])[select_view].astype(np.float32)[:, 0]
    E = np.eye(4, dtype=np.float32)
    E[:3, :3] = np.array(cams["R"])[select_view]
    E[:3, 3] = (np.array(cams["T"])[select_view].astype(np.float32) / 1000.0)[:3, 0]

    img_paths = np.array(
        [np.array(frame["ims"])[select_view] for frame in annots["ims"]]
    )
    if max_frames > 0:
        img_paths = img_paths[:max_frames]

    out = cfg["output"]
    output_path = os.path.join(out["dir"], out.get("name", subject))
    os.makedirs(os.path.join(output_path, "images"), exist_ok=True)
    os.makedirs(os.path.join(output_path, "masks"), exist_ok=True)

    smpl = SMPL(smpl_model_path)
    cameras, mesh_infos, all_betas = {}, {}, []
    for idx, ipath in enumerate(img_paths):
        out_name = f"frame_{idx:06d}"
        img = load_image(os.path.join(subject_dir, ipath))

        # subjects 313/315 index SMPL params by the id embedded in the name
        if subject in ("313", "315"):
            base = os.path.splitext(os.path.basename(ipath))[0]
            start = base.find(")_")
            smpl_idx = int(base[start + 2 : start + 6])
        else:
            smpl_idx = idx
        sp = np.load(
            os.path.join(smpl_params_dir, f"{smpl_idx}.npy"), allow_pickle=True
        ).item()
        betas = sp["shapes"][0]
        poses = sp["poses"][0]
        all_betas.append(betas)

        cameras[out_name] = {"intrinsics": K, "extrinsics": E, "distortions": D}
        _, tpose_joints = smpl(np.zeros_like(poses), betas)
        _, joints = smpl(poses, betas)
        mesh_infos[out_name] = {
            "Rh": sp["Rh"][0],
            "Th": sp["Th"][0],
            "poses": poses,
            "joints": joints,
            "tpose_joints": tpose_joints,
        }
        save_image(get_mask(subject_dir, ipath), os.path.join(output_path, "masks", out_name + ".png"))
        save_image(img, os.path.join(output_path, "images", out_name + ".png"))

    with open(os.path.join(output_path, "cameras.pkl"), "wb") as f:
        pickle.dump(cameras, f)
    with open(os.path.join(output_path, "mesh_infos.pkl"), "wb") as f:
        pickle.dump(mesh_infos, f)

    avg_betas = np.mean(np.stack(all_betas), axis=0)
    np.save(os.path.join(output_path, "avg_betas.npy"), avg_betas)
    v, template_joints = smpl(np.zeros(72), avg_betas)
    edges, _ = unique_edges(smpl.faces)
    with open(os.path.join(output_path, "canonical_joints.pkl"), "wb") as f:
        pickle.dump(
            {
                "vertex": v,
                "joints": template_joints,
                "weights": smpl.weights,
                "edges": edges,
                "faces": smpl.faces,
            },
            f,
        )
    return output_path


def main(argv=None):
    ap = argparse.ArgumentParser(description="Prepare a ZJU-MoCap subject (gomavatar_tpu_torch).")
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--smpl_model", required=True, help="path to SMPL_*.pkl")
    args = ap.parse_args(argv)
    with open(args.cfg) as f:
        cfg = yaml.safe_load(f)
    return prepare_zju(cfg, args.smpl_model)


if __name__ == "__main__":
    main()
