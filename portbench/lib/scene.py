"""The benchmark's inputs, made from ``--seed``: the state, the LPIPS trunk,
poses, cameras and the train frames on disk.  Train frames are the plain
reference's renders of the state, so that a step fits the avatar to frames
it could have been trained on.

A pose animates joints 1-10 (amplitude 0.2 rad about a fixed axis each) at
phases drawn per frame, the motion range of the capture the avatar was
trained on.  Views come from a fixed set (a full turn about the body's
vertical axis) that the seed only reorders, so every seed renders the same
set of sizes.
"""

from __future__ import annotations

import json
import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.data import fold_global, pose_inputs
from portbench.reference.mesh import synthetic_body

ROOT = Path(__file__).resolve().parents[1]
VGG_WIDTHS = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng((seed % 2**63, *stream))


def torch_gen(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((seed * 1000003 + stream) % 2**63)
    return g


def load_state(path: str, device):
    """(meta, params): the npz's nested params as float32 tensors."""
    with np.load(ROOT.parent / path) as z:
        meta = json.loads(str(z["meta"]))
        params: dict = {}
        for key in z.files:
            if key.startswith("params/"):
                *parents, leaf = key.split("/")[1:]
                d = params
                for p in parents:
                    d = d.setdefault(p, {})
                d[leaf] = torch.as_tensor(np.asarray(z[key], np.float32), device=device)
        frame = {k[6:]: np.asarray(z[k], np.float32) for k in z.files if k.startswith("frame/")}

    def listify(d):
        if not isinstance(d, dict):
            return d
        if all(k.isdigit() for k in d):
            return [listify(d[k]) for k in sorted(d, key=int)]
        return {k: listify(v) for k, v in d.items()}

    return meta, listify(params), frame


def model_params(params: dict, model: dict) -> dict:
    """The state's params that the configuration's model has: a module the
    model leaves out is not loaded."""
    return {k: v for k, v in params.items()
            if k not in ("pose_refinement", "non_rigid", "shadow")
            or model.get("shadow_module" if k == "shadow" else k, {}).get("name", "none") != "none"}


def draw_trunk(seed: int, device, heads_path: str):
    """A VGG16 trunk He-scaled from the seed (OIHW, zero biases) with the
    LPIPS heads of ``heads_path``."""
    g = torch_gen(seed, 1, device)
    convs, c_in = [], 3
    for c in VGG_WIDTHS:
        w = torch.randn((c, c_in, 3, 3), generator=g, device=device) * float(np.sqrt(2.0 / (9 * c_in)))
        convs.append({"w": w, "b": torch.zeros(c, device=device)})
        c_in = c
    with np.load(ROOT.parent / heads_path) as z:
        heads = [torch.as_tensor(np.asarray(z[f"head_{i}"], np.float32).reshape(-1, 1), device=device)
                 for i in range(5)]
    return {"convs": convs, "heads": heads}


def pose(r: np.random.Generator) -> np.ndarray:
    p = np.zeros(72, np.float32)
    for j in range(1, 11):
        p[3 * j + j % 3] = 0.2 * np.sin(r.uniform(0.0, 2.0 * np.pi))
    return p


def yaw(E: np.ndarray, angle: float) -> np.ndarray:
    """The extrinsics of the camera turned ``angle`` about the body's vertical axis."""
    R = np.eye(4)
    c, s = np.cos(angle), np.sin(angle)
    R[:3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
    return np.asarray(E, np.float64) @ R


def scaled_K(K512: np.ndarray, size: int) -> np.ndarray:
    """The state's 512^2 intrinsics at a ``size``^2 frame: the subject keeps its share of the frame."""
    K = np.asarray(K512, np.float64).copy()
    K[:2] *= size / 512.0
    return K


def joints(meta: dict) -> np.ndarray:
    return synthetic_body(**meta["body"])[3].astype(np.float32)


# -- train frames on disk -----------------------------------------------------------

def camera_frame(rgb, alpha, png: int, g) -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 (png, png, 3) image and (png, png) 0/255 mask of a render:
    upsampled to the camera's resolution, with sensor noise, so that the
    frame has a camera frame's entropy."""
    up = F.interpolate(rgb.permute(2, 0, 1)[None], size=(png, png), mode="bicubic", align_corners=False)[0]
    img = up.permute(1, 2, 0) * 255.0 + torch.randn((png, png, 3), generator=g, device=rgb.device) * 4.0
    mask = F.interpolate(alpha[None, None], size=(png, png), mode="bilinear", align_corners=False)[0, 0] > 0.5
    return img.clamp(0, 255).to(torch.uint8), mask.to(torch.uint8) * 255


def write_train_frames(out: str, seed: int, n: int, png: int, meta: dict, frame0: dict, distortions, device,
                       render):
    """The recipe's preprocessed layout (images/, masks/, cameras.pkl,
    mesh_infos.pkl, canonical_joints.pkl) of ``n`` frames of ``png``^2 under
    ``out``; ``render(E, pose inputs)`` gives each frame's (rgb, alpha)
    at the frame size.  Returns (cameras, mesh_infos, canonical joints)."""
    import cv2

    os.makedirs(os.path.join(out, "images"), exist_ok=True)
    os.makedirs(os.path.join(out, "masks"), exist_ok=True)
    cj = joints(meta)
    r = rng(seed, 2)
    yaws = r.permutation(n) * (2.0 * np.pi / n)
    cameras, infos, names = {}, {}, [f"{i:06d}" for i in range(n)]
    K = scaled_K(frame0["K"], png)
    for i, name in enumerate(names):
        cameras[name] = {"intrinsics": K, "extrinsics": np.asarray(frame0["E"], np.float64)}
        if distortions is not None:
            cameras[name]["distortions"] = np.asarray(distortions, np.float64)
        infos[name] = {"Rh": np.array([0.0, yaws[i], 0.0], np.float32), "Th": np.zeros(3, np.float32),
                       "poses": pose(r), "joints": cj, "tpose_joints": cj}
    g = torch_gen(seed, 3, device)

    def write(name, img, mask):
        cv2.imwrite(os.path.join(out, "images", name + ".png"), img)
        cv2.imwrite(os.path.join(out, "masks", name + ".png"), mask)

    with ThreadPoolExecutor(8) as pool:
        jobs = []
        for name in names:
            mi = infos[name]
            E = fold_global(frame0["E"], mi["Rh"], mi["Th"]).astype(np.float32)
            rgb, alpha = render(E, pose_inputs(mi["poses"], cj.copy(), cj))
            img, mask = camera_frame(rgb, alpha, png, g)
            jobs.append(pool.submit(write, name, img.cpu().numpy(), mask.cpu().numpy()))
        for j in jobs:
            j.result()
    with open(os.path.join(out, "cameras.pkl"), "wb") as f:
        pickle.dump(cameras, f)
    with open(os.path.join(out, "mesh_infos.pkl"), "wb") as f:
        pickle.dump(infos, f)
    verts, faces, w, _ = synthetic_body(**meta["body"])
    with open(os.path.join(out, "canonical_joints.pkl"), "wb") as f:
        pickle.dump({"vertex": verts.astype(np.float32), "joints": cj, "weights": w.astype(np.float32),
                     "faces": faces, "edges": None}, f)
    return cameras, infos, cj


# -- render frames ----------------------------------------------------------------

def view_frame(seed: int, i: int, views: int, start: int, meta: dict, frame0: dict, size: int) -> dict:
    """Camera and pose of novel-view frame ``i``: view (start + i) of a
    turn of ``views``, a pose drawn for (seed, i)."""
    p = pose(rng(seed, 4, i))
    out = {"K": scaled_K(frame0["K"], size).astype(np.float32),
           "E": yaw(frame0["E"], 2.0 * np.pi * ((start + i) % views) / views).astype(np.float32),
           "poses": p}
    cj = joints(meta)
    out.update(pose_inputs(p, cj.copy(), cj))
    return out

