"""The 512^2 synthetic teacher capture of the end-to-end demonstration
schedule (``configs/exps/e2e_synthetic.yaml``); port of the JAX package's
``tools/make_e2e_data.py``.

A teacher avatar, the procedural tube body one subdivision finer than the
capture's canonical mesh (57,600 faces over the capture's 14,400), with a
procedural per-face albedo, smoothly bumped geometry and a shadow MLP with
visible shading, is animated over a pose track and rendered by the port's
own eval renderer (``gom_forward(train=False)``, kernel B1 on the card).  The
frames are written in the reference's preprocessed artifact format
(images/, masks/, cameras.pkl, mesh_infos.pkl, canonical_joints.pkl), then a
copy of the test split with perturbed poses (test_noisy/), a raw-ZJU capture
of the held-out fifth of the train poses at twice the size (zju_raw/), an
MDM pose clip (mdm_poses.npy) and the teacher's per-face state
(teacher.npz).

The teacher is the JAX package's: its shadow trunk is drawn from
``prng.key(seed)`` as the reference draws it from ``jax.random.PRNGKey(seed)``
(``weights/e2e_teacher_shadow.npz`` holds JAX's own draw as a witness); every
other leaf is procedural or drawn from numpy in the reference's order.

    python -m gomavatar_tpu_torch.tools.make_e2e_data --out data/e2e [--frames 100] [--device cpu]

It runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import pickle
import shutil
import time
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from gomavatar_tpu_torch import prng
from gomavatar_tpu_torch.cli.train import check_device
from gomavatar_tpu_torch.config import default_cfg
from gomavatar_tpu_torch.convert import params_from_jax
from gomavatar_tpu_torch.data.dataset import (
    TrainDataset,
    body_pose_to_body_RTs_np,
    get_canonical_global_tfms_np,
    to_device,
)
from gomavatar_tpu_torch.models.gom import gom_forward, init_gom, subdivide_gom
from gomavatar_tpu_torch.models.smpl import synthetic_body
from gomavatar_tpu_torch.ops.camera import apply_global_tfm_to_camera

IMG = (512, 512)
# JAX's draw of the teacher's shadow trunk (seed 7), kept as a witness of
# the port's own draw
TEACHER_SHADOW = Path(__file__).resolve().parent.parent / "weights" / "e2e_teacher_shadow.npz"


def teacher_model(info, seed=7, img=IMG, device="cuda"):
    """(params, statics, gom_cfg) of the teacher, one subdivision phase finer
    than the capture's canonical mesh: the un-subdivided student has 4x
    fewer faces than the ground truth and cannot represent the sub-face
    albedo detail, so the subdivision adds representational power."""
    cfg = default_cfg()
    m = cfg["model"]
    m["img_size"] = list(img)
    m["pose_refinement"]["name"] = "none"
    m["non_rigid"]["name"] = "none"
    m["shadow_module"]["name"] = "basic"
    m["normal_renderer"]["name"] = "mesh"
    m["canonical_geometry"]["deform_so3"] = True
    m["canonical_geometry"]["deform_scale"] = True
    params, statics, gom_cfg = init_gom(m, info, device, prng.key(seed))
    params, statics, gom_cfg = subdivide_gom(params, statics, gom_cfg)
    rng = np.random.default_rng(seed)

    # procedural striped/checkered albedo from canonical face centroids,
    # plus a high-frequency term (~4 cm wavelength, ~3x the coarse face
    # size) that only the subdivided resolution can express per face
    v = params["vertices"].cpu().numpy()
    f = statics.faces.cpu().numpy()
    c = v[f].mean(axis=1)
    ang = np.arctan2(c[:, 2], c[:, 0])
    hf = 0.16 * np.sin(150.0 * c[:, 1]) * np.sin(20.0 * ang)
    colors = np.stack(
        [
            0.5 + 0.34 * np.sin(9.0 * c[:, 1] + 2.0 * ang) + hf,
            0.5 + 0.34 * np.sin(5.0 * ang + 1.0) + hf,
            0.5 + 0.34 * np.sin(14.0 * c[:, 1]) * np.cos(3.0 * ang) - hf,
        ],
        axis=-1,
    ).clip(0.03, 0.97)

    # smooth low-frequency geometry bumps the student must learn
    bump = 1.0 + 0.07 * np.sin(4.0 * ang_of(v) + 6.0 * v[:, 1])
    v2 = v.copy()
    v2[:, 0] *= bump
    v2[:, 2] *= bump

    # mild per-face rotation/scale deviations, then the shadow head with
    # visible normal-dependent shading (an initial head is ~flat 1.0)
    so3 = rng.normal(size=tuple(params["so3"].shape)) * 0.1
    scale = 1.0 + rng.normal(size=tuple(params["scale"].shape)) * 0.1
    head_w = rng.normal(size=tuple(params["shadow"]["head"]["w"].shape)) * 0.25

    params["appearance"]["colors"] = params_from_jax(colors, device)
    params["vertices"] = params_from_jax(v2, device)
    params["so3"] = params_from_jax(so3, device)
    params["scale"] = params_from_jax(scale, device)
    params["shadow"]["head"] = {"w": params_from_jax(head_w, device),
                                "b": torch.zeros_like(params["shadow"]["head"]["b"])}
    return params, statics, gom_cfg


def ang_of(v):
    return np.arctan2(v[:, 2], v[:, 0])


def pose_track(t: float, T: int, rng_amp) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Smooth sinusoidal joint curves + a full-turn global yaw over the clip."""
    pose = np.zeros(72, np.float32)
    for j, (amp, freq, phase, axis) in enumerate(rng_amp):
        pose[3 * (j + 1) + axis] = amp * np.sin(2 * np.pi * freq * t / T + phase)
    Rh = np.array([0.0, 2 * np.pi * t / T, 0.0], np.float32)  # full orbit of yaw
    Th = np.array([0.05 * np.sin(2 * np.pi * t / T), 0.0, 0.0], np.float32)
    return pose, Rh, Th


def orbit_E(azimuth_deg: float) -> np.ndarray:
    """World-to-camera extrinsics of a camera 2.4 m from the body, turned
    ``azimuth_deg`` about the vertical axis."""
    az = np.deg2rad(azimuth_deg)
    Ry = np.array([[np.cos(az), 0, np.sin(az)], [0, 1, 0], [-np.sin(az), 0, np.cos(az)]])
    E = np.eye(4)
    E[:3, :3] = Ry
    E[2, 3] = 2.4
    return E


def write_split(out_dir, n_frames, azimuth_deg, info, img=IMG, frame_offset=0, seed=3):
    """Write the artifact skeleton (cameras/mesh_infos/canonical + black
    placeholder frames); returns the frame names."""
    os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "masks"), exist_ok=True)
    W, H = img
    focal = 1.1 * H
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1.0]], np.float64)
    E = orbit_E(azimuth_deg)

    rng = np.random.default_rng(seed)
    # 10 animated joints with random amplitude/frequency/axis
    tracks = [
        (float(rng.uniform(0.1, 0.3)), float(rng.integers(1, 4)),
         float(rng.uniform(0, 2 * np.pi)), int(rng.integers(0, 3)))
        for _ in range(10)
    ]

    cameras, mesh_infos, names = {}, {}, []
    black = Image.fromarray(np.zeros((H, W, 3), np.uint8))
    T_total = n_frames + frame_offset
    for i in range(n_frames):
        name = f"frame_{i:06d}"
        names.append(name)
        pose, Rh, Th = pose_track(i + frame_offset, T_total, tracks)
        cameras[name] = {"intrinsics": K, "extrinsics": E}
        mesh_infos[name] = {
            "Rh": Rh,
            "Th": Th,
            "poses": pose,
            "joints": info["canonical_joints"],
            "tpose_joints": info["canonical_joints"],
        }
        black.save(os.path.join(out_dir, "images", name + ".png"))
        black.convert("L").save(os.path.join(out_dir, "masks", name + ".png"))

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
    return names


def frame_dropped(aux) -> int:
    """Entries an eval render dropped: the binning telemetry and the tile
    overflow."""
    tel = aux.get("binning")
    dropped = int(tel.total_dropped()) if tel is not None else 0
    return dropped + int(aux.get("tile_overflow", 0))


def to_uint8(x) -> np.ndarray:
    """[0, 1] floats -> uint8 by truncation, as the reference writes them."""
    return (np.clip(np.asarray(x), 0, 1) * 255).astype(np.uint8)


def render_split(out_dir, params, statics, gom_cfg, img=IMG, device="cuda"):
    """Teacher-render every frame through the same dataset pipeline the
    student will train on (consistent K/E/pose handling); returns the number
    of frames."""
    ds = TrainDataset(out_dir, bgcolor=[0, 0, 0], target_size=img)
    t0 = time.time()
    for i in range(len(ds)):
        item = ds[i]
        batch = to_device(item, device)
        with torch.no_grad():
            rgb, mask, aux = gom_forward(
                params, statics, gom_cfg, batch["K"], batch["E"], batch["cnl_gtfms"], batch["dst_Rs"],
                batch["dst_Ts"], dst_posevec=batch["dst_posevec"], i_iter=1e7, train=False, device=device,
            )
        dropped = frame_dropped(aux)
        if dropped:
            raise RuntimeError(f"teacher render dropped {dropped} entries on frame {i}")
        name = item["frame_name"]
        Image.fromarray(to_uint8(rgb.cpu())).save(os.path.join(out_dir, "images", name + ".png"))
        Image.fromarray(to_uint8(mask.cpu())).save(os.path.join(out_dir, "masks", name + ".png"))
        if i % 20 == 0:
            print(f"  {out_dir}: {i}/{len(ds)} ({time.time() - t0:.1f}s)", flush=True)
    return len(ds)


def write_noisy_split(test_dir: str, noisy_dir: str, pose_noise: float,
                      root_noise: float, rh_noise: float, seed: int = 11):
    """A perturbed copy of the test split: the same GT images/masks/cameras,
    but mesh_infos.pkl records inaccurate poses, the situation test-time
    pose refinement exists for.  The exact poses the frames were rendered
    with are kept next to it as mesh_infos_gt.pkl for diagnostics."""
    if os.path.isdir(noisy_dir):
        shutil.rmtree(noisy_dir)
    os.makedirs(noisy_dir)
    for sub in ("images", "masks"):
        shutil.copytree(os.path.join(test_dir, sub), os.path.join(noisy_dir, sub))
    for f in ("cameras.pkl", "canonical_joints.pkl"):
        shutil.copy(os.path.join(test_dir, f), os.path.join(noisy_dir, f))
    with open(os.path.join(test_dir, "mesh_infos.pkl"), "rb") as f:
        mesh_infos = pickle.load(f)
    with open(os.path.join(noisy_dir, "mesh_infos_gt.pkl"), "wb") as f:
        pickle.dump(mesh_infos, f)
    rng = np.random.default_rng(seed)
    for name, mi in mesh_infos.items():
        poses = mi["poses"].copy()
        # non-root joint angles only: the root orientation lives in Rh
        poses[3:] += rng.normal(size=poses[3:].shape).astype(np.float32) * pose_noise
        mi["poses"] = poses
        mi["Rh"] = mi["Rh"] + rng.normal(size=3).astype(np.float32) * rh_noise
        mi["Th"] = mi["Th"] + rng.normal(size=3).astype(np.float32) * root_noise
    with open(os.path.join(noisy_dir, "mesh_infos.pkl"), "wb") as f:
        pickle.dump(mesh_infos, f)
    print(f"noisy split: {noisy_dir} (pose sigma {pose_noise} rad, "
          f"Th sigma {root_noise} m, Rh sigma {rh_noise} rad)")


# the apron of each quadrant window toward the frame interior, tile-aligned
APRON = 2 * 16


def window_cfg(gom_cfg, window):
    """The render config of one quadrant window of a 2x frame: its size,
    budgets x4 (a window of the 2x render sees up to the full 2x
    per-primitive footprint) and single-band binning."""
    return dataclasses.replace(
        gom_cfg,
        img_size=tuple(window),
        max_tiles_per_gaussian=4 * gom_cfg.max_tiles_per_gaussian,
        max_tiles_per_face=4 * gom_cfg.max_tiles_per_face,
        buffer_factor=4 * gom_cfg.buffer_factor,
        active_tile_cap=4 * gom_cfg.active_tile_cap,
        binning_band0=None,
        binning_band0_train=None,
    )


def quadrant_windows(K, frame_hw):
    """(window, quads) of a frame of ``frame_hw`` = (H, W) rendered as four
    quadrants: the windows' size (w, h) and, per quadrant, (Kq, (oy, ox),
    (ly, lx)): the intrinsics with the principal point shifted to the
    window's origin, the quadrant's origin in the frame and its crop offset
    inside the window.  Each window carries a 32 px apron toward the frame
    interior, cropped after the render: primitives are culled against the
    render window, so without the apron a primitive just outside a quadrant
    is dropped while its bbox tail still touches kept pixels; with it, a
    culled primitive is >= 32 px from every kept pixel, beyond any bbox
    margin the binner enumerates."""
    H, W = frame_hw
    QW, QH = W // 2, H // 2
    quads = []
    for oy in (0, QH):
        for ox in (0, QW):
            # window origin: the apron extends toward the frame interior
            wx = max(0, ox - (APRON if ox else 0))
            wy = max(0, oy - (APRON if oy else 0))
            Kq = np.asarray(K, np.float32).copy()
            Kq[0, 2] -= wx
            Kq[1, 2] -= wy
            quads.append((Kq, (oy, ox), (oy - wy, ox - wx)))
    return (QW + APRON, QH + APRON), quads


def render_windowed(params, statics, gom_cfg, K, E, cnl, Rs, Ts, posevec, frame_hw, device="cuda"):
    """(rgb (H, W, 3), mask (H, W), dropped) of a frame too large for one
    render (a 2x frame of 64x64 tiles overflows the binner's 11-bit tile
    field), rendered as the four windows of :func:`quadrant_windows` and
    stitched on the host."""
    H, W = frame_hw
    QW, QH = W // 2, H // 2
    window, quads = quadrant_windows(K, frame_hw)
    cfg2 = window_cfg(gom_cfg, window)
    rgb_full = np.zeros((H, W, 3), np.float32)
    mask_full = np.zeros((H, W), np.float32)
    dropped = 0
    for Kq, (oy, ox), (ly, lx) in quads:
        with torch.no_grad():
            rgb, mask, aux = gom_forward(
                params, statics, cfg2, Kq, E, cnl, Rs, Ts, dst_posevec=posevec, i_iter=1e7, train=False,
                device=device,
            )
        rgb_full[oy:oy + QH, ox:ox + QW] = rgb[ly:ly + QH, lx:lx + QW].cpu().numpy()
        mask_full[oy:oy + QH, ox:ox + QW] = mask[ly:ly + QH, lx:lx + QW].cpu().numpy()
        dropped += frame_dropped(aux)
    return rgb_full, mask_full, dropped


def raw_cameras(img=IMG, n_views: int = 2):
    """(K, Es, (H, W)) of the raw-ZJU capture at twice ``img``: view 0 the
    training camera (the protocol excludes it), the ``n_views`` novel views
    spread over the unseen side of the orbit."""
    W, H = img[0] * 2, img[1] * 2
    focal = 1.1 * H
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1.0]], np.float64)
    azimuths = [0.0] + [140.0 + 80.0 * v / max(n_views - 1, 1) for v in range(n_views)]
    return K, [orbit_E(a) for a in azimuths], (H, W)


def raw_pose_names(mesh_infos) -> list:
    """The train frames the raw capture renders: the last fifth of the
    framelist (all of it when it has fewer than five)."""
    names = sorted(mesh_infos.keys())
    fifth = len(names) // 5
    return names[-fifth:] if fifth > 0 else names


def raw_frame_inputs(mi, E):
    """(E_eff, dst_Rs, dst_Ts, dst_posevec) of a raw frame of the train
    frame ``mi`` seen by camera ``E``."""
    dst_Rs, dst_Ts = body_pose_to_body_RTs_np(mi["poses"], mi["tpose_joints"].astype(np.float32))
    E_eff = apply_global_tfm_to_camera(E, mi["Rh"].astype(np.float32), mi["Th"].astype(np.float32))
    return np.asarray(E_eff, np.float32), dst_Rs, dst_Ts, mi["poses"].reshape(-1)[3:] + 1e-2


def write_zju_raw(raw_dir: str, train_dir: str, params, statics, gom_cfg, n_views: int = 2, img=IMG,
                  device="cuda"):
    """A tiny raw-ZJU-format capture driving the novel-pose protocol:
    annots.npy with the training camera as view 0 (excluded) plus
    ``n_views`` novel cameras, Camera_B*/%06d.jpg teacher renders at 2x
    resolution (the ZJU evaluator halves raw images), and identical mask/ +
    mask_cihp/ silhouettes.  Returns the number of frames per view.

    Only the last fifth of the train framelist is rendered: with
    dataset.train.split_for_pose those frames are never trained on, so
    --type pose measures novel-pose novel-view generalisation."""
    K, Es, (H, W) = raw_cameras(img, n_views)
    annots = {
        "cams": {
            "K": [K.copy() for _ in Es],
            "R": [E[:3, :3].copy() for E in Es],
            "T": [E[:3, 3:4] * 1000.0 for E in Es],  # ZJU stores T in mm
            "D": [np.zeros((5, 1)) for _ in Es],
        }
    }
    os.makedirs(raw_dir, exist_ok=True)
    np.save(os.path.join(raw_dir, "annots.npy"), annots)

    with open(os.path.join(train_dir, "mesh_infos.pkl"), "rb") as f:
        mesh_infos = pickle.load(f)
    pose_names = raw_pose_names(mesh_infos)

    cnl_gtfms = get_canonical_global_tfms_np(np.asarray(mesh_infos[pose_names[0]]["tpose_joints"], np.float32))
    t0 = time.time()
    for vi in range(1, len(Es)):
        cam_dir = f"Camera_B{vi + 1}"
        os.makedirs(os.path.join(raw_dir, cam_dir), exist_ok=True)
        os.makedirs(os.path.join(raw_dir, "mask", cam_dir), exist_ok=True)
        os.makedirs(os.path.join(raw_dir, "mask_cihp", cam_dir), exist_ok=True)
        for name in pose_names:
            mi = mesh_infos[name]
            frame_id = int(name.split("_")[1])
            E_eff, dst_Rs, dst_Ts, posevec = raw_frame_inputs(mi, Es[vi])
            rgb, mask, dropped = render_windowed(
                params, statics, gom_cfg, K, E_eff, cnl_gtfms, dst_Rs, dst_Ts, posevec, (H, W), device,
            )
            if dropped:
                raise RuntimeError(f"zju_raw teacher render dropped {dropped} ({name})")
            Image.fromarray(to_uint8(rgb)).save(os.path.join(raw_dir, cam_dir, f"{frame_id:06d}.jpg"), quality=95)
            for mdir in ("mask", "mask_cihp"):
                Image.fromarray(to_uint8(mask)).save(os.path.join(raw_dir, mdir, cam_dir, f"{frame_id:06d}.png"))
        print(f"  zju_raw view {vi}: {len(pose_names)} frames ({time.time() - t0:.1f}s)", flush=True)
    return len(pose_names)


def write_mdm_fixture(path: str, info, n_frames: int = 6, seed: int = 5):
    """A tiny MDM-format pose clip for ``evaluate --type pose_mdm``: an
    allow_pickle dict .npy of thetas_ori (24, 3, T) and root_translation
    (3, T)."""
    rng = np.random.default_rng(seed)
    thetas = np.zeros((24, 3, n_frames), np.float32)
    for j in (1, 2, 4, 5, 16, 17, 18, 19):  # legs + arms
        axis = int(rng.integers(0, 3))
        amp = float(rng.uniform(0.2, 0.5))
        ph = float(rng.uniform(0, 2 * np.pi))
        thetas[j, axis, :] = amp * np.sin(2 * np.pi * np.arange(n_frames) / n_frames + ph)
    # root row = global orientation (the loader splits it into Rh)
    thetas[0, 1, :] = np.linspace(0, np.pi, n_frames)
    # NewPoseDataset recenters by canonical_joints[0]; put the root there so
    # the radius-8 orbit camera frames the body
    root = np.tile(info["canonical_joints"][0][:, None], (1, n_frames)).astype(np.float32)
    np.save(path, {"thetas_ori": thetas, "root_translation": root})
    print(f"mdm fixture: {path} ({n_frames} frames)")


def write_capture(out, info, teacher, frames=100, test_frames=24, img=IMG, pose_noise=0.03, root_noise=0.02,
                  rh_noise=0.01, mdm_frames=6, zju_views=2, device="cuda") -> dict:
    """Every split of the capture under ``out``, rendered from ``teacher`` =
    (params, statics, gom_cfg); teacher.npz last, so that its presence
    means the capture is complete.  A render that drops a binning entry
    raises.  Returns the frames rendered per split and each stage's
    seconds."""
    params, statics, gom_cfg = teacher
    train_dir = os.path.join(out, "train")
    test_dir = os.path.join(out, "test")
    write_split(train_dir, frames, azimuth_deg=0.0, info=info, img=img)
    # held-out camera 70 deg off + the same pose track continued (novel view
    # of seen-style motion, like the ZJU novel-view protocol)
    write_split(test_dir, test_frames, azimuth_deg=70.0, info=info, img=img)

    print("rendering teacher frames on", torch.device(device), flush=True)
    seconds = {}
    t0 = time.perf_counter()
    n_train = render_split(train_dir, params, statics, gom_cfg, img, device)
    n_test = render_split(test_dir, params, statics, gom_cfg, img, device)
    seconds["render"] = time.perf_counter() - t0

    write_noisy_split(test_dir, os.path.join(out, "test_noisy"), pose_noise, root_noise, rh_noise)
    t0 = time.perf_counter()
    n_raw = write_zju_raw(os.path.join(out, "zju_raw"), train_dir, params, statics, gom_cfg, n_views=zju_views,
                          img=img, device=device)
    seconds["zju_raw"] = time.perf_counter() - t0
    write_mdm_fixture(os.path.join(out, "mdm_poses.npy"), info, mdm_frames)

    # the teacher, for later inspection and benches on trained-like data
    np.savez(
        os.path.join(out, "teacher.npz"),
        colors=params["appearance"]["colors"].cpu().numpy(),
        vertices=params["vertices"].cpu().numpy(),
        so3=params["so3"].cpu().numpy(),
        scale=params["scale"].cpu().numpy(),
    )
    print("done:", out, flush=True)
    return {"train": n_train, "test": n_test, "zju_raw": n_raw * zju_views, "seconds": seconds}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Write the synthetic teacher capture of the e2e schedule.")
    ap.add_argument("--out", default="data/e2e")
    ap.add_argument("--frames", type=int, default=100)
    ap.add_argument("--test_frames", type=int, default=24)
    ap.add_argument("--rings", type=int, default=144)
    ap.add_argument("--segs", type=int, default=48)
    ap.add_argument("--img", type=int, default=512, help="square image size (tile-aligned)")
    ap.add_argument("--pose_noise", type=float, default=0.03,
                    help="sigma (rad) of joint-angle noise written into the noisy test split (test_noisy/) for "
                    "train_pose to refine")
    ap.add_argument("--root_noise", type=float, default=0.02, help="Th noise sigma (m)")
    ap.add_argument("--rh_noise", type=float, default=0.01, help="Rh noise sigma (rad)")
    ap.add_argument("--mdm_frames", type=int, default=6)
    ap.add_argument("--zju_views", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="torch device: cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = check_device(args.device)
    img = (args.img, args.img)

    info = synthetic_body(n_rings=args.rings, n_seg=args.segs)
    print(f"body: {len(info['faces'])} faces, {len(info['canonical_vertex'])} verts")
    teacher = teacher_model(info, img=img, device=device)
    return write_capture(
        args.out, info, teacher, frames=args.frames, test_frames=args.test_frames, img=img,
        pose_noise=args.pose_noise, root_noise=args.root_noise, rh_noise=args.rh_noise,
        mdm_frames=args.mdm_frames, zju_views=args.zju_views, device=device,
    )


if __name__ == "__main__":
    main()
