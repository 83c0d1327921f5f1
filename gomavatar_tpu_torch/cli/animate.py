"""Multi-scene animation (port of gomavatar_tpu/cli/animate.py): a freeview
orbit or an MDM-driven motion for several avatars, one strip of the scenes
side by side per frame.

    # N trained scenes:
    python -m gomavatar_tpu_torch.cli.animate --cfgs cfgA.yaml cfgB.yaml ... \
        --type freeview --n_frames 60 --out out_dir [--device cpu]
    # without data (synthetic avatars):
    python -m gomavatar_tpu_torch.cli.animate --synthetic 4 --n_frames 16 --out out_dir

On one card the scenes are rendered in turn, each frame of each scene by
``gom_forward(train=False)`` (kernel B1), so every scene lands in the strip,
which is n x W wide for n scenes.  Where several CUDA cards are visible,
k rank processes (``parallel.spawn``, NCCL) render the scenes through
``parallel.make_multi_scene_render``, k the largest divisor of n that is at
most the number of cards (JAX asserts that n divides onto its devices; the
port takes fewer ranks instead, and one card where k is 1): rank r renders
every scene of its block of n / k, the frames are gathered in scene order
and rank 0 writes the strips.  With ``--cfgs`` the camera intrinsics come
from ``--img`` and the render size from each checkpoint's config.  It runs on the card unless ``--device
cpu``; ``main`` returns a summary.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch
from PIL import Image

from gomavatar_tpu_torch.cli.train import check_device
from gomavatar_tpu_torch.eval_lib import to_8b_image
from gomavatar_tpu_torch.parallel import barrier, make_multi_scene_render, render_scenes, spawn


def _synthetic_scenes(n: int, img_size, device):
    """n untrained avatars on the synthetic body of seed s, their MLP
    weights drawn from ``prng.key(s)``."""
    from gomavatar_tpu_torch import prng
    from gomavatar_tpu_torch.config import default_cfg
    from gomavatar_tpu_torch.models.gom import init_gom
    from gomavatar_tpu_torch.models.smpl import synthetic_body

    cfg = default_cfg()
    m = cfg["model"]
    m["img_size"] = list(img_size)
    m["shadow_module"]["name"] = "basic"
    m["normal_renderer"]["name"] = "mesh"
    m["canonical_geometry"]["deform_so3"] = True
    m["canonical_geometry"]["deform_scale"] = True
    packs, infos = [], []
    for s in range(n):
        info = synthetic_body(n_rings=24, n_seg=20, seed=s)
        packs.append(init_gom(m, info, device, prng.key(s)))
        infos.append(info)
    return packs, infos


def _mdm_items(infos, pose_path, n_frames, img_size):
    """Per-frame items driving every scene with one MDM motion clip: the root
    rotation folded into the camera, a camera at distance 2.6."""
    from gomavatar_tpu_torch.data.dataset import body_pose_to_body_RTs_np, get_canonical_global_tfms_np
    from gomavatar_tpu_torch.ops.camera import apply_global_tfm_to_camera

    data = dict(np.load(pose_path, allow_pickle=True).item())
    thetas = np.asarray(data["thetas_ori"])  # (24, 3, T)
    poses_all = np.transpose(thetas, (2, 0, 1)).copy()
    Rh_all = poses_all[:, 0].copy()
    Th_all = np.transpose(np.asarray(data["root_translation"]), (1, 0))
    poses_all[:, 0] = 0.0
    T_total = min(len(poses_all), n_frames)

    W, H = img_size
    focal = 1.1 * H
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]], np.float32)
    E0 = np.eye(4, dtype=np.float32)
    E0[2, 3] = 2.6

    per_frame = []
    for t in range(T_total):
        items = []
        pose = poses_all[t].reshape(-1).astype(np.float32)
        for info in infos:
            E = apply_global_tfm_to_camera(E0, Rh_all[t], Th_all[0] - info["canonical_joints"][0]).astype(np.float32)
            Rs, Ts = body_pose_to_body_RTs_np(pose, info["canonical_joints"])
            items.append({
                "K": K,
                "E": E,
                "cnl_gtfms": get_canonical_global_tfms_np(info["canonical_joints"]),
                "dst_Rs": Rs,
                "dst_Ts": Ts,
                "dst_posevec": pose[3:] + 1e-2,
                "bgcolor": np.zeros(3, np.float32),
                "target_rgbs": np.zeros((H, W, 3), np.float32),
                "target_masks": np.zeros((H, W), np.float32),
            })
        per_frame.append(items)
    return per_frame


def _orbit_items(infos, frame_idx, n_frames, img_size):
    """Per-frame items of a freeview orbit about the vertical axis, one arm
    joint waving."""
    from gomavatar_tpu_torch.data.dataset import body_pose_to_body_RTs_np, get_canonical_global_tfms_np
    from gomavatar_tpu_torch.models.smpl import synthetic_camera
    from gomavatar_tpu_torch.ops.camera import rotate_camera_by_frame_idx

    K, E0 = synthetic_camera(img_size, distance=3.0, focal=0.9 * img_size[1])
    per_frame = []
    for t in range(n_frames):
        items = []
        for info in infos:
            E = rotate_camera_by_frame_idx(E0, t, period=n_frames, rotate_axis="y")
            pose = np.zeros(72, np.float32)
            pose[12] = 0.4 * np.sin(2 * np.pi * t / n_frames)
            Rs, Ts = body_pose_to_body_RTs_np(pose, info["canonical_joints"])
            H, W = img_size[1], img_size[0]
            items.append({
                "K": K,
                "E": E.astype(np.float32),
                "cnl_gtfms": get_canonical_global_tfms_np(info["canonical_joints"]),
                "dst_Rs": Rs,
                "dst_Ts": Ts,
                "dst_posevec": pose[3:] + 1e-2,
                "bgcolor": np.zeros(3, np.float32),
                "target_rgbs": np.zeros((H, W, 3), np.float32),
                "target_masks": np.zeros((H, W), np.float32),
            })
        per_frame.append(items)
    return per_frame


def check_homogeneous_scenes(packs):
    """All scenes must be at one subdivision phase (one face count), as the
    JAX package's single compiled program requires; fail with a clear
    message otherwise."""
    gom_cfg = packs[0][2]
    mismatched = [(i, p[2].num_faces) for i, p in enumerate(packs) if p[2].num_faces != gom_cfg.num_faces]
    if mismatched:
        details = ", ".join(f"scene {i}: {f} faces" for i, f in mismatched)
        raise SystemExit(
            f"multi-scene animate needs all scenes at the SAME subdivision "
            f"phase: scene 0 has {gom_cfg.num_faces} faces but {details}. "
            f"Re-train or pick checkpoints at matching phases."
        )
    return gom_cfg


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="Animate several avatars side by side (gomavatar_tpu_torch).")
    ap.add_argument("--cfgs", nargs="*", default=None, help="per-scene experiment configs")
    ap.add_argument("--synthetic", type=int, default=0, help="render N synthetic avatars instead")
    ap.add_argument("--type", default="freeview", choices=["freeview", "mdm"])
    ap.add_argument("--pose_path", default=None, help="MDM motion npy (--type mdm); synthesized if omitted")
    ap.add_argument("--n_frames", type=int, default=30)
    ap.add_argument("--img", type=int, nargs=2, default=[256, 256])
    ap.add_argument("--out", default="log/animate")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if not args.synthetic and not args.cfgs:
        raise SystemExit("--cfgs or --synthetic required")
    return args


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    device = check_device(args.device)
    ranks = scene_ranks(args.synthetic or len(args.cfgs), device)
    if ranks > 1:
        return spawn(animate_rank, [torch.device("cuda", i) for i in range(ranks)], argv)[0]
    return animate(args, device)


def scene_ranks(n: int, device) -> int:
    """How many ranks render n scenes: on CUDA the largest divisor of n that
    is at most the number of cards (1 keeps the one-card loop), else 1."""
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    return max(k for k in range(1, min(n, cards) + 1) if n % k == 0)


def animate_rank(group, argv) -> dict | None:
    """One rank of the multi-scene animation: the summary on rank 0."""
    return animate(parse_args(argv), group.device, group)


def animate(args, device, group=None) -> dict | None:
    """Load the scenes, render every frame's strip (in turn, or through the
    multi-scene render under ``group``) and write the PNGs (rank 0)."""
    lead = group is None or group.rank == 0
    img_size = tuple(args.img)
    if args.synthetic:
        packs, infos = _synthetic_scenes(args.synthetic, img_size, device)
    else:
        from gomavatar_tpu_torch.config import make_cfg
        from gomavatar_tpu_torch.data.dataset import TrainDataset
        from gomavatar_tpu_torch.trainer import Trainer

        packs, infos = [], []
        for cfg_path in args.cfgs:
            cfg = make_cfg(cfg_path)
            ds = TrainDataset(cfg["dataset"]["train"]["dataset_path"], bgcolor=[0, 0, 0])
            tr = Trainer(cfg, ds.get_canonical_info(), device=device)
            tr.load_for_eval(os.path.join(cfg["save_dir"], "checkpoints"))
            packs.append((tr.params, tr.statics, tr.gom_cfg))
            infos.append(ds.get_canonical_info())

    n = len(packs)
    check_homogeneous_scenes(packs)
    render = make_multi_scene_render(group) if group is not None else None

    os.makedirs(args.out, exist_ok=True)
    if args.type == "mdm":
        pose_path = args.pose_path
        if pose_path is None:
            from gomavatar_tpu_torch.data.synthetic import write_synthetic_mdm_poses

            pose_path = os.path.join(args.out, "_demo_motion.npy")
            if lead:
                write_synthetic_mdm_poses(pose_path, n_frames=args.n_frames)
            if group is not None:
                barrier(group)  # the motion file is written before any rank reads it
        frames = _mdm_items(infos, pose_path, args.n_frames, img_size)
    else:
        frames = _orbit_items(infos, 0, args.n_frames, img_size)
    t0 = time.perf_counter()
    for t, items in enumerate(frames):
        rgb, _ = render_scenes(packs, items, device) if render is None else render(packs, items)
        if not lead:
            continue
        strip = torch.cat(list(rgb), dim=1).cpu().numpy()
        Image.fromarray(to_8b_image(strip)).save(os.path.join(args.out, f"frame_{t:04d}.png"))
        print(f"frame {t + 1}/{len(frames)}", flush=True)
    seconds = time.perf_counter() - t0
    if not lead:
        return None
    print(f"wrote {len(frames)} frames x {n} scenes to {args.out} in {seconds:.3f} s "
          f"({len(frames) / max(seconds, 1e-9):.2f} frames/s, PNG writes included)")
    return {"frames": len(frames), "scenes": n, "seconds": seconds, "out": args.out}


if __name__ == "__main__":
    main()
