"""End-to-end learning check: overfit the model to a couple of frames (port
of the JAX package's ``tools/overfit_check.py``).

Trains the full train step (kernels B2-B5 on the card, all mesh losses,
Adam) on two synthetic frames at 128x128 and reports the train-view PSNR
before and after: the check that optimisation really works, which unit
tests cannot give.  It fails unless the PSNR gains more than 5 dB.

    python -m gomavatar_tpu_torch.tools.overfit_check [--iters 400] [--img 128] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from gomavatar_tpu_torch.cli.train import check_device
from gomavatar_tpu_torch.config import default_cfg
from gomavatar_tpu_torch.losses import unpack
from gomavatar_tpu_torch.metrics import psnr
from gomavatar_tpu_torch.models.smpl import synthetic_body, synthetic_camera
from gomavatar_tpu_torch.ops.skeleton import body_pose_to_body_RTs, get_canonical_global_tfms
from gomavatar_tpu_torch.trainer import Trainer


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Overfit two synthetic frames; fails below +5 dB.")
    ap.add_argument("--iters", type=int, default=400)
    ap.add_argument("--img", type=int, default=128)
    ap.add_argument("--device", default="cuda", help="torch device: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = check_device(args.device)

    S = args.img
    cfg = default_cfg()
    cfg["img_size"] = [S, S]
    m = cfg["model"]
    m["img_size"] = [S, S]
    m["canonical_geometry"]["deform_so3"] = True
    m["canonical_geometry"]["deform_scale"] = True
    m["shadow_module"]["name"] = "basic"
    m["normal_renderer"]["name"] = "mesh"
    t = cfg["train"]
    t["losses"]["lpips"]["coeff"] = 0.0
    t["losses"]["laplacian"]["coeff_observation"] = 10.0
    t["losses"]["normal"]["coeff_mask"] = 1.0
    t["losses"]["normal"]["mask_dilate"] = True
    t["losses"]["normal"]["coeff_consist"] = 0.1
    t["losses"]["color_consist"]["coeff"] = 0.05
    # overfitting schedule: higher lr, no decay over this short run
    for k in t["lr"]:
        t["lr"][k] = 0.005 if t["lr"][k] > 0 else 0.0
    t["lr_decay_steps"] = 10_000_000

    info = synthetic_body(n_rings=24, n_seg=20)
    trainer = Trainer(cfg, info, device=device)

    # two target frames: coloured stripes on the true body silhouette
    K, E = synthetic_camera((S, S), distance=2.4, focal=1.1 * S)
    joints = torch.as_tensor(np.asarray(info["canonical_joints"], np.float32), device=device)
    cnl = get_canonical_global_tfms(joints)

    def dev(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    batches = []
    for fidx in range(2):
        pose = np.zeros(72, np.float32)
        pose[12] = 0.3 * fidx
        Rs, Ts = body_pose_to_body_RTs(dev(pose), joints)
        base = {"K": dev(K), "E": dev(E), "cnl_gtfms": cnl, "dst_Rs": Rs, "dst_Ts": Ts,
                "dst_posevec": dev(pose[3:] + 1e-2), "bgcolor": torch.zeros(3, device=device)}
        # render the true body with a striped appearance as ground truth
        _, mask0, _ = trainer.forward(base)
        yy = np.arange(S)[:, None] * np.ones((1, S))
        stripes = np.stack(
            [0.2 + 0.6 * ((yy // 8) % 2), 0.7 - 0.5 * ((yy // 8) % 2), 0.5 * np.ones((S, S))], axis=-1,
        ).astype(np.float32)
        m0 = mask0.cpu().numpy()
        base["target_rgbs"] = dev(stripes * m0[..., None])
        base["target_masks"] = dev((m0 > 0.5).astype(np.float32))
        batches.append(base)

    def train_psnr():
        vals = []
        for b in batches:
            rgb, mask, _ = trainer.forward(b)
            pred = unpack(rgb, mask, b["bgcolor"], clamp=True)
            vals.append(float(psnr(pred, b["target_rgbs"])))
        return float(np.mean(vals))

    p0 = train_psnr()
    t0 = time.perf_counter()
    for i in range(args.iters):
        total, _ = trainer.step(batches[i % 2])
        if i % 100 == 0:
            print(f"iter {i}: loss {float(total):.4f}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    p1 = train_psnr()
    print(f"PSNR {p0:.2f} -> {p1:.2f} dB after {args.iters} iters ({args.iters / dt:.1f} it/s)")
    if not p1 > p0 + 5.0:
        raise AssertionError(f"model failed to learn (PSNR {p0:.2f} -> {p1:.2f}; expected >= +5 dB)")
    print("OVERFIT CHECK PASSED")
    return {"psnr_before": p0, "psnr_after": p1, "iters": args.iters, "it_per_s": args.iters / dt}


if __name__ == "__main__":
    main()
