"""One-command LPIPS calibration (port of the JAX package's
``tools/calibrate_lpips.py``): convert torch checkpoints into the npz files
that ``models.lpips.load_lpips`` picks up, in the JAX package's format.

The pretrained trunks (torchvision's VGG16, ~528 MB, and AlexNet, ~233 MB)
and LPIPS's AlexNet heads are not shipped with the repository.  On a machine
with torchvision and the lpips package, save them once:

    python - <<'PY'
    import torch, torchvision
    torch.save(torchvision.models.vgg16(weights='DEFAULT').state_dict(), 'vgg16.pth')
    torch.save(torchvision.models.alexnet(weights='DEFAULT').state_dict(), 'alexnet.pth')
    import lpips, os, shutil
    shutil.copy(os.path.join(os.path.dirname(lpips.__file__), 'weights/v0.1/alex.pth'), 'alex_heads.pth')
    PY

The VGG heads are the reference's ``utils/lpips/weights/v0.1/vgg.pth``.
Then convert, on the host (no card needed):

    python -m gomavatar_tpu_torch.tools.calibrate_lpips --vgg16 vgg16.pth --vgg_heads vgg.pth
    python -m gomavatar_tpu_torch.tools.calibrate_lpips --alexnet alexnet.pth --alex_heads alex_heads.pth

The files go to ``--out_dir``, by default the port's ``WEIGHTS_DIR``
(``gomavatar_tpu_torch/weights/``, or ``GOMAVATAR_LPIPS_DIR`` where it is
set): ``lpips_vgg.npz`` and ``lpips_alex.npz``, or ``lpips_vgg_heads.npz``
for ``--vgg_heads`` alone.  Training, ``cli.evaluate`` and the evaluators
then report ``lpips`` as CALIBRATED, comparable with published numbers.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from gomavatar_tpu_torch.models import lpips as lpips_lib


def main(argv=None) -> list[tuple[str, bool]]:
    """Convert what the flags name; returns [(written path, calibrated)]."""
    ap = argparse.ArgumentParser(description="Convert torch LPIPS checkpoints into load_lpips's npz files.")
    ap.add_argument("--vgg16", help="torchvision vgg16 state_dict .pth")
    ap.add_argument("--vgg_heads", help="reference utils/lpips/weights/v0.1/vgg.pth")
    ap.add_argument("--alexnet", help="torchvision alexnet state_dict .pth")
    ap.add_argument("--alex_heads", help="lpips package weights/v0.1/alex.pth")
    ap.add_argument("--out_dir", default=lpips_lib.WEIGHTS_DIR)
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    wrote = []

    if args.vgg16:
        params, calibrated = lpips_lib.load_torch_vgg16(args.vgg16, args.vgg_heads, device="cpu")
        out = os.path.join(args.out_dir, "lpips_vgg.npz")
        lpips_lib.save_npz(out, params)
        wrote.append((out, calibrated))
    elif args.vgg_heads:
        # heads alone (the 7 KB file the reference ships)
        heads = lpips_lib.load_torch_heads(args.vgg_heads)
        out = os.path.join(args.out_dir, "lpips_vgg_heads.npz")
        np.savez(out, **{f"head_{i}": h for i, h in enumerate(heads)})
        wrote.append((out, False))

    if args.alexnet:
        params, calibrated = lpips_lib.load_torch_alexnet(args.alexnet, args.alex_heads, device="cpu")
        out = os.path.join(args.out_dir, "lpips_alex.npz")
        lpips_lib.save_npz(out, params)
        wrote.append((out, calibrated))

    if not wrote:
        ap.error("nothing to convert: pass --vgg16/--vgg_heads/--alexnet")
    for path, calibrated in wrote:
        print(f"wrote {path} (calibrated={calibrated})")
        _, _, status = lpips_lib.load_lpips("alex" if "alex" in os.path.basename(path) else "vgg",
                                            weights_dir=args.out_dir, quiet=True, device="cpu")
        print(f"  load_lpips now reports: {status}")
    return wrote


if __name__ == "__main__":
    main()
