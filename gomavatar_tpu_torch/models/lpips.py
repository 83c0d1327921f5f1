"""VGG16 LPIPS, the perceptual term of the training loss (port of the VGG
path of gomavatar_tpu/models/lpips.py).

Scaling layer -> VGG16 trunk (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
taps) -> unit-normalise each feature vector -> squared difference ->
non-negative 1x1 linear head -> spatial mean -> sum over the five taps.

Weights: the reference's five linear heads ship with this package
(``weights/lpips_vgg_heads.npz``, 7 KB, a copy of the JAX package's).  The
trunk is NOT pretrained: nothing is downloaded, so it is a random He-scaled
trunk drawn from ``torch.Generator`` seed 1234.  Like the JAX package's own
fixed-seed trunk it gives a perceptual-style training signal, but its values
are uncalibrated and not comparable with published LPIPS numbers.  (The JAX
trunk cannot be redrawn in torch; ``convert.lpips_from_jax`` carries it
across for the parity tests.)

Convolutions run in bfloat16 by default, as in the reference.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

HEADS_PATH = Path(__file__).resolve().parent.parent / "weights" / "lpips_vgg_heads.npz"

# VGG16 feature config: conv widths, "M" = 2x2 max pool
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
# indices (in conv order) after which LPIPS taps features: relu1_2 ... relu5_3
_TAPS = (1, 3, 6, 9, 12)
_TAP_CHANNELS = (64, 128, 256, 512, 512)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def init_lpips(heads=None, device="cuda"):
    """Random He-scaled VGG16 trunk (conv weights OIHW) drawn from
    ``torch.Generator`` seed 1234, with ``heads`` (five (C,) arrays) or
    uniform 1/C heads.  Returns (params, calibrated=False)."""
    gen = torch.Generator().manual_seed(1234)
    convs = []
    c_in = 3
    for c in _VGG_CFG:
        if c == "M":
            continue
        w = torch.randn((c, c_in, 3, 3), generator=gen) * float(np.sqrt(2.0 / (c_in * 9)))
        convs.append({"w": w.to(device), "b": torch.zeros((c,), device=device)})
        c_in = c
    if heads is None:
        head_ws = [torch.full((c, 1), 1.0 / c, device=device) for c in _TAP_CHANNELS]
    else:
        head_ws = [torch.as_tensor(np.asarray(h, np.float32).reshape(-1, 1), device=device) for h in heads]
    return {"convs": convs, "heads": head_ws}, False


def load_lpips(device="cuda"):
    """The packaged reference heads on the random trunk: (params, calibrated,
    status).  ``calibrated`` is False: the trunk is not pretrained."""
    with np.load(HEADS_PATH) as z:
        heads = [z[f"head_{i}"] for i in range(5)]
    params, calibrated = init_lpips(heads=heads, device=device)
    status = (
        "lpips[vgg]: UNCALIBRATED - reference linear heads on a random trunk "
        "(torch.Generator seed 1234); values are not comparable with published LPIPS"
    )
    return params, calibrated, status


def _vgg_features(params, x: torch.Tensor, bf16: bool):
    """x (H, W, 3) in [-1, 1] -> the five tap feature maps, (1, C, h, w) f32."""
    shift = torch.tensor(_SHIFT, dtype=x.dtype, device=x.device)
    scale = torch.tensor(_SCALE, dtype=x.dtype, device=x.device)
    h = ((x - shift) / scale).permute(2, 0, 1)[None]  # (1, 3, H, W)
    dtype = torch.bfloat16 if bf16 else torch.float32
    h = h.to(dtype)
    feats = []
    conv_i = 0
    for c in _VGG_CFG:
        if c == "M":
            # 2x2/2 max pool; odd edges are cropped, as torch does
            h = F.max_pool2d(h, 2)
            continue
        conv = params["convs"][conv_i]
        h = F.conv2d(h, conv["w"].to(dtype), padding=1)
        h = torch.relu(h + conv["b"].to(dtype)[None, :, None, None])
        if conv_i in _TAPS:
            feats.append(h.float())
        conv_i += 1
    return feats


def lpips(params, pred: torch.Tensor, gt: torch.Tensor, bf16: bool = True) -> torch.Tensor:
    """LPIPS distance between two (H, W, 3) images in [-1, 1]."""
    f_p = _vgg_features(params, pred, bf16)
    f_g = _vgg_features(params, gt, bf16)
    total = torch.zeros((), dtype=torch.float32, device=pred.device)
    for fp, fg, head in zip(f_p, f_g, params["heads"]):
        # x * rsqrt(sum x^2 + eps^2): x / (|x| + eps) has a 0/0 gradient at
        # the all-zero post-ReLU feature vectors of flat regions
        np_ = fp * torch.rsqrt(torch.sum(fp * fp, dim=1, keepdim=True) + 1e-20)
        ng_ = fg * torch.rsqrt(torch.sum(fg * fg, dim=1, keepdim=True) + 1e-20)
        d = (np_ - ng_) ** 2  # (1, C, h, w)
        w = torch.clamp_min(head[:, 0], 0.0)[None, :, None, None]
        total = total + torch.mean(torch.sum(d * w, dim=1))
    return total
