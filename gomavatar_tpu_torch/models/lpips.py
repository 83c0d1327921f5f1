"""LPIPS with a VGG16 or an AlexNet trunk (port of
gomavatar_tpu/models/lpips.py).

Scaling layer -> trunk relu features (VGG16: relu1_2, relu2_2, relu3_3,
relu4_3, relu5_3; AlexNet: relu1..5) -> unit-normalise each feature vector
-> squared difference -> non-negative 1x1 linear head -> spatial mean -> sum
over the five taps.  VGG16 is the training loss and the ZJU protocol's
metric; AlexNet the PeopleSnapshot protocol's metric.

Weights: :func:`load_lpips` picks the best available, in the JAX package's
order, from ``WEIGHTS_DIR`` (this package's ``weights/``, or
``GOMAVATAR_LPIPS_DIR`` when set):
  * ``lpips_{vgg,alex}.npz``, a converted pretrained trunk with its heads in
    the JAX package's format (``tools/calibrate_lpips.py`` writes it): the
    values are CALIBRATED, comparable with published LPIPS numbers;
  * vgg only: the reference's five linear heads (``lpips_vgg_heads.npz``,
    7 KB, shipped with this package) on a random trunk;
  * a random trunk with uniform heads.
A random trunk is He-scaled and drawn as the JAX package draws it: from
``prng.key(1234)`` (VGG) or ``prng.key(4321)`` (AlexNet), one ``split`` per
conv, each weight drawn in JAX's HWIO shape and then transposed to OIHW.  So
the port's random trunk is JAX's, number for number.  It gives a
perceptual-style training signal, but its values are uncalibrated.  Each
trunk is drawn once per process, on the host (the VGG16 trunk's 14.7 M
normals take a few seconds; ``chip_smoke.py`` 9c times the draw).

Convolutions run in bfloat16 by default, as in the reference.
"""

from __future__ import annotations

import functools
import logging
import os
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from gomavatar_tpu_torch import prng

log = logging.getLogger(__name__)

HEADS_PATH = Path(__file__).resolve().parent.parent / "weights" / "lpips_vgg_heads.npz"
# where load_lpips looks for lpips_{vgg,alex}.npz and lpips_vgg_heads.npz
WEIGHTS_DIR = os.environ.get("GOMAVATAR_LPIPS_DIR", str(HEADS_PATH.parent))

# VGG16 feature config: conv widths, "M" = 2x2 max pool
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512]
# indices (in conv order) after which LPIPS taps features: relu1_2 ... relu5_3
_TAPS = (1, 3, 6, 9, 12)
_TAP_CHANNELS = (64, 128, 256, 512, 512)

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

# AlexNet trunk (torchvision alexnet.features, the LPIPS slices):
# (out_c, kernel, stride, pad, pool_before), pool_before = a 3x3/2 max pool
# precedes the conv
_ALEX_CONVS = [
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
]
_ALEX_TAP_CHANNELS = (64, 192, 384, 256, 256)


@functools.lru_cache(maxsize=None)
def random_trunk(seed: int, shapes: tuple) -> tuple[np.ndarray, ...]:
    """He-scaled conv weights, HWIO, as the JAX package draws them from
    ``PRNGKey(seed)``: ``k, sub = split(k)`` then ``normal(sub, hwio)``
    times sqrt(2 / fan_in) in float32, conv by conv; drawn once per
    process."""
    k = prng.key(seed)
    ws = []
    for shape in shapes:
        k, sub = prng.split(k)
        fan_in = shape[0] * shape[1] * shape[2]
        ws.append(prng.normal(sub, shape) * np.float32(np.sqrt(2.0 / fan_in)))
    return tuple(ws)


def _convs(seed: int, shapes, device):
    """The random trunk's convs, weights OIHW on ``device``."""
    return [{"w": torch.as_tensor(np.ascontiguousarray(w.transpose(3, 2, 0, 1)), device=device),
             "b": torch.zeros((w.shape[3],), device=device)}
            for w in random_trunk(seed, tuple(shapes))]


def vgg_shapes():
    widths = [c for c in _VGG_CFG if c != "M"]
    return [(3, 3, c_in, c) for c_in, c in zip([3] + widths[:-1], widths)]


def alex_shapes():
    widths = [c for c, *_ in _ALEX_CONVS]
    return [(ksz, ksz, c_in, c) for c_in, (c, ksz, *_) in zip([3] + widths[:-1], _ALEX_CONVS)]


def init_lpips(heads=None, device="cuda"):
    """JAX's random He-scaled VGG16 trunk (seed 1234; conv weights OIHW),
    with ``heads`` (five (C,) arrays) or uniform 1/C heads.  Returns
    (params, calibrated=False)."""
    return {"convs": _convs(1234, vgg_shapes(), device), "heads": _heads(heads, _TAP_CHANNELS, device)}, False


def _heads(heads, channels, device):
    if heads is None:
        return [torch.full((c, 1), 1.0 / c, device=device) for c in channels]
    return [torch.as_tensor(np.asarray(h, np.float32).reshape(-1, 1), device=device) for h in heads]


def init_lpips_alex(heads=None, device="cuda"):
    """JAX's random He-scaled AlexNet trunk (seed 4321; conv weights OIHW),
    with ``heads`` or uniform 1/C heads.  Returns (params,
    calibrated=False); the ``"alex"`` key marks the trunk."""
    return {"alex": (), "convs": _convs(4321, alex_shapes(), device),
            "heads": _heads(heads, _ALEX_TAP_CHANNELS, device)}, False


def load_npz(path: str, device="cuda"):
    """LPIPS params from a converted-trunk npz in the JAX package's format
    (``conv_w_{i}`` HWIO, ``conv_b_{i}``, ``head_{i}`` (C, 1), an ``alex``
    marker for the AlexNet trunk)."""
    with np.load(path) as z:
        n_convs = sum(1 for k in z.files if k.startswith("conv_w_"))
        params = {
            "convs": [
                {"w": torch.as_tensor(z[f"conv_w_{i}"].transpose(3, 2, 0, 1).copy(), device=device),
                 "b": torch.as_tensor(z[f"conv_b_{i}"], device=device)}
                for i in range(n_convs)
            ],
            "heads": [torch.as_tensor(z[f"head_{i}"], device=device) for i in range(5)],
        }
        if "alex" in z.files:
            params = {"alex": (), **params}
    return params


_STATUS_LOGGED: set[str] = set()


def load_lpips(trunk: str = "vgg", weights_dir: str | None = None, quiet: bool = False, device="cuda"):
    """Best-available LPIPS params for ``trunk`` ("vgg" | "alex"), in this
    order of preference:
      1. ``<weights_dir>/lpips_<trunk>.npz``: a converted pretrained trunk
         and its heads, CALIBRATED;
      2. vgg only: the reference's heads (``lpips_vgg_heads.npz``) on the
         fixed-seed random trunk: real head weighting, values still not
         comparable with published LPIPS numbers;
      3. the fixed-seed random trunk with uniform heads.
    Returns ``(params, calibrated, status)`` and logs the status line once
    per trunk."""
    wdir = weights_dir or WEIGHTS_DIR
    full = os.path.join(wdir, f"lpips_{trunk}.npz")
    heads_path = os.path.join(wdir, "lpips_vgg_heads.npz")
    if os.path.exists(full):
        out = load_npz(full, device), True, f"lpips[{trunk}]: CALIBRATED (converted trunk {full})"
    elif trunk == "vgg" and os.path.exists(heads_path):
        with np.load(heads_path) as z:
            heads = [z[f"head_{i}"] for i in range(5)]
        out = init_lpips(heads=heads, device=device)[0], False, (
            "lpips[vgg]: UNCALIBRATED — reference linear heads "
            "(utils/lpips/weights/v0.1/vgg.pth) on a fixed-seed random "
            "trunk; run tools/calibrate_lpips.py for published-comparable "
            "values"
        )
    else:
        params, _ = init_lpips_alex(device=device) if trunk == "alex" else init_lpips(device=device)
        out = params, False, (
            f"lpips[{trunk}]: UNCALIBRATED — fixed-seed random trunk + "
            "uniform heads; run tools/calibrate_lpips.py"
        )
    if not quiet and trunk not in _STATUS_LOGGED:
        _STATUS_LOGGED.add(trunk)
        (log.info if out[1] else log.warning)("%s", out[2])
    return out


def _channel_constant(values, like: torch.Tensor) -> torch.Tensor:
    """(3,) ``values`` made on ``like``'s device: filled there, since a copy
    from the host would block a captured step."""
    return torch.stack([torch.full((), v, dtype=like.dtype, device=like.device) for v in values])


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """(x - shift) / scale per channel, the trunks' input scaling."""
    return (x - _channel_constant(_SHIFT, x)) / _channel_constant(_SCALE, x)


def _vgg_features(params, x: torch.Tensor, bf16: bool):
    """x (H, W, 3) in [-1, 1] -> the five tap feature maps, (1, C, h, w) f32."""
    h = _normalize(x).permute(2, 0, 1)[None]  # (1, 3, H, W)
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


def _alex_features(params, x: torch.Tensor, bf16: bool):
    """x (H, W, 3) in [-1, 1] -> the five AlexNet relu taps, (1, C, h, w) f32."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    h = _normalize(x).permute(2, 0, 1)[None].to(dtype)
    feats = []
    for conv, (_, _, stride, pad, pool_before) in zip(params["convs"], _ALEX_CONVS):
        if pool_before:
            h = F.max_pool2d(h, 3, 2)  # no padding, floor output size
        h = F.conv2d(h, conv["w"].to(dtype), stride=stride, padding=pad)
        h = torch.relu(h + conv["b"].to(dtype)[None, :, None, None])
        feats.append(h.float())
    return feats


def lpips(params, pred: torch.Tensor, gt: torch.Tensor, bf16: bool = True) -> torch.Tensor:
    """LPIPS distance between two (H, W, 3) images in [-1, 1]; the trunk is
    AlexNet when ``params`` hold the ``"alex"`` key, else VGG16."""
    features = _alex_features if "alex" in params else _vgg_features
    f_p = features(params, pred, bf16)
    f_g = features(params, gt, bf16)
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
