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
    the JAX package's format: the values are CALIBRATED, comparable with
    published LPIPS numbers.  ``python -m
    gomavatar_tpu_torch.tools.calibrate_lpips`` writes it from torchvision's
    VGG16 or AlexNet state dict and LPIPS's linear heads
    (:func:`load_torch_vgg16`, :func:`load_torch_alexnet`,
    :func:`load_torch_heads`, :func:`save_npz`);
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

Layout (:func:`channels_last`, from the device): on a card the trunk runs
channels-last (NHWC) from the image to the head, the layout in which cuDNN's
bf16 tensor-core kernels run on Hopper, so no conv transposes its input,
weights or output.  The weights are laid out once (:func:`laid_out`: each
conv's float32 weight channels-last, and beside it its bfloat16 copy
``w_bf16``, channels-last, and bias ``b_bf16``), wherever params are made
for a card here and where ``Trainer`` and the pose optimizer take them, so
a trunk call casts no weight; each such call counts ``lpips.trunk_nhwc``.
The image's (H, W, 3) is NHWC in memory already, so its (1, 3, H, W) view
is free.  On the CPU the trunk runs NCHW as the JAX package lays it out.

The distance head after the taps (:func:`lpips_head`): on CUDA taps one
hand-written forward and one backward over all five taps in the trunk's
dtype (``csrc/lpips_head.cu``: 2 launches forward, 1 backward, counted in
``lpips_head.launches``; the counter ``lpips.head_kernel`` once a call); on
CPU taps :func:`lpips_head_plain` on their float32 copies, differentiated
by autograd; any other device raises.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from gomavatar_tpu_torch import prng
from gomavatar_tpu_torch.utils.profiling import count

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
    with ``heads`` (five (C,) arrays) or uniform 1/C heads, :func:`laid_out`.
    Returns (params, calibrated=False)."""
    return laid_out({"convs": _convs(1234, vgg_shapes(), device), "heads": _heads(heads, _TAP_CHANNELS, device)}), False


def _heads(heads, channels, device):
    if heads is None:
        return [torch.full((c, 1), 1.0 / c, device=device) for c in channels]
    return [torch.as_tensor(np.asarray(h, np.float32).reshape(-1, 1), device=device) for h in heads]


def init_lpips_alex(heads=None, device="cuda"):
    """JAX's random He-scaled AlexNet trunk (seed 4321; conv weights OIHW),
    with ``heads`` or uniform 1/C heads, :func:`laid_out`.  Returns (params,
    calibrated=False); the ``"alex"`` key marks the trunk."""
    return laid_out({"alex": (), "convs": _convs(4321, alex_shapes(), device),
                     "heads": _heads(heads, _ALEX_TAP_CHANNELS, device)}), False


def save_npz(path: str, params) -> None:
    """Write LPIPS params as a flat npz in the JAX package's format
    (``conv_w_{i}`` HWIO float32, ``conv_b_{i}``, ``head_{i}``, and an
    ``alex`` marker for the AlexNet trunk), which both packages load."""
    def host(t):
        return t.detach().cpu().numpy().astype(np.float32)

    flat = {}
    for i, c in enumerate(params["convs"]):
        flat[f"conv_w_{i}"] = np.ascontiguousarray(host(c["w"]).transpose(2, 3, 1, 0))
        flat[f"conv_b_{i}"] = host(c["b"])
    for i, h in enumerate(params["heads"]):
        flat[f"head_{i}"] = host(h)
    if "alex" in params:
        flat["alex"] = np.zeros(())
    np.savez(path, **flat)


def load_npz(path: str, device="cuda"):
    """LPIPS params from a converted-trunk npz in the JAX package's format
    (``conv_w_{i}`` HWIO, ``conv_b_{i}``, ``head_{i}`` (C, 1), an ``alex``
    marker for the AlexNet trunk), :func:`laid_out`."""
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
    return laid_out(params)


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


def channels_last(device) -> bool:
    """Whether the trunk runs channels-last on ``device``: on a card, where
    cuDNN's bf16 tensor-core kernels run NHWC and transpose NCHW tensors in
    and out of every conv; elsewhere it runs NCHW."""
    return torch.device(device).type == "cuda"


def laid_out(params):
    """``params`` with the trunk's weights laid out for its device: where
    :func:`channels_last`, each conv's float32 weight ``w`` channels-last (the
    same values) and beside it ``w_bf16``, its bfloat16 copy channels-last,
    and ``b_bf16``, its bias in bfloat16: made once here, so the trunk casts
    nothing per call.  ``params`` themselves elsewhere or where laid out
    already."""
    convs = params["convs"]
    if "w_bf16" in convs[0] or not channels_last(convs[0]["w"].device):
        return params
    cl = torch.channels_last
    with torch.no_grad():
        convs = [{**c, "w": c["w"].contiguous(memory_format=cl), "w_bf16": c["w"].to(torch.bfloat16, memory_format=cl),
                  "b_bf16": c["b"].to(torch.bfloat16)} for c in convs]
    return {**params, "convs": convs}


def _trunk_input(params, x: torch.Tensor, bf16: bool):
    """The trunk's input, (1, 3, H, W) in its dtype (bfloat16 when
    ``bf16``), from x (H, W, 3), and each conv's (weight, bias) in that
    dtype.  Channels-last (:func:`channels_last`): the normalised image's
    (1, 3, H, W) view of its NHWC memory and :func:`laid_out`'s weights,
    counted as ``lpips.trunk_nhwc``; else NCHW, the weights cast per call."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    if channels_last(x.device):
        count("lpips.trunk_nhwc")
        convs = laid_out(params)["convs"]
        h = _normalize(x)[None].permute(0, 3, 1, 2).to(dtype, memory_format=torch.channels_last)
        return h, [(c["w_bf16"], c["b_bf16"]) if bf16 else (c["w"], c["b"]) for c in convs]
    h = _normalize(x).permute(2, 0, 1)[None].to(dtype)
    return h, [(c["w"].to(dtype), c["b"].to(dtype)) for c in params["convs"]]


def _channel_constant(values, like: torch.Tensor) -> torch.Tensor:
    """(3,) ``values`` made on ``like``'s device: filled there, since a copy
    from the host would block a captured step."""
    return torch.stack([torch.full((), v, dtype=like.dtype, device=like.device) for v in values])


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """(x - shift) / scale per channel, the trunks' input scaling."""
    return (x - _channel_constant(_SHIFT, x)) / _channel_constant(_SCALE, x)


def _vgg_features(params, x: torch.Tensor, bf16: bool):
    """x (H, W, 3) in [-1, 1] -> the five tap feature maps, (1, C, h, w) in
    the trunk's dtype (bfloat16 when ``bf16``) and layout."""
    h, convs = _trunk_input(params, x, bf16)
    feats = []
    conv_i = 0
    for c in _VGG_CFG:
        if c == "M":
            # 2x2/2 max pool; odd edges are cropped, as torch does
            h = F.max_pool2d(h, 2)
            continue
        w, b = convs[conv_i]
        h = F.conv2d(h, w, padding=1)
        h = torch.relu(h + b[None, :, None, None])
        if conv_i in _TAPS:
            feats.append(h)
        conv_i += 1
    return feats


def _alex_features(params, x: torch.Tensor, bf16: bool):
    """x (H, W, 3) in [-1, 1] -> the five AlexNet relu taps, (1, C, h, w) in
    the trunk's dtype and layout."""
    h, convs = _trunk_input(params, x, bf16)
    feats = []
    for (w, b), (_, _, stride, pad, pool_before) in zip(convs, _ALEX_CONVS):
        if pool_before:
            h = F.max_pool2d(h, 3, 2)  # no padding, floor output size
        h = F.conv2d(h, w, stride=stride, padding=pad)
        h = torch.relu(h + b[None, :, None, None])
        feats.append(h)
    return feats


def lpips(params, pred: torch.Tensor, gt: torch.Tensor, bf16: bool = True) -> torch.Tensor:
    """LPIPS distance between two (H, W, 3) images in [-1, 1]; the trunk is
    AlexNet when ``params`` hold the ``"alex"`` key, else VGG16."""
    features = _alex_features if "alex" in params else _vgg_features
    return lpips_head(features(params, pred, bf16), features(params, gt, bf16), params["heads"])


# ---- the distance head ------------------------------------------------------------


def lpips_head_plain(f_p, f_g, heads) -> torch.Tensor:
    """The distance head on float32 taps: each (1, C, h, w) feature vector
    unit-normalised, the squared difference weighted by the clamped head
    (``heads[k]`` (C, 1)), summed over channels, its spatial mean summed over
    the taps in order."""
    total = torch.zeros((), dtype=torch.float32, device=f_p[0].device)
    for fp, fg, head in zip(f_p, f_g, heads):
        # x * rsqrt(sum x^2 + eps^2): x / (|x| + eps) has a 0/0 gradient at
        # the all-zero post-ReLU feature vectors of flat regions
        np_ = fp * torch.rsqrt(torch.sum(fp * fp, dim=1, keepdim=True) + 1e-20)
        ng_ = fg * torch.rsqrt(torch.sum(fg * fg, dim=1, keepdim=True) + 1e-20)
        d = (np_ - ng_) ** 2  # (1, C, h, w)
        w = torch.clamp_min(head[:, 0], 0.0)[None, :, None, None]
        total = total + torch.mean(torch.sum(d * w, dim=1))
    return total


def lpips_head(f_p, f_g, heads) -> torch.Tensor:
    """:func:`lpips_head_plain` of the taps ``f_p`` (the prediction's) and
    ``f_g`` (the target's), differentiable in ``f_p`` only: on CUDA taps
    (bfloat16 or float32, each (1, C, h, w) contiguous, NCHW or
    channels-last) by the kernels of
    ``csrc/lpips_head.cu``, on CPU taps by the plain version on their
    float32 copies."""
    dev = f_p[0].device
    if dev.type == "cpu":
        return lpips_head_plain([f.float() for f in f_p], [f.float() for f in f_g], heads)
    if dev.type != "cuda":
        raise ValueError(f"the LPIPS head runs on CUDA or CPU tensors, not {dev}")
    count("lpips.head_kernel")
    return _LpipsHead.apply(len(f_p), *f_p, *f_g, *heads)


lpips_head.launches = 0

# the kernels' block and its shared memory (csrc/lpips_head.cu)
_HEAD_THREADS = 256
_HEAD_SMEM = 48 * 1024
_HEAD_DTYPES = {torch.bfloat16: 2, torch.float32: 4}


def head_plan(C: int, P: int, elem: int, ptrs=(), nhwc: bool = False) -> tuple[int, int]:
    """(tile, vec) of a tap of C channels and P pixels of ``elem``-byte
    floats, NCHW or (``nhwc``) channels-last: a block's pixels, the largest
    power of two up to 256 whose two tiles fit the block's shared memory
    beside the head and its scratch (a tile: C rows of ``tile`` pixels, or
    ``tile`` pixel rows of C + 4 / ``elem``, whose pad keeps the kernels'
    reads off shared bank conflicts), and the bytes a load, the widest of 16,
    8, 4 and 2 (not below ``elem``) that divides every address in ``ptrs``
    and the run a load walks: a channel row's P pixels, or a pixel's C
    channels."""
    pad = 4 // elem if nhwc else 0
    room = (_HEAD_SMEM - 4 * C - 8 * _HEAD_THREADS) // (2 * (C + pad) * elem)
    if room < 8:
        most = (_HEAD_SMEM - 8 * _HEAD_THREADS - 16 * pad * elem) // (16 * elem + 4)
        raise ValueError(f"the LPIPS head kernel takes at most {most} channels of {elem}-byte floats, not {C}")
    tile = min(_HEAD_THREADS, 1 << (room.bit_length() - 1))
    run = (C if nhwc else P) * elem
    for vec in (16, 8, 4, 2):
        if vec >= elem and run % vec == 0 and all(p % vec == 0 for p in ptrs):
            return tile, vec
    raise ValueError(f"the LPIPS head kernel reads {elem}-byte floats at {elem}-byte aligned addresses")


# the taps' arrays of both launchers: taps, bytes an element, fp, fg, head,
# C, P, tile, vec, nhwc (csrc/lpips_head.cu)
_TAP_ARGTYPES = [ctypes.c_int, ctypes.c_int, *[ctypes.POINTER(ctypes.c_void_p)] * 3,
                 *[ctypes.POINTER(ctypes.c_int)] * 5]


@functools.lru_cache(maxsize=None)
def _head_fns():
    from gomavatar_tpu_torch import cuda_build

    lib = cuda_build.load("lpips_head")
    fwd, bwd = lib.gom_lpips_head_fwd, lib.gom_lpips_head_bwd
    fwd.argtypes = [ctypes.c_void_p] * 3 + _TAP_ARGTYPES + [ctypes.c_void_p]  # r, partial, out; stream
    bwd.argtypes = [ctypes.c_void_p] * 2 + [ctypes.POINTER(ctypes.c_void_p)] + _TAP_ARGTYPES + [ctypes.c_void_p]
    fwd.restype = bwd.restype = ctypes.c_int
    return fwd, bwd


def _head_table(f_p, f_g, heads, grads=()):
    """((n, elem, fp, fg, head, C, P, tile, vec, nhwc): the taps' arguments
    of a launch, blocks, pixels); raises on what the kernels do not take.  A
    tap's layout is read from ``fp``: NCHW where it is contiguous, else
    channels-last where it is that, which ``fg`` then shares."""
    elem = _HEAD_DTYPES.get(f_p[0].dtype)
    if elem is None:
        raise ValueError(f"the LPIPS head kernel takes bfloat16 or float32 taps, not {f_p[0].dtype}")
    n, dev = len(f_p), f_p[0].device
    Cs, Ps, tiles, vecs, layouts = [], [], [], [], []
    for k, (fp, fg, head) in enumerate(zip(f_p, f_g, heads)):
        if fp.dim() != 4 or fp.shape[0] != 1 or fg.shape != fp.shape:
            raise ValueError(f"taps must be two (1, C, h, w) tensors of one shape, got {tuple(fp.shape)} and "
                             f"{tuple(fg.shape)}")
        C, P = fp.shape[1], fp.shape[2] * fp.shape[3]
        nhwc = not fp.is_contiguous() and fp.is_contiguous(memory_format=torch.channels_last)
        layout = torch.channels_last if nhwc else torch.contiguous_format
        for name, t in (("fp", fp), ("fg", fg)):
            if t.dtype != f_p[0].dtype or not t.is_contiguous(memory_format=layout) or t.device != dev:
                raise ValueError(f"{name} must be a {f_p[0].dtype} tensor on {dev}, contiguous NCHW or both "
                                 f"taps channels-last")
        if head.dtype != torch.float32 or head.numel() != C or not head.is_contiguous() or head.device != dev:
            raise ValueError(f"a head must be a contiguous float32 tensor of {C} values on {dev}")
        tile, vec = head_plan(C, P, elem, [fp.data_ptr(), fg.data_ptr()] + [g.data_ptr() for g in grads[k:k + 1]],
                              nhwc)
        Cs.append(C), Ps.append(P), tiles.append(tile), vecs.append(vec), layouts.append(int(nhwc))

    def ptrs(ts):
        return (ctypes.c_void_p * n)(*(t.data_ptr() for t in ts))

    def ints(v):
        return (ctypes.c_int * n)(*v)

    blocks = sum(-(-P // t) for P, t in zip(Ps, tiles))
    return ((n, elem, ptrs(f_p), ptrs(f_g), ptrs(heads), ints(Cs), ints(Ps), ints(tiles), ints(vecs), ints(layouts)),
            blocks, sum(Ps))


class _LpipsHead(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n, *taps):
        from gomavatar_tpu_torch.ops.splat.pallas_kernel import launch_kernel

        f_p, f_g, heads = taps[:n], taps[n:2 * n], [h.reshape(-1) for h in taps[2 * n:]]
        if any(ctx.needs_input_grad[1 + n:]):
            raise ValueError("the LPIPS head kernel differentiates in the prediction's taps only")
        table, blocks, pixels = _head_table(f_p, f_g, heads)
        dev = f_p[0].device
        r = torch.empty((2 * pixels,), dtype=torch.float32, device=dev)
        partial = torch.empty((blocks,), dtype=torch.float32, device=dev)
        out = torch.empty((), dtype=torch.float32, device=dev)
        launch_kernel("lpips_head_fwd", _head_fns()[0], r, partial, out, *table)
        lpips_head.launches += 2
        ctx.n = n
        ctx.save_for_backward(*f_p, *f_g, *heads, r)
        return out

    @staticmethod
    def backward(ctx, g_out):
        from gomavatar_tpu_torch.ops.splat.pallas_kernel import launch_kernel

        n, saved = ctx.n, ctx.saved_tensors
        f_p, f_g, heads, r = saved[:n], saved[n:2 * n], saved[2 * n:3 * n], saved[3 * n]
        grads = [torch.empty_like(fp) for fp in f_p]
        table, _, _ = _head_table(f_p, f_g, heads, grads)
        g_out = g_out.to(torch.float32).contiguous()
        grad_ptrs = (ctypes.c_void_p * n)(*(g.data_ptr() for g in grads))
        launch_kernel("lpips_head_bwd", _head_fns()[1], r, g_out, grad_ptrs, *table)
        lpips_head.launches += 1
        return (None, *grads, *([None] * (2 * n)))


def torch_conv_indices(trunk: str) -> list[int]:
    """The conv layers' positions in torchvision's ``features`` (each conv
    is followed by a ReLU, each "M" or pool_before is a pool): VGG16 0, 2,
    5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28; AlexNet 0, 3, 6, 8, 10."""
    idx, out = 0, []
    if trunk == "vgg":
        for c in _VGG_CFG:
            if c == "M":
                idx += 1
            else:
                out.append(idx)
                idx += 2
    else:
        for *_, pool_before in _ALEX_CONVS:
            idx += int(pool_before)
            out.append(idx)
            idx += 2
    return out


def load_torch_heads(path: str) -> list[np.ndarray]:
    """LPIPS's linear heads from its checkpoint (keys
    ``lin{i}.model.1.weight``, shape (1, C, 1, 1)): five (C,) float32
    arrays, clamped at >= 0 as LPIPS clamps them at use."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return [np.maximum(sd[f"lin{i}.model.1.weight"].float().numpy().reshape(-1), np.float32(0.0))
            for i in range(5)]


def _load_torch_trunk(trunk: str, path: str, heads_path, channels, device):
    """The convs of a torchvision state dict at ``torch_conv_indices(trunk)``
    (weights stay OIHW; every other key, such as ``classifier.*``, is
    ignored), with LPIPS heads from ``heads_path`` or uniform 1/C heads,
    :func:`laid_out`."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    convs = [{"w": sd[f"features.{i}.weight"].float().to(device), "b": sd[f"features.{i}.bias"].float().to(device)}
             for i in torch_conv_indices(trunk)]
    heads = load_torch_heads(heads_path) if heads_path is not None else None
    return laid_out({"convs": convs, "heads": _heads(heads, channels, device)}), heads_path is not None


def load_torch_vgg16(path: str, heads_path: str | None = None, device="cuda"):
    """LPIPS params from torchvision's VGG16 state dict (``vgg16-*.pth``)
    and, optionally, LPIPS's VGG heads (``vgg.pth``).  Returns (params,
    calibrated): calibrated when the heads were given."""
    return _load_torch_trunk("vgg", path, heads_path, _TAP_CHANNELS, device)


def load_torch_alexnet(path: str, heads_path: str | None = None, device="cuda"):
    """LPIPS params from torchvision's AlexNet state dict
    (``alexnet-*.pth``) and, optionally, LPIPS's AlexNet heads
    (``alex.pth``); the ``"alex"`` key marks the trunk.  Returns (params,
    calibrated)."""
    params, calibrated = _load_torch_trunk("alex", path, heads_path, _ALEX_TAP_CHANNELS, device)
    return {"alex": (), **params}, calibrated
