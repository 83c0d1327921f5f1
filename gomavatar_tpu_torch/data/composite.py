"""A train item's composite over its background and its resize, on the card
(``csrc/composite_resize.cu``) or in plain float64 PyTorch, bit for bit
what ``TrainDataset._composite_resize`` computes with OpenCV from the
frame's undistorted ``uint8`` image and one-channel mask:

  * ``alpha = mask / 255`` and ``alpha * img + (1 - alpha) * bgcolor`` in
    float64 (the image through float32 and the color float32: exact);
  * the image resized with ``INTER_LANCZOS4`` on float64: per axis 8 taps
    at float32 coefficients (OpenCV's ``interpolateLanczos4`` of the
    fraction ``(float)((d + 0.5) * scale - 0.5)``: sines and cosines in
    double, the sum normalised in float32), the border replicated, each
    output row's horizontal sums taken tap by tap in float64, then the
    vertical sum over its 8 rows the same way;
  * the mask resized with ``INTER_LINEAR`` on float64, which OpenCV (4.13,
    5.0) computes per axis as ``fma(b - a, f, a)`` with the fraction ``f =
    fma(d + 0.5, src / dst, -0.5)`` less its floor, 0 at a clamped border,
    the rows first: at an exact 2x as well (no area path for float64);
  * the image ``/ 255`` and both cast to float32 (the mask's one channel:
    the host path resizes three equal ones and keeps the first).

The scale is read from the shapes.  The tables of taps and coefficients
are made on the host (``math``'s sines, numpy's float32) once per (source,
output) size; ``tests/test_torch_composite.py`` holds the plain version to
``cv2.resize`` bit for bit at 1024² -> 512² and 540² -> 544².  At a
frame's own size ``cv2.resize`` copies it, and the tables are the copy's
(:func:`copy_axis`; ``tests/test_torch_any_size.py`` at 540²).  The plain
version never divides a tensor by a Python number (PyTorch's CUDA division
by a host scalar multiplies by its reciprocal) and takes OpenCV's fused
multiply-adds exactly (:func:`fma`).
"""

from __future__ import annotations

import ctypes
import math
import threading
from fractions import Fraction

import numpy as np
import torch

LANCZOS_TAPS = 8
_S45 = 0.70710678118654752440084436210485
_LANCZOS_CS = ((1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45), (-1, 0), (_S45, _S45), (0, -1), (-_S45, _S45))
_f32 = np.float32


def _lanczos4(x: np.float32) -> list:
    """OpenCV's ``interpolateLanczos4(x)``: the 8 float32 coefficients."""
    y0 = float(-(x + _f32(3))) * math.pi * 0.25
    s0, c0 = math.sin(y0), math.cos(y0)
    coeffs, total = [], _f32(0)
    for i, (cs, cc) in enumerate(_LANCZOS_CS):
        yi = _f32(x + _f32(3) - _f32(i))
        if abs(yi) >= _f32(1e-6):
            y = float(-yi) * math.pi * 0.25
            c = _f32((cs * s0 + cc * c0) / (y * y))
        else:
            c = _f32(1e30)
        coeffs.append(c)
        total = _f32(total + c)
    total = _f32(_f32(1) / total)
    return [_f32(c * total) for c in coeffs]


def lanczos_axis(src: int, dst: int):
    """(taps (dst, 8) int32, coefficients (dst, 8) float32) of one axis."""
    scale = 1.0 / (dst / src)
    taps = np.empty((dst, LANCZOS_TAPS), np.int32)
    coef = np.empty((dst, LANCZOS_TAPS), np.float32)
    for d in range(dst):
        f = _f32((d + 0.5) * scale - 0.5)
        s = math.floor(f)
        taps[d] = np.clip(np.arange(s - 3, s + 5), 0, src - 1)
        coef[d] = _lanczos4(_f32(f - _f32(s)))
    return taps, coef


def copy_axis(n: int):
    """(taps (n, 8) int32, coefficients (n, 8) float32) of an axis of a
    frame resized to its own size: ``cv2.resize`` copies such a frame, so
    each output takes its own pixel, the tap at its centre, at weight 1 and
    the others at 0 (``lanczos_axis``'s float32 coefficients there are 1
    and +-1e-30, which a black pixel beside a lit one would keep)."""
    taps = np.clip(np.arange(n)[:, None] + np.arange(-3, 5)[None, :], 0, n - 1).astype(np.int32)
    coef = np.zeros((n, LANCZOS_TAPS), np.float32)
    coef[:, 3] = 1.0
    return taps, coef


def linear_axis(src: int, dst: int):
    """(taps (dst, 2) int32, fractions (dst,) float64) of one axis."""
    scale = Fraction(src / dst)
    taps = np.empty((dst, 2), np.int32)
    frac = np.empty((dst,), np.float64)
    for d in range(dst):
        # fma(d + 0.5, scale, -0.5): the exact value, rounded once
        f = float(Fraction(2 * d + 1, 2) * scale - Fraction(1, 2))
        s = math.floor(f)
        f -= s
        if s < 0:
            s, f = 0, 0.0
        if s >= src - 1:
            s, f = src - 1, 0.0
        taps[d] = (s, min(s + 1, src - 1))
        frac[d] = f
    return taps, frac


_tables: dict = {}
_tables_lock = threading.Lock()


def tables(src_hw, out_hw, device) -> tuple:
    """(Lanczos x taps, x coefficients, y taps, y coefficients, linear x
    taps, x fractions, y taps, y fractions) as tensors on ``device``, made
    once per sizes and device."""
    key = (tuple(src_hw), tuple(out_hw), str(device))
    with _tables_lock:
        t = _tables.get(key)
        if t is None:
            (H, W), (OH, OW) = src_hw, out_hw
            if (H, W) == (OH, OW):
                # copied, as cv2.resize copies it (the linear fractions are 0)
                lx, ly = copy_axis(W), copy_axis(H)
            else:
                lx, ly = lanczos_axis(W, OW), lanczos_axis(H, OH)
            host = (*lx, *ly, *linear_axis(W, OW), *linear_axis(H, OH))
            t = tuple(torch.as_tensor(a, device=device) for a in host)
            _tables[key] = t
    return t


# -- plain version ----------------------------------------------------------------


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """(p, e) with p + e = a * b exactly (Dekker's product, no FMA)."""
    p = a * b
    split = 134217729.0  # 2^27 + 1
    ca, cb = a * split, b * split
    ah, bh = ca - (ca - a), cb - (cb - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def _sum_round_odd(a, b):
    """a + b rounded to odd: the sum where exact, else the neighbour of
    the nearest rounding whose last mantissa bit is 1."""
    s, e = _two_sum(a, b)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(e > 0, torch.full_like(s, math.inf), torch.full_like(s, -math.inf))
    return torch.where((e != 0) & even, torch.nextafter(s, toward), s)


def fma(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``x * y + z`` rounded once, in float64 from separately rounded
    operations (Boldo and Melquiond's emulated FMA, through rounding to
    odd), on any device."""
    uh, ul = _two_prod(x, y)
    th, tl = _two_sum(z, uh)
    return th + _sum_round_odd(tl, ul)


def composite_resize_plain(img: torch.Tensor, mask: torch.Tensor, bgcolor, out_hw):
    """(rgb (OH, OW, 3) float32, mask (OH, OW) float32) of ``img`` (H, W, 3)
    uint8 over ``bgcolor`` (3 numbers, the float32 color in 0-255) through
    ``mask`` (H, W) uint8, at ``out_hw``, in float64 on ``img``'s device."""
    dev = img.device
    f64 = dict(dtype=torch.float64, device=dev)
    lx, cx, ly, cy, mx, fx, my, fy = tables(img.shape[:2], out_hw, dev)
    c255 = torch.full((), 255.0, **f64)
    alpha = mask.to(torch.float64) / c255
    bg = torch.as_tensor(np.asarray(bgcolor, np.float32)).to(**f64)
    comp = alpha[..., None] * img.to(torch.float64) + (1.0 - alpha[..., None]) * bg
    cx, cy = cx.to(torch.float64), cy.to(torch.float64)
    rows = None
    for j in range(LANCZOS_TAPS):
        t = comp[:, lx[:, j].long()] * cx[None, :, j, None]
        rows = t if rows is None else rows + t
    out = None
    for k in range(LANCZOS_TAPS):
        t = rows[ly[:, k].long()] * cy[:, k, None, None]
        out = t if out is None else out + t
    a0, a1 = alpha[:, mx[:, 0].long()], alpha[:, mx[:, 1].long()]
    h = fma(a1 - a0, fx[None, :], a0)
    r0, r1 = h[my[:, 0].long()], h[my[:, 1].long()]
    m = fma(r1 - r0, fy[:, None], r0)
    return (out / c255).to(torch.float32), m.to(torch.float32)


# -- the kernel -------------------------------------------------------------------

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # img, mask, H, W
    ctypes.c_double, ctypes.c_double, ctypes.c_double,  # bgcolor
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # Lanczos x taps, coef, y taps, coef
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # linear x taps, frac, y taps, frac
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,  # rgb, mask out, OH, OW
    ctypes.c_void_p,  # stream
]


def _kernel_fn():
    from gomavatar_tpu_torch import cuda_build

    fn = cuda_build.load("composite_resize").gom_composite_resize
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def composite_resize(img: torch.Tensor, mask: torch.Tensor, bgcolor, out_hw):
    """:func:`composite_resize_plain`'s outputs: on a CUDA tensor by one
    launch of the kernel on the current stream, on a CPU tensor by the
    plain version."""
    if img.device.type == "cpu":
        return composite_resize_plain(img, mask, bgcolor, out_hw)
    from gomavatar_tpu_torch.ops.splat.pallas_kernel import launch_kernel

    H, W = img.shape[:2]
    if img.dtype != torch.uint8 or img.shape != (H, W, 3) or not img.is_contiguous():
        raise ValueError(f"img must be a contiguous (H, W, 3) uint8 tensor, got {tuple(img.shape)} {img.dtype}")
    if mask.dtype != torch.uint8 or mask.shape != (H, W) or not mask.is_contiguous() or mask.device != img.device:
        raise ValueError(f"mask must be a contiguous ({H}, {W}) uint8 tensor on {img.device}")
    OH, OW = out_hw
    rgb = torch.empty((OH, OW, 3), dtype=torch.float32, device=img.device)
    out_mask = torch.empty((OH, OW), dtype=torch.float32, device=img.device)
    bg = [float(c) for c in np.asarray(bgcolor, np.float32)]
    launch_kernel("composite_resize", _kernel_fn(), img, mask, H, W, *bg, *tables((H, W), (OH, OW), img.device),
                  rgb, out_mask, OH, OW)
    return rgb, out_mask
