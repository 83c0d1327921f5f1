"""ctypes bindings for the native host image pipeline (port of
gomavatar_tpu/data/native_loader.py).

It binds the repository's ``native/libgomhost.so`` (native/gom_host.cpp, a
plain C interface), built on demand with ``native/Makefile`` (g++, libpng,
libjpeg).  Callers check :func:`available` and take the cv2 path where the
library cannot be built or loaded.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    so = os.path.abspath(os.path.join(_NATIVE_DIR, "libgomhost.so"))
    if not os.path.exists(so):
        try:
            subprocess.run(
                ["make", "-C", os.path.abspath(_NATIVE_DIR)],
                check=True,
                capture_output=True,
            )
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return None
    lib.undistort_resize_composite.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),  # img
        ctypes.POINTER(ctypes.c_uint8),  # mask
        ctypes.c_int, ctypes.c_int,  # H, W
        ctypes.POINTER(ctypes.c_double),  # K
        ctypes.POINTER(ctypes.c_double),  # D
        ctypes.c_int,  # n_d
        ctypes.POINTER(ctypes.c_float),  # bgcolor
        ctypes.POINTER(ctypes.c_float),  # out_img
        ctypes.POINTER(ctypes.c_float),  # out_mask
        ctypes.c_int, ctypes.c_int,  # outH, outW
    ]
    lib.rodrigues.argtypes = [
        ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double),
    ]
    lib.load_frame.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int,
    ]
    lib.load_frame.restype = ctypes.c_int
    lib.probe_image.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)
    ]
    lib.probe_image.restype = ctypes.c_int
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def undistort_resize_composite(
    img: np.ndarray,
    mask: np.ndarray,
    K: np.ndarray,
    D: np.ndarray | None,
    bgcolor: np.ndarray,
    out_hw: tuple[int, int],
):
    """Fused undistort + resize + composite in one native pass.

    Args:
      img: (H, W, 3) uint8; mask: (H, W) uint8; K: (3, 3); D: (n,) or None;
      bgcolor: (3,) float in [0, 255]; out_hw: (outH, outW).
    Returns:
      (img (outH, outW, 3) float32 in [0, 255], mask (outH, outW) float32 in [0, 1]).
    """
    lib = _load()
    assert lib is not None, "native library unavailable"
    img = np.ascontiguousarray(img, np.uint8)
    mask = np.ascontiguousarray(mask, np.uint8)
    H, W = img.shape[:2]
    outH, outW = out_hw
    K = np.ascontiguousarray(K, np.float64)
    D = np.ascontiguousarray(D if D is not None else np.zeros(0), np.float64)
    bg = np.ascontiguousarray(bgcolor, np.float32)
    out_img = np.empty((outH, outW, 3), np.float32)
    out_mask = np.empty((outH, outW), np.float32)

    u8p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    f64p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    f32p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    lib.undistort_resize_composite(
        u8p(img), u8p(mask), H, W, f64p(K), f64p(D), len(D),
        f32p(bg), f32p(out_img), f32p(out_mask), outH, outW,
    )
    return out_img, out_mask


def load_frame(
    img_path: str,
    mask_path: str,
    K: np.ndarray,
    D: np.ndarray | None,
    bgcolor: np.ndarray,
    out_hw: tuple[int, int],
):
    """Decode + undistort + resize + composite entirely in C++ (no GIL):
    one call from PNG/JPEG paths to float tensors."""
    lib = _load()
    assert lib is not None
    outH, outW = out_hw
    K = np.ascontiguousarray(K, np.float64)
    D = np.ascontiguousarray(D if D is not None else np.zeros(0), np.float64)
    bg = np.ascontiguousarray(bgcolor, np.float32)
    out_img = np.empty((outH, outW, 3), np.float32)
    out_mask = np.empty((outH, outW), np.float32)
    f64p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    f32p = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    rc = lib.load_frame(
        img_path.encode(), mask_path.encode(), f64p(K), f64p(D), len(D),
        f32p(bg), f32p(out_img), f32p(out_mask), outH, outW,
    )
    if rc != 0:
        raise IOError(f"native load_frame failed ({rc}) for {img_path}")
    return out_img, out_mask


def probe_image(path: str) -> tuple[int, int]:
    """(H, W) of an image from its header (no full decode for PNG)."""
    lib = _load()
    assert lib is not None
    H = ctypes.c_int()
    W = ctypes.c_int()
    rc = lib.probe_image(path.encode(), ctypes.byref(H), ctypes.byref(W))
    if rc != 0:
        raise IOError(f"probe_image failed ({rc}) for {path}")
    return H.value, W.value


def rodrigues(rvec: np.ndarray) -> np.ndarray:
    lib = _load()
    assert lib is not None
    rvec = np.ascontiguousarray(rvec, np.float64)
    R = np.empty(9, np.float64)
    lib.rodrigues(
        rvec.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        R.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return R.reshape(3, 3)
