"""Splat blend constants shared with the CUDA rasterizer's forward semantics
(port of the constants of gomavatar_tpu/ops/splat/reference.py): alpha is
clamped to 0.99, contributions below 1/255 are skipped, and a pixel stops
taking contributions once its transmittance would fall below 1e-4."""

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
