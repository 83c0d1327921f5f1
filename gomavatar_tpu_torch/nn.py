"""Minimal MLP layer over plain dicts of tensors (port of gomavatar_tpu/nn.py).

Parameters keep the reference's pytree layout, ``{"layers": [{"w", "b"},
...], "head": {"w", "b"}}`` with ``w`` of shape (d_in, d_out), so weights
carry across from JAX one array for one tensor (``convert.params_from_jax``).

Init follows the reference draw for draw: xavier-uniform with ReLU gain
sqrt(2) for the hidden layers and a head drawn uniform in +-last_init_scale
with zero bias, from the caller's ``prng`` key split as the reference splits
it.  Numbers are drawn on the host and then moved to ``device``, so one key
gives JAX's weights on every device.
"""

from __future__ import annotations

import math

import torch

from gomavatar_tpu_torch import prng

RELU_GAIN = math.sqrt(2.0)


def _uniform(key, shape, limit: float, device) -> torch.Tensor:
    return torch.as_tensor(prng.uniform(key, shape, -limit, limit), device=device)


def linear_init(key, d_in: int, d_out: int, gain: float = 1.0, device="cuda"):
    limit = gain * math.sqrt(6.0 / (d_in + d_out))
    return {
        "w": _uniform(key, (d_in, d_out), limit, device),
        "b": torch.zeros((d_out,), dtype=torch.float32, device=device),
    }


def linear_apply(p: dict, x: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, p["w"]) + p["b"]


def mlp_init(
    key,
    d_in: int,
    width: int,
    depth: int,
    d_out: int,
    skips: tuple[int, ...] = (),
    skip_dim: int = 0,
    last_init_scale: float = 1e-5,
    device="cuda",
):
    """``depth`` hidden linears (ReLU), the ``skip_dim``-sized embedding
    re-concatenated before hidden layer i for i in ``skips`` (i > 0), then a
    linear head.  ``key`` splits into depth + 1: one per hidden layer, the
    last for the head."""
    keys = prng.split(key, depth + 1)
    layers = []
    d = d_in
    for i in range(depth):
        din_i = d + (skip_dim if (i in skips and i > 0) else 0)
        layers.append(linear_init(keys[i], din_i, width, gain=RELU_GAIN, device=device))
        d = width
    head = {
        "w": _uniform(keys[-1], (width, d_out), last_init_scale, device),
        "b": torch.zeros((d_out,), dtype=torch.float32, device=device),
    }
    return {"layers": layers, "head": head}


def mlp_apply(p: dict, x: torch.Tensor, skips: tuple[int, ...] = (), skip_input=None):
    h = x
    for i, layer in enumerate(p["layers"]):
        if i in skips and i > 0 and skip_input is not None:
            h = torch.cat([h, skip_input], dim=-1)
        h = torch.relu(linear_apply(layer, h))
    return linear_apply(p["head"], h)
