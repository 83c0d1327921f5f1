"""Positional encodings: standard NeRF-style and Hann-annealed coarse-to-fine
(port of gomavatar_tpu/ops/embedding.py).  Band order is per frequency, sin
then cos, as in the reference."""

from __future__ import annotations

import math

import torch


def embed_dim(multires: int, include_input: bool, d: int = 3) -> int:
    return (d if include_input else 0) + 2 * multires * d


def positional_encoding(x: torch.Tensor, multires: int, include_input: bool = True) -> torch.Tensor:
    """[x?, sin(2^k x), cos(2^k x)]_k."""
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    parts = [x] if include_input else []
    for k in range(multires):
        parts.append(torch.sin(x * freqs[k]))
        parts.append(torch.cos(x * freqs[k]))
    return torch.cat(parts, dim=-1)


def hann_window_weights(
    multires: int, i_iter, kick_in_iter: float, full_band_iter: float, device=None
) -> torch.Tensor:
    """Per-frequency Hann ramp: band j fades in as
    alpha = multires * (i - kick_in) / (full_band - kick_in) passes j."""
    i_iter = torch.as_tensor(i_iter, dtype=torch.float32, device=device)
    t = torch.clamp_min(i_iter - kick_in_iter, 0.0)
    alpha = multires * t / (full_band_iter - kick_in_iter)
    j = torch.arange(multires, dtype=torch.float32, device=i_iter.device)
    return (1.0 - torch.cos(math.pi * torch.clamp(alpha - j, 0.0, 1.0))) / 2.0


def annealed_positional_encoding(
    x: torch.Tensor,
    multires: int,
    i_iter,
    kick_in_iter: float = 0.0,
    full_band_iter: float = 50000.0,
) -> torch.Tensor:
    """Hann-annealed encoding without the input: w_j * [sin, cos](2^j x)."""
    w = hann_window_weights(multires, i_iter, kick_in_iter, full_band_iter, device=x.device)
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    parts = []
    for k in range(multires):
        parts.append(w[k] * torch.sin(x * freqs[k]))
        parts.append(w[k] * torch.cos(x * freqs[k]))
    return torch.cat(parts, dim=-1)
