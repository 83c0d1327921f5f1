"""Image metrics, PSNR and SSIM, in both evaluation protocols of the
reference (port of gomavatar_tpu/metrics.py):

  * ZJU / neuralbody protocol: PSNR -10 log10(mse), and scikit-image 0.18's
    ``structural_similarity`` on float images, whose implicit data_range is
    2.0 (the float dtype range [-1, 1]), with a uniform 7x7 window and
    sample covariance, averaged over the channels;
  * Anim-NeRF / PeopleSnapshot protocol: torchmetrics defaults, data_range
    1.0, a gaussian 11x11 window with sigma 1.5, population covariance.

Images are (H, W, C) float tensors; every function is plain torch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, gt: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    return 10.0 * torch.log10(data_range**2 / torch.mean((pred - gt) ** 2))


def mse(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - gt) ** 2)


def _filter(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Valid-mode 2D filter of each channel of (H, W, C) by (k, k)."""
    x = img.permute(2, 0, 1)[:, None]  # (C, 1, H, W)
    return F.conv2d(x, kernel[None, None])[:, 0].permute(1, 2, 0)


def _uniform_filter(img: torch.Tensor, size: int) -> torch.Tensor:
    return _filter(img, torch.ones((size, size), dtype=img.dtype, device=img.device) / (size * size))


def _gaussian_filter(img: torch.Tensor, size: int, sigma: float) -> torch.Tensor:
    r = torch.arange(size, dtype=img.dtype, device=img.device) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (r / sigma) ** 2)
    g = g / torch.sum(g)
    return _filter(img, torch.outer(g, g))


def _ssim_core(pred, gt, data_range, win_size, filt, use_sample_covariance):
    K1, K2 = 0.01, 0.03
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    mu_p = filt(pred)
    mu_g = filt(gt)
    mu_pp = filt(pred * pred)
    mu_gg = filt(gt * gt)
    mu_pg = filt(pred * gt)
    # skimage's sample covariance carries the N / (N - 1) correction
    cov_norm = win_size * win_size / (win_size * win_size - 1.0) if use_sample_covariance else 1.0
    var_p = cov_norm * (mu_pp - mu_p * mu_p)
    var_g = cov_norm * (mu_gg - mu_g * mu_g)
    cov = cov_norm * (mu_pg - mu_p * mu_g)
    num = (2 * mu_p * mu_g + C1) * (2 * cov + C2)
    den = (mu_p**2 + mu_g**2 + C1) * (var_p + var_g + C2)
    return torch.mean(num / den)


def ssim_skimage(pred: torch.Tensor, gt: torch.Tensor, data_range: float = 2.0) -> torch.Tensor:
    """scikit-image 0.18 ``structural_similarity(multichannel=True)`` on
    float images: uniform 7x7 window, sample covariance, data_range 2.0."""
    return _ssim_core(pred, gt, data_range, 7, lambda x: _uniform_filter(x, 7), use_sample_covariance=True)


def ssim_torchmetrics(pred: torch.Tensor, gt: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """torchmetrics ``StructuralSimilarityIndexMeasure`` defaults: gaussian
    11x11 sigma-1.5 window, population covariance."""
    return _ssim_core(pred, gt, data_range, 11, lambda x: _gaussian_filter(x, 11, 1.5), use_sample_covariance=False)
