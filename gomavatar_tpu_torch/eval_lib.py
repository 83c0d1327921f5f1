"""Evaluators for both benchmark protocols of the reference (port of
gomavatar_tpu/eval_lib.py).

  * ``Evaluator``: the ZJU-MoCap / neuralbody protocol: MSE, PSNR,
    skimage-0.18 SSIM (the data_range=2 float quirk) and VGG-LPIPS x 1000;
  * ``EvaluatorSnapshot``: the Anim-NeRF protocol: torchmetrics PSNR and
    SSIM (data_range=1) and AlexNet-LPIPS.

Both quantise through uint8 before the metrics, as the reference does
(``to_8b_image``), report LPIPS as ``lpips_uncalibrated`` when the trunk is
not a converted pretrained one, and dump the per-frame lists to
``metric_{tag}.npy``.  The metrics run on the device of the LPIPS params.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from gomavatar_tpu_torch.metrics import psnr, ssim_skimage, ssim_torchmetrics
from gomavatar_tpu_torch.models import lpips as lpips_lib


def to_8b_image(img: np.ndarray) -> np.ndarray:
    return (255.0 * np.clip(img, 0.0, 1.0)).astype(np.uint8)


class _EvaluatorBase:
    TRUNK = "vgg"

    def __init__(self, lpips_params=None, lpips_calibrated=False, device="cuda"):
        if lpips_params is None:
            # best-available weights; logs the calibration status once
            lpips_params, lpips_calibrated, _ = lpips_lib.load_lpips(self.TRUNK, device=device)
        self.lpips_params = lpips_params
        self.lpips_calibrated = lpips_calibrated
        self.device = lpips_params["heads"][0].device
        self.metrics: dict[str, list] = {}

    def _add(self, name, value):
        self.metrics.setdefault(name, []).append(float(value))

    def _tensor(self, img: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(img, np.float32), device=self.device)

    def _lpips(self, pred, gt):
        return float(lpips_lib.lpips(self.lpips_params, self._tensor(pred * 2.0 - 1.0), self._tensor(gt * 2.0 - 1.0)))

    def summarize(self, path: str | None = None) -> dict[str, float]:
        means = {k: float(np.mean(v)) for k, v in self.metrics.items()}
        if not self.lpips_calibrated and "lpips" in means:
            means["lpips_uncalibrated"] = means.pop("lpips")
        if path is not None:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            np.save(path, self.metrics)
        self.metrics = {}
        return means


class Evaluator(_EvaluatorBase):
    """ZJU / neuralbody protocol."""

    def evaluate(self, rgb_pred: np.ndarray, rgb_gt: np.ndarray):
        pred = to_8b_image(rgb_pred) / 255.0
        gt = to_8b_image(rgb_gt) / 255.0
        mse = float(np.mean((pred - gt) ** 2))
        self._add("mse", mse)
        self._add("psnr", -10.0 * np.log(mse) / np.log(10.0))
        self._add("ssim", ssim_skimage(self._tensor(pred), self._tensor(gt)))
        self._add("lpips", self._lpips(pred, gt) * 1000.0)


class EvaluatorSnapshot(_EvaluatorBase):
    """PeopleSnapshot / Anim-NeRF protocol, with AlexNet-LPIPS."""

    TRUNK = "alex"

    def evaluate(self, rgb_pred: np.ndarray, rgb_gt: np.ndarray):
        pred = to_8b_image(rgb_pred) / 255.0
        gt = to_8b_image(rgb_gt) / 255.0
        self._add("psnr", psnr(self._tensor(pred), self._tensor(gt)))
        self._add("ssim", ssim_torchmetrics(self._tensor(pred), self._tensor(gt)))
        self._add("lpips", self._lpips(pred, gt))
