"""TensorBoard logging with frequency gating (port of
gomavatar_tpu/utils/tb.py).

Scalars, images, videos, text, histograms and 3D point clouds / meshes, all
gated by a global step and a frequency, so that a call off the cadence is a
no-op.  A scalar may be a device tensor: it is read (a host sync) only on
the cadence.  Uses torch's ``SummaryWriter``.
"""

from __future__ import annotations

import numpy as np
import torch


class TBLogger:
    def __init__(self, log_dir: str, freq: int = 100, only_scalar: bool = False):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir)
        self.freq = freq
        self.global_step = 0
        self.only_scalar = only_scalar

    def set_step(self, step: int):
        self.global_step = step

    @property
    def _on(self) -> bool:
        return self.freq > 0 and self.global_step % self.freq == 0

    def summ_scalar(self, tag: str, value, force: bool = False):
        if force or self._on:
            self.writer.add_scalar(tag, float(value), self.global_step)

    def summ_image(self, tag: str, img):
        """img: (H, W, 3) or (H, W) float in [0, 1]."""
        if not self._on or self.only_scalar:
            return
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[..., None].repeat(3, -1)
        img = np.clip(img, 0.0, 1.0)
        self.writer.add_image(tag, img.transpose(2, 0, 1), self.global_step)

    def summ_video(self, tag: str, frames, fps: int = 10):
        if not self._on or self.only_scalar:
            return
        v = np.clip(np.asarray(frames), 0, 1)  # (T, H, W, 3)
        self.writer.add_video(
            tag, torch.from_numpy(v.transpose(0, 3, 1, 2)[None]), self.global_step, fps=fps
        )

    def summ_text(self, tag: str, text: str):
        if self._on:
            self.writer.add_text(tag, text, self.global_step)

    def summ_hist(self, tag: str, values):
        if not self._on or self.only_scalar:
            return
        self.writer.add_histogram(tag, torch.from_numpy(np.asarray(values).reshape(-1)), self.global_step)

    def summ_pointcloud(self, tag: str, verts, colors=None, faces=None):
        """verts (N, 3) [+ colors (N, 3) in 0..1, + faces (F, 3)], as a
        mesh summary."""
        if not self._on or self.only_scalar:
            return
        v = torch.from_numpy(np.asarray(verts, np.float32))[None]
        c = None
        if colors is not None:
            c = torch.from_numpy(
                (np.clip(np.asarray(colors), 0, 1) * 255).astype(np.uint8)
            )[None]
        f = None
        if faces is not None:
            f = torch.from_numpy(np.asarray(faces, np.int64))[None]
        self.writer.add_mesh(tag, v, colors=c, faces=f, global_step=self.global_step)

    def summ_feat(self, tag: str, feat):
        """PCA-to-RGB feature-map visualisation.  feat: (C, H, W), projected
        to its top-3 principal components (plain SVD) and min-max
        normalised."""
        if not self._on or self.only_scalar:
            return
        feat = np.asarray(feat, np.float32)
        C, H, W = feat.shape
        x = feat.transpose(1, 2, 0).reshape(-1, C)
        x = x - x.mean(axis=0)
        # PCA via SVD of the centered data (components = right singular vecs)
        _, _, vt = np.linalg.svd(x, full_matrices=False)
        rgb = (x @ vt[:3].T).reshape(H, W, 3)
        rgb = (rgb - rgb.min()) / max(rgb.max() - rgb.min(), 1e-12)
        self.writer.add_image(tag, rgb.transpose(2, 0, 1), self.global_step)

    def summ_pointcloud2d(self, tag: str, pts, img_size):
        """Rasterise 2D points into a binary image.  pts: (N, 2) pixel xy;
        img_size (W, H)."""
        if not self._on or self.only_scalar:
            return
        W, H = img_size
        img = np.zeros((H, W), np.float32)
        pts = np.asarray(pts)
        x = np.round(pts[:, 0]).astype(np.int64)
        y = np.round(pts[:, 1]).astype(np.int64)
        keep = (x >= 0) & (x < W) & (y >= 0) & (y < H)
        img[y[keep], x[keep]] = 1.0
        self.writer.add_image(tag, img[None], self.global_step)

    def summ_error_map(self, tag: str, pred, gt):
        if not self._on or self.only_scalar:
            return
        err = np.abs(np.asarray(pred) - np.asarray(gt)).mean(-1)
        err = err / max(err.max(), 1e-6)
        self.summ_image(tag, err)

    def flush(self):
        self.writer.flush()

    def close(self):
        """Flush and stop the writer's thread."""
        self.writer.close()
