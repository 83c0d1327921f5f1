"""The learning check of gomavatar_tpu_torch (``tools/overfit_check.py``) on
the CPU at a small size: 60 steps of the full train step (the plain versions
of kernels B2-B5, every mesh loss, Adam) on its two synthetic 64^2 frames
gain more than 5 dB of train-view PSNR, the JAX tool's own criterion at
400 steps and 128^2 (``tools/overfit_check.py:85``)."""

from gomavatar_tpu_torch.tools import overfit_check
from torch_threads import one_torch_thread  # noqa: F401


def test_overfit_gains_more_than_5_db():
    r = overfit_check.main(["--img", "64", "--iters", "60", "--device", "cpu"])
    assert r["psnr_after"] > r["psnr_before"] + 5.0
    assert r["iters"] == 60
