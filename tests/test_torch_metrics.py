"""gomavatar_tpu_torch's metrics, LPIPS loading and evaluators against
gomavatar_tpu's on the CPU, on the same numpy images.

The metrics hold to JAX's within 1e-5 (the same float32 arithmetic, summed in
another order); the evaluators within 1e-4 relative, with their LPIPS
convolutions in float32 on both sides: XLA and torch round bfloat16
convolutions differently (3e-4 of the VGG value here), and
test_torch_losses.py holds the bfloat16 LPIPS to JAX's at its own tolerance.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gomavatar_tpu import eval_lib as JE
from gomavatar_tpu import metrics as JM
from gomavatar_tpu.models import lpips as JL
from gomavatar_tpu_torch import eval_lib as TE
from gomavatar_tpu_torch import metrics as TM
from gomavatar_tpu_torch.convert import lpips_from_jax
from gomavatar_tpu_torch.models import lpips as TL
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
METRIC_ATOL = 1e-5
EVAL_RTOL = 1e-4


def _images(kind: str, seed: int = 0, hw=(40, 48)):
    """A prediction and a target in [0, 1]: 'random' floats, or 'quantised'
    through uint8 as the evaluators see them."""
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 1, (*hw, 3)).astype(np.float32)
    pred = np.clip(gt + 0.1 * rng.standard_normal(gt.shape), 0, 1).astype(np.float32)
    if kind == "quantised":
        pred, gt = (np.round(x * 255.0) / 255.0 for x in (pred, gt))
    return pred.astype(np.float32), gt.astype(np.float32)


@pytest.mark.parametrize("kind", ["random", "quantised"])
@pytest.mark.parametrize("name", ["psnr", "mse", "ssim_skimage", "ssim_torchmetrics"])
def test_metric_matches_jax(name, kind):
    pred, gt = _images(kind)
    want = float(getattr(JM, name)(jnp.asarray(pred), jnp.asarray(gt)))
    got = float(getattr(TM, name)(torch.as_tensor(pred), torch.as_tensor(gt)))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=0, atol=METRIC_ATOL * max(1.0, abs(want)))


def test_ssim_is_one_on_equal_images_and_falls_with_noise():
    pred, gt = _images("random")
    t = torch.as_tensor
    assert float(TM.ssim_skimage(t(gt), t(gt))) == pytest.approx(1.0, abs=1e-6)
    assert float(TM.ssim_torchmetrics(t(gt), t(gt))) == pytest.approx(1.0, abs=1e-6)
    assert float(TM.ssim_skimage(t(pred), t(gt))) < 0.99


@pytest.fixture(scope="module")
def lpips_pairs():
    """JAX's VGG and AlexNet LPIPS params (their random trunks, the VGG
    with the packaged heads) and the port's copies of them."""
    with np.load(TL.HEADS_PATH) as z:
        heads = [z[f"head_{i}"] for i in range(5)]
    j_vgg, _ = JL.init_lpips(heads=heads)
    j_alex, _ = JL.init_lpips_alex()
    return {"vgg": (j_vgg, lpips_from_jax(j_vgg, device="cpu")),
            "alex": (j_alex, lpips_from_jax(j_alex, device="cpu"))}


@pytest.mark.parametrize("bf16", [False, True])
def test_alex_lpips_matches_jax(lpips_pairs, bf16):
    j_params, t_params = lpips_pairs["alex"]
    assert "alex" in t_params
    pred, gt = _images("random", seed=3, hw=(96, 96))
    pred, gt = 2 * pred - 1, 2 * gt - 1
    want = float(JL.lpips(j_params, jnp.asarray(pred), jnp.asarray(gt), bf16=bf16))
    got = float(TL.lpips(t_params, torch.as_tensor(pred), torch.as_tensor(gt), bf16=bf16))
    assert want > 1e-4
    np.testing.assert_allclose(got, want, rtol=1e-5 if not bf16 else 1e-2)


def test_alex_trunk_is_drawn_from_its_seed():
    a, calibrated = TL.init_lpips_alex(device="cpu")
    b, _ = TL.init_lpips_alex(device="cpu")
    assert not calibrated and "alex" in a
    assert [tuple(c["w"].shape) for c in a["convs"]] == [(64, 3, 11, 11), (192, 64, 5, 5), (384, 192, 3, 3),
                                                           (256, 384, 3, 3), (256, 256, 3, 3)]
    assert all(torch.equal(x["w"], y["w"]) for x, y in zip(a["convs"], b["convs"]))
    assert float(a["convs"][2]["w"].std()) == pytest.approx(np.sqrt(2.0 / (192 * 9)), rel=0.02)


@pytest.mark.parametrize("cls", ["Evaluator", "EvaluatorSnapshot"])
def test_evaluator_matches_jax(lpips_pairs, cls, tmp_path, monkeypatch):
    """Two frames through both packages' evaluator with the same LPIPS
    params: the means, the lpips_uncalibrated rename and the metric dump."""
    for lib in (JL, TL):
        monkeypatch.setattr(lib, "lpips", lambda p, a, b, fn=lib.lpips: fn(p, a, b, bf16=False))
    j_params, t_params = lpips_pairs["vgg" if cls == "Evaluator" else "alex"]
    j_ev = getattr(JE, cls)(lpips_params=j_params)
    t_ev = getattr(TE, cls)(lpips_params=t_params)
    for seed in (1, 2):
        pred, gt = _images("random", seed=seed, hw=(64, 64))
        j_ev.evaluate(pred, gt)
        t_ev.evaluate(pred, gt)
    want = j_ev.summarize(str(tmp_path / "j" / "metric_view.npy"))
    got = t_ev.summarize(str(tmp_path / "t" / "metric_view.npy"))
    assert set(got) == set(want) and "lpips_uncalibrated" in got and "lpips" not in got
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=EVAL_RTOL, err_msg=k)
    dumped = np.load(tmp_path / "t" / "metric_view.npy", allow_pickle=True).item()
    assert set(dumped) == set(np.load(tmp_path / "j" / "metric_view.npy", allow_pickle=True).item())
    assert all(len(v) == 2 for v in dumped.values())
    assert t_ev.metrics == {}  # summarize starts a new run


def test_evaluator_keeps_lpips_when_calibrated(lpips_pairs):
    ev = TE.Evaluator(lpips_params=lpips_pairs["vgg"][1], lpips_calibrated=True)
    pred, gt = _images("quantised")
    ev.evaluate(pred, gt)
    assert "lpips" in ev.summarize()


def test_to_8b_image_matches_jax():
    x = np.linspace(-0.2, 1.2, 97, dtype=np.float32).reshape(97, 1, 1)
    np.testing.assert_array_equal(TE.to_8b_image(x), JE.to_8b_image(x))


@pytest.mark.parametrize("trunk", ["vgg", "alex"])
def test_load_lpips_preference_order_matches_jax(trunk, tmp_path):
    """Empty dir -> random trunk; with the packaged heads (vgg) -> the heads;
    with a converted npz in JAX's format -> CALIBRATED, the same params and
    the same LPIPS in both packages."""
    _, cal, status = TL.load_lpips(trunk, weights_dir=str(tmp_path), quiet=True, device="cpu")
    _, j_cal, j_status = JL.load_lpips(trunk, weights_dir=str(tmp_path), quiet=True)
    assert not cal and not j_cal and status == j_status and "random trunk" in status
    if trunk == "vgg":
        (tmp_path / "lpips_vgg_heads.npz").write_bytes(TL.HEADS_PATH.read_bytes())
        params, cal, status = TL.load_lpips("vgg", weights_dir=str(tmp_path), quiet=True, device="cpu")
        _, _, j_status = JL.load_lpips("vgg", weights_dir=str(tmp_path), quiet=True)
        assert not cal and status == j_status and "reference linear heads" in status
        with np.load(TL.HEADS_PATH) as z:
            np.testing.assert_array_equal(params["heads"][0][:, 0].numpy(), z["head_0"])
    j_params = (JL.init_lpips_alex if trunk == "alex" else JL.init_lpips)(jax.random.PRNGKey(7))[0]
    JL.save_npz(str(tmp_path / f"lpips_{trunk}.npz"), j_params)
    params, cal, status = TL.load_lpips(trunk, weights_dir=str(tmp_path), quiet=True, device="cpu")
    j_loaded, j_cal, j_status = JL.load_lpips(trunk, weights_dir=str(tmp_path), quiet=True)
    assert cal and j_cal and status == j_status and "CALIBRATED" in status
    assert ("alex" in params) == (trunk == "alex")
    for c, jc in zip(params["convs"], j_loaded["convs"]):
        np.testing.assert_array_equal(c["w"].numpy(), np.asarray(jc["w"]).transpose(3, 2, 0, 1))
    pred, gt = _images("random", seed=5, hw=(64, 64))
    want = float(JL.lpips(j_loaded, jnp.asarray(2 * pred - 1), jnp.asarray(2 * gt - 1), bf16=False))
    got = float(TL.lpips(params, torch.as_tensor(2 * pred - 1), torch.as_tensor(2 * gt - 1), bf16=False))
    np.testing.assert_allclose(got, want, rtol=1e-5)


_ENV_PROBE = """
import json, sys
import numpy as np, jax.numpy as jnp, torch
from gomavatar_tpu.models import lpips as JL
from gomavatar_tpu_torch.models import lpips as TL
rng = np.random.default_rng(0)
gt = rng.uniform(-1, 1, (64, 64, 3)).astype(np.float32)
pred = np.clip(gt + 0.2 * rng.standard_normal(gt.shape), -1, 1).astype(np.float32)
jp, jc, js = JL.load_lpips("alex", quiet=True)
tp, tc, ts = TL.load_lpips("alex", quiet=True, device="cpu")
print(json.dumps({"jax": [jc, js, float(JL.lpips(jp, jnp.asarray(pred), jnp.asarray(gt), bf16=False))],
                  "torch": [tc, ts, float(TL.lpips(tp, torch.as_tensor(pred), torch.as_tensor(gt), bf16=False))],
                  "dirs": [JL.WEIGHTS_DIR, TL.WEIGHTS_DIR]}))
"""


def test_converted_trunk_loads_through_the_env_in_both_packages(tmp_path):
    """The C1 pin: an AlexNet npz in JAX's format in GOMAVATAR_LPIPS_DIR is
    CALIBRATED in both packages and gives the same LPIPS."""
    JL.save_npz(str(tmp_path / "lpips_alex.npz"), JL.init_lpips_alex(jax.random.PRNGKey(11))[0])
    env = dict(os.environ, GOMAVATAR_LPIPS_DIR=str(tmp_path), JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", _ENV_PROBE], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["dirs"] == [str(tmp_path)] * 2
    (jc, js, jv), (tc, ts, tv) = res["jax"], res["torch"]
    assert jc and tc and js == ts and "CALIBRATED" in ts
    assert jv > 1e-4
    np.testing.assert_allclose(tv, jv, rtol=1e-5)
