"""The port's LPIPS checkpoint conversion (``load_torch_heads``,
``load_torch_vgg16``, ``load_torch_alexnet``, ``save_npz`` and
``gomavatar_tpu_torch/tools/calibrate_lpips.py``) against the JAX package's
on the same ``.pth`` files on the CPU.

The files are torchvision's and LPIPS's layouts at full width, made from a
numpy seed: VGG16's and AlexNet's ``features`` (He-scaled weights, nonzero
biases), a few small ``classifier.*`` keys the conversion must ignore, and
linear heads with negative entries for the clamp.  The converted params are
exactly JAX's (the weights after the OIHW <-> HWIO transpose); LPIPS on them
holds to JAX's within 1e-5 relative in float32 and 1e-2 in bfloat16 (XLA and
torch round bfloat16 convolutions differently); the taps hold to a
``torch.nn`` trunk loaded from the same state dict within 1e-5 relative, in
norm and elementwise with 1e-5 of each tap's largest value as the floor.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from gomavatar_tpu.models import lpips as JL
from gomavatar_tpu_torch.models import lpips as TL
from gomavatar_tpu_torch.tools import calibrate_lpips
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
TRUNKS = ("vgg", "alex")
# torchvision's positions of the convs in ``features``
CONV_INDICES = {"vgg": [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28], "alex": [0, 3, 6, 8, 10]}
TAP_CHANNELS = {"vgg": [64, 128, 256, 512, 512], "alex": [64, 192, 384, 256, 256]}
F32_RTOL, BF16_RTOL = 1e-5, 1e-2
HW = 64


def torchvision_features(trunk: str) -> nn.Sequential:
    """``features`` of torchvision's VGG16 or AlexNet, module for module."""
    if trunk == "alex":
        return nn.Sequential(
            nn.Conv2d(3, 64, 11, 4, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, 1, 2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, 1, 1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, 1, 1), nn.ReLU(), nn.MaxPool2d(3, 2),
        )
    layers, c_in = [], 3
    for c in [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512, 512, 512, "M"]:
        if c == "M":
            layers.append(nn.MaxPool2d(2, 2))
        else:
            layers += [nn.Conv2d(c_in, c, 3, 1, 1), nn.ReLU()]
            c_in = c
    return nn.Sequential(*layers)


def seeded_checkpoint(trunk: str, seed: int):
    """(features module, trunk state dict with classifier keys, heads state
    dict), drawn from numpy ``seed``."""
    rng = np.random.default_rng(seed)
    seq = torchvision_features(trunk)
    with torch.no_grad():
        for m in seq:
            if isinstance(m, nn.Conv2d):
                o, i, kh, kw = m.weight.shape
                m.weight.copy_(torch.from_numpy((rng.standard_normal((o, i, kh, kw)) *
                                                 np.sqrt(2.0 / (i * kh * kw))).astype(np.float32)))
                m.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.05, o).astype(np.float32)))
    sd = {f"features.{k}": v.clone() for k, v in seq.state_dict().items()}
    for k in ("0", "3", "6"):
        sd[f"classifier.{k}.weight"] = torch.from_numpy(rng.standard_normal((4, 8)).astype(np.float32))
        sd[f"classifier.{k}.bias"] = torch.from_numpy(rng.standard_normal(4).astype(np.float32))
    heads = {f"lin{i}.model.1.weight": torch.from_numpy(rng.uniform(-0.05, 0.2, (1, c, 1, 1)).astype(np.float32))
             for i, c in enumerate(TAP_CHANNELS[trunk])}
    return seq, sd, heads


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    """Both trunks' and heads' ``.pth`` files, written by ``torch.save``."""
    root = tmp_path_factory.mktemp("pth")
    out = {}
    for seed, trunk in enumerate(TRUNKS):
        seq, sd, heads = seeded_checkpoint(trunk, seed)
        trunk_path, heads_path = str(root / f"{trunk}_trunk.pth"), str(root / f"{trunk}_heads.pth")
        torch.save(sd, trunk_path)
        torch.save(heads, heads_path)
        out[trunk] = {"seq": seq, "sd": sd, "heads": heads, "trunk_path": trunk_path, "heads_path": heads_path}
    return out


def load_both(trunk, c, with_heads=True):
    heads = c["heads_path"] if with_heads else None
    if trunk == "vgg":
        return JL.load_torch_vgg16(c["trunk_path"], heads), TL.load_torch_vgg16(c["trunk_path"], heads, device="cpu")
    return JL.load_torch_alexnet(c["trunk_path"], heads), TL.load_torch_alexnet(c["trunk_path"], heads, device="cpu")


def images(seed: int):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(-1, 1, (HW, HW, 3)).astype(np.float32)
    pred = np.clip(gt + 0.3 * rng.standard_normal(gt.shape), -1, 1).astype(np.float32)
    return pred, gt


def assert_params_equal(t_params, j_params):
    """The port's params (OIHW weights) exactly JAX's (HWIO)."""
    assert ("alex" in t_params) == ("alex" in j_params)
    assert len(t_params["convs"]) == len(j_params["convs"])
    for c, jc in zip(t_params["convs"], j_params["convs"]):
        assert c["w"].dtype == torch.float32
        np.testing.assert_array_equal(c["w"].numpy(), np.asarray(jc["w"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(c["b"].numpy(), np.asarray(jc["b"]))
    for h, jh in zip(t_params["heads"], j_params["heads"], strict=True):
        assert tuple(h.shape) == tuple(jh.shape)
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh))


def test_conv_indices_are_torchvisions():
    for trunk in TRUNKS:
        assert TL.torch_conv_indices(trunk) == CONV_INDICES[trunk]
        seq = torchvision_features(trunk)
        assert [i for i, m in enumerate(seq) if isinstance(m, nn.Conv2d)] == CONV_INDICES[trunk]


@pytest.mark.parametrize("trunk", TRUNKS)
def test_load_torch_heads_matches_jax(ckpts, trunk):
    c = ckpts[trunk]
    got, want = TL.load_torch_heads(c["heads_path"]), JL.load_torch_heads(c["heads_path"])
    assert len(got) == len(want) == 5
    for i, (g, w, ch) in enumerate(zip(got, want, TAP_CHANNELS[trunk])):
        raw = c["heads"][f"lin{i}.model.1.weight"].numpy().reshape(-1)
        assert g.dtype == np.float32 and g.shape == (ch,)
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, np.maximum(raw, 0.0))
        assert (raw < 0).any() and (g >= 0).all()


@pytest.mark.parametrize("with_heads", [False, True], ids=["uniform_heads", "heads"])
@pytest.mark.parametrize("trunk", TRUNKS)
def test_load_torch_trunk_matches_jax(ckpts, trunk, with_heads):
    c = ckpts[trunk]
    (j_params, j_cal), (t_params, t_cal) = load_both(trunk, c, with_heads)
    assert t_cal == j_cal == with_heads
    assert ("alex" in t_params) == (trunk == "alex")
    assert_params_equal(t_params, j_params)
    # the convs are the state dict's tensors at torchvision's indices; the
    # classifier keys are not read
    for conv, idx in zip(t_params["convs"], CONV_INDICES[trunk], strict=True):
        assert torch.equal(conv["w"], c["sd"][f"features.{idx}.weight"])
        assert torch.equal(conv["b"], c["sd"][f"features.{idx}.bias"])
        assert float(conv["b"].abs().max()) > 0
    if not with_heads:
        for h, ch in zip(t_params["heads"], TAP_CHANNELS[trunk]):
            assert torch.equal(h, torch.full((ch, 1), 1.0 / ch))


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("trunk", TRUNKS)
def test_converted_lpips_matches_jax(ckpts, trunk, bf16):
    (j_params, _), (t_params, _) = load_both(trunk, ckpts[trunk])
    pred, gt = images(3)
    want = float(JL.lpips(j_params, jnp.asarray(pred), jnp.asarray(gt), bf16=bf16))
    got = float(TL.lpips(t_params, torch.as_tensor(pred), torch.as_tensor(gt), bf16=bf16))
    assert want > 1e-3
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL if bf16 else F32_RTOL)


@pytest.mark.parametrize("trunk", TRUNKS)
def test_taps_match_torch_nn_trunk(ckpts, trunk):
    """The port's taps of the converted trunk against torchvision's
    ``features`` loaded with the same state dict (no JAX involved)."""
    c = ckpts[trunk]
    seq = torchvision_features(trunk)
    seq.load_state_dict({k[len("features."):]: v for k, v in c["sd"].items() if k.startswith("features.")})
    params, _ = (TL.load_torch_vgg16 if trunk == "vgg" else TL.load_torch_alexnet)(c["trunk_path"], device="cpu")
    pred, _ = images(4)
    x = ((torch.as_tensor(pred) - torch.tensor(TL._SHIFT)) / torch.tensor(TL._SCALE)).permute(2, 0, 1)[None]
    relus = [i for i, m in enumerate(seq) if isinstance(m, nn.ReLU)]
    tap_at = {relus[k] for k in ((1, 3, 6, 9, 12) if trunk == "vgg" else range(5))}
    want = []
    with torch.no_grad():
        for i, m in enumerate(seq):
            x = m(x)
            if i in tap_at:
                want.append(x.clone())
        got = (TL._vgg_features if trunk == "vgg" else TL._alex_features)(params, torch.as_tensor(pred), bf16=False)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.shape == w.shape and float(w.abs().max()) > 0
        # the port adds the bias after the conv, torch.nn inside it: values
        # that round near 0 keep no relative digits, so each tap is held
        # within 1e-5 of its own largest value as well
        scale = float(w.abs().max())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=F32_RTOL, atol=F32_RTOL * scale)
        assert float(torch.linalg.norm(g - w) / torch.linalg.norm(w)) <= F32_RTOL


@pytest.mark.parametrize("trunk", TRUNKS)
def test_save_npz_matches_jax_and_loads_across(ckpts, trunk, tmp_path):
    (j_params, _), (t_params, _) = load_both(trunk, ckpts[trunk])
    t_path, j_path = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    TL.save_npz(t_path, t_params)
    JL.save_npz(j_path, j_params)
    with np.load(t_path) as t, np.load(j_path) as j:
        assert sorted(t.files) == sorted(j.files)
        assert ("alex" in t.files) == (trunk == "alex")
        for k in j.files:
            assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    # each package reads the other's file to the same numbers
    assert_params_equal(TL.load_npz(j_path, device="cpu"), JL.load_npz(t_path))
    assert_params_equal(TL.load_npz(t_path, device="cpu"), j_params)


def tool_lines(text: str, out_dir: str) -> list[str]:
    return [line.replace(out_dir, "<out_dir>") for line in text.splitlines() if line.strip()]


def test_tools_write_the_same_files(ckpts, tmp_path, capsys):
    """JAX's tools/calibrate_lpips.py (a subprocess) and the port's main on
    the same four files: identical npz arrays, the same printed lines, and
    CALIBRATED in both packages' load_lpips, each reading its own dir."""
    v, a = ckpts["vgg"], ckpts["alex"]
    flags = ["--vgg16", v["trunk_path"], "--vgg_heads", v["heads_path"], "--alexnet", a["trunk_path"],
             "--alex_heads", a["heads_path"]]
    j_dir, t_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "tools/calibrate_lpips.py", *flags, "--out_dir", j_dir], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    wrote = calibrate_lpips.main([*flags, "--out_dir", t_dir])
    assert [(os.path.basename(p), cal) for p, cal in wrote] == [("lpips_vgg.npz", True), ("lpips_alex.npz", True)]
    printed = tool_lines(capsys.readouterr().out, t_dir)
    assert printed == tool_lines(out.stdout, j_dir) and len(printed) == 4
    for name in ("lpips_vgg.npz", "lpips_alex.npz"):
        with np.load(os.path.join(j_dir, name)) as j, np.load(os.path.join(t_dir, name)) as t:
            assert sorted(t.files) == sorted(j.files)
            for k in j.files:
                assert t[k].dtype == j[k].dtype
                np.testing.assert_array_equal(t[k], j[k], err_msg=f"{name} {k}")
    for trunk in TRUNKS:
        _, t_cal, t_status = TL.load_lpips(trunk, weights_dir=t_dir, quiet=True, device="cpu")
        _, j_cal, j_status = JL.load_lpips(trunk, weights_dir=j_dir, quiet=True)
        assert t_cal and j_cal and "CALIBRATED" in t_status
        assert t_status.replace(t_dir, "<dir>") == j_status.replace(j_dir, "<dir>")


def test_heads_only_reproduces_the_shipped_heads(tmp_path, capsys):
    """A heads .pth rebuilt from the shipped lpips_vgg_heads.npz, converted
    by --vgg_heads alone, gives the shipped arrays back exactly."""
    with np.load(TL.HEADS_PATH) as z:
        shipped = {k: z[k] for k in z.files}
    path = str(tmp_path / "vgg.pth")
    torch.save({f"lin{i}.model.1.weight": torch.from_numpy(shipped[f"head_{i}"].reshape(1, -1, 1, 1))
                for i in range(5)}, path)
    out_dir = tmp_path / "out"
    assert calibrate_lpips.main(["--vgg_heads", path, "--out_dir", str(out_dir)]) == [
        (str(out_dir / "lpips_vgg_heads.npz"), False)]
    with np.load(out_dir / "lpips_vgg_heads.npz") as z:
        assert sorted(z.files) == sorted(shipped)
        for k, want in shipped.items():
            assert z[k].dtype == want.dtype
            np.testing.assert_array_equal(z[k], want)
    assert "reference linear heads" in capsys.readouterr().out


def test_out_dir_defaults_to_the_ports_weights_dir(ckpts, tmp_path, monkeypatch):
    # WEIGHTS_DIR: GOMAVATAR_LPIPS_DIR where it is set, else the port's own
    # weights/, never a directory of the JAX package
    assert TL.HEADS_PATH.parent == ROOT / "gomavatar_tpu_torch" / "weights"
    assert TL.WEIGHTS_DIR == os.environ.get("GOMAVATAR_LPIPS_DIR", str(TL.HEADS_PATH.parent))
    monkeypatch.setattr(TL, "WEIGHTS_DIR", str(tmp_path / "here"))
    calibrate_lpips.main(["--vgg_heads", ckpts["vgg"]["heads_path"]])
    assert (tmp_path / "here" / "lpips_vgg_heads.npz").exists()
    # a user's run with GOMAVATAR_LPIPS_DIR set
    env = dict(os.environ, GOMAVATAR_LPIPS_DIR=str(tmp_path / "env"), PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-m", "gomavatar_tpu_torch.tools.calibrate_lpips", "--vgg_heads",
                          ckpts["vgg"]["heads_path"]], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert (tmp_path / "env" / "lpips_vgg_heads.npz").exists()


def test_nothing_to_convert_is_jaxs_error(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        calibrate_lpips.main(["--out_dir", str(tmp_path)])
    assert exc.value.code == 2
    err = capsys.readouterr().err.strip().splitlines()[-1]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "tools/calibrate_lpips.py", "--out_dir", str(tmp_path)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    want = out.stderr.strip().splitlines()[-1]
    assert "error: nothing to convert" in err
    assert err.split("error:")[1] == want.split("error:")[1]
