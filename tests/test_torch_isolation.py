"""gomavatar_tpu_torch and chip_smoke.py stand alone: they import neither
jax nor anything of gomavatar_tpu, tools or __graft_entry__; CPU tensors
never reach a CUDA kernel; the chip smoke refuses to run without a card."""

import ast
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gomavatar_tpu_torch.ops import frame_render as TF

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "gomavatar_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "gomavatar_tpu", "tools", "__graft_entry__")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            yield "__import__"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_forbidden_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN + ("__import__",)))
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_package_imports_without_jax():
    modules = [
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in sorted(PKG.rglob("*.py"))
    ]
    code = (
        "import sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "import chip_smoke\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _tiny_b1_inputs(device):
    """One active tile (of 4 slots) holding one splat centred on pixel
    (7.5, 7.5) and no triangle."""
    entries = torch.zeros((24, 128))
    entries[0:2, 0] = 7.5  # mean
    entries[2, 0] = entries[4, 0] = 0.1  # conic a, c
    entries[5, 0] = 1.0  # opacity
    entries[6:9, 0] = torch.tensor([0.2, 0.4, 0.6])
    ids = torch.zeros((4,), dtype=torch.int32)
    count = torch.tensor([1, 0, 0, 0], dtype=torch.int32)
    args = (entries, ids, ids.clone(), count, torch.tensor(1, dtype=torch.int32))
    return tuple(a.to(device) for a in args)


def test_cpu_call_leaves_launch_count_at_zero():
    rgb, alpha, sel = TF.frame_sweep(*_tiny_b1_inputs("cpu"), num_tiles_x=4)
    assert TF.frame_sweep.launches == 0
    # pixel (7, 7): power = -0.5 * 0.1 * (0.5^2 + 0.5^2), alpha = e^power
    expected = math.exp(-0.025)
    assert float(alpha[0, 0, 7 * 16 + 7]) == pytest.approx(expected, rel=1e-6)
    assert float(rgb[0, 2, 7 * 16 + 7]) == pytest.approx(0.6 * expected, rel=1e-6)
    assert float(sel[0, 4].sum()) == 0.0  # no triangle, no hit
    assert float(alpha[1:].abs().sum()) == 0.0


def test_other_devices_raise():
    with pytest.raises(ValueError):
        TF.frame_sweep(*_tiny_b1_inputs("meta"), num_tiles_x=4)
    assert TF.frame_sweep.launches == 0


def test_chip_smoke_refuses_without_a_card(tmp_path):
    assert not torch.cuda.is_available()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"ok"' not in out.stdout
    # alone in a directory, without the rest of the repository
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    out = subprocess.run([sys.executable, str(lone)], cwd=tmp_path, capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and '"ok"' not in out.stdout
