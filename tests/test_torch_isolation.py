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
from gomavatar_tpu_torch.ops import mesh_raster_pallas as MK
from gomavatar_tpu_torch.ops.splat import pallas_kernel as SK
from torch_threads import one_torch_thread  # noqa: F401

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


def test_version_is_the_jax_packages():
    """The port's ``__version__`` is the JAX package's, read from that
    package's source, so this file loads nothing of it."""
    import gomavatar_tpu_torch

    tree = ast.parse((ROOT / "gomavatar_tpu" / "__init__.py").read_text())
    versions = [node.value.value for node in tree.body if isinstance(node, ast.Assign)
                and any(getattr(t, "id", None) == "__version__" for t in node.targets)]
    assert versions == [gomavatar_tpu_torch.__version__] == ["0.1.0"]


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
    assert TF.frame_partials.launches == TF.frame_merge.launches == 0
    # pixel (7, 7): power = -0.5 * 0.1 * (0.5^2 + 0.5^2), alpha = e^power
    expected = math.exp(-0.025)
    assert float(alpha[0, 0, 7 * 16 + 7]) == pytest.approx(expected, rel=1e-6)
    assert float(rgb[0, 2, 7 * 16 + 7]) == pytest.approx(0.6 * expected, rel=1e-6)
    assert float(sel[0, 4].sum()) == 0.0  # no triangle, no hit
    assert float(alpha[1:].abs().sum()) == 0.0


def test_other_devices_raise():
    with pytest.raises(ValueError):
        TF.frame_sweep(*_tiny_b1_inputs("meta"), num_tiles_x=4)
    assert TF.frame_partials.launches == TF.frame_merge.launches == 0


def _train_launches():
    return (SK.splat_fwd_partials.launches, SK.splat_fwd_merge.launches, SK.splat_bwd_partials.launches,
            SK.splat_bwd_grads.launches, MK.mesh_fwd_partials.launches, MK.mesh_fwd_merge.launches, MK.mesh_bwd.launches)


def _tiny_train_inputs(device):
    """One tile (of 4) holding one entry: a splat centred on pixel
    (7.5, 7.5) in the splat rows, a triangle over the tile's top-left
    corner in the mesh rows."""
    splat = torch.zeros((16, 128))
    splat[0:2, 0] = 7.5
    splat[2, 0] = splat[4, 0] = 0.1
    splat[5, 0] = 1.0
    splat[6:9, 0] = torch.tensor([0.2, 0.4, 0.6])
    mesh = torch.zeros((16, 128))
    mesh[0:6, 0] = torch.tensor([0.0, 0.0, 12.0, 0.0, 0.0, 12.0])
    mesh[6:9, 0] = 2.0
    mesh[9:12, 0] = torch.tensor([0.0, 0.0, 3.0])
    mesh[12, 0] = 1.0
    valid = torch.zeros((128,))
    valid[0] = 1.0
    start = torch.zeros((4,), dtype=torch.int32)
    count = torch.tensor([128, 0, 0, 0], dtype=torch.int32)
    return tuple(a.to(device) for a in (splat, mesh, valid, start, count))


def test_cpu_train_kernels_leave_launch_counts_at_zero():
    splat, mesh, valid, start, count = _tiny_train_inputs("cpu")
    splat.requires_grad_(True)
    mesh.requires_grad_(True)
    img, alpha = SK.composite_tiles(splat, valid, start, count, 3, 2, 2)
    normal, hit, soft = MK.mesh_composite(mesh, valid, start, count, 2, 2, True, 6.5)
    (img.sum() + alpha.sum() + normal.sum() + soft.sum()).backward()
    assert _train_launches() == (0,) * 7
    img, alpha, normal, hit, soft = (t.detach() for t in (img, alpha, normal, hit, soft))
    expected = math.exp(-0.025)  # pixel (7, 7), as for B1
    assert float(alpha[7, 7]) == pytest.approx(expected, rel=1e-6)
    assert float(img[7, 7, 2]) == pytest.approx(0.6 * expected, rel=1e-6)
    assert float(hit[1, 1]) == 1.0 and float(normal[1, 1, 2]) == 3.0 and float(hit[12, 12]) == 0.0
    assert float(alpha[16:].abs().sum()) == 0.0 and float(soft[16:].abs().sum()) == 0.0
    assert float(splat.grad[5, 0]) > 0 and float(mesh.grad[0:6, 0].abs().sum()) > 0


def test_other_devices_raise_for_the_train_kernels():
    splat, mesh, valid, start, count = _tiny_train_inputs("meta")
    with pytest.raises(ValueError):
        SK.composite_tiles(splat, valid, start, count, 3, 2, 2)
    with pytest.raises(ValueError):
        MK.mesh_composite(mesh, valid, start, count, 2, 2, True, 6.5)
    assert _train_launches() == (0,) * 7


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
