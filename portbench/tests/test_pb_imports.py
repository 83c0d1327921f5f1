"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module name, and the reference loads nothing of the
program."""

import subprocess
import sys
from pathlib import Path

from portbench import run

ROOT = Path(__file__).resolve().parents[2]


def test_forbidden_by_whole_name(monkeypatch):
    base = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "gomavatar_tpu_torch_probe", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_probe", sys)
    assert set(run.forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "gomavatar_tpu.probe", sys)
    assert "gomavatar_tpu" in run.forbidden_modules()


def loaded(code: str) -> set:
    code += "\nimport sys; print(sorted({m.split('.')[0] for m in sys.modules}))"
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True).stdout
    return set(eval(out.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_the_program():
    mods = loaded("from portbench.reference import data, mesh, model, step")
    assert not mods & {"gomavatar_tpu_torch", "gomavatar_tpu", "jax", "jaxlib", "flax"}


def test_harness_loads_no_jax():
    code = ("import runpy, sys; sys.argv = ['run.py', '--help']\n"
            "try:\n    runpy.run_path('portbench/run.py', run_name='__main__')\nexcept SystemExit:\n    pass\n"
            "from portbench.lib import harness, scene, trace, work, readers\n"
            "from gomavatar_tpu_torch.trainer import Trainer\n"
            "from gomavatar_tpu_torch.cli.train import train_dataset")
    assert not loaded(code) & {"gomavatar_tpu", "jax", "jaxlib", "flax"}
