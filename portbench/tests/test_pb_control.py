"""The control on the card: the plain reference computed in TF32 (the step
below the float32 the configuration states) put in the program's place
fails each cell's limits, at the cell's own size."""

import json
from pathlib import Path

import pytest

from portbench import run
from portbench.lib import harness as H
from portbench.tools.readings import control_numbers

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_control_fails(cell, card):
    spec = run.resolve(BENCH, cell)
    numbers = control_numbers(spec, 2**31 + 7, card, 2.0)
    assert not H.judge(numbers, spec["limits"]["limits"]), numbers
