"""BENCHMARK.json and the files it names resolve by name, within the
contract's shapes."""

import json
import re
from pathlib import Path

import pytest

from portbench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves(cell):
    spec = run.resolve(BENCH, cell)
    conf = next(c for c in BENCH["configs"] if c["name"] == spec["cell"]["config"])
    assert conf["file"].startswith("portbench/") and spec["config"]["name"] == conf["name"]
    assert sorted(conf["reduced"]) == sorted(spec["config"]["reduced"])
    assert Path(spec["driver"]).is_file()
    assert (ROOT / spec["config"]["state"]).is_file()
    assert spec["end_to_end"] and spec["per_layer"]
    assert set(spec["readers"]) == {m["name"] for m in spec["per_layer"]}
    for m in spec["per_layer"]:
        assert Path(spec["readers"][m["name"]]) == ROOT / "portbench" / "metrics" / f"{m['name']}.py"
        assert Path(spec["readers"][m["name"]]).is_file()
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
    assert spec["limits"]["limits"]


def test_frozen_inputs_match_their_sources():
    for copy, source in (("portbench/inputs/e2e_trained.npz", "artifacts/e2e_trained.npz"),
                         ("portbench/inputs/lpips_vgg_heads.npz", "gomavatar_tpu_torch/weights/lpips_vgg_heads.npz")):
        assert (ROOT / copy).read_bytes() == (ROOT / source).read_bytes()
