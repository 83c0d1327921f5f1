"""gomavatar_tpu_torch's e2e report against gomavatar_tpu's, on the JAX
package's committed logs of its e2e run (``artifacts/e2e_logs/``): the
parsers give JAX's results on every log, and the report rebuilds E2E.md's
tables from them.  The port's own logs are parsed in
``test_torch_e2e_chain.py``."""

import glob
import os
import sys

import pytest

from gomavatar_tpu_torch.tools import make_e2e_report as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
from tools import make_e2e_report as J  # noqa: E402  (the JAX package's report)

LOGS = os.path.join(REPO, "artifacts", "e2e_logs")
EVAL_LOGS = sorted(os.path.relpath(p, LOGS) for p in glob.glob(os.path.join(LOGS, "**", "log_eval_*.txt"),
                                                              recursive=True))


@pytest.mark.parametrize("rel", ["log.txt", "nosubdiv/log.txt"])
def test_parse_train_log_matches_jax(rel):
    path = os.path.join(LOGS, rel)
    got, want = T.parse_train_log(path), J.parse_train_log(path)
    assert got == want
    iters, events = got
    assert iters and any(kind == "eval:test" for kind, *_ in events)


def test_every_eval_log_is_covered():
    assert len(EVAL_LOGS) == 8


@pytest.mark.parametrize("rel", EVAL_LOGS)
def test_parse_eval_log_matches_jax(rel):
    path = os.path.join(LOGS, rel)
    got = T.parse_eval_log(path)
    assert got == J.parse_eval_log(path)
    assert len(got) == 1 and got[0]["drops"] == 0


def _table_lines(text):
    return [line for line in text.splitlines() if line.startswith("|")]


def test_report_rebuilds_jax_tables(tmp_path):
    out = str(tmp_path / "E2E.md")
    summary = T.main(["--log_dir", LOGS, "--out", out, "--device", "the device under test"])
    with open(out) as f:
        text = f.read()
    with open(os.path.join(REPO, "E2E.md")) as f:
        jax_text = f.read()
    lines = _table_lines(text)
    assert len(lines) > 40
    jax_lines = set(_table_lines(jax_text))
    assert [line for line in lines if line not in jax_lines] == []
    assert "on the device under test" in text.splitlines()[0] and "TPU" not in text
    assert summary["drops"] == 0
    assert summary["pose"]["refined"]["psnr"] == 28.4994 and summary["final"]["view"]["psnr"] == 28.7472
    assert round(summary["crossover"]["gain"], 2) == 2.70
    assert [kind for kind, *_ in summary["events"]] == ["subdivide", "subdivide", "resume"]


@pytest.mark.parametrize("card, want", [(True, "NVIDIA H100 80GB HBM3, power limit not read"), (False, "the CPU")],
                         ids=["card", "no card"])
def test_card_name_without_nvidia_smi(monkeypatch, card, want):
    """Where nvidia-smi fails, the report names the card torch sees, and
    the CPU only where there is none."""
    def no_smi(*args, **kwargs):
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(T.subprocess, "run", no_smi)
    monkeypatch.setattr(T.torch.cuda, "is_available", lambda: card)
    monkeypatch.setattr(T.torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    assert T.card_name() == want
