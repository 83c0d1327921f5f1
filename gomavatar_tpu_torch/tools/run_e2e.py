"""The end-to-end demonstration chain of the port: the full compressed
training schedule, all five evaluation protocols, the noisy-pose refinement
chain and a no-subdivision control, against the synthetic teacher capture;
the counterpart of the JAX package's ``tools/run_e2e.sh``.  Every stage
calls the port's own entry point in this process, in the script's order:

  datagen (``make_e2e_data``; skipped when ``<data>/teacher.npz`` exists,
  which the generator writes last) -> train -> resume to ``--resume_iters``
  -> evaluate view, train, freeview, pose, pose_mdm -> the noisy chain: a
  raw view eval of ``<data>/test_noisy``, ``train_pose`` on it, a view
  eval with the refined poses -> export (``export_trained``) -> the
  control: the same yaml with ``subdivide_iters: []`` and ``exp_name`` +
  ``_nosubdiv``, trained and view-evaluated -> the report
  (``make_e2e_report``, written to ``<save_dir>/E2E.md``).

    python -m gomavatar_tpu_torch.tools.run_e2e [--cfg configs/exps/e2e_synthetic.yaml] \
        [--log_dir LOG] [--data data/e2e] [--art gomavatar_tpu_torch/artifacts/e2e_trained.npz] \
        [--resume_iters 6100] [--freeview_frames 30] [--pose_frames 6] [--control 1] \
        [--datagen_args "..."] [--device cpu]

The flags stand for the script's environment overrides (E2E_CFG, E2E_DATA,
E2E_ART, E2E_RESUME_ITERS, E2E_FREEVIEW_FRAMES, E2E_POSE_FRAMES,
E2E_CONTROL, E2E_DATAGEN_ARGS); the capture's size is the yaml's
``img_size``.  The run's logs go to the yaml's save_dir
(``log_dir/exp_name``, the script's E2E_DIR); ``--log_dir`` replaces the
yaml's ``log_dir`` through a copy of the yaml written there.  The script's
watchdog, which restarted stages whose TPU client hung, has no counterpart:
a stage that fails ends the chain with its error.  Each stage's wall time
and the decode rate of the train split go to ``<save_dir>/e2e_stages.json``.
It runs on the card unless ``--device cpu``; ``main`` returns a summary.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shlex
import sys
import time

import yaml

from gomavatar_tpu_torch.cli import evaluate as eval_cli
from gomavatar_tpu_torch.cli import train as train_cli
from gomavatar_tpu_torch.cli import train_pose as pose_cli
from gomavatar_tpu_torch.config import make_cfg
from gomavatar_tpu_torch.tools import export_trained, make_e2e_data, make_e2e_report

DECODE_ITEMS = 20


class _Tee:
    """A stream that writes to several."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, s):
        for st in self.streams:
            st.write(s)
        return len(s)

    def flush(self):
        for st in self.streams:
            st.flush()


@contextlib.contextmanager
def tee_stdout(path: str):
    """Standard output appended to ``path`` as well, as the script's
    ``>> log`` does."""
    with open(path, "a") as f, contextlib.redirect_stdout(_Tee(sys.stdout, f)):
        yield


def decode_rate(cfg_path: str, n: int = DECODE_ITEMS) -> dict:
    """Items/s of the driver's own decode of the train split
    (``cli.train.train_dataset``: the native library where it loads and the
    yaml asks for it, else cv2), over its first ``n`` items."""
    ds = train_cli.train_dataset(make_cfg(cfg_path))
    n = min(n, len(ds))
    t0 = time.perf_counter()
    for i in range(n):
        ds[i]
    dt = time.perf_counter() - t0
    return {"path": "native" if ds.use_native else "cv2", "items": n, "items_per_s": n / max(dt, 1e-9)}


def with_log_dir(cfg_path: str, log_dir: str) -> str:
    """A copy of the yaml at ``cfg_path`` with its ``log_dir`` replaced,
    written into the run's save_dir; returns its path."""
    with open(cfg_path) as f:
        raw = yaml.safe_load(f)
    raw["log_dir"] = log_dir
    save_dir = os.path.join(log_dir, raw.get("exp_name", make_cfg(None)["exp_name"]))
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, "e2e_cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def control_cfg(cfg_path: str, out_path: str) -> str:
    """The control's yaml: ``cfg_path``'s with subdivision off and
    ``exp_name`` + ``_nosubdiv``."""
    with open(cfg_path) as f:
        raw = yaml.safe_load(f)
    raw["exp_name"] = raw["exp_name"] + "_nosubdiv"
    raw.setdefault("model", {})["subdivide_iters"] = []
    with open(out_path, "w") as f:
        yaml.safe_dump(raw, f)
    return out_path


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="The end-to-end demonstration chain (gomavatar_tpu_torch).")
    ap.add_argument("--cfg", default="configs/exps/e2e_synthetic.yaml")
    ap.add_argument("--log_dir", default=None, help="replaces the yaml's log_dir (default: the yaml's)")
    ap.add_argument("--data", default="data/e2e", help="where the capture is written and test_noisy/ is read")
    ap.add_argument("--art", default=export_trained.ARTIFACT, help="the exported trained avatar")
    ap.add_argument("--resume_iters", type=int, default=6100, help="the resume check trains to this iteration")
    ap.add_argument("--freeview_frames", type=int, default=30)
    ap.add_argument("--pose_frames", type=int, default=6, help="test frames of the pose refinement")
    ap.add_argument("--control", type=int, choices=(0, 1), default=1, help="1: run the no-subdivision control")
    ap.add_argument("--datagen_args", default="", help="more flags of make_e2e_data, as one string")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device = str(train_cli.check_device(args.device))
    cfg_path = with_log_dir(args.cfg, args.log_dir) if args.log_dir else args.cfg
    cfg = make_cfg(cfg_path)
    save_dir = cfg["save_dir"]
    ckpt = os.path.join(save_dir, "checkpoints")
    os.makedirs(save_dir, exist_ok=True)
    gen_argv = ["--out", args.data, "--img", str(cfg["img_size"][0]), *shlex.split(args.datagen_args), "--device", device]
    gen = make_e2e_data.parse_args(gen_argv)
    dev = ["--device", device]
    noisy = os.path.join(args.data, "test_noisy")

    seconds, out = {}, {"save_dir": save_dir}
    stages_path = os.path.join(save_dir, make_e2e_report.STAGES)

    def stage(name, title, fn):
        print(f"=== {title} ===", flush=True)
        t0 = time.perf_counter()
        result = fn()
        seconds[name] = time.perf_counter() - t0
        with open(stages_path, "w") as f:
            json.dump({"seconds": seconds, "decode": out.get("decode")}, f, indent=1)
        return result

    def evaluate(tag, *extra, cfg=cfg_path):
        out.setdefault("evals", {})[tag] = stage(
            f"eval {tag}", f"eval: {tag}", lambda: eval_cli.main(["--cfg", cfg, *extra, *dev]))

    if not os.path.exists(os.path.join(args.data, "teacher.npz")):
        def datagen():
            with tee_stdout(os.path.join(save_dir, "log_datagen.txt")):
                return make_e2e_data.main(gen_argv)

        out["datagen"] = stage("datagen", "datagen (the synthetic teacher capture)", datagen)
    out["decode"] = decode_rate(cfg_path)
    t = cfg["train"]
    m = cfg["model"]
    trainer = stage(
        "train", f"train ({t['total_iters']} iters, subdivision @{m.get('subdivide_iters')}, kick-ins "
        f"{m['pose_refinement'].get('kick_in_iter')}/{m['non_rigid'].get('kick_in_iter')})",
        lambda: train_cli.main(["--cfg", cfg_path, *dev]))
    out["train"] = {"i_iter": trainer.i_iter, "phase": trainer.phase, "num_faces": trainer.gom_cfg.num_faces}
    del trainer
    trainer = stage("resume", "resume check: replay subdivision, restore, train on",
                    lambda: train_cli.main(["--cfg", cfg_path, "--resume", "--max_iters", str(args.resume_iters), *dev]))
    out["resume"] = {"i_iter": trainer.i_iter, "phase": trainer.phase, "num_faces": trainer.gom_cfg.num_faces}
    del trainer

    evaluate("view", "--type", "view")
    evaluate("train", "--type", "train")
    evaluate("freeview", "--type", "freeview", "--n_frames", str(args.freeview_frames))
    evaluate("pose", "--type", "pose")
    evaluate("pose_mdm", "--type", "pose_mdm")
    evaluate("view_noisy_raw", "--type", "view", "--dataset_path", noisy, "--tag", "view_noisy_raw")
    out["pose"] = stage("train_pose", "test-time pose refinement on the perturbed poses", lambda: pose_cli.main(
        ["--cfg", cfg_path, "--max_frames", str(args.pose_frames), "--dataset_path", noisy, *dev]))
    evaluate("view_noisy_refined", "--type", "view", "--dataset_path", noisy, "--pose_path",
             os.path.join(ckpt, "pose.pkl"), "--tag", "view_noisy_refined")
    out["export"] = stage("export", "export the trained avatar", lambda: export_trained.main(
        ["--cfg", cfg_path, "--out", args.art, "--rings", str(gen.rings), "--segs", str(gen.segs), *dev]))

    if args.control:
        ctrl = control_cfg(cfg_path, os.path.join(save_dir, "config_nosubdiv.yaml"))
        trainer = stage("control train", "control: the same schedule with subdivision off",
                        lambda: train_cli.main(["--cfg", ctrl, *dev]))
        out["control"] = {"i_iter": trainer.i_iter, "phase": trainer.phase, "num_faces": trainer.gom_cfg.num_faces}
        del trainer
        out["control"]["eval"] = stage("control eval view", "control: eval view",
                                       lambda: eval_cli.main(["--cfg", ctrl, "--type", "view", *dev]))

    where = make_e2e_report.card_name() if device.startswith("cuda") else "the CPU"
    out["report"] = stage("report", "report", lambda: make_e2e_report.main(
        ["--log_dir", save_dir, "--out", os.path.join(save_dir, "E2E.md"), "--device", where]))
    out["seconds"] = seconds
    print("ALL E2E STAGES DONE", flush=True)
    return out


if __name__ == "__main__":
    main()
