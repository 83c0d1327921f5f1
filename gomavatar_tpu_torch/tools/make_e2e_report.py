"""Write the report of a finished end-to-end run (``run_e2e``); port of the
JAX package's ``tools/make_e2e_report.py``.

Parses ``<log_dir>/{log.txt, log_pose.txt, log_eval_*.txt}`` (and the
no-subdivision control run's logs beside them) into: the schedule events,
binning-drop accounting, the loop's it/s before and after the subdivision,
the loss trajectory, the periodic eval curves, the coarse-to-fine
crossover, the final evaluations over all five protocols, the subdivision
ablation and the noisy-pose raw -> refined recovery; with the wall time of
each stage and the decode rate where ``run_e2e`` left ``e2e_stages.json``.
The header names the device the run took, for a card its name and power
limit as ``nvidia-smi`` reports them.

    python -m gomavatar_tpu_torch.tools.make_e2e_report [--log_dir log/e2e_synthetic] \
        [--out gomavatar_tpu_torch/E2E.md] [--device "NVIDIA H100 80GB HBM3, 700.00 W"]
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import subprocess

import torch

REPORT = os.path.join("gomavatar_tpu_torch", "E2E.md")
STAGES = "e2e_stages.json"


def card_name() -> str:
    """The card's name and power limit from ``nvidia-smi``; where that
    fails, the card's name from torch with its limit unread; "the CPU"
    where there is no card."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True)
    except (OSError, subprocess.CalledProcessError):
        if torch.cuda.is_available():
            return f"{torch.cuda.get_device_name(0)}, power limit not read"
        return "the CPU"
    return out.stdout.strip().splitlines()[0]


def parse_train_log(path):
    """(iters, events) of a train log: iters (iter, it/s, total, {term:
    value}) per logged step; events (kind, iter, info) for a subdivision,
    a resume and each periodic eval."""
    iters = []
    events = []
    with open(path) as f:
        for line in f:
            m = re.search(r"iter (\d+) \(([\d.]+) it/s\) - loss: ([\d.]+) \((.*)\)", line)
            if m:
                terms = {}
                for kv in m.group(4).split(", "):
                    k, _, v = kv.partition(": ")
                    terms[k] = float(v)
                iters.append((int(m.group(1)), float(m.group(2)), float(m.group(3)), terms))
            m = re.search(r"subdividing at iter (\d+): (\d+) -> (\d+) faces", line)
            if m:
                events.append(("subdivide", int(m.group(1)), f"{m.group(2)} -> {m.group(3)} faces"))
            m = re.search(r"resumed from (\S+) \(iter (\d+), phase (\d+)\)", line)
            if m:
                events.append(("resume", int(m.group(2)), f"phase {m.group(3)}"))
            m = re.search(r"evaluate on (\S+): (\{.*\})", line)
            if m:
                events.append(("eval:" + m.group(1), iters[-1][0] if iters else 0, ast.literal_eval(m.group(2))))
    return iters, events


# the first line of one driver invocation in an appended eval log: JAX's
# platform banner, or the checkpoint line both packages' evaluate logs
# before any line parsed here
RUN_START = re.compile(r"Platform '\w+'|loaded iter \d+")


def parse_eval_log(path):
    """All driver invocations appended to one eval log -> the list of their
    non-empty run dicts (metrics / drops / refined-poses marker).  Empty
    runs are dropped before the caller enumerates, so run indices stay
    contiguous."""
    runs, cur = [], None
    with open(path) as f:
        for line in f:
            if RUN_START.search(line):
                if cur:
                    runs.append(cur)
                cur = {}
                continue
            if cur is None:
                cur = {}
            m = re.search(r"metrics: (\{.*\})", line)
            if m:
                cur["metrics"] = ast.literal_eval(m.group(1))
            m = re.search(r"render budget overflow on \d+ frames \((\d+) entries total\)", line)
            if m:
                cur["drops"] = int(m.group(1))
            if "zero dropped entries" in line:
                cur["drops"] = 0
            if "using refined poses" in line:
                cur["refined"] = True
    if cur:
        runs.append(cur)
    return [r for r in runs if r]


def parse_pose_log(path):
    """{stage: metrics} of a pose-refinement log, the last occurrence of
    each stage."""
    by_stage = {}
    with open(path) as f:
        for line in f:
            m = re.search(r"eval \[(\S+)\]: (\{.*\})", line)
            if m:
                by_stage[m.group(1)] = ast.literal_eval(m.group(2))
    return by_stage


def final_evals(log_dir):
    """[(tag, metrics with dropped_entries)] of the final eval logs, in the
    chain's order."""
    rows = []
    for tag_name in ("view", "train", "freeview", "pose", "pose_mdm", "view_noisy_raw", "view_noisy_refined"):
        path = os.path.join(log_dir, f"log_eval_{tag_name}.txt")
        if not os.path.exists(path):
            continue
        # within a run the budget summary precedes the optional metrics
        # line (freeview and pose_mdm have no ground truth, hence no metrics)
        for j, r in enumerate(parse_eval_log(path)):
            tag = tag_name if j == 0 else (f"{tag_name}+refined_poses" if r.get("refined") else f"{tag_name}#{j}")
            d = dict(r.get("metrics", {}))
            d["dropped_entries"] = r.get("drops", "?")
            rows.append((tag, d))
    return rows


def median(xs):
    return sorted(xs)[len(xs) // 2]


def fmt_float(v):
    return f"{v:.4f}" if isinstance(v, float) else str(v)


def metric_table(rows, keys, head="iter"):
    out = [f"| {head} | " + " | ".join(keys) + " |", "|" + "---|" * (len(keys) + 1)]
    for it, d in rows:
        out.append("| " + str(it) + " | " + " | ".join(fmt_float(d.get(k, "-")) for k in keys) + " |")
    return "\n".join(out)


def drops_of(terms) -> float:
    return terms.get("bin_drop_budget", 0) + terms.get("bin_drop_buffer", 0) + terms.get("bin_drop_ncmax", 0)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Write the report of an end-to-end run.")
    ap.add_argument("--log_dir", default="log/e2e_synthetic")
    ap.add_argument("--out", default=REPORT)
    ap.add_argument("--device", default=None,
                    help="the device the run took, as the report names it (default: the card's name and power "
                    "limit from nvidia-smi)")
    args = ap.parse_args(argv)
    L = args.log_dir
    device = args.device or card_name()

    iters, events = parse_train_log(os.path.join(L, "log.txt"))
    if not iters:
        raise SystemExit(f"no training iterations found in {L}/log.txt")
    subdiv_iters = [it for kind, it, _ in events if kind == "subdivide" and it > 0]

    # loss trajectory at a readable cadence
    milestones = sorted({it for it, *_ in iters} & set(range(0, 10**7, 500)) | {iters[0][0], iters[-1][0]})
    by_iter = {it: (rate, tot, terms) for it, rate, tot, terms in iters}
    traj = []
    for it in milestones:
        rate, tot, terms = by_iter[it]
        traj.append((it, {"it/s": rate, "total": tot, "rgb": terms.get("rgb"), "mask": terms.get("mask"),
                          "lpips": terms.get("lpips"), "drops": drops_of(terms)}))

    evals = {"test_on_train": [], "test": []}
    for kind, it, payload in events:
        if kind.startswith("eval:"):
            evals.setdefault(kind.split(":", 1)[1], []).append((it, payload))

    drops_total = sum(drops_of(t) for *_, t in iters)
    rates = [r for _, r, _, _ in iters[2:]]
    stages_path = os.path.join(L, STAGES)
    stages = json.load(open(stages_path)) if os.path.exists(stages_path) else None

    lines = []
    w = lines.append
    w(f"# E2E of gomavatar_tpu_torch: the full compressed training schedule on {device}")
    w("")
    w("The complete ZJU recipe (subdivision, pose-refinement kick-in,")
    w("non-rigid Hann anneal, LPIPS loss, exponential lr decay) compressed")
    w("50x at the reference's milestone ratios, run end to end from init")
    w("through the port's own drivers (`gomavatar_tpu_torch.cli.*`) on")
    w(f"{device}, against the synthetic teacher capture")
    w("(`gomavatar_tpu_torch.tools.make_e2e_data`; the ground truth is")
    w("realizable by the model class, so converged PSNR measures the")
    w("training pipeline itself).")
    w("Reproduce with `python -m gomavatar_tpu_torch.tools.run_e2e`.")
    w("")
    w("## Schedule events")
    w("")
    for kind, it, info in events:
        if not kind.startswith("eval:"):
            # the resume replays the subdivision at its own iter 0 before
            # restoring; label it so that it does not read like a schedule event
            tag = " (resume-check replay)" if kind == "subdivide" and it == 0 else ""
            w(f"* iter {it}: **{kind}** ({info}){tag}")
    w(f"* binning drops across all logged train steps: **{int(drops_total)}**")
    if rates:
        w(f"* steady-state loop throughput (host+device, checkpoint and eval steps included): median "
          f"**{median(rates):.2f} it/s**, last-100 median **{median(rates[-100:]):.2f} it/s**")
    if subdiv_iters:
        pre = [r for it, r, _, _ in iters[2:] if it < subdiv_iters[0]]
        post = [r for it, r, _, _ in iters[2:] if it > subdiv_iters[0]]
        if pre and post:
            w(f"* loop median before the subdivision **{median(pre):.2f} it/s**, after it "
              f"**{median(post):.2f} it/s**")
    if stages:
        w("")
        w("## Wall time of each stage")
        w("")
        w("| stage | seconds |")
        w("|---|---|")
        for name, s in stages["seconds"].items():
            w(f"| {name} | {s:.1f} |")
        if stages.get("decode"):
            d = stages["decode"]
            w("")
            w(f"*Decode of the train split (`cli.train.train_dataset`, {d['path']}): "
              f"{d['items_per_s']:.1f} items/s over {d['items']} items.*")
    w("")
    w("## Loss / throughput trajectory (every 500 iters)")
    w("")
    w(metric_table(traj, ["it/s", "total", "rgb", "mask", "lpips", "drops"]))
    for split, rows in evals.items():
        if not rows:
            continue
        w("")
        w(f"## Periodic eval: {split}")
        w("")
        w(metric_table(rows, sorted({k for _, d in rows for k in d})))

    # ---- coarse-to-fine crossover
    crossover = None
    test_rows = evals.get("test", [])
    if test_rows and subdiv_iters:
        sub_at = subdiv_iters[0]
        pre = [(it, d["psnr"]) for it, d in test_rows if it <= sub_at and "psnr" in d]
        post = [(it, d["psnr"]) for it, d in test_rows if it > sub_at and "psnr" in d]
        if pre and post:
            pre_peak = max(pre, key=lambda x: x[1])
            post_peak = max(post, key=lambda x: x[1])
            gain = post_peak[1] - pre_peak[1]
            crossover = {"pre_peak": pre_peak[1], "post_best": post_peak[1], "gain": gain}
            w("")
            w("## Coarse-to-fine crossover (held-out PSNR)")
            w("")
            w(f"* pre-subdivision peak: **{pre_peak[1]:.2f} dB** @ iter {pre_peak[0]}")
            w(f"* post-subdivision best: **{post_peak[1]:.2f} dB** @ iter {post_peak[0]}"
              f" (final: {post[-1][1]:.2f} @ {post[-1][0]})")
            verdict = "EXCEEDS" if gain > 0 else "DOES NOT EXCEED"
            w(f"* the post-subdivision phase **{verdict}** the pre-subdivision peak ({gain:+.2f} dB)")

    # ---- final evaluations (log_eval_{tag}.txt)
    final_rows = final_evals(L)
    if final_rows:
        w("")
        w("## Final eval (cli/evaluate.py, from the trained checkpoint, all five `--type` protocols)")
        w("")
        w(metric_table(final_rows, sorted({k for _, d in final_rows for k in d}), head="type"))

    # ---- subdivision ablation: the control run with subdivision off
    control = None
    ctrl_view = os.path.join(L + "_nosubdiv", "log_eval_view.txt")
    if os.path.exists(ctrl_view):
        control = next((r["metrics"] for r in parse_eval_log(ctrl_view) if "metrics" in r), None)
        main_view = dict(final_rows).get("view", {})
        if control and "psnr" in main_view:
            w("")
            w("## Subdivision ablation (control run: identical schedule, subdivision OFF)")
            w("")
            w(metric_table([("with subdivision", main_view), ("no subdivision (control)", control)],
                           sorted({k for k in list(control) + list(main_view) if k != "dropped_entries"}),
                           head="run"))
            w("")
            w(f"*Subdivision is worth **{main_view['psnr'] - control['psnr']:+.2f} dB** held-out PSNR on this "
              "capture.*")

    # ---- test-time pose refinement (log_pose.txt)
    pose = {}
    pose_path = os.path.join(L, "log_pose.txt")
    if os.path.exists(pose_path):
        pose = parse_pose_log(pose_path)
        if pose:
            w("")
            w("## Test-time pose refinement on the perturbed test split (cli/train_pose.py)")
            w("")
            w("The test split's recorded poses carry synthetic capture error")
            w("(`make_e2e_data --pose_noise`: sigma 0.03 rad/joint + 0.02 m")
            w("root + 0.01 rad global); `raw` renders with those inaccurate")
            w("poses, `refined` after per-frame optimization.")
            w("")
            w(metric_table(list(pose.items()), sorted({k for d in pose.values() for k in d}), head="stage"))
            if "raw" in pose and "refined" in pose:
                rec = pose["refined"].get("psnr", 0) - pose["raw"].get("psnr", 0)
                w("")
                w(f"*Refinement recovers **{rec:+.2f} dB** over the raw perturbed poses.*")
    w("")
    text = "\n".join(lines)
    print(text)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write(text + "\n")
    print(f"\n(wrote {args.out})")
    return {"iters": len(iters), "events": [e for e in events if not e[0].startswith("eval:")],
            "drops": drops_total, "final": dict(final_rows), "crossover": crossover, "control": control,
            "pose": pose, "path": args.out}


if __name__ == "__main__":
    main()
