"""Run one cell of the benchmark once, from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic mix are found by name from
``BENCHMARK.json``: the configuration at its ``file``, the mix at
``portbench/traffic/<traffic>.json`` (whose ``driver`` names
``portbench/drivers/<driver>.py``), each per-layer metric's reader at
``portbench/metrics/<metric>.py`` and the cell's limits at
``portbench/limits/<cell>.json``.  The program under test is
``gomavatar_tpu_torch``; the run needs as many CUDA devices as the cell
asks for.  The last line of standard output is the result (JSON); the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key.
"""

from __future__ import annotations

import os
import sys
import time


def process_start() -> float:
    """The wall-clock time at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


T_START = process_start()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# the program's and torch's caches inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "portbench_cache", sub)

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import tempfile  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gomavatar_tpu")


def forbidden_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is one that the
    benchmark may not load, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: str) -> dict:
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


def resolve(bench: dict, workload: str) -> dict:
    """The cell's entry, configuration, mix, driver path, limits, the
    per-layer metrics it reports and their readers' paths, by name from
    ``bench``."""
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    mix = read_json(f"portbench/traffic/{cell['traffic']}.json")
    reports = {m["name"] for m in bench["end_to_end"] if workload in m.get("workloads", [workload])}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in reports)]
    return {"cell": cell, "config": read_json(conf["file"]), "mix": mix,
            "driver": os.path.join(ROOT, "portbench", "drivers", mix["driver"] + ".py"),
            "limits": read_json(f"portbench/limits/{workload}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if m["name"] in reports and m["name"] != "setup_s"],
            "per_layer": per_layer,
            "readers": {m["name"]: os.path.join(ROOT, "portbench", "metrics", m["name"] + ".py") for m in per_layer}}


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device, out_dir: str) -> dict:
    """One run of a resolved cell on ``device``: the result's keys, and
    ``compared``, the numbers beside their limits."""
    import torch

    from portbench.lib import harness as H
    from portbench.lib import trace as tr

    driver_mod = load_file(spec["driver"], "portbench_driver_" + spec["mix"]["driver"])
    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        cell = H.Cell(spec["cell"]["name"], spec["config"], spec["mix"], seed, device, tmp)
        limits = spec["limits"]["limits"]
        drv = driver_mod.Driver(cell)
        drv.setup()
        prof_cfg = spec["mix"]["trace"]
        stretch = None  # the profiler and its window range while a profiled stretch runs
        units, t0 = 0, time.perf_counter()
        # the program's set-up: the benchmark's own making of its inputs
        # (the reference's renders of the train frames) is not counted
        setup_s = time.time() - T_START - cell.spans.total(H.INPUTS)[0]
        t_prof = [None, None]
        units_before = units_prof = 0
        # a profiled stretch that has begun runs to its end
        while time.perf_counter() - t0 < seconds or stretch is not None:
            if trace and t_prof[0] is None and time.perf_counter() - t0 >= prof_cfg["start"] * seconds:
                units_before, t_prof[0] = units, time.perf_counter()
                stretch = contextlib.ExitStack()
                stretch.enter_context(tr.profile(out_dir))
                stretch.enter_context(torch.profiler.record_function(tr.PREFIX + "window"))
                cell.spans.profiling = True
            drv.run_unit()
            units += 1
            if stretch is not None:
                units_prof += 1
                if units_prof == prof_cfg["units"]:
                    drv.drain()
                    cell.spans.profiling = False
                    t_prof[1] = time.perf_counter()
                    stretch.close()
                    stretch = None
        drv.drain()
        window_s = time.perf_counter() - t0
        attempted, failed = drv.counts()
        dev = H.device_info(device)
        e2e = drv.e2e(window_s, units)
        drv.release()
        numbers = drv.check()
        correct = H.judge(numbers, limits)
        out = {"correct": correct, "attempted": attempted, "failed": failed, "device": dev}
        if not trace:
            metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in spec["end_to_end"]}
            metrics["setup_s"] = {"value": setup_s, "unit": "s"}
        else:
            dig = tr.digest(os.path.join(out_dir, "trace.json")) if t_prof[1] is not None else None
            run = {"spans": cell.spans, "t0": t0, "t_prof": t_prof, "units_before": units_before,
                   "units_prof": units_prof, "digest": dig, "work": drv.work()}
            metrics = {}
            for m in spec["per_layer"]:
                reader = load_file(spec["readers"][m["name"]], "portbench_metric_" + m["name"].replace(".", "_"))
                value = reader.read(run)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            if dig is not None:
                out["device"].update(busy_s=dig["busy_s"], window_s=dig["window_s"])
                out["breakdown"] = {"device_ops": dig["top_ops"], "idle_gaps": dig["idle_gaps"]}
        out["metrics"] = metrics
        out["compared"] = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
        return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = read_json("BENCHMARK.json")
    spec = resolve(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["cell"]["chips"]:
        print(f"{args.workload} needs {spec['cell']['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found", file=sys.stderr)
        return 2
    from gomavatar_tpu_torch import cuda_build

    cuda_build.build_all()
    out_dir = os.path.join(tempfile.gettempdir(), f"portbench-trace-{os.getpid()}")
    out = run_cell(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), out_dir)
    if args.trace:
        import shutil

        shutil.rmtree(out_dir, ignore_errors=True)
    return report(out)


def report(out: dict) -> int:
    """Print the result, its numbers compared last on standard error, and
    return 0; or, where this process has loaded JAX or the JAX package by
    now (the program, the check or a metric's reader), name them on
    standard error, print no result and return 1."""
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}; no result", file=sys.stderr)
        return 1
    for name, c in out["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
