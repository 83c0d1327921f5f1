"""The readings a cell's limits are set from, on the card, in one process:
the numbers compared of whole runs of the program on each ``--seeds``
seed, and of the control (the plain reference in TF32 put in the
program's place) on each ``--control_seeds`` seed.  One JSON line per
reading.

    python3 portbench/tools/readings.py --workload zju377.train --seconds 1 \\
        --seeds 1,2,3 --control_seeds 4,5,6
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from portbench import run  # noqa: E402


def control_numbers(spec: dict, seed: int, device, seconds: float) -> dict:
    """The control's numbers on ``seed``: set-up and a window of ``seconds``
    of the cell (so that it compares as much as a run of that length), then
    the reference in TF32 judged as the program would be."""
    from portbench.lib import harness as H

    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        cell = H.Cell(spec["cell"]["name"], spec["config"], spec["mix"], seed, device, tmp)
        drv = run.load_file(spec["driver"], "portbench_driver_" + spec["mix"]["driver"]).Driver(cell)
        drv.setup()
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            drv.run_unit()
        drv.drain()
        drv.release()
        return drv.check(control=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control_seeds", default="")
    args = ap.parse_args(argv)
    import torch

    from gomavatar_tpu_torch import cuda_build

    cuda_build.build_all()
    device = torch.device("cuda", 0)
    spec = run.resolve(run.read_json("BENCHMARK.json"), args.workload)
    for kind, seeds in (("program", args.seeds), ("control", args.control_seeds)):
        for seed in [int(s) for s in seeds.split(",") if s]:
            t = time.time()
            if kind == "program":
                out = run.run_cell(spec, seed, args.seconds, False, device, "")
                numbers = {k: v["value"] for k, v in out["compared"].items()}
                extra = {"correct": out["correct"], "failed": out["failed"], "attempted": out["attempted"],
                         "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
            else:
                numbers, extra = control_numbers(spec, seed, device, args.seconds), {}
            print(json.dumps({"workload": args.workload, "kind": kind, "seed": seed, "numbers": numbers,
                              "seconds": time.time() - t, **extra}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
