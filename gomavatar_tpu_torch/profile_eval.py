"""Where the time of the port's eval forward goes, on the card.

Runs the trained avatar's 512^2 frame through ``gom_forward(train=False)``,
eagerly and as the eval program (``models.gom.eval_program``: one captured
CUDA graph, replayed), and reports, after a warm-up:
  * the whole forward, each way, host clock around a synchronised call
    (median, p90);
  * each stage of the forward on its own, host clock around a synchronised
    call (median): posed vertices (pose MLP, non-rigid MLP, FK + LBS), the
    geometry table, the per-face shadow MLP, sorted binning, the entry
    gather, kernel B1, untile + shading;
  * for each way, torch.profiler's device time by kernel over a steady
    window of forwards, the kernels per frame, and the device's busy share:
    kernel time over the unprofiled forward's time (the profiler's own host
    cost slows the profiled window).
The first line names the card and its power limit.

    python -m gomavatar_tpu_torch.profile_eval [--iters 20] [--json profile_eval.json]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from gomavatar_tpu_torch.convert import load_trained
from gomavatar_tpu_torch.models import gom as G
from gomavatar_tpu_torch.models import modules as M
from gomavatar_tpu_torch.ops import frame_render as FR
from gomavatar_tpu_torch.ops.geometry import frame_geometry
from gomavatar_tpu_torch.ops.splat.binning import bin_sorted
from gomavatar_tpu_torch.utils import profiling


def _host_times(fn, iters: int):
    """Host ms of ``iters`` synchronised calls, and the last result."""
    times, out = [], None
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times, out


def _host_ms(fn, iters: int):
    """Median host time of a synchronised call, and the last result."""
    times, out = _host_times(fn, iters)
    return statistics.median(times), out


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def measure(fn, iters: int, warmup: int = 3, window: int | None = None) -> dict:
    """``fn`` (one frame or step) after ``warmup`` calls: the median and p90
    of ``iters`` synchronised calls on the host clock, then torch.profiler
    over a window of ``window`` calls (``iters`` if None): the device ms and
    kernels per call by kernel, and the busy share, the device ms over the
    unprofiled median."""
    from torch.profiler import ProfilerActivity, profile

    window = window or iters
    for _ in range(warmup):
        fn()
    times, _ = _host_times(fn, iters)
    median, p90 = statistics.median(times), statistics.quantiles(times, n=10)[-1]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(window):
            fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA or evt.key.startswith(profiling.PREFIX):
            continue  # host-side ops and the program's spans also carry their kernels' device time
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        kernels.append({"name": evt.key, "ms": dev_us / 1e3 / window, "count": evt.count / window})
    kernels.sort(key=lambda k: -k["ms"])
    device_ms = sum(k["ms"] for k in kernels)
    return {"median_ms": median, "p90_ms": p90, "device_ms": device_ms,
            "kernels_per_call": sum(k["count"] for k in kernels), "busy_share": device_ms / median,
            "window_ms_per_call": window_ms / window, "kernels": kernels}


def report(label: str, m: dict, unit: str, top: int) -> None:
    print(f"{label}: median {m['median_ms']:.3f} ms/{unit}, p90 {m['p90_ms']:.3f}; device kernels "
          f"{m['device_ms']:.3f} ms/{unit} over {m['kernels_per_call']:.0f} kernels/{unit}, busy "
          f"{100 * m['busy_share']:.1f} % of the unprofiled median (profiled window "
          f"{m['window_ms_per_call']:.3f} ms/{unit} wall)")
    for k in m["kernels"][:top]:
        print(f"  {k['ms']:8.4f} ms  x{k['count']:<6.1f} {k['name'][:90]}")


def stage_times(params, statics, cfg, frame, iters: int) -> dict:
    """The stages of render_frame_eval, composed here one by one."""
    f = frame
    res = {}
    res["posed_vertices"], verts = _host_ms(lambda: G.posed_vertices(
        params, statics, cfg, f["cnl_gtfms"], f["dst_Rs"], f["dst_Ts"], f["dst_posevec"]), iters)
    colors = M.appearance_apply(params["appearance"])
    res["frame_geometry"], geom = _host_ms(lambda: frame_geometry(
        verts, statics.faces, params["so3"], params["scale"], colors, statics.vf_incidence,
        statics.vf_valid, f["K"], f["E"], cfg.img_size, cfg.sigma, 0.0), iters)
    sh_cfg = cfg.module_cfg("shadow")
    res["shadow_mlp"], face_sh = _host_ms(
        lambda: M.shadow_apply(params["shadow"], sh_cfg, geom.table[:, 19:22])[:, 0] * 2.0, iters)
    table = geom.table.clone()
    table[:, 22] = face_sh
    shading0 = M.shadow_apply(params["shadow"], sh_cfg, torch.zeros((1, 3), device=table.device))[0, 0] * 2.0
    ub = geom.union_box
    res["bin_sorted"], bins = _host_ms(lambda: bin_sorted(
        ub[0], ub[1], ub[2], ub[3], geom.depth, geom.valid, cfg.img_size,
        max_tiles_per_primitive=cfg.max_tiles_per_gaussian, buffer_factor=cfg.buffer_factor,
        active_cap=cfg.active_tile_cap,
        flag_boxes=((geom.sx0, geom.sx1, geom.sy0, geom.sy1, geom.valid_splat),
                    (geom.mx0, geom.mx1, geom.my0, geom.my1, geom.valid_mesh)),
        band0=cfg.binning_band0, overflow_cap=max(statics.faces.shape[0] // 8, 2048)), iters)
    res["gather_entries"], entries = _host_ms(lambda: FR.gather_entries(table, bins), iters)
    res["b1_frame_sweep"], outs = _host_ms(lambda: FR.frame_sweep(
        entries, bins.active_id, bins.seg_start, bins.seg_count, bins.n_active, bins.num_tiles_x), iters)

    def tail():
        rgb = FR.untile(outs[0], bins, cfg.img_size)
        sel = FR.untile(outs[2], bins, cfg.img_size)
        shading = torch.where(sel[..., 4] > 0, sel[..., 3], shading0)
        return rgb * shading[..., None], FR.untile(outs[1], bins, cfg.img_size)[..., 0]

    res["untile_shading"], _ = _host_ms(tail, iters)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--json", default=None, help="also write the numbers to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_eval measures the card; no CUDA device is present")
    card = card_name()
    params, statics, cfg, frame = load_trained(device="cuda")
    f = frame
    frame_args = (f["K"], f["E"], f["cnl_gtfms"], f["dst_Rs"], f["dst_Ts"], f["dst_posevec"], 1e7, None, None)
    render = G.eval_program()
    ways = {
        "eager": lambda: G.eval_forward(params, statics, cfg, *frame_args),
        "captured": lambda: render(params, statics, cfg, *frame_args),
    }
    measured = {k: measure(fn, args.iters) for k, fn in ways.items()}
    stages = stage_times(params, statics, cfg, frame, args.iters)

    print(f"card: {card}")
    for k, m in measured.items():
        report(f"forward, {k}", m, "frame", 25 if k == "eager" else 12)
    for name, ms in stages.items():
        print(f"  stage {name:16s} {ms:8.3f} ms")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"card": card, **measured, "stages_ms": stages}, fh, indent=1)


if __name__ == "__main__":
    main()
