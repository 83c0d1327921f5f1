"""Where the time of the port's eval forward goes, on the card.

Runs the trained avatar's 512^2 frame through ``gom_forward(train=False)``
and reports, after a warm-up:
  * the whole forward, host clock around a synchronised call (median);
  * each stage of the forward on its own, host clock around a synchronised
    call (median): posed vertices (pose MLP, non-rigid MLP, FK + LBS), the
    geometry table, the per-face shadow MLP, sorted binning, the entry
    gather, kernel B1, untile + shading;
  * torch.profiler's device time by kernel over a steady window of forwards,
    and the device's busy share: kernel time over the unprofiled forward's
    time (the profiler's own host cost slows the profiled window).
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


def _host_ms(fn, iters: int):
    """Median host time of a synchronised call, and the last result."""
    times, out = [], None
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


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
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    params, statics, cfg, frame = load_trained(device="cuda")

    def forward():
        return G.gom_forward(params, statics, cfg, frame["K"], frame["E"], frame["cnl_gtfms"],
                             frame["dst_Rs"], frame["dst_Ts"], dst_posevec=frame["dst_posevec"])

    for _ in range(5):
        forward()
    fwd_ms, _ = _host_ms(forward, args.iters)
    stages = stage_times(params, statics, cfg, frame, args.iters)

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            forward()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue  # host-side ops also carry their kernels' device time
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        kernels.append((evt.key, dev_us / 1e3 / args.iters, evt.count // args.iters))
    kernels.sort(key=lambda k: -k[1])
    device_ms = sum(k[1] for k in kernels)

    print(f"card: {card}")
    print(f"forward: median {fwd_ms:.3f} ms/frame ({1e3 / fwd_ms:.2f} frames/s)")
    for name, ms in stages.items():
        print(f"  stage {name:16s} {ms:8.3f} ms")
    print(f"device kernels: {device_ms:.3f} ms/frame over {sum(k[2] for k in kernels)} launches/frame, "
          f"{100 * device_ms / fwd_ms:.1f} % of the unprofiled forward (profiled window "
          f"{window_ms / args.iters:.3f} ms/frame wall)")
    for name, ms, n in kernels[:25]:
        print(f"  {ms:8.4f} ms  x{n:<4d} {name[:90]}")
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"card": card, "forward_ms": fwd_ms, "stages_ms": stages,
                       "window_ms_per_frame": window_ms / args.iters, "device_ms_per_frame": device_ms,
                       "kernels": [{"name": n, "ms": ms, "count": c} for n, ms, c in kernels]}, fh, indent=1)


if __name__ == "__main__":
    main()
