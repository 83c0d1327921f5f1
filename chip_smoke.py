#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``gomavatar_tpu_torch``) on one
NVIDIA H100: the quickest proof that the port builds, drives its main path
through its kernels, and agrees with its plain versions on the card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit; build every CUDA kernel from the
     sources in gomavatar_tpu_torch/csrc (one nvcc per source, in parallel).
  2. kernel B1 against its plain PyTorch version on the card, on the 64^2
     gate scene (untrained, seed 0) and on the trained 512^2 frame, with and
     without the mesh pass; then the whole gate-scene forward on the card
     against the same forward on the CPU.
  3. the main path: the trained 57,600-face avatar rendered at 512^2 by
     ``gom_forward(train=False)`` on three frames (the packed frame and two
     with a perturbed pose vector and camera), with every launch count set
     to 0 just before and read just after; drop counters, overflow and
     finiteness are checked; then the forward and the kernel are timed.
Its last four lines are the forward timings as JSON, the kernels JSON line,
the card line and the result JSON.  Without a CUDA card it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# kernel-vs-plain criteria for rgb and alpha: the JAX package's fused/unfused
# gate (bench.py): > 99.95 % of values within 1e-4, worst under 5e-3 (float
# reassociation near the T < 1e-4 termination can flip one entry on
# isolated pixels).  sel: hit equal on >= 99.9 % of pixels, normal and
# shading within 1e-4 wherever the hits agree.
CLOSE_TOL, CLOSE_FRAC, WORST_MAX = 1e-4, 0.9995, 5e-3
HIT_FRAC, SEL_TOL = 0.999, 1e-4

# Published H100 SXM peaks (H100 SXM data sheet): float32 outside the
# tensor cores and HBM bandwidth, at the full 700 W power limit.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# fp32 operations of B1's inner loop per (pixel, entry) pair, counted from
# csrc/frame_render.cu: the splat term 27 (11 for the power polynomial, the
# exp, 4 for the alpha gates, 4 for the transmittance step, 7 for the rgb
# and alpha accumulation), the mesh term 19 (12 for the two barycentric and
# the depth planes, 2 for w2, 5 compares).  The splat term is counted only
# for pairs a pixel still evaluates (before its transmittance is spent);
# the mesh term for every swept pair.
SPLAT_OPS, MESH_OPS = 27, 19
# exp runs on the special-function units: 16 results per SM per clock at
# compute capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput), 132 SMs, 1.98 GHz boost clock (H100 SXM data sheet).
PEAK_EXP_PER_S = 16 * 132 * 1.98e9

# 100 timed forwards: the p90 has 10 samples beyond it
FORWARD_ITERS, KERNEL_ITERS, PLAIN_ITERS = 100, 50, 5


def require(ok, message: str) -> None:
    """A failed check ends the smoke with an error (asserts vanish under -O)."""
    if not ok:
        raise RuntimeError(message)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of one call over ``iters`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(label: str, a: torch.Tensor, b: torch.Tensor) -> float:
    d = (a.float() - b.float()).abs()
    frac = float((d <= CLOSE_TOL).float().mean())
    worst = float(d.max())
    print(f"  {label}: {frac * 100:.4f} % within {CLOSE_TOL:g}, worst {worst:.3g}")
    require(bool(torch.isfinite(a).all() and torch.isfinite(b).all()), f"{label}: non-finite values")
    require(frac > CLOSE_FRAC and worst < WORST_MAX, f"{label}: outside the criteria")
    return worst


def check_sel(label: str, a: torch.Tensor, b: torch.Tensor) -> None:
    """a, b: (H, W, 5) selections [normal xyz, shading, hit]."""
    same_hit = a[..., 4] == b[..., 4]
    frac = float(same_hit.float().mean())
    both = same_hit & (a[..., 4] > 0)
    d = (a[..., :4] - b[..., :4]).abs().amax(dim=-1)
    worst = float(d[both].max()) if bool(both.any()) else 0.0
    print(f"  {label}: hit equal on {frac * 100:.4f} %, normal+shading worst {worst:.3g} "
          f"over {int(both.sum())} hit pixels")
    require(frac >= HIT_FRAC and worst <= SEL_TOL, f"{label}: outside the criteria")


def compare_b1(label, table, bins, img_size):
    """Kernel B1 vs its plain version on the same entries, with and without
    the mesh pass.  Returns (worst rgb/alpha difference, kernel ms, plain
    ms), both times with the mesh pass on."""
    from gomavatar_tpu_torch.ops.frame_render import (
        frame_sweep, frame_sweep_plain, gather_entries, untile,
    )

    entries = gather_entries(table, bins)
    args = (entries, bins.active_id, bins.seg_start, bins.seg_count, bins.n_active, bins.num_tiles_x)
    worst = 0.0
    for with_mesh in (True, False):
        k = frame_sweep(*args, with_mesh=with_mesh)
        p = frame_sweep_plain(*args, with_mesh=with_mesh)
        torch.cuda.synchronize()
        tag = f"{label} {'mesh on' if with_mesh else 'mesh off'}"
        worst = max(worst, check_close(f"{tag} rgb", untile(k[0], bins, img_size), untile(p[0], bins, img_size)))
        worst = max(worst, check_close(f"{tag} alpha", untile(k[1], bins, img_size), untile(p[1], bins, img_size)))
        if with_mesh:
            check_sel(f"{tag} sel", untile(k[2], bins, img_size), untile(p[2], bins, img_size))
    kernel_ms = cuda_ms(lambda: frame_sweep(*args), KERNEL_ITERS)
    plain_ms = cuda_ms(lambda: frame_sweep_plain(*args), PLAIN_ITERS)
    print(f"  {label}: B1 kernel {kernel_ms:.4f} ms, plain version {plain_ms:.3f} ms")
    return worst, kernel_ms, plain_ms


def frame_inputs(params, statics, cfg, frame):
    from gomavatar_tpu_torch.models import modules as M
    from gomavatar_tpu_torch.models.gom import frame_table_and_bins, posed_vertices

    verts_obs = posed_vertices(
        params, statics, cfg, frame["cnl_gtfms"], frame["dst_Rs"], frame["dst_Ts"],
        frame["dst_posevec"],
    )
    colors = M.appearance_apply(params["appearance"])
    return frame_table_and_bins(params, statics, cfg, verts_obs, colors, frame["K"], frame["E"])


def forward(params, statics, cfg, frame, device="cuda"):
    from gomavatar_tpu_torch.models.gom import gom_forward

    return gom_forward(
        params, statics, cfg, frame["K"], frame["E"], frame["cnl_gtfms"],
        frame["dst_Rs"], frame["dst_Ts"], dst_posevec=frame["dst_posevec"], i_iter=1e7,
        device=device,
    )


def perturbed_frames(frame, seed: int = 0):
    """The packed frame plus two novel views: the camera turned +-0.3 rad
    about the vertical axis through the origin, the pose vector jittered."""
    rng = np.random.default_rng(seed)
    dev = frame["E"].device
    frames = [frame]
    for angle in (0.3, -0.3):
        c, s = np.cos(angle), np.sin(angle)
        Ry = torch.tensor(
            [[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]], dtype=torch.float32, device=dev
        )
        f = dict(frame)
        f["E"] = frame["E"] @ Ry
        jitter = rng.normal(0.0, 0.05, frame["dst_posevec"].shape).astype(np.float32)
        f["dst_posevec"] = frame["dst_posevec"] + torch.as_tensor(jitter, device=dev)
        frames.append(f)
    return frames


def b1_work(table, bins, ncmax: int):
    """(ops, bytes, swept entries, swept pairs, live splat pairs) of one B1
    call on this frame's data: entries swept (clamped to ncmax chunks from
    the aligned-down start), the (pixel, entry) pairs, and the pairs whose
    splat term is still live (the pixel's transmittance not yet spent)."""
    from gomavatar_tpu_torch.ops.frame_render import P, gather_entries
    from gomavatar_tpu_torch.ops.splat.binning import CHUNK, TILE
    from gomavatar_tpu_torch.ops.splat.reference import ALPHA_MAX, ALPHA_MIN, T_EPS

    entries = gather_entries(table, bins)
    n = min(int(bins.n_active), bins.active_id.shape[0])
    start = bins.seg_start[:n].long()
    count = bins.seg_count[:n].long()
    head = start % CHUNK
    swept = torch.minimum(count, ncmax * CHUNK - head)
    L = int(swept.max())
    dev = entries.device
    lane = torch.arange(L, device=dev)[None, :]
    ok = lane < swept[:, None]
    e = entries[:, torch.clamp_max(start[:, None] + lane, entries.shape[1] - 1)]  # (NCH, n, L)
    tile = bins.active_id[:n].long()
    px = ((tile % bins.num_tiles_x) * TILE)[:, None, None] + (torch.arange(P, device=dev) % TILE)[None, :, None]
    py = ((tile // bins.num_tiles_x) * TILE)[:, None, None] + (torch.arange(P, device=dev) // TILE)[None, :, None]
    dx = px.float() - e[0][:, None, :]
    dy = py.float() - e[1][:, None, :]
    power = -0.5 * (e[2][:, None, :] * dx * dx + e[4][:, None, :] * dy * dy) - e[3][:, None, :] * dx * dy
    alpha = torch.clamp_max(e[5][:, None, :] * torch.exp(power), ALPHA_MAX)
    alpha = torch.where((power > 0) | (alpha < ALPHA_MIN) | ~ok[:, None, :], 0.0, alpha)
    t_excl = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha[..., :-1]], -1), -1)
    live = int(((t_excl >= T_EPS) & ok[:, None, :]).sum())
    pairs = int(swept.sum()) * P
    ops = SPLAT_OPS * live + MESH_OPS * pairs
    nbytes = int(swept.sum()) * entries.shape[0] * 4 + n * (3 + 1 + 5) * P * 4 + 4 * (3 * n + 1)
    return ops, nbytes, int(swept.sum()), pairs, live


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    from gomavatar_tpu_torch import cuda_build
    from gomavatar_tpu_torch.convert import load_trained
    from gomavatar_tpu_torch.ops import frame_render as FR
    from gomavatar_tpu_torch.scene import gate_scene

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    # ---- 1. build
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    print(f"[1] built {sorted(logs) or 'nothing (cached)'} in {time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line.lower():
                print(f"  {name}: {line.strip()}")

    # ---- 2. kernel vs plain, on the card
    print(f"[2] kernel B1 vs its plain version on the card ({card})")
    g_params, g_statics, g_cfg, g_frame = gate_scene(device="cuda", seed=0)
    table, bins, _ = frame_inputs(g_params, g_statics, g_cfg, g_frame)
    compare_b1("gate 64^2", table, bins, g_cfg.img_size)

    t0 = time.perf_counter()
    params, statics, cfg, frame = load_trained(device="cuda")
    print(f"  trained avatar loaded: {cfg.num_faces} faces at {cfg.img_size}, "
          f"{time.perf_counter() - t0:.1f} s")
    t_table, t_bins, _ = frame_inputs(params, statics, cfg, frame)
    max_abs_err, b1_ms, plain_ms = compare_b1("trained 512^2", t_table, t_bins, cfg.img_size)

    print("  gate-scene forward, card vs CPU")
    rgb_c, mask_c, _ = forward(g_params, g_statics, g_cfg, g_frame)
    rgb_h, mask_h, _ = forward(*gate_scene(device="cpu", seed=0), device="cpu")
    check_close("gate forward rgb", rgb_c.cpu(), rgb_h)
    check_close("gate forward mask", mask_c.cpu(), mask_h)

    # ---- 3. the main path
    print("[3] main path: gom_forward(train=False) on the trained avatar at 512^2")
    frames = perturbed_frames(frame)
    FR.frame_sweep.launches = 0
    outs = [forward(params, statics, cfg, f) for f in frames]
    torch.cuda.synchronize()
    launches = FR.frame_sweep.launches
    W, H = cfg.img_size
    for i, (rgb, mask, aux) in enumerate(outs):
        tel = aux["binning"]
        dropped, overflow = int(tel.total_dropped()), int(aux["tile_overflow"])
        print(f"  frame {i}: rgb {tuple(rgb.shape)} mean {float(rgb.mean()):.4f}, "
              f"mask mean {float(mask.mean()):.4f}, max tile entries {int(tel.max_tile_entries)}, "
              f"dropped {dropped}, tile_overflow {overflow}")
        require(rgb.shape == (H, W, 3) and mask.shape == (H, W), f"frame {i}: wrong output shape")
        require(bool(torch.isfinite(rgb).all() and torch.isfinite(mask).all()), f"frame {i}: non-finite output")
        require(float(mask.mean()) > 0.01, f"frame {i}: empty render")
        require(dropped == 0 and overflow == 0, f"frame {i}: binning dropped entries")
    print(f"  B1 launches: {launches} for {len(frames)} frames")
    require(launches == len(frames), "the main path did not launch B1 once per frame")

    # timings (after the counted run)
    for _ in range(3):
        forward(params, statics, cfg, frame)
    torch.cuda.synchronize()
    per_frame = []
    for _ in range(FORWARD_ITERS):
        t0 = time.perf_counter()
        forward(params, statics, cfg, frame)
        torch.cuda.synchronize()
        per_frame.append((time.perf_counter() - t0) * 1e3)
    fwd_ms = statistics.median(per_frame)
    fwd_p90 = statistics.quantiles(per_frame, n=10)[-1]

    ops, nbytes, n_entries, pairs, live = b1_work(t_table, t_bins, FR.NCMAX)
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    t_exp = live / PEAK_EXP_PER_S * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(t_ops, t_exp, t_bytes)
    print(f"  forward: median {fwd_ms:.3f} ms/frame, p90 {fwd_p90:.3f} ms over {FORWARD_ITERS} frames "
          f"({1e3 / fwd_ms:.2f} frames/s at the median) on {card}")
    print(f"  B1: {b1_ms:.4f} ms/launch, plain version {plain_ms:.3f} ms, on {card}")
    print(f"  B1 work: {int(t_bins.n_active)} active tiles, {n_entries} swept entries, {pairs} pairs, "
          f"{live} live splat pairs; {ops:.4g} fp32 ops ({t_ops:.4f} ms at 67 TFLOP/s), "
          f"{live} exps ({t_exp:.4f} ms at {PEAK_EXP_PER_S:.3g}/s), "
          f"{nbytes} bytes ({t_bytes:.4f} ms at 3.35 TB/s)")

    result = {
        "kernels": [
            {
                "name": "B1 frame_render",
                "route": "cuda",
                "source": "gomavatar_tpu_torch/csrc/frame_render.cu",
                "replaces": "gomavatar_tpu/ops/frame_render.py:74",
                "launches": launches,
                "max_abs_err": max_abs_err,
                "ms": b1_ms,
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": "bytes" if t_bytes >= max(t_ops, t_exp) else "operations",
                "library_ms": None,
            }
        ],
    }
    print(json.dumps({"forward": {"median_ms": fwd_ms, "p90_ms": fwd_p90, "fps": 1e3 / fwd_ms,
                                  "frames": FORWARD_ITERS, "seconds": time.perf_counter() - t_start}}))
    print(json.dumps(result))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
