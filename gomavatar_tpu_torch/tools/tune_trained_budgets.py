"""Sweep the eval path's tile budgets on a trained avatar (port of the JAX
package's ``tools/tune_trained_budgets.py``).

For each setting of (``max_tiles_per_gaussian``, ``binning_band0``,
``active_tile_cap``) the avatar's packed frame goes through
``gom_forward(train=False)`` (kernel B1 on the card) under
``dataclasses.replace(cfg, ...)``.  Each line gives the binning's
``dropped_budget`` and ``dropped_buffer``, the renderer's ``tile_overflow``
and the forward's median ms; the first line gives the widest splat's tile
span on the packed frame, which is what the per-splat budget has to cover.
It changes no default: the floor of the budget stays 32, as in the JAX
package.

    python -m gomavatar_tpu_torch.tools.tune_trained_budgets \\
        [--avatar artifacts/e2e_trained.npz] [--img 512] [--device cpu]

``--avatar`` takes any exported avatar npz (``tools/export_trained.py``);
``--img`` renders the packed frame at another square size, its intrinsics
scaled to match.
"""

from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import numpy as np
import torch

from gomavatar_tpu_torch.cli.train import check_device
from gomavatar_tpu_torch.convert import TRAINED, load_trained
from gomavatar_tpu_torch.models import modules as M
from gomavatar_tpu_torch.models.gom import eval_aux, frame_table_and_bins, gom_forward, posed_vertices
from gomavatar_tpu_torch.ops.geometry import frame_geometry
from gomavatar_tpu_torch.ops.splat.binning import TILE

# (max_tiles_per_gaussian, binning_band0, active_tile_cap): the JAX tool's
# five settings (the default of both packages is (32, 4, 512)), then two
# budgets past the floor of 32
SETTINGS = ((16, 4, 512), (24, 4, 512), (24, 6, 512), (32, 4, 512), (32, 8, 512), (40, 4, 512), (48, 4, 512))
# timed forwards per setting, after WARMUP untimed ones
ITERS, WARMUP = 30, 3


def widest_span(params, statics, cfg, frame) -> int:
    """The most tiles any valid splat's union box covers on the frame."""
    with torch.no_grad():
        verts = posed_vertices(params, statics, cfg, frame["cnl_gtfms"], frame["dst_Rs"], frame["dst_Ts"],
                               frame["dst_posevec"])
        g = frame_geometry(verts, statics.faces, params["so3"], params["scale"],
                           M.appearance_apply(params["appearance"]), statics.vf_incidence, statics.vf_valid,
                           frame["K"], frame["E"], cfg.img_size, cfg.sigma, 0.0)
    x0, x1, y0, y1 = (b.cpu().numpy() for b in g.union_box)
    tiles = (np.floor(x1 / TILE) - np.floor(x0 / TILE) + 1) * (np.floor(y1 / TILE) - np.floor(y0 / TILE) + 1)
    return int(np.where(g.valid.cpu().numpy(), np.maximum(tiles, 0), 0).max())


def forward(params, statics, cfg, frame, device):
    return gom_forward(params, statics, cfg, frame["K"], frame["E"], frame["cnl_gtfms"], frame["dst_Rs"],
                       frame["dst_Ts"], dst_posevec=frame["dst_posevec"], i_iter=1e7, train=False, device=device)


def counters(aux) -> dict:
    tel = aux["binning"]
    return {"dropped_budget": int(tel.dropped_budget), "dropped_buffer": int(tel.dropped_buffer),
            "tile_overflow": int(aux["tile_overflow"])}


def binned_counters(params, statics, cfg, frame) -> dict:
    """The forward's counters from its binning alone, without B1's render."""
    with torch.no_grad():
        verts = posed_vertices(params, statics, cfg, frame["cnl_gtfms"], frame["dst_Rs"], frame["dst_Ts"],
                               frame["dst_posevec"])
        _, bins, _ = frame_table_and_bins(params, statics, cfg, verts, M.appearance_apply(params["appearance"]),
                                          frame["K"], frame["E"])
    return counters(eval_aux(bins))


def sweep(params, statics, cfg, frame, settings, iters: int, warmup: int, device="cuda"):
    """One row per setting: its counters and the forward's median and p90
    ms over ``iters`` synchronised calls after ``warmup``."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    rows = []
    for mtg, band0, cap in settings:
        c = dataclasses.replace(cfg, max_tiles_per_gaussian=mtg, binning_band0=band0, active_tile_cap=cap)
        with torch.no_grad():
            row = {"max_tiles_per_gaussian": mtg, "binning_band0": band0, "active_tile_cap": cap,
                   **counters(forward(params, statics, c, frame, device)[2])}
            for _ in range(warmup):
                forward(params, statics, c, frame, device)
            ms = []
            for _ in range(iters):
                sync()
                t0 = time.perf_counter()
                forward(params, statics, c, frame, device)
                sync()
                ms.append((time.perf_counter() - t0) * 1e3)
        row["median_ms"] = statistics.median(ms)
        row["p90_ms"] = statistics.quantiles(ms, n=10)[-1] if len(ms) > 1 else ms[0]
        rows.append(row)
    return rows


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Sweep the eval path's tile budgets on a trained avatar.")
    ap.add_argument("--avatar", default=str(TRAINED), help="an exported avatar npz (default: the JAX package's)")
    ap.add_argument("--img", type=int, default=None, help="render at this square size (default: the avatar's)")
    ap.add_argument("--device", default="cuda", help="torch device: cuda (the default) or cpu")
    args = ap.parse_args(argv)
    device = check_device(args.device)

    params, statics, cfg, frame = load_trained(args.avatar, device)
    if args.img is not None:
        frame = dict(frame, K=frame["K"].clone())
        frame["K"][:2] *= args.img / cfg.img_size[0]
        cfg = dataclasses.replace(cfg, img_size=(args.img, args.img))
    span = widest_span(params, statics, cfg, frame)
    print(f"{args.avatar}: {cfg.num_faces} faces at {cfg.img_size[0]}x{cfg.img_size[1]}; the widest splat spans "
          f"{span} tiles of {TILE}x{TILE} px", flush=True)
    rows = sweep(params, statics, cfg, frame, SETTINGS, ITERS, WARMUP, device)
    for r in rows:
        print(f"mtg={r['max_tiles_per_gaussian']:3d} band0={r['binning_band0']} cap={r['active_tile_cap']}: "
              f"dropped_budget={r['dropped_budget']} dropped_buffer={r['dropped_buffer']} "
              f"tile_overflow={r['tile_overflow']}  median {r['median_ms']:.3f} ms  p90 {r['p90_ms']:.3f} ms",
              flush=True)
    return {"avatar": args.avatar, "num_faces": cfg.num_faces, "img_size": list(cfg.img_size),
            "widest_span": span, "settings": rows}


if __name__ == "__main__":
    main()
