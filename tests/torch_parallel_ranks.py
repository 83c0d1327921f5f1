"""Rank functions of the gomavatar_tpu_torch.parallel tests, torch-only.

``parallel.spawn`` starts each rank in a new process, which imports the
module of its function by name; a test module imports JAX, so the ranks'
functions live here.  Every input arrives as numpy (params as the nested
numpy tree that ``convert.params_from_jax`` takes) and every result leaves
as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from gomavatar_tpu_torch.config import default_cfg
from gomavatar_tpu_torch.convert import params_from_jax
from gomavatar_tpu_torch.models import gom as TG
from gomavatar_tpu_torch.optim import tree_leaves

IMG = (48, 48)


def dp_cfg(cfg, subdivide_at=None):
    """tests/test_parallel.py's config (48^2, basic shadow, mesh normals,
    so3 and scale deformed), LPIPS off; applies to either package's
    default_cfg."""
    m = cfg["model"]
    m["img_size"] = list(IMG)
    m["shadow_module"]["name"] = "basic"
    m["normal_renderer"]["name"] = "mesh"
    m["canonical_geometry"]["deform_so3"] = True
    m["canonical_geometry"]["deform_scale"] = True
    if subdivide_at is not None:
        m["subdivide_iters"] = [subdivide_at]
    cfg["train"]["losses"]["lpips"]["coeff"] = 0.0
    return cfg


def tensors(item: dict, device) -> dict:
    return {k: torch.tensor(np.asarray(v, np.float32), device=device) for k, v in item.items()}


def numpy_leaves(params) -> list:
    return [p.detach().cpu().numpy().copy() for p in tree_leaves(params)]


def trainer_runs(group, params_np, info, frames, subdivisions=(None,)):
    """:func:`trainer_run` once for each entry of ``subdivisions``."""
    return [trainer_run(group, params_np, info, frames, s) for s in subdivisions]


def trainer_run(group, params_np, info, frames, subdivide_at=None):
    """Steps of a ``Trainer`` under ``group`` from ``params_np`` at iteration
    0, subdividing at ``subdivide_at``: step s on ``frames[s][rank]``.
    Returns {"losses": per step {name: float} with "total", "mu": Adam's
    first moments after step 0, "params": the leaves after each step,
    "faces", "phase"}."""
    from gomavatar_tpu_torch.trainer import Trainer

    cfg = dp_cfg(default_cfg(), subdivide_at)
    _, statics, gom_cfg = TG.init_gom(cfg["model"], info, device=group.device)
    params = params_from_jax(params_np, device=group.device)
    tr = Trainer(cfg, device=group.device, state=(params, statics, gom_cfg, 0, 0), group=group)
    out = {"losses": [], "params": []}
    for s, per_rank in enumerate(frames):
        total, losses = tr.step(tensors(per_rank[group.rank], group.device))
        out["losses"].append({"total": float(total), **{k: float(v) for k, v in losses.items()}})
        out["params"].append(numpy_leaves(tr.params))
        if s == 0:
            out["mu"] = [m.cpu().numpy().copy() for m in tr.opt_state.mu]
    out["faces"], out["phase"] = tr.gom_cfg.num_faces, tr.phase
    return out


def scene_packs(model_cfg, scenes, device):
    """(params, statics, cfg) of each scene, given as (params_np, info)."""
    packs = []
    for params_np, info in scenes:
        _, statics, cfg = TG.init_gom(model_cfg, info, device=device)
        packs.append((params_from_jax(params_np, device=device), statics, cfg))
    return packs


def multi_scene_run(group, model_cfg, scenes, items):
    """The multi-scene render of ``scenes`` (see :func:`scene_packs`) on
    ``items``: (rgb, mask) as numpy on this rank."""
    from gomavatar_tpu_torch.parallel import make_multi_scene_render

    packs = scene_packs(model_cfg, scenes, group.device)
    rgb, mask = make_multi_scene_render(group)(packs, items)
    return rgb.numpy(), mask.numpy()


def tile_runs(group, cases):
    """:func:`tile_run` on each case (its arguments after the group)."""
    return [tile_run(group, *case) for case in cases]


def tile_run(group, model_cfg, active_cap, params_np, info, frame_np):
    """The tile-parallel render of the scene at ``active_tile_cap =
    active_cap`` with the normal: (rgb, alpha, normal, hit as numpy,
    {n_active, n_local, dropped, tile_overflow})."""
    import dataclasses

    from gomavatar_tpu_torch.parallel import make_tile_parallel_render, shard_slots

    params, statics, cfg = scene_packs(model_cfg, [(params_np, info)], group.device)[0]
    cfg = dataclasses.replace(cfg, active_tile_cap=active_cap)
    f = tensors(frame_np, group.device)
    verts_obs = TG.posed_vertices(params, statics, cfg, f["cnl_gtfms"], f["dst_Rs"], f["dst_Ts"], f["dst_posevec"])
    colors = params["appearance"]["colors"]
    *outs, aux = make_tile_parallel_render(group, cfg, statics, with_normal=True)(
        params, verts_obs, colors, f["K"], f["E"])
    _, bins, _ = TG.frame_table_and_bins(params, statics, cfg, verts_obs, colors, f["K"], f["E"])
    tel = aux["binning"]
    info_out = {"n_active": int(bins.n_active), "n_local": int(shard_slots(bins, group.rank, group.world)[3]),
                "dropped": int(tel.dropped_budget) + int(tel.dropped_buffer),
                "tile_overflow": int(aux["tile_overflow"])}
    return [o.numpy() for o in outs], info_out
