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


# ---- the rank programs (tests/test_torch_rank_programs.py) ----------------------


def program_jobs(group, jobs):
    """Each ``(name, args)`` of ``jobs`` run by the function ``name`` of
    this module on ``group``, in order: their results, one rank start for
    all."""
    return [globals()[name](group, *args) for name, args in jobs]


def dp_program_run(group, params_np, info, frames, subdivide_at=None):
    """``Trainer(group=...)``'s steps through its rank program from
    ``params_np`` at iteration 0 (step s on ``frames[s][rank]``), and
    without a subdivision the eager ``make_data_parallel_train_step`` from
    the same state beside it.  Returns {"params", "eager" (the leaves after
    each step), "losses", "mu" (Adam's first moments after step 0),
    "reduces" (all-reduces per step), "in_place" (the state is the
    program's buffers after each step), "overwritten" (step 1's outputs are
    step 0's tensors with new values), "programs" (per phase: its class,
    captures and form), "faces", "phase"}."""
    from gomavatar_tpu_torch.parallel import all_reduce_sum, make_data_parallel_train_step
    from gomavatar_tpu_torch.trainer import Trainer

    cfg = dp_cfg(default_cfg(), subdivide_at)
    _, statics, gom_cfg = TG.init_gom(cfg["model"], info, device=group.device)
    tr = Trainer(cfg, device=group.device, state=(params_from_jax(params_np, group.device), statics, gom_cfg, 0, 0),
                 group=group)
    eager = make_data_parallel_train_step(group, gom_cfg, cfg["train"]["losses"], tr.tx)
    p, o = params_from_jax(params_np, group.device), tr.opt_state
    out = {"params": [], "eager": [], "losses": [], "reduces": [], "in_place": []}
    programs = []
    for s, per_rank in enumerate(frames):
        batch = tensors(per_rank[group.rank], group.device)
        calls = all_reduce_sum.calls
        total, losses = tr.step(batch)
        out["reduces"].append(all_reduce_sum.calls - calls)
        prog = tr._step_fn
        if prog not in programs:
            programs.append(prog)
        out["in_place"].append(tr.params is prog.last_args[0] and tr.opt_state is prog.last_args[1])
        out["losses"].append({"total": float(total), **{k: float(v) for k, v in losses.items()}})
        out["params"].append(numpy_leaves(tr.params))
        if s == 0:
            out["mu"] = [m.cpu().numpy().copy() for m in tr.opt_state.mu]
            first, first_total = total, float(total)
        elif s == 1 and len(programs) == 1:
            out["overwritten"] = total is first and float(first) != first_total
        if subdivide_at is None:
            p, o, _, _ = eager(p, o, tr.statics, None, batch, float(s))
            out["eager"].append(numpy_leaves(p))
    out["programs"] = [(type(q).__name__, q.captures, q.one_graph) for q in programs]
    out["faces"], out["phase"] = tr.gom_cfg.num_faces, tr.phase
    return out


def tile_program_run(group, model_cfg, active_cap, params_np, info, frames_np):
    """The tile-parallel render's program of the scene at ``active_tile_cap
    = active_cap`` with the normal, called on each of ``frames_np`` in turn:
    per call (rgb, alpha, normal, hit as numpy, all-gathers in the call);
    "same_outputs": every call returned the first call's tensors;
    "captures"."""
    import dataclasses

    from gomavatar_tpu_torch.parallel import all_gather_cat, make_tile_parallel_render

    params, statics, cfg = scene_packs(model_cfg, [(params_np, info)], group.device)[0]
    cfg = dataclasses.replace(cfg, active_tile_cap=active_cap)
    render = make_tile_parallel_render(group, cfg, statics, with_normal=True)
    calls, first = [], None
    same = True
    for frame_np in frames_np:
        f = tensors(frame_np, group.device)
        verts_obs = TG.posed_vertices(params, statics, cfg, f["cnl_gtfms"], f["dst_Rs"], f["dst_Ts"],
                                      f["dst_posevec"])
        n = all_gather_cat.calls
        *outs, _ = render(params, verts_obs, params["appearance"]["colors"], f["K"], f["E"])
        first = first or outs
        same = same and all(a is b for a, b in zip(outs, first))
        calls.append(([o.numpy().copy() for o in outs], all_gather_cat.calls - n))
    return {"calls": calls, "same_outputs": same, "captures": render.captures}


def multi_scene_calls(group, model_cfg, scenes, items, n_calls):
    """``n_calls`` calls of the multi-scene render of ``scenes`` on
    ``items``: per call (rgb, mask as numpy, all-gathers in the call)."""
    from gomavatar_tpu_torch.parallel import all_gather_cat, make_multi_scene_render

    packs = scene_packs(model_cfg, scenes, group.device)
    render = make_multi_scene_render(group)
    out = []
    for _ in range(n_calls):
        n = all_gather_cat.calls
        rgb, mask = render(packs, items)
        out.append((rgb.numpy().copy(), mask.numpy().copy(), all_gather_cat.calls - n))
    return out
