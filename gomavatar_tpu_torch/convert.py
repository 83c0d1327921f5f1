"""Carry weights across from the JAX package and load the trained avatar.

* ``params_from_jax`` maps the JAX param pytree, given as numpy arrays
  (nested dicts, with the MLPs' ``layers`` as lists), onto this package's
  param dicts: the layouts are the same, one array for one tensor.
* ``load_trained`` reads the committed trained avatar
  (``artifacts/e2e_trained.npz``, a flat npz: ``meta`` JSON,
  ``params/<path>`` arrays, ``frame/<key>`` arrays) without JAX: it rebuilds
  the mesh from ``synthetic_body(**meta["body"])``, replays
  ``meta["phase"]`` subdivisions and checks the face count against
  ``meta["num_faces"]``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from gomavatar_tpu_torch.models.gom import init_gom, subdivide_gom
from gomavatar_tpu_torch.models.smpl import synthetic_body

TRAINED = Path(__file__).resolve().parent.parent / "artifacts" / "e2e_trained.npz"
FRAME_KEYS = ("K", "E", "cnl_gtfms", "dst_Rs", "dst_Ts", "dst_posevec")


def params_from_jax(tree, device="cuda"):
    """Nested dicts/lists of numpy (or array-like) leaves -> the same
    structure of float32 tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    return torch.tensor(np.asarray(tree, dtype=np.float32), device=device)


def adam_state_from_optax(opt_state, device="cuda"):
    """An optax state of the JAX package's ``make_optimizer`` chain ->
    ``optim.AdamState``: Adam's count and moments (leaves in sorted-key
    order, as ``optim.tree_leaves`` lists them) and the decay schedule's
    count (0 when the chain has no schedule)."""
    from gomavatar_tpu_torch.optim import AdamState, tree_leaves

    found = {}

    def walk(s):
        fields = getattr(s, "_fields", None)
        if fields == ("count", "mu", "nu"):
            found["adam"] = s
        elif fields == ("count",):
            found["schedule"] = int(np.asarray(s.count))
        elif isinstance(s, (tuple, list)):
            for x in s:
                walk(x)

    walk(opt_state)
    adam = found["adam"]

    def moments(tree):
        return [torch.tensor(np.asarray(a, np.float32), device=device) for a in tree_leaves(tree)]

    return AdamState(int(np.asarray(adam.count)), moments(adam.mu), moments(adam.nu), found.get("schedule", 0))


def unflatten_params(npz) -> dict:
    """``params/a/0/b`` keys of a flat npz -> nested dicts; all-integer-keyed
    dicts become lists (the MLPs' ``layers``)."""
    params: dict = {}
    for key in npz.files:
        if not key.startswith("params/"):
            continue
        parts = key.split("/")[1:]
        d = params
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = npz[key]

    def listify(d):
        if not isinstance(d, dict):
            return d
        if d and all(k.isdigit() for k in d):
            return [listify(d[k]) for k in sorted(d, key=int)]
        return {k: listify(v) for k, v in d.items()}

    return listify(params)


def trained_meta(path=TRAINED) -> dict:
    """The ``meta`` record of the trained avatar (iter, phase, model_cfg,
    num_faces, body)."""
    with np.load(path) as npz:
        return json.loads(str(npz["meta"]))


def load_trained(path=TRAINED, device="cuda"):
    """(params, statics, gom_cfg, frame) of the trained avatar, with the
    packed animation frame's K, E, cnl_gtfms, dst_Rs, dst_Ts and dst_posevec
    as float32 tensors on ``device``."""
    with np.load(path) as npz:
        meta = json.loads(str(npz["meta"]))
        info = synthetic_body(**meta["body"])
        params, statics, gom_cfg = init_gom(meta["model_cfg"], info, device=device)
        for _ in range(meta["phase"]):
            params, statics, gom_cfg = subdivide_gom(params, statics, gom_cfg)
        if gom_cfg.num_faces != meta["num_faces"]:
            raise RuntimeError(f"mesh generator drift: {gom_cfg.num_faces} vs {meta['num_faces']} faces")
        params = params_from_jax(unflatten_params(npz), device)
        frame = {
            k: torch.as_tensor(np.asarray(npz[f"frame/{k}"], np.float32), device=device)
            for k in FRAME_KEYS
        }
    return params, statics, gom_cfg, frame


def load_trained_state(path=TRAINED, device="cuda"):
    """(state, frame) of the trained avatar, where ``state`` = (params,
    statics, gom_cfg, i_iter, phase) starts a ``trainer.Trainer`` where its
    training stopped."""
    params, statics, gom_cfg, frame = load_trained(path, device)
    meta = trained_meta(path)
    return (params, statics, gom_cfg, int(meta["iter"]), int(meta["phase"])), frame
