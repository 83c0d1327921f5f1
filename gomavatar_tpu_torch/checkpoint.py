"""Checkpoint / resume with ``torch.save`` (port of gomavatar_tpu/checkpoint.py).

Each ``iter_{N}`` directory holds one file, ``state.pt``, with
{params, opt_state, meta}: the params tree, the ``optim.AdamState`` as a
dict, and meta = {iter, phase}, where ``phase`` counts completed
subdivisions, the shape-changing milestone that a restore replays before it
loads (``Trainer.resume``, ``Trainer.load_for_eval``).  Tensors are saved on
the CPU and loaded with ``weights_only=True``.  The JAX package's orbax
checkpoints are not read here; ``convert.py`` carries a JAX model across.
"""

from __future__ import annotations

import os
import re

import torch

from gomavatar_tpu_torch.optim import AdamState, counter, tree_leaves

STATE_FILE = "state.pt"


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_cpu(v) for v in tree]
    return tree.detach().cpu()


def save_checkpoint(ckpt_dir: str, it: int, params, opt_state: AdamState, phase: int) -> None:
    """Write ``<ckpt_dir>/iter_{it}/state.pt``, replacing one that exists."""
    path = os.path.abspath(os.path.join(ckpt_dir, f"iter_{it}"))
    os.makedirs(path, exist_ok=True)
    payload = {
        "params": _to_cpu(params),
        "opt_state": {
            "count": int(opt_state.count),
            "mu": _to_cpu(opt_state.mu),
            "nu": _to_cpu(opt_state.nu),
            "schedule_count": int(opt_state.schedule_count),
        },
        "meta": {"iter": int(it), "phase": int(phase)},
    }
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))


def latest_checkpoint(ckpt_dir: str) -> tuple[str, int] | None:
    """(path, iter) of the highest ``iter_{N}`` directory, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"iter_(\d+)", name)
        if m:
            it = int(m.group(1))
            if best is None or it > best[1]:
                best = (os.path.join(ckpt_dir, name), it)
    return best


def _load(path: str, device="cpu", mmap: bool = False) -> dict:
    return torch.load(os.path.join(os.path.abspath(path), STATE_FILE), map_location=device, weights_only=True,
                      mmap=mmap)


def read_phase(path: str) -> int:
    """Read only the phase counter (the tensors are memory-mapped, not read)."""
    return int(_load(path, mmap=True)["meta"]["phase"])


def _check_like(saved, like, where: str):
    """Raise ValueError unless ``saved`` has the structure of ``like`` and
    every tensor leaf its shape."""
    if isinstance(like, dict):
        if not isinstance(saved, dict) or set(saved) != set(like):
            raise ValueError(f"checkpoint {where}: keys {sorted(saved) if isinstance(saved, dict) else saved!r}"
                             f" where {sorted(like)} were expected")
        for k in like:
            _check_like(saved[k], like[k], f"{where}/{k}")
    elif isinstance(like, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(like):
            raise ValueError(f"checkpoint {where}: {len(saved) if isinstance(saved, (list, tuple)) else saved!r} items "
                             f"where {len(like)} were expected")
        for i, (s, l) in enumerate(zip(saved, like)):
            _check_like(s, l, f"{where}/{i}")
    elif not isinstance(saved, torch.Tensor) or saved.shape != like.shape:
        got = tuple(saved.shape) if isinstance(saved, torch.Tensor) else saved
        raise ValueError(f"checkpoint {where}: shape {got} where {tuple(like.shape)} was expected (replay the "
                         f"subdivisions to the stored phase first)")


def restore_checkpoint(path: str, params_like, opt_state_like: AdamState):
    """Load (params, opt_state, iter, phase) onto the device of
    ``params_like``.  The templates must already have the stored phase's
    shapes (the caller replays the subdivisions first); a leaf whose shape
    differs raises ValueError."""
    device = tree_leaves(params_like)[0].device
    payload = _load(path, device)
    _check_like(payload["params"], params_like, "params")
    opt = payload["opt_state"]
    _check_like(opt["mu"], opt_state_like.mu, "opt_state/mu")
    _check_like(opt["nu"], opt_state_like.nu, "opt_state/nu")
    opt_state = AdamState(counter(opt["count"], device), list(opt["mu"]), list(opt["nu"]),
                          counter(opt["schedule_count"], device))
    return payload["params"], opt_state, int(payload["meta"]["iter"]), int(payload["meta"]["phase"])

