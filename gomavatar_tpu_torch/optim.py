"""Adam with per-module learning-rate groups and the exponential decay
schedule (port of gomavatar_tpu/optim.py).

The reference is one optax chain: ``scale_by_adam(0.9, 0.999, 1e-8)`` ->
per-group ``scale(-lr)`` -> ``scale_by_schedule(0.1 ** (t / decay))``.  Here
the same chain is written out over the params' leaves, with the same state:
Adam's count and moments, and the schedule's own count, which is 0 on the
first update and which ``fast_forward_schedule`` sets after a phase change.
Both counts are int32 tensors on the params' device, as optax keeps them,
and the bias corrections and the decay are computed there in float32, so an
update reads nothing from the host and a captured step (``programs.py``)
replays with the counts it finds.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# param key -> lr group (the names of cfg["train"]["lr"])
_GROUP_OF_KEY = {
    "vertices": "canonical_geometry_xyz",
    "so3": "canonical_geometry",
    "scale": "canonical_geometry",
    "appearance": "appearance",
    "lbs_logits": "lbs_weights",
    "pose_refinement": "pose_refinement",
    "non_rigid": "non_rigid",
    "shadow": "shadow",
}

B1, B2, EPS = 0.9, 0.999, 1e-8


def tree_leaves(tree) -> list:
    """The tensors of a nested dict/list params tree, dict keys in sorted
    order (the order of ``jax.tree_util.tree_leaves``)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves: list):
    """A tree shaped like ``tree`` holding ``leaves`` in tree_leaves order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    return build(tree)


def leaf_groups(params: dict) -> list[str]:
    """The lr group of every leaf, in tree_leaves order."""
    return [_GROUP_OF_KEY[k] for k in sorted(params) for _ in tree_leaves(params[k])]


class AdamState(NamedTuple):
    count: torch.Tensor  # () int32: Adam's update count (bias correction)
    mu: list  # first moments, one per leaf
    nu: list  # second moments
    schedule_count: torch.Tensor  # () int32: the decay schedule's step


def counter(value: int, device) -> torch.Tensor:
    """A count of the optimizer state: a 0-d int32 tensor on ``device``."""
    return torch.full((), int(value), dtype=torch.int32, device=device)


def init_state(leaves: list) -> AdamState:
    """Zero moments and counts on the leaves' device."""
    device = leaves[0].device
    return AdamState(counter(0, device), [torch.zeros_like(p) for p in leaves], [torch.zeros_like(p) for p in leaves],
                     counter(0, device))


def adam_directions(grads: list, state: AdamState):
    """optax's ``scale_by_adam(0.9, 0.999, 1e-8)`` over the leaves:
    (m_hat / (sqrt(v_hat) + eps) per leaf, the new count, mu, nu)."""
    mu = torch._foreach_add(torch._foreach_mul(grads, 1.0 - B1), torch._foreach_mul(state.mu, B1))
    nu = torch._foreach_add(
        torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - B2), torch._foreach_mul(state.nu, B2)
    )
    count = state.count + 1
    # 1 - decay ** count in float32 on the device, as optax's bias correction
    bc1 = 1.0 - torch.pow(B1, count.to(torch.float32))
    bc2 = 1.0 - torch.pow(B2, count.to(torch.float32))
    denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), EPS)
    return torch._foreach_div(torch._foreach_div(mu, bc1), denom), count, mu, nu


class Optimizer:
    """Adam(0.9, 0.999, 1e-8) with a learning rate per param group and the
    decay 0.1^(t / lr_decay_steps) when ``lr_update_exp``."""

    def __init__(self, train_cfg: dict, params: dict):
        lrs = train_cfg["lr"]
        self.decay_steps = float(train_cfg["lr_decay_steps"])
        self.use_decay = bool(train_cfg.get("lr_update_exp", True))
        self.lrs = [float(lrs[g]) for g in leaf_groups(params)]

    def init(self, params: dict) -> AdamState:
        return init_state(tree_leaves(params))

    def update(self, grads: list, state: AdamState):
        """(updates, new state) for the leaves' gradients, as the optax chain
        computes them."""
        directions, count, mu, nu = adam_directions(grads, state)
        # the per-group -lr, then the schedule, each a rounded float32 product
        updates = [torch.mul(u, -lr) for u, lr in zip(directions, self.lrs)]
        if self.use_decay:
            # 0.1 ** (t / decay_steps) in float32 on the device
            scale = torch.pow(0.1, state.schedule_count.to(torch.float32) / self.decay_steps)
            updates = torch._foreach_mul(updates, scale)
        return updates, AdamState(count, mu, nu, state.schedule_count + 1)


def make_optimizer(train_cfg: dict, params: dict) -> Optimizer:
    return Optimizer(train_cfg, params)


def apply_updates(params: dict, updates: list) -> dict:
    return tree_unflatten(params, torch._foreach_add(tree_leaves(params), updates))


def fast_forward_schedule(state: AdamState, step: int) -> AdamState:
    """Set the schedule's count to ``step``: the reference recomputes the lr
    from the global iteration, so a rebuilt optimizer keeps the decay
    continuous across a phase change.  Adam's own count restarts, as a
    fresh optimizer's does."""
    return state._replace(schedule_count=counter(step, state.schedule_count.device))
