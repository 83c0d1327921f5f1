"""Adam with per-group learning rates and the 0.1^(t / decay) schedule of
gomavatar_tpu_torch against the optax chain of gomavatar_tpu's
``make_optimizer`` on the CPU: five updates on fixed gradients, after a
fresh start, after ``fast_forward_schedule`` and from an optax state carried
across mid-trajectory; rtol 1e-6."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from gomavatar_tpu import optim as JO
from gomavatar_tpu_torch import optim as TO
from gomavatar_tpu_torch.convert import adam_state_from_optax, params_from_jax
from gomavatar_tpu_torch.scene import E2E_TRAIN
from torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-6
STEPS = 5


def _params(rng):
    """A params tree with every lr group, an MLP as a list of layers."""
    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {
        "vertices": a(20, 3), "so3": a(8, 3), "scale": a(8, 3),
        "appearance": {"colors": a(8, 3)},
        "pose_refinement": {"layers": [{"w": a(4, 5), "b": a(5)}, {"w": a(5, 2), "b": a(2)}]},
        "non_rigid": {"layers": [{"w": a(3, 4), "b": a(4)}]},
        "shadow": {"layers": [{"w": a(3, 1), "b": a(1)}]},
    }


def _grads(rng, params, n):
    return [jax.tree_util.tree_map(lambda p: rng.standard_normal(p.shape).astype(np.float32), params) for _ in range(n)]


def _jax_run(tx, state, params, grads):
    for g in grads:
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state, params)
        params = optax.apply_updates(params, updates)
    return params, state


def _torch_run(tx, state, params, grads):
    for g in grads:
        updates, state = tx.update([torch.as_tensor(x) for x in jax.tree_util.tree_leaves(g)], state)
        params = TO.apply_updates(params, updates)
    return params, state


def _assert_params_close(t_params, j_params):
    t_leaves, j_leaves = TO.tree_leaves(t_params), jax.tree_util.tree_leaves(j_params)
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL, atol=1e-7)


def _train_cfg(decay: bool):
    cfg = dict(E2E_TRAIN)
    cfg["lr_update_exp"] = decay
    cfg["lr_decay_steps"] = 3  # a fast decay: the schedule's rounding shows
    return cfg


@pytest.mark.parametrize("fast_forward", [0, 6100])
@pytest.mark.parametrize("decay", [True, False])
def test_adam_and_schedule_match_optax(fast_forward, decay):
    rng = np.random.default_rng(0)
    params = _params(rng)
    grads = _grads(rng, params, STEPS)
    cfg = _train_cfg(decay)
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    jtx = JO.make_optimizer(cfg, j_params)
    ttx = TO.make_optimizer(cfg, params_from_jax(params, device="cpu"))
    j_state, t_state = jtx.init(j_params), ttx.init(params_from_jax(params, device="cpu"))
    if fast_forward:
        j_state = JO.fast_forward_schedule(j_state, fast_forward)
        t_state = TO.fast_forward_schedule(t_state, fast_forward)
    j_params, j_state = _jax_run(jtx, j_state, j_params, grads)
    t_params, t_state = _torch_run(ttx, t_state, params_from_jax(params, device="cpu"), grads)
    _assert_params_close(t_params, j_params)
    assert t_state.count == STEPS
    assert t_state.schedule_count == fast_forward + STEPS


def test_state_carried_across_mid_trajectory():
    """Three optax updates, the state carried across, two more on both."""
    rng = np.random.default_rng(1)
    params = _params(rng)
    grads = _grads(rng, params, STEPS)
    cfg = _train_cfg(True)
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    jtx = JO.make_optimizer(cfg, j_params)
    j_params, j_state = _jax_run(jtx, JO.fast_forward_schedule(jtx.init(j_params), 100), j_params, grads[:3])
    t_state = adam_state_from_optax(j_state, device="cpu")
    assert t_state.count == 3 and t_state.schedule_count == 103
    t_params = params_from_jax(jax.tree_util.tree_map(np.asarray, j_params), device="cpu")
    ttx = TO.make_optimizer(cfg, t_params)
    j_params, _ = _jax_run(jtx, j_state, j_params, grads[3:])
    t_params, _ = _torch_run(ttx, t_state, t_params, grads[3:])
    _assert_params_close(t_params, j_params)


def test_leaf_groups_follow_the_reference_labels():
    rng = np.random.default_rng(2)
    params = _params(rng)
    labels = jax.tree_util.tree_leaves(JO.label_params(params))
    assert TO.leaf_groups(params) == labels
