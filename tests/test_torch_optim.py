"""Adam with per-group learning rates and the 0.1^(t / decay) schedule of
gomavatar_tpu_torch against the optax chain of gomavatar_tpu's
``make_optimizer`` on the CPU: five updates on fixed gradients, after a
fresh start, after ``fast_forward_schedule`` and from an optax state carried
across mid-trajectory, and the same inside a program (``programs.py``) that
writes the state in place, its counts device tensors; the pose optimizer's
``PoseAdam`` against ``optax.adam`` under the pose schedule of
gomavatar_tpu's ``make_pose_optimizer``, across its decay boundaries;
rtol 1e-6."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from gomavatar_tpu import optim as JO
from gomavatar_tpu_torch import optim as TO
from gomavatar_tpu_torch.cli.train_pose import PoseAdam
from gomavatar_tpu_torch.programs import Program
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


@pytest.mark.parametrize("fast_forward", [0, 6100])
def test_adam_in_a_program_matches_optax(fast_forward):
    """The update as the train program runs it: the state written into the
    program's buffers in place, the counts int32 tensors that the program
    never reads on the host; five calls equal optax's five updates."""
    rng = np.random.default_rng(3)
    params = _params(rng)
    grads = _grads(rng, params, STEPS)
    cfg = _train_cfg(True)
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    jtx = JO.make_optimizer(cfg, j_params)
    j_state = JO.fast_forward_schedule(jtx.init(j_params), fast_forward)
    j_params, _ = _jax_run(jtx, j_state, j_params, grads)

    t_params = params_from_jax(params, device="cpu")
    ttx = TO.make_optimizer(cfg, t_params)
    state = TO.fast_forward_schedule(ttx.init(t_params), fast_forward)

    def step(leaves, state, g):
        updates, new_state = ttx.update(g, state)
        torch._foreach_copy_(leaves + TO.tree_leaves(list(state)),
                             list(torch._foreach_add(leaves, updates)) + TO.tree_leaves(list(new_state)))
        return leaves, state

    prog = Program(step)
    leaves = TO.tree_leaves(t_params)
    for g in grads:
        leaves, state = prog(leaves, state, [torch.as_tensor(x) for x in jax.tree_util.tree_leaves(g)])
    assert prog.captures == 1
    _assert_params_close(TO.tree_unflatten(t_params, leaves), j_params)
    assert state.count.dtype == state.schedule_count.dtype == torch.int32
    assert int(state.count) == STEPS and int(state.schedule_count) == fast_forward + STEPS


@pytest.mark.parametrize("decay", [1, 2, 3])
def test_pose_adam_matches_optax_across_decay(decay):
    """Seven updates of the pose variables (Rh, Th, the 72-d pose) with the
    step size halving every ``decay`` updates: the step size from the
    device count equals optax's schedule at each of them."""
    rng = np.random.default_rng(4)
    shapes = {"Rh": (3,), "Th": (3,), "poses": (72,)}
    pose = {k: rng.standard_normal(v).astype(np.float32) for k, v in shapes.items()}
    grads = [{k: rng.standard_normal(v).astype(np.float32) for k, v in shapes.items()} for _ in range(7)]
    lr = 1e-2

    def schedule(t):  # gomavatar_tpu/cli/train_pose.py's
        return lr * 0.5 ** (t // decay)

    jtx = optax.adam(schedule)
    j_vars = {k: jnp.asarray(v) for k, v in pose.items()}
    j_state = jtx.init(j_vars)
    ttx = PoseAdam({"lr": lr, "decay": decay})
    keys = ("Rh", "Th", "poses")
    t_vars = [torch.as_tensor(pose[k]) for k in keys]
    t_state = ttx.init(t_vars)
    for g in grads:
        updates, j_state = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, j_state, j_vars)
        j_vars = optax.apply_updates(j_vars, updates)
        t_updates, t_state = ttx.update([torch.as_tensor(g[k]) for k in keys], t_state)
        t_vars = torch._foreach_add(t_vars, t_updates)
        for k, t in zip(keys, t_vars):
            np.testing.assert_allclose(t.numpy(), np.asarray(j_vars[k]), rtol=RTOL, atol=1e-7)
    assert int(t_state.count) == len(grads) and t_state.count.dtype == torch.int32
