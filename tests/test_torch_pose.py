"""Test-time pose refinement of gomavatar_tpu_torch against gomavatar_tpu's on
the CPU: the pose -> bone transform chain and its vector-Jacobian product,
the posed joints, the pose loss's gradient in (Rh, Th, pose), and three
steps of the port's pose optimizer against JAX's ``make_pose_optimizer`` on
the same 48^2 scene (the body, config and randomized per-face so3, scale and
colors of tests/test_torch_trainer.py, the JAX params carried across, LPIPS
off).  The model is frozen; only the pose takes a gradient.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from gomavatar_tpu.cli.train_pose import make_pose_optimizer as jax_make_pose_optimizer
from gomavatar_tpu.config import default_cfg as jax_default_cfg
from gomavatar_tpu.losses import unpack as jax_unpack
from gomavatar_tpu.models.gom import gom_forward as jax_gom_forward
from gomavatar_tpu.models.gom import init_gom as jax_init_gom
from gomavatar_tpu.models.smpl import synthetic_body, synthetic_camera
from gomavatar_tpu.ops import skeleton as JS
from gomavatar_tpu_torch.cli import train_pose as TP
from gomavatar_tpu_torch.config import default_cfg
from gomavatar_tpu_torch.convert import params_from_jax
from gomavatar_tpu_torch.losses import unpack
from gomavatar_tpu_torch.models import gom as TG
from gomavatar_tpu_torch.ops import skeleton as TS
from torch_threads import one_torch_thread  # noqa: F401

IMG = (48, 48)
ITERS = 3
# a step size large enough that the three losses fall visibly, halved after
# two steps so that the schedule takes part
POSE_CFG = {"lr": 1e-2, "decay": 2, "iters": ITERS}
# the trainer test's loss tolerances and their reason: step 0 within rtol
# 1e-5; later steps start from variables that differ by float roundings,
# which Adam's first updates (lr * g / |g|) turn into steps of up to 2 lr
# where a gradient element is near 0: rtol 1e-3
LOSS_RTOL_STEP0, LOSS_RTOL = 1e-5, 1e-3
# gradients: within 1e-3 of each variable's largest |gradient| (the plain
# kernel versions sum over their entries in another order than JAX's jnp
# paths)
GRAD_ATOL_REL = 1e-3
# the skeleton chain: rtol 1e-5 (atol for the exact zeros)
CHAIN_RTOL, CHAIN_ATOL = 1e-5, 1e-7


def _model_cfg(cfg):
    m = cfg["model"]
    m["img_size"] = list(IMG)
    m["canonical_geometry"]["deform_so3"] = True
    m["canonical_geometry"]["deform_scale"] = True
    m["shadow_module"]["name"] = "basic"
    m["normal_renderer"]["name"] = "mesh"
    m["pose_refinement"]["name"] = "basic"
    m["non_rigid"]["name"] = "basic"
    return cfg


def _loss_cfg(cfg):
    losses = cfg["train"]["losses"]
    losses["lpips"]["coeff"] = 0.0
    return losses


@pytest.fixture(scope="module")
def info():
    return synthetic_body(n_rings=10, n_seg=8)


@pytest.fixture(scope="module")
def scene(info):
    """(JAX params, statics, cfg; port params, statics, cfg; batch_np,
    init pose)."""
    jparams, jstatics, jcfg = jax_init_gom(jax.random.PRNGKey(0), _model_cfg(jax_default_cfg())["model"], info)
    rng = np.random.default_rng(0)
    F = jcfg.num_faces
    jparams["so3"] = jnp.asarray(0.2 * rng.standard_normal((F, 3)), jnp.float32)
    jparams["scale"] = jnp.asarray(1.0 + 0.2 * rng.standard_normal((F, 3)), jnp.float32)
    jparams["appearance"] = {"colors": jnp.asarray(rng.uniform(0.05, 0.95, (F, 3)), jnp.float32)}
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    _, tstatics, tcfg = TG.init_gom(_model_cfg(default_cfg())["model"], info, device="cpu")

    K, E = synthetic_camera(IMG, distance=3.0, focal=45.0)
    joints = np.asarray(info["canonical_joints"], np.float32)
    H, W = IMG[1], IMG[0]
    target = np.zeros((H, W, 3), np.float32)
    target[12:36, 18:30] = [0.8, 0.2, 0.2]
    tmask = np.zeros((H, W), np.float32)
    tmask[12:36, 18:30] = 1.0
    batch = {
        "K": K, "E": E, "cnl_gtfms": np.asarray(JS.get_canonical_global_tfms(jnp.asarray(joints))),
        "dst_tpose_joints": joints, "bgcolor": np.zeros(3, np.float32),
        "target_rgbs": target, "target_masks": tmask,
    }
    batch = {k: np.array(v, np.float32) for k, v in batch.items()}
    pose = np.zeros(72, np.float32)
    pose[:3] = rng.normal(0.0, 0.05, 3)
    pose[3:] = rng.normal(0.0, 0.1, 69)
    return (jparams, jstatics, jcfg), (tparams, tstatics, tcfg), batch, pose


def _jax_frame_loss(pose_vars, self_target, params, statics, gom_cfg, loss_cfg, batch):
    """The pose loss of gomavatar_tpu/cli/train_pose.py (frame_loss), LPIPS
    off, restated from the JAX package's functions.  Where ``self_target``
    (a traced flag, so that one compiled program serves both cases) the
    targets are the render itself, held constant, so that every difference
    is exactly 0 (a render recomputed apart need not round the same way)."""
    Rh, Th, poses = pose_vars["Rh"], pose_vars["Th"], pose_vars["poses"]
    dst_Rs, dst_Ts = JS.body_pose_to_body_RTs(poses, batch["dst_tpose_joints"])
    rgb, mask, _ = jax_gom_forward(
        params, statics, gom_cfg, batch["K"], batch["E"], batch["cnl_gtfms"], dst_Rs, dst_Ts,
        dst_posevec=poses[3:] + 1e-2, i_iter=1e7, global_R=Rh, global_T=Th, train=True,
    )
    rgb_u = jax_unpack(rgb, mask, batch["bgcolor"])
    target_rgbs = jnp.where(self_target, jax.lax.stop_gradient(rgb_u), batch["target_rgbs"])
    target_masks = jnp.where(self_target, jax.lax.stop_gradient(mask), batch["target_masks"])
    loss = jnp.mean(jnp.abs(rgb_u - target_rgbs)) * loss_cfg["rgb"]["coeff"]
    return loss + jnp.mean(jnp.abs(mask - target_masks)) * loss_cfg["mask"]["coeff"]


def _torch_vars(pose):
    return {"Rh": torch.zeros(3, requires_grad=True), "Th": torch.zeros(3, requires_grad=True),
            "poses": torch.as_tensor(pose).clone().requires_grad_(True)}


def _jax_vars(pose):
    return {"Rh": jnp.zeros(3), "Th": jnp.zeros(3), "poses": jnp.asarray(pose)}


@pytest.mark.parametrize("kind", ["random", "zero"])
def test_pose_chain_and_its_vjp_match_jax(info, kind):
    """body_pose_to_body_RTs, its VJP in (pose, T-pose joints) for random
    cotangents, and get_joints_from_pose, at a random pose and at exactly 0
    (where both so3_exp take their Taylor branch)."""
    rng = np.random.default_rng(1)
    pose = rng.normal(0.0, 0.3, 72).astype(np.float32) if kind == "random" else np.zeros(72, np.float32)
    joints = np.asarray(info["canonical_joints"], np.float32)
    g_R = rng.standard_normal((24, 3, 3)).astype(np.float32)
    g_T = rng.standard_normal((24, 3)).astype(np.float32)

    (jR, jT), vjp = jax.vjp(jax.jit(JS.body_pose_to_body_RTs), jnp.asarray(pose), jnp.asarray(joints))
    j_dpose, j_djoints = vjp((jnp.asarray(g_R), jnp.asarray(g_T)))
    tp = torch.as_tensor(pose).requires_grad_(True)
    tj = torch.as_tensor(joints).clone().requires_grad_(True)
    tR, tT = TS.body_pose_to_body_RTs(tp, tj)
    t_dpose, t_djoints = torch.autograd.grad((tR, tT), (tp, tj), (torch.as_tensor(g_R), torch.as_tensor(g_T)))
    for name, a, b in (("Rs", tR.detach(), jR), ("Ts", tT.detach(), jT), ("d pose", t_dpose, j_dpose),
                       ("d joints", t_djoints, j_djoints)):
        assert np.isfinite(a.numpy()).all(), name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=CHAIN_RTOL, atol=CHAIN_ATOL, err_msg=name)
    assert float(t_dpose.abs().max()) > 0

    got = TS.get_joints_from_pose(torch.as_tensor(pose), torch.as_tensor(joints)).numpy()
    want = np.asarray(jax.jit(JS.get_joints_from_pose)(jnp.asarray(pose), jnp.asarray(joints)))
    np.testing.assert_allclose(got, want, rtol=CHAIN_RTOL, atol=CHAIN_ATOL)


@pytest.fixture(scope="module")
def jax_loss_grad(scene):
    """(pose_vars, self_target, batch) -> (loss, gradient in pose_vars)."""
    (jparams, jstatics, jcfg), _, _, _ = scene
    loss_cfg = _loss_cfg(jax_default_cfg())
    return jax.jit(jax.value_and_grad(functools.partial(
        _jax_frame_loss, params=jparams, statics=jstatics, gom_cfg=jcfg, loss_cfg=loss_cfg
    )))


def _check_gradients(t_loss, t_grads, j_loss, j_grads):
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=LOSS_RTOL_STEP0)
    for k in TP.POSE_KEYS:
        a, b = t_grads[k].numpy(), np.asarray(j_grads[k])
        assert np.isfinite(a).all(), k
        scale = float(np.abs(b).max())
        assert scale > 0, k
        np.testing.assert_allclose(a, b, rtol=0, atol=GRAD_ATOL_REL * scale, err_msg=k)


def _torch_loss_grad(scene, batch, pose):
    _, (tparams, tstatics, tcfg), _, _ = scene
    tv = _torch_vars(pose)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, dropped = TP.frame_loss(tv, tparams, tstatics, tcfg, _loss_cfg(default_cfg()), None, tbatch)
    grads = torch.autograd.grad(loss, [tv[k] for k in TP.POSE_KEYS])
    assert int(dropped) == 0
    return loss.detach(), dict(zip(TP.POSE_KEYS, grads))


def test_pose_gradient_matches_jax(scene, jax_loss_grad):
    """The step-0 gradient in (Rh, Th, pose) at Rh = Th = 0, and the loss."""
    _, _, batch, pose = scene
    j_loss, j_grads = jax_loss_grad(_jax_vars(pose), False, batch={k: jnp.asarray(v) for k, v in batch.items()})
    t_loss, t_grads = _torch_loss_grad(scene, batch, pose)
    _check_gradients(t_loss, t_grads, j_loss, j_grads)


def test_pose_gradient_where_the_target_equals_the_render(scene, jax_loss_grad):
    """The targets are the render at the start pose, so every pixel's L1
    difference is exactly 0, the background's included: the gradient is
    that of |x| at 0, +1 in JAX (torch.abs would give 0 and no gradient at
    all).  The port's frame_loss gets its own render, recomputed apart, as
    its target."""
    _, (tparams, tstatics, tcfg), batch, pose = scene
    j_batch = {k: jnp.asarray(v) for k, v in batch.items()}
    j_loss, j_grads = jax_loss_grad(_jax_vars(pose), True, batch=j_batch)
    assert float(j_loss) == 0.0

    tv = _torch_vars(pose)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    with torch.no_grad():
        dst_Rs, dst_Ts = TS.body_pose_to_body_RTs(tv["poses"], tbatch["dst_tpose_joints"])
        rgb, tmask, _ = TG.gom_forward(tparams, tstatics, tcfg, tbatch["K"], tbatch["E"], tbatch["cnl_gtfms"],
                                       dst_Rs, dst_Ts, dst_posevec=tv["poses"][3:] + 1e-2, global_R=tv["Rh"],
                                       global_T=tv["Th"], train=True, device="cpu")
        t_target = unpack(rgb, tmask, tbatch["bgcolor"])
    t_loss, t_grads = _torch_loss_grad(
        scene, dict(batch, target_rgbs=t_target.numpy(), target_masks=tmask.numpy()), pose
    )
    assert float(t_loss) == 0.0
    _check_gradients(t_loss, t_grads, j_loss, j_grads)


@pytest.fixture(scope="module")
def optimized(scene):
    """JAX's make_pose_optimizer and the port's on the same batch and start."""
    (jparams, jstatics, jcfg), (tparams, tstatics, tcfg), batch, pose = scene
    j_opt = jax_make_pose_optimizer(jcfg, _loss_cfg(jax_default_cfg()), POSE_CFG, ITERS)
    j_best, j_best_loss, j_losses = j_opt(jparams, jstatics, None, {k: jnp.asarray(v) for k, v in batch.items()},
                                          jnp.asarray(pose))
    t_opt = TP.make_pose_optimizer(tcfg, _loss_cfg(default_cfg()), POSE_CFG, ITERS)
    t_best, t_best_loss, t_losses, t_dropped = t_opt(tparams, tstatics, None,
                                                     {k: torch.as_tensor(v) for k, v in batch.items()},
                                                     torch.as_tensor(pose))
    j = ({k: np.asarray(v) for k, v in j_best.items()}, float(j_best_loss), np.asarray(j_losses))
    t = ({k: v.numpy() for k, v in t_best.items()}, float(t_best_loss), t_losses.numpy(), t_dropped.numpy())
    return j, t


def test_pose_optimizer_losses_match_jax(optimized):
    (_, _, j_losses), (_, _, t_losses, t_dropped) = optimized
    assert t_losses.shape == j_losses.shape == (ITERS,)
    assert np.isfinite(t_losses).all() and (t_dropped == 0).all()
    np.testing.assert_allclose(t_losses[0], j_losses[0], rtol=LOSS_RTOL_STEP0)
    np.testing.assert_allclose(t_losses[1:], j_losses[1:], rtol=LOSS_RTOL)
    assert t_losses[-1] < t_losses[0]


def test_pose_optimizer_keeps_jax_best(optimized):
    """The best step's index equal, its loss within rtol 1e-3, its variables
    within 2 lr k (k the best index: Adam's first steps are +-lr wherever a
    gradient element is near 0)."""
    (j_best, j_best_loss, j_losses), (t_best, t_best_loss, t_losses, _) = optimized
    k = int(np.argmin(j_losses))
    assert int(np.argmin(t_losses)) == k and k > 0
    np.testing.assert_allclose(t_best_loss, j_best_loss, rtol=LOSS_RTOL)
    assert t_best_loss == t_losses[k]
    for name in TP.POSE_KEYS:
        np.testing.assert_allclose(t_best[name], j_best[name], rtol=0, atol=2 * POSE_CFG["lr"] * k, err_msg=name)


def test_pose_adam_step_size_follows_the_schedule():
    """optax reads its count before the update: steps 0 and 1 at lr, 2 and 3
    at lr / 2, 4 at lr / 4 (decay 2)."""
    tx = TP.PoseAdam(POSE_CFG)
    lr = np.float32(POSE_CFG["lr"])
    assert [tx.step_size(t) for t in range(5)] == [float(-lr * s) for s in (1, 1, 0.5, 0.5, 0.25)]
